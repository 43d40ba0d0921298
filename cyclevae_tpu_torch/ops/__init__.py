from .cuda_gru import (
    cuda_gru_ar,
    cuda_gru_ar_bwd,
    cuda_gru_ar_train,
    cuda_gru_ar_train_gates,
    gru_ar_bwd_reference,
    gru_ar_gates_reference,
    gru_ar_reference,
    gru_ar_train_reference,
)
from .cuda_wavernn import cuda_wavernn_generate, philox4x32_10, wavernn_generate_reference
from .gru_ar_vjp import gru_ar_fused
from .gru_scan import gru_ar_scan, precompute_input_gates

__all__ = ["cuda_gru_ar", "cuda_gru_ar_bwd", "cuda_gru_ar_train", "cuda_gru_ar_train_gates",
           "gru_ar_bwd_reference", "gru_ar_gates_reference", "gru_ar_reference",
           "gru_ar_train_reference",
           "cuda_wavernn_generate", "philox4x32_10", "wavernn_generate_reference",
           "gru_ar_fused", "gru_ar_scan", "precompute_input_gates"]
