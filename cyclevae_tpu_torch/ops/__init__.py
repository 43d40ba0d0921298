from .cuda_gru import cuda_gru_ar, gru_ar_reference
from .gru_scan import gru_ar_scan, precompute_input_gates

__all__ = ["cuda_gru_ar", "gru_ar_reference", "gru_ar_scan",
           "precompute_input_gates"]
