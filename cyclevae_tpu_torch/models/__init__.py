from .gru_vae import (
    GRURNNConfig,
    LOG_SCALE_MIN,
    LOG_VAR_MIN,
    gru_rnn_apply,
    init_gru_rnn,
    init_hidden,
    sampling_vae_batch,
    sampling_vae_laplace_batch,
    set_scale_stats,
)
from .layers import (
    dilconv_apply,
    dilconv_effective,
    init_dense,
    init_dilconv,
    init_gru_stack,
    window_gather,
    xavier_uniform,
)

__all__ = [
    "GRURNNConfig",
    "LOG_SCALE_MIN",
    "LOG_VAR_MIN",
    "gru_rnn_apply",
    "init_gru_rnn",
    "init_hidden",
    "sampling_vae_batch",
    "sampling_vae_laplace_batch",
    "set_scale_stats",
    "dilconv_apply",
    "dilconv_effective",
    "init_dense",
    "init_dilconv",
    "init_gru_stack",
    "window_gather",
    "xavier_uniform",
]
