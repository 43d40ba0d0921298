"""Stage 4 (training) driver: so far only the model-config mapping that the
decode stage needs too.  PyTorch counterpart of
``cyclevae_tpu/pipeline/train_stage.py``."""

from __future__ import annotations

from ..utils.config import ExperimentConfig
from ..vi.train import CycleVAEConfig


def model_config(exp: ExperimentConfig) -> CycleVAEConfig:
    m = exp.model
    return CycleVAEConfig(
        in_dim=m.in_dim, out_dim=m.out_dim, lat_dim=m.lat_dim, n_spk=m.n_spk,
        hidden_units=m.hidden_units, hidden_layers=m.hidden_layers,
        kernel_size=m.kernel_size, dilation_size=m.dilation_size,
        n_cyc=m.n_cyc, do_prob=m.do_prob, stdim=m.stdim,
        posterior=m.posterior, use_pallas=m.use_pallas,
        compute_dtype=m.compute_dtype)
