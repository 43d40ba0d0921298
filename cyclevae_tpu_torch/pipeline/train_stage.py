"""Stage 4 (training) driver: so far the model-config mapping (which the
decode stage needs too) and the batch padding of the epoch loop.  PyTorch
counterpart of ``cyclevae_tpu/pipeline/train_stage.py``; the epoch driver
``run_train`` waits for the port's HDF5 stats and host DTW."""

from __future__ import annotations

from typing import Dict

import numpy as np

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


def _pad_batch_utts(batch: Dict, bsu: int) -> Dict:
    """Pad a partial utterance batch to bsu with zero-flen dummies, so every
    batch of a bucket has one shape (masks null their loss contribution)."""
    B = batch["feats"].shape[0]
    if B == bsu:
        return batch
    out = {}
    for k, v in batch.items():
        pad_shape = (bsu - B,) + v.shape[1:]
        out[k] = np.concatenate([v, np.zeros(pad_shape, v.dtype)])
    return out
