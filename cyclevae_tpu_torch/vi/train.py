"""CycleVAE model assembly: configuration, parameter container, init.

PyTorch counterpart of the model-assembly part of
``cyclevae_tpu/vi/train.py`` (``CycleVAEConfig``, ``CycleVAEParams``,
``init_cyclevae``).  The training core (cyclic flow, ELBO, TBPTT, optimizer)
lands here with the training slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from ..models.gru_vae import GRURNNConfig, init_gru_rnn
from ..utils.device import resolve_device
from ..utils.tree import tree_map


@dataclass(frozen=True)
class CycleVAEConfig:
    """Encoder/decoder pair configuration (reference train…py:310-329)."""

    in_dim: int = 54
    out_dim: int = 50
    lat_dim: int = 32
    n_spk: int = 2
    hidden_units: int = 1024
    hidden_layers: int = 1
    kernel_size: int = 3
    dilation_size: int = 2
    n_cyc: int = 2
    do_prob: float = 0.5
    stdim: int = 4
    posterior: str = "gauss"    # "gauss" | "laplace" (reference gru_vae.py:101-144)
    # perf knobs (numerics-affecting, off by default for reference parity):
    # use_pallas routes the AR recurrence through the fused kernel
    # (ops/cuda_gru.py); compute_dtype="bfloat16" rounds the products'
    # operands to bf16 with float32 master weights
    use_pallas: bool = False
    compute_dtype: str = "float32"

    @property
    def enc_cfg(self) -> GRURNNConfig:
        return GRURNNConfig(
            in_dim=self.in_dim, out_dim=self.lat_dim * 2,
            hidden_units=self.hidden_units, hidden_layers=self.hidden_layers,
            kernel_size=self.kernel_size, dilation_size=self.dilation_size,
            do_prob=self.do_prob, scale_in=True, scale_out=False,
            compute_dtype=self.compute_dtype)

    @property
    def dec_cfg(self) -> GRURNNConfig:
        return GRURNNConfig(
            in_dim=self.lat_dim + self.n_spk, out_dim=self.out_dim,
            hidden_units=self.hidden_units, hidden_layers=self.hidden_layers,
            kernel_size=self.kernel_size, dilation_size=self.dilation_size,
            do_prob=self.do_prob, scale_in=False, scale_out=True,
            compute_dtype=self.compute_dtype)


class CycleVAEParams(NamedTuple):
    encoder: Dict
    decoder: Dict


def params_to(params: CycleVAEParams, device) -> CycleVAEParams:
    """The same parameters as float32 tensors on ``device`` (a no-op for
    tensors already there)."""
    move = lambda a: torch.as_tensor(a).to(device=device, dtype=torch.float32)
    return CycleVAEParams(*(tree_map(move, p) for p in params))


def init_cyclevae(generator: torch.Generator, cfg: CycleVAEConfig,
                  mean_jnt=None, scale_jnt=None, device=None) -> CycleVAEParams:
    """Init both nets from ``generator`` (drawn on its device, then moved to
    ``device``, CUDA by default); bake joint stats into the frozen scalers if
    given (encoder normalizes the full in_dim feature, decoder
    un-normalizes the out_dim mcep block = stats[stdim:])."""
    device = resolve_device(device)
    enc = init_gru_rnn(generator, cfg.enc_cfg)
    dec = init_gru_rnn(generator, cfg.dec_cfg)
    if mean_jnt is not None:
        mean_jnt = torch.as_tensor(mean_jnt, dtype=torch.float32)
        scale_jnt = torch.as_tensor(scale_jnt, dtype=torch.float32)
        enc["scale_in"] = {"mean": mean_jnt, "scale": scale_jnt}
        dec["scale_out"] = {"mean": mean_jnt[cfg.stdim:], "scale": scale_jnt[cfg.stdim:]}
    return params_to(CycleVAEParams(encoder=enc, decoder=dec), device)
