"""Log-joint assembly for posterior inference over CycleVAE latents.

PyTorch counterpart of ``cyclevae_tpu/infer/logjoint.py``: the frozen
decoder + a standard-normal prior over the per-frame latent trajectory
become a log-joint log p(x, z) = log p(x | dec(z)) + log p(z), against which
HMC/NUTS (per-utterance latents) run.  The likelihood is the training
objective's L1-MCD term as a Laplace observation model, with the same
constant (10/ln10)*sqrt(2) (vi/elbo.py).

The decoder runs ``gru_rnn_apply(..., differentiable=True)``: with
``cfg.use_pallas`` that is ``ops.gru_ar_vjp.gru_ar_fused``, K2 forward and K3
backward on the card.  Gradients are taken with respect to z only
(``value_and_grad``); the factories detach the parameters, so the backward
forms no weight gradients.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.gru_vae import gru_rnn_apply
from ..utils.tree import tree_map
from ..vi.elbo import mcd_constant
from ..vi.train import CycleVAEConfig, CycleVAEParams

_SQRT2 = 1.4142135623730950488016887242097


def _frozen(params: CycleVAEParams) -> CycleVAEParams:
    return CycleVAEParams(*(tree_map(lambda t: t.detach(), net) for net in params))


def make_utterance_logjoint(
    params: CycleVAEParams,
    cfg: CycleVAEConfig,
    feats: torch.Tensor,        # (T, in_dim) raw features of the utterance
    spk_code: torch.Tensor,     # (T, n_spk) decoder conditioning code
    obs_scale: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return logjoint(z) for z of shape (T, lat_dim).

    log p(x, z) = -beta * sum_t sum_d |mcep_td - dec(z)_td|  (Laplace lik.)
                  - 0.5 * sum z^2                           (N(0, I) prior)
    with beta = (10/ln10)*sqrt(2)/obs_scale matching the training MCD weight.
    """
    batched = make_utterance_logjoint_batched(params, cfg, feats, spk_code, obs_scale)
    return lambda z: batched(z[None])[0]


def make_utterance_logjoint_batched(
    params: CycleVAEParams,
    cfg: CycleVAEConfig,
    feats: torch.Tensor,        # (T, in_dim)
    spk_code: torch.Tensor,     # (T, n_spk)
    obs_scale: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched-chain log-joint: z (C, T, lat_dim) -> (C,) log p(x, z_c).

    Chains ride the decoder's batch axis: one AR-GRU call (one K2, and one
    K3 for a gradient) for all chains."""
    params = _frozen(params)
    mcep = feats[..., cfg.stdim:]
    beta = mcd_constant() * _SQRT2 / obs_scale
    s = params.decoder["scale_out"]

    def logjoint(z: torch.Tensor) -> torch.Tensor:
        C = z.shape[0]
        y0 = ((0.0 - s["mean"]) / s["scale"]).expand(C, cfg.out_dim)
        code_z = torch.cat([spk_code.expand((C,) + tuple(spk_code.shape)), z], dim=-1)
        out, _, _ = gru_rnn_apply(params.decoder, cfg.dec_cfg, code_z, y0,
                                  use_pallas=cfg.use_pallas, differentiable=True)
        lik = -beta * torch.sum(torch.abs(out - mcep), dim=(-2, -1))
        prior = -0.5 * torch.sum(z ** 2, dim=(-2, -1))
        return lik + prior

    return logjoint


def make_gaussian_logjoint(mean: torch.Tensor, cov_diag: torch.Tensor):
    """Diagonal-Gaussian target for sampler correctness tests."""
    def logjoint(z):
        return -0.5 * torch.sum((z - mean) ** 2 / cov_diag)
    return logjoint


def value_and_grad(logjoint: Callable[[torch.Tensor], torch.Tensor],
                   z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logjoint(z), d sum(logjoint(z)) / dz), both detached: for a batched
    log-joint each chain's own gradient (the chains are independent)."""
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        value = logjoint(z)
        (grad,) = torch.autograd.grad(value.sum(), z)
    return value.detach(), grad
