"""Diagonal-covariance GMM: log-likelihood, posterior-expected means, EM.

PyTorch counterpart of ``cyclevae_tpu/models/gmm.py`` (reference
src/nets/gru_vae.py:200-262, the GMM nn.Module: the speaker-space modeling
surface, not called by the shipped binaries).  params = {"weights" (K,),
"means" (K, D), "dcovs" (K, D)}; EM is a pure params -> params update, and
the random init draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def init_gmm(generator: torch.Generator, n_mix: int, n_dim: int,
             data: Optional[torch.Tensor] = None) -> Dict:
    """Means drawn from ``data``'s rows without replacement (or standard
    normal without data), weights uniform, every covariance the data's
    variance (or 1)."""
    dev = generator.device
    if data is not None:
        idx = torch.randperm(data.shape[0], generator=generator, device=dev)[:n_mix]
        means = data[idx.to(data.device)]
        var = torch.var(data, dim=0, unbiased=False)
    else:
        means = torch.randn((n_mix, n_dim), generator=generator, device=dev)
        var = torch.ones((n_dim,), device=dev)
    return {
        "weights": torch.full((n_mix,), 1.0 / n_mix, device=means.device),
        "means": means,
        "dcovs": var.expand(n_mix, -1).clone(),
    }


def _log_component_probs(params: Dict, data: torch.Tensor) -> torch.Tensor:
    """(T, D) -> (T, K) log [w_k N(x | mu_k, diag(cov_k))]."""
    D = data.shape[-1]
    diff = data[:, None, :] - params["means"][None, :, :]
    mahal = torch.sum(diff ** 2 / params["dcovs"][None, :, :], dim=-1)
    log_det = torch.sum(torch.log(params["dcovs"]), dim=-1)
    log_norm = -0.5 * (D * math.log(2.0 * math.pi) + log_det)
    return torch.log(params["weights"])[None, :] + log_norm[None, :] - 0.5 * mahal


def gmm_forward(params: Dict, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean log-likelihood + posterior-expected means (reference forward
    gru_vae.py:211-227), in log space."""
    log_probs = _log_component_probs(params, data)
    log_like = torch.logsumexp(log_probs, dim=-1)
    post = torch.exp(log_probs - log_like[:, None])
    return torch.mean(log_like), post @ params["means"]


def gmm_log_prob(params: Dict, data: torch.Tensor) -> torch.Tensor:
    """Mean log-likelihood (reference ``probs`` gru_vae.py:229-239)."""
    return torch.mean(torch.logsumexp(_log_component_probs(params, data), dim=-1))


def gmm_em_update(params: Dict, data: torch.Tensor,
                  min_var: float = 1e-6) -> Tuple[Dict, torch.Tensor]:
    """One EM step (reference ``update`` gru_vae.py:241-262).
    Returns (new params, mean log-likelihood before the update)."""
    log_probs = _log_component_probs(params, data)
    log_like = torch.logsumexp(log_probs, dim=-1)
    post = torch.exp(log_probs - log_like[:, None])        # (T, K)
    nk = torch.sum(post, dim=0)                            # (K,)
    weights = nk / data.shape[0]
    means = (post.T @ data) / nk[:, None]
    diff2 = (data[:, None, :] - means[None, :, :]) ** 2
    dcovs = torch.clamp(torch.einsum("tk,tkd->kd", post, diff2) / nk[:, None], min=min_var)
    return {"weights": weights, "means": means, "dcovs": dcovs}, torch.mean(log_like)
