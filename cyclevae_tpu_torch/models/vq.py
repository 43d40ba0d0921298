"""VQ-VAE helper surface: nearest-centroid search and soft assignment.

PyTorch counterpart of ``cyclevae_tpu/models/vq.py`` (reference
src/nets/gru_vae.py:147-197: nn_search, nn_search_batch, weighted_ctr, the
L1-distance centroid helpers of the ``cyclevqvae`` variant, run.sh:183),
plus the straight-through quantizer and the codebook perplexity of the VQ
trainer.  ``jax.lax.stop_gradient`` is ``.detach()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _l1_dist(encoding: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(..., D) x (K, D) -> (..., K) sum_d |e_d - c_kd|."""
    return torch.sum(torch.abs(encoding[..., None, :] - centroids), dim=-1)


def nn_search(encoding: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(T, D) x (K, D) -> (T,) argmin_k sum_d |e_td - c_kd|."""
    return torch.argmin(_l1_dist(encoding, centroids), dim=-1)


def nn_search_batch(encoding: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B, T, D) x (K, D) -> (B, T)."""
    return torch.argmin(_l1_dist(encoding, centroids), dim=-1)


def weighted_ctr(encoding: torch.Tensor, centroids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft assignment: exp(-L1) posterior-weighted centroids + mean weighted
    distance (reference gru_vae.py:178-193)."""
    dist = _l1_dist(encoding, centroids)                     # (T, K)
    score = torch.exp(-dist)
    post = score / torch.sum(score, dim=1, keepdim=True)     # (T, K)
    weighted_centroids = post @ centroids                    # (T, D)
    weighted_dist = torch.mean(torch.sum(dist * post, dim=1))
    return weighted_centroids, weighted_dist


def vq_straight_through(encoding: torch.Tensor, centroids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straight-through quantization: forward = nearest centroid, backward =
    identity (the standard VQ-VAE estimator)."""
    ids = nn_search(encoding, centroids)
    quantized = centroids[ids]
    return encoding + (quantized - encoding).detach(), ids


def vq_straight_through_batch(encoding: torch.Tensor, centroids: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, D) straight-through quantization with the reference's L1
    nearest-centroid assignment.  Returns (st_quantized (B,T,D),
    hard_quantized (B,T,D), ids (B,T)): the hard values feed the
    codebook/commitment losses, the straight-through values the decoder."""
    ids = nn_search_batch(encoding, centroids)
    quantized = centroids[ids]
    return encoding + (quantized - encoding).detach(), quantized, ids


def codebook_perplexity(ids: torch.Tensor, n_centroids: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """exp(entropy) of the (optionally masked) codebook-usage histogram:
    K means uniform usage, 1 means codebook collapse."""
    onehot = torch.nn.functional.one_hot(ids.long(), n_centroids).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask[..., None]
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = ids.numel()
    p = torch.sum(onehot.reshape(-1, n_centroids), dim=0) / denom
    plogp = torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0)
    return torch.exp(-torch.sum(plogp))
