"""Loss / metric algebra for the cyclic ELBO.

PyTorch counterpart of ``cyclevae_tpu/vi/elbo.py`` (the reference's TWFSEloss
semantics, src/nets/gru_vae.py:466-534):
  * MCD in dB, L2 form: (10/ln10) * sqrt(2 * sum_D (x-y)^2) per frame,
  * MCD L1 form: (10/ln10) * sqrt(2) * sum_D |x-y| per frame (the training
    loss),
  * GV log-RMSE: mean_D sqrt((log var_T(x) - log var_T(y))^2).

All forms take a mask of valid frames, so padded frames drop out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# 10 / ln(10) (reference gru_vae.py:493)
_MCD_K = 10.0 / 2.3025850929940456840179914546844
_SQRT2 = 1.4142135623730950488016887242097


def mcd_constant() -> float:
    return _MCD_K


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], axis: int = -1) -> torch.Tensor:
    if mask is None:
        return torch.mean(x, dim=axis)
    denom = torch.clamp(torch.sum(mask, dim=axis), min=1.0)
    return torch.sum(x * mask, dim=axis) / denom


def mcd_l1(x: torch.Tensor, y: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-utterance mean L1-MCD over frames. x, y: (..., T, D); mask (..., T)."""
    per_frame = _MCD_K * _SQRT2 * torch.sum(torch.abs(x - y), dim=-1)
    return masked_mean(per_frame, mask)


def mcd_l2(x: torch.Tensor, y: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and per-frame L2-MCD in dB (evaluation metric form)."""
    per_frame = _MCD_K * torch.sqrt(2.0 * torch.sum((x - y) ** 2, dim=-1))
    return masked_mean(per_frame, mask), per_frame


def masked_var(x: torch.Tensor, mask: Optional[torch.Tensor], ddof: int = 0) -> torch.Tensor:
    """Variance over the frame axis with masking; x: (..., T, D), mask (..., T).

    ddof=0 is numpy's np.var (the reference eval epoch); ddof=1 torch.var's
    unbiased estimator (the TWFSEloss GV mode)."""
    if mask is None:
        n = x.shape[-2]
        mean = torch.mean(x, dim=-2, keepdim=True)
        return torch.sum((x - mean) ** 2, dim=-2) / max(n - ddof, 1)
    m = mask[..., None]
    n = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    mean = torch.sum(x * m, dim=-2, keepdim=True) / n[..., None, :]
    return torch.sum(((x - mean) ** 2) * m, dim=-2) / torch.clamp(n - ddof, min=1.0)


def rmse_corr(x: torch.Tensor, y: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              l2: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """TWFSEloss RMSE+corr mode (reference gru_vae.py:511-521).

    Per-dimension RMSE over the frame axis (L2) or mean absolute error (L1),
    plus the per-dimension Pearson correlation over frames; both averaged over
    dimensions.  x, y: (..., T, D); mask (..., T).
    """
    m = None if mask is None else mask[..., None]
    if l2:
        per_dim = torch.sqrt(masked_mean((x - y) ** 2, m, axis=-2))
    else:
        per_dim = masked_mean(torch.abs(x - y), m, axis=-2)
    if m is None:
        xd = x - torch.mean(x, dim=-2, keepdim=True)
        yd = y - torch.mean(y, dim=-2, keepdim=True)
    else:
        n = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
        xd = (x - torch.sum(x * m, dim=-2, keepdim=True) / n) * m
        yd = (y - torch.sum(y * m, dim=-2, keepdim=True) / n) * m
    num = torch.sum(xd * yd, dim=-2)
    den = torch.sqrt(torch.sum(xd ** 2, dim=-2)) * torch.sqrt(torch.sum(yd ** 2, dim=-2))
    corr = num / torch.clamp(den, min=1e-12)
    return torch.mean(per_dim, dim=-1), torch.mean(corr, dim=-1)


def gv_log_rmse(x: torch.Tensor, gv_mean: torch.Tensor,
                mask: Optional[torch.Tensor] = None, ddof: int = 0) -> torch.Tensor:
    """RMSE of the log per-utterance variance against a data GV mean vector."""
    var_x = masked_var(x, mask, ddof=ddof)
    return torch.mean(torch.sqrt((torch.log(var_x) - torch.log(gv_mean)) ** 2), dim=-1)
