"""Tensor versions of the frame-parallel DSP transforms.

The port's counterpart of ``cyclevae_tpu/dsp/jax_ops.py``. The mel-cepstrum
transforms are linear up to the log/exp: ``freqt`` is a linear recursion, and
cepstrum <-> log-spectrum is a DFT pair. So

    sp2mc(ps) = log(ps) @ A        with A = (half+1, order+1)
    mc2sp(mc) = exp(mc @ B)        with B = (order+1, half+1)

The basis matrices are built once by passing unit vectors through the C++
library (:mod:`.sptk`); each transform is then one ``torch.matmul`` over
(frames, bins). Also: masked MCD, the GV postfilter and a spectral power
correction. Every function keeps its tensors on the caller's device and
dtype, and is differentiable. None of them is on the stage-6 path, which runs
the C++ library on the host as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _sp2mc_basis(order: int, alpha: float, fftl: int) -> np.ndarray:
    """(half+1, order+1) matrix A with sp2mc(ps) = log(ps) @ A."""
    from . import sptk
    eye = np.eye(fftl // 2 + 1)
    # sp2mc is linear in log(ps): probe with log(ps) = e_i  -> ps = exp(e_i)
    return sptk.sp2mc(np.exp(eye), order, alpha).astype(np.float64)


@functools.lru_cache(maxsize=8)
def _mc2sp_basis(order: int, alpha: float, fftl: int) -> np.ndarray:
    """(order+1, half+1) matrix B with mc2sp(mc) = exp(mc @ B)."""
    from . import sptk
    return np.log(sptk.mc2sp(np.eye(order + 1), alpha, fftl)).astype(np.float64)


def _like(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def sp2mc(powerspec: torch.Tensor, order: int, alpha: float) -> torch.Tensor:
    """(..., half+1) power spectra -> (..., order+1) mel-cepstra (one matmul)."""
    fftl = (powerspec.shape[-1] - 1) * 2
    A = _like(_sp2mc_basis(order, float(alpha), fftl), powerspec)
    return torch.log(torch.clamp_min(powerspec, 1e-30)) @ A


def mc2sp(mc: torch.Tensor, alpha: float, fftl: int) -> torch.Tensor:
    """(..., order+1) mel-cepstra -> (..., fftl//2+1) power spectra."""
    B = _like(_mc2sp_basis(mc.shape[-1] - 1, float(alpha), fftl), mc)
    return torch.exp(mc @ B)


_MCD_K = 10.0 / 2.3025850929940456840179914546844


def calc_mcd(x: torch.Tensor, y: torch.Tensor,
             mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-wise L2 MCD in dB over (..., T, D); returns (mean, per-frame)."""
    per = _MCD_K * torch.sqrt(2.0 * torch.sum((x - y) ** 2, dim=-1))
    if mask is None:
        return per.mean(dim=-1), per
    denom = torch.clamp_min(mask.sum(dim=-1), 1.0)
    return (per * mask).sum(dim=-1) / denom, per


def gv_postfilter(cvmcep: torch.Tensor, gv_mean_data: torch.Tensor,
                  cvgv_mean_model: torch.Tensor) -> torch.Tensor:
    """GV postfilter (decode…py:418-421): scale deviations of dims 1: by
    sqrt(gv_data/gv_model), keep c0."""
    datamean = cvmcep[..., 1:].mean(dim=-2, keepdim=True)
    scaled = (torch.sqrt(gv_mean_data / cvgv_mean_model)
              * (cvmcep[..., 1:] - datamean) + datamean)
    return torch.cat([cvmcep[..., :1], scaled], dim=-1)


def mod_pow_device(cvmcep: torch.Tensor, mcep: torch.Tensor, alpha: float,
                   fftl: int = 1024) -> torch.Tensor:
    """Power correction: match frame energy via Parseval on the reconstructed
    power spectrum (the host ``mod_pow`` uses the truncated impulse response;
    this spectral form is its fftl-limit)."""
    e_cv = mc2sp(cvmcep, alpha, fftl).mean(dim=-1)
    e_ref = mc2sp(mcep, alpha, fftl).mean(dim=-1)
    dpow = 0.5 * torch.log(e_ref / torch.clamp_min(e_cv, 1e-30))
    return torch.cat([cvmcep[..., :1] + dpow[..., None], cvmcep[..., 1:]], dim=-1)
