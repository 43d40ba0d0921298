"""SPTK-class mel-cepstrum ops (Python API over the C++ library).

The port's copy of ``cyclevae_tpu/dsp/sptk.py``, over the port's own copy of
the library (``native/``). Replaces the reference's pysptk usage: sp2mc/mc2sp
(feature_extract_vc.py:354, 400; decode…py:259,480), mc2e (mod_pow,
:131-138), mc2b + MLSADF (decode…py:529-533).
"""

from __future__ import annotations

import numpy as np

from ._lib import as_f64, get_lib


def sp2mc(powerspec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """(T, fftl//2+1) power spectra -> (T, order+1) mel-cepstra."""
    lib = get_lib()
    ps = as_f64(np.atleast_2d(powerspec))
    n_frames, half1 = ps.shape
    fftl = (half1 - 1) * 2
    out = np.zeros((n_frames, order + 1))
    lib.cvdsp_sp2mc(ps, n_frames, order, alpha, fftl, out)
    return out if powerspec.ndim > 1 else out[0]


def mc2sp(mc: np.ndarray, alpha: float, fftlen: int) -> np.ndarray:
    """(T, order+1) mel-cepstra -> (T, fftlen//2+1) power spectra."""
    lib = get_lib()
    mc = as_f64(np.atleast_2d(mc))
    n_frames, order1 = mc.shape
    out = np.zeros((n_frames, fftlen // 2 + 1))
    lib.cvdsp_mc2sp(mc, n_frames, order1 - 1, alpha, fftlen, out)
    return out


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    lib = get_lib()
    c = as_f64(c)
    out = np.zeros(order + 1)
    lib.cvdsp_freqt(c, len(c) - 1, order, alpha, out)
    return out


def mc2e(mc: np.ndarray, alpha: float = 0.455, irlen: int = 1024) -> np.ndarray:
    """Per-frame energy from mel-cepstra via truncated impulse response
    (FFT fast path; see mc2e_direct for the O(irlen^2) oracle)."""
    lib = get_lib()
    mc = as_f64(np.atleast_2d(mc))
    n_frames, order1 = mc.shape
    out = np.zeros(n_frames)
    lib.cvdsp_mc2e(mc, n_frames, order1 - 1, alpha, irlen, out)
    return out


def mc2e_direct(mc: np.ndarray, alpha: float = 0.455,
                irlen: int = 1024) -> np.ndarray:
    """Direct c2ir-recursion energy (the oracle the FFT path is tested
    against; ~8x slower per frame)."""
    lib = get_lib()
    mc = as_f64(np.atleast_2d(mc))
    n_frames, order1 = mc.shape
    out = np.zeros(n_frames)
    lib.cvdsp_mc2e_direct(mc, n_frames, order1 - 1, alpha, irlen, out)
    return out


def mc2b(mc: np.ndarray, alpha: float) -> np.ndarray:
    lib = get_lib()
    mc = as_f64(np.atleast_2d(mc))
    n_frames, order1 = mc.shape
    out = np.zeros_like(mc)
    lib.cvdsp_mc2b(mc, n_frames, order1 - 1, alpha, out)
    return out


def b2mc(b: np.ndarray, alpha: float) -> np.ndarray:
    lib = get_lib()
    b = as_f64(np.atleast_2d(b))
    n_frames, order1 = b.shape
    out = np.zeros_like(b)
    lib.cvdsp_b2mc(b, n_frames, order1 - 1, alpha, out)
    return out


def mlsadf(x: np.ndarray, b: np.ndarray, alpha: float, hop: int) -> np.ndarray:
    """MLSA-filter waveform x with per-frame coefficients b (T, order+1),
    coefficients advancing every `hop` samples (differential-spectrum
    filtering path, decode…py:529-533)."""
    lib = get_lib()
    x = as_f64(x)
    b = as_f64(np.atleast_2d(b))
    n_frames, order1 = b.shape
    out = np.zeros_like(x)
    lib.cvdsp_mlsadf(x, len(x), b, n_frames, order1 - 1, alpha, hop, out)
    return out
