"""WORLD-class vocoder analysis/synthesis (Python API over the C++ library).

The port's copy of ``cyclevae_tpu/dsp/world.py``, over the port's own copy of
the library (``native/``). Replaces the reference's pyworld usage:
  harvest/stonemask  -> estimate_f0 + refine_f0   (feature_extract_vc.py:88-99)
  cheaptrick         -> spectral_envelope          (:90, :101)
  d4c                -> aperiodicity               (:91, :102)
  code_aperiodicity  -> code_aperiodicity          (:352-353)
  synthesize         -> synthesize                 (:401, decode…py:482-545)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ._lib import as_f64, get_lib


def harvest(x: np.ndarray, fs: int, f0_floor: float = 60.0,
            f0_ceil: float = 700.0, frame_period: float = 5.0
            ) -> Tuple[np.ndarray, np.ndarray]:
    """F0 estimation (NCCF + Viterbi tracking). Returns (f0, time_axis)."""
    lib = get_lib()
    x = as_f64(x)
    n_frames = lib.cvdsp_n_frames(len(x), fs, frame_period)
    f0 = np.zeros(n_frames)
    t = np.zeros(n_frames)
    lib.cvdsp_estimate_f0(x, len(x), fs, frame_period, f0_floor, f0_ceil, f0, t)
    return f0, t


def stonemask(x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray,
              fs: int) -> np.ndarray:
    """Harmonic spectral-peak F0 refinement."""
    lib = get_lib()
    x = as_f64(x)
    f0 = as_f64(f0)
    time_axis = as_f64(time_axis)
    out = np.zeros(len(f0))
    lib.cvdsp_refine_f0(x, len(x), fs, time_axis, f0, len(f0), out)
    return out


def cheaptrick(x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray, fs: int,
               fft_size: int = 1024) -> np.ndarray:
    """Pitch-adaptive spectral envelope; (T, fft_size//2+1) power spectra."""
    lib = get_lib()
    x = as_f64(x)
    f0 = as_f64(f0)
    time_axis = as_f64(time_axis)
    out = np.zeros((len(f0), fft_size // 2 + 1))
    lib.cvdsp_spectral_envelope(x, len(x), fs, time_axis, f0, len(f0),
                                fft_size, out)
    return out


def d4c(x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray, fs: int,
        fft_size: int = 1024) -> np.ndarray:
    """Band aperiodicity; (T, fft_size//2+1) values in [0.001, 0.999]."""
    lib = get_lib()
    x = as_f64(x)
    f0 = as_f64(f0)
    time_axis = as_f64(time_axis)
    out = np.zeros((len(f0), fft_size // 2 + 1))
    lib.cvdsp_aperiodicity(x, len(x), fs, time_axis, f0, len(f0), fft_size, out)
    return out


def code_aperiodicity(ap: np.ndarray, fs: int) -> np.ndarray:
    """(T, half+1) aperiodicity -> (T, n_bands) coded values (dB at 3k steps)."""
    lib = get_lib()
    ap = as_f64(ap)
    n_frames, half1 = ap.shape
    fftl = (half1 - 1) * 2
    n_bands = lib.cvdsp_n_coded_aperiodicity(fs)
    out = np.zeros((n_frames, n_bands))
    lib.cvdsp_code_aperiodicity(ap, n_frames, fs, fftl, out)
    return out


def decode_aperiodicity(coded: np.ndarray, fs: int, fft_size: int = 1024
                        ) -> np.ndarray:
    lib = get_lib()
    coded = as_f64(coded)
    n_frames = coded.shape[0]
    out = np.zeros((n_frames, fft_size // 2 + 1))
    lib.cvdsp_decode_aperiodicity(coded, n_frames, fs, fft_size, out)
    return out


def synthesize(f0: np.ndarray, sp: np.ndarray, ap: np.ndarray, fs: int,
               frame_period: float = 5.0, seed: int = 1234567) -> np.ndarray:
    """Pitch-synchronous OLA synthesis from (f0, envelope, aperiodicity)."""
    lib = get_lib()
    f0 = as_f64(f0)
    sp = as_f64(sp)
    ap = as_f64(ap)
    n_frames, half1 = sp.shape
    fftl = (half1 - 1) * 2
    n_out = lib.cvdsp_synthesis_length(n_frames, fs, frame_period)
    out = np.zeros(n_out)
    lib.cvdsp_synthesize(f0, sp, ap, n_frames, fs, frame_period, fftl,
                         seed, out)
    return out
