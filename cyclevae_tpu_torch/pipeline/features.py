"""Stage 1's per-utterance analysis: WORLD/SPTK features and F0 helpers.

Copies of ``cyclevae_tpu/pipeline/features.py:29-117`` over the port's own
DSP library (:mod:`cyclevae_tpu_torch.dsp`): the F0 transforms, the power
correction ``mod_pow``, frame power and speech-frame extraction, and the
WORLD analysis. Stage 1's extraction into HDF5 files (``extract_one``,
``extract_features``) is not ported yet.

Feature layout (the central data type):
  feat_org_lf0 = [uv(1), log-continuous-F0-lpf(1), codeap(2), mcep(50)] = 54 d.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.interpolate import interp1d

from ..dsp import sptk, world


def convert_continuos_f0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """F0 -> (uv flags, linearly interpolated continuous F0)
    (reference feature_extract_vc.py:199-228)."""
    f0 = np.copy(f0)
    uv = np.float32(f0 != 0)
    if not (f0 != 0).any():
        return uv, f0
    start_f0 = f0[f0 != 0][0]
    end_f0 = f0[f0 != 0][-1]
    start_idx = np.where(f0 == start_f0)[0][0]
    end_idx = np.where(f0 == end_f0)[0][-1]
    f0[:start_idx] = start_f0
    f0[end_idx:] = end_f0
    nz_frames = np.where(f0 != 0)[0]
    f = interp1d(nz_frames, f0[nz_frames])
    cont_f0 = f(np.arange(0, f0.shape[0]))
    return uv, cont_f0


def convert_f0(f0: np.ndarray, f0_mean_src: float, f0_std_src: float,
               f0_mean_trg: float, f0_std_trg: float) -> np.ndarray:
    """Log-Gaussian F0 transform (reference feature_extract_vc.py:116-121)."""
    nonzero = f0 > 0
    cvf0 = np.zeros(len(f0))
    cvf0[nonzero] = np.exp((f0_std_trg / f0_std_src)
                           * (np.log(f0[nonzero]) - f0_mean_src) + f0_mean_trg)
    return cvf0


def convert_linf0(f0: np.ndarray, f0_mean_src: float, f0_std_src: float,
                  f0_mean_trg: float, f0_std_trg: float) -> np.ndarray:
    """Linear-domain F0 transform (reference feature_extract_vc.py:124-129;
    unused by the shipped flow but part of the surface — the stats stage
    records linear-domain F0 mean/std for it, calc_stats_vc.py:126-135)."""
    nonzero = f0 > 0
    cvf0 = np.zeros(len(f0))
    cvf0[nonzero] = (f0_std_trg / f0_std_src) * (f0[nonzero] - f0_mean_src) \
        + f0_mean_trg
    return cvf0


def mod_pow(cvmcep: np.ndarray, mcep: np.ndarray, alpha: float = 0.455,
            irlen: int = 1024, ref_e: np.ndarray = None) -> np.ndarray:
    """Power correction: move converted mcep c0 so frame energy matches the
    original (reference feature_extract_vc.py:131-138).  ``ref_e``: optional
    precomputed mc2e(mcep) — decode_pair reuses the same reference energies
    across its 6 mod_pow calls (stage-6 hot path)."""
    cv_e = sptk.mc2e(cvmcep, alpha=alpha, irlen=irlen)
    r_e = ref_e if ref_e is not None else sptk.mc2e(mcep, alpha=alpha,
                                                    irlen=irlen)
    dpow = np.log(r_e / cv_e) / 2
    mod_cvmcep = np.copy(cvmcep)
    mod_cvmcep[:, 0] += dpow
    return mod_cvmcep


def spc2npow(spectrogram: np.ndarray) -> np.ndarray:
    """Normalized frame power in dB (reference feature_extract_vc.py:153-171)."""
    fftl2 = spectrogram.shape[1] - 1
    fftl = fftl2 * 2
    power = (spectrogram[:, 0] + spectrogram[:, fftl2]
             + 2.0 * np.sum(spectrogram[:, 1:fftl2], axis=1)) / fftl
    meanpow = np.mean(power)
    return 10.0 * np.log10(power / meanpow)


def extfrm(data: np.ndarray, npow: np.ndarray,
           power_threshold: float = -20.0) -> Tuple[np.ndarray, np.ndarray]:
    """Speech-frame extraction by power threshold (reference :141-150)."""
    if data.shape[0] != len(npow):
        raise ValueError("Length of two vectors is different.")
    valid_index = np.where(npow > power_threshold)
    return data[valid_index], valid_index


def analyze(x: np.ndarray, fs: int, minf0: Optional[float] = None,
            maxf0: Optional[float] = None, fperiod: float = 5.0,
            fftl: int = 1024):
    """WORLD-class analysis: (time_axis, f0, envelope, aperiodicity).
    With minf0/maxf0 -> speaker-bounded range (reference analyze_range :96-104);
    without -> default range (analyze :80-93)."""
    f0_floor = minf0 if minf0 is not None else 60.0
    f0_ceil = maxf0 if maxf0 is not None else 700.0
    _f0, time_axis = world.harvest(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                                   frame_period=fperiod)
    f0 = world.stonemask(x, _f0, time_axis, fs)
    sp = world.cheaptrick(x, f0, time_axis, fs, fftl)
    ap = world.d4c(x, f0, time_axis, fs, fftl)
    return time_axis, f0, sp, ap
