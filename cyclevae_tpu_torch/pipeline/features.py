"""F0 helpers of stage 1 (feature extraction) that need no WORLD or HDF5.

Copies of ``convert_continuos_f0`` and ``convert_f0`` from
``cyclevae_tpu/pipeline/features.py``; the analysis itself (WORLD/SPTK, the
HDF5 feature store) is not ported yet.

Feature layout (the central data type):
  feat_org_lf0 = [uv(1), log-continuous-F0-lpf(1), codeap(2), mcep(50)] = 54 d.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.interpolate import interp1d


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
