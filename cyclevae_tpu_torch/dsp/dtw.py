"""DTW alignment + MCD (Python API over the C++ library).

The port's copy of ``cyclevae_tpu/dsp/dtw.py``, over the port's own copy of
the library (``native/``). Call-signature parity with the reference's dtw_c
extension:
  dtw_org_to_trg(org, trg) -> (aligned_org, twf, mean_mcd, per-frame mcd)
    (train…py:679-688, decode…py:334-364, calc_cvgv…py:210-277)
  calc_mcd(x, y) -> (mean_mcd, per-frame mcd)   (train…py:932-948)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ._lib import as_f64, get_lib


def calc_mcd(x: np.ndarray, y: np.ndarray) -> Tuple[float, np.ndarray]:
    """Frame-wise MCD (dB) over equal-length sequences."""
    lib = get_lib()
    x = as_f64(x)
    y = as_f64(y)
    assert x.shape == y.shape, (x.shape, y.shape)
    T, dim = x.shape
    per = np.zeros(T)
    mean = lib.cvdsp_calc_mcd(x, y, T, dim, per)
    return mean, per


def dtw_org_to_trg(org: np.ndarray, trg: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Align org to trg by DTW over an MCD local distance.

    Returns (aligned_org with len(trg) frames, twf org indices, mean MCD,
    per-frame MCD) — the reference's return contract.
    """
    lib = get_lib()
    org = as_f64(org)
    trg = as_f64(trg)
    T_org, dim = org.shape
    T_trg, dim2 = trg.shape
    assert dim == dim2
    twf = np.zeros(T_trg, dtype=np.int32)
    per = np.zeros(T_trg)
    mean = lib.cvdsp_dtw_org_to_trg(org, T_org, trg, T_trg, dim, twf, per)
    return org[twf], twf, mean, per
