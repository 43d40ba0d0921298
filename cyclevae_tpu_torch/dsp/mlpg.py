"""MLPG — maximum-likelihood parameter generation (Python API over C++).

The port's copy of ``cyclevae_tpu/dsp/mlpg.py``, over the port's own copy of
the library (``native/``). Surface parity for the reference's last native
dependency: `mlpg_c` is pinned (reference tools/requirements.txt:10) but
never imported — this implements the algorithm that package provides
(Tokuda et al. 2000) so the inventory row has a working op: given per-frame
means and diagonal variances of windowed features (static + delta [+
delta-delta]), solve for the smooth static trajectory maximizing the Gaussian
likelihood, (W' P W) c = W' P mu, by banded Cholesky.

Typical use: smooth a decoder's per-frame mcep means with delta statistics
before synthesis (trajectory smoothing the reference never enabled).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ._lib import as_f64, get_lib

# standard HTS window set: static, delta, delta-delta
WIN_STATIC = np.array([1.0])
WIN_DELTA = np.array([-0.5, 0.0, 0.5])
WIN_ACCEL = np.array([1.0, -2.0, 1.0])
DEFAULT_WINDOWS = (WIN_STATIC, WIN_DELTA)


def mlpg(mean: np.ndarray, var: np.ndarray,
         windows: Sequence[np.ndarray] = DEFAULT_WINDOWS) -> np.ndarray:
    """Solve for the static trajectory.

    Args:
      mean: (T, n_win*dim) window-major means — columns [k*dim, (k+1)*dim)
        hold window k's per-frame means (static first).
      var: matching diagonal variances; a frame/window with var <= 0 is
        treated as unobserved (its row of W is dropped).
      windows: odd-length tap vectors, one per window block (center tap
        applies to frame t).  Default (static, HTS delta).

    Returns: (T, dim) static trajectory.
    """
    lib = get_lib()
    mean = as_f64(mean)
    var = as_f64(var)
    assert mean.shape == var.shape, (mean.shape, var.shape)
    n_win = len(windows)
    assert mean.shape[1] % n_win == 0, (mean.shape, n_win)
    dim = mean.shape[1] // n_win
    T = mean.shape[0]
    lens = np.array([len(w) for w in windows], dtype=np.int32)
    assert all(n % 2 == 1 for n in lens), "windows must be odd-length"
    taps = as_f64(np.concatenate([np.asarray(w, np.float64)
                                  for w in windows]))
    out = np.zeros((T, dim))
    rc = lib.cvdsp_mlpg(mean, var, T, dim, taps, lens, n_win, out)
    if rc != 0:
        raise ValueError(
            "MLPG normal matrix is singular: some trajectory column has a "
            "frame unobserved (var<=0) by every window — check the input "
            "variances instead of consuming a garbage trajectory")
    return out


def apply_delta_windows(x: np.ndarray,
                        windows: Sequence[np.ndarray] = DEFAULT_WINDOWS
                        ) -> np.ndarray:
    """Stack windowed views of a static trajectory: (T, dim) -> (T, n_win*dim)
    with edge frames zero-padded — the forward operator W whose inverse
    problem mlpg() solves (useful for building MLPG inputs and for tests)."""
    x = np.asarray(x, np.float64)
    T = x.shape[0]
    cols = []
    for w in windows:
        l = (len(w) - 1) // 2
        acc = np.zeros_like(x)
        for o, c in zip(range(-l, l + 1), np.asarray(w, np.float64)):
            if c == 0.0:
                continue
            src = np.zeros_like(x)
            if o >= 0:
                src[:T - o] = x[o:]
            else:
                src[-o:] = x[:T + o]
            acc += c * src
        cols.append(acc)
    return np.concatenate(cols, axis=1)
