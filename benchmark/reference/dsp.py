"""Plain reference of the host steps between a conversion and its rendering:
the global-variance postfilter, the log-Gaussian F0 transform, and the
vocoder's conditioning vector [U/V, log continuous F0 (low-passed), coded
aperiodicities, mel-cepstrum] (the cyclevae-vc recipe's
``feature_extract_vc.py`` and ``decode_gru-cyclevae_gauss.py``), in numpy
and scipy, float64 as the recipe computes them."""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d
from scipy.signal import firwin, lfilter


def gv_postfilter(mcep: np.ndarray, gv_data: np.ndarray, gv_model: np.ndarray) -> np.ndarray:
    """Scale each frame's deviation from the utterance mean by
    sqrt(gv_data / gv_model), c0 left as it is."""
    mean = np.mean(mcep[:, 1:], axis=0)
    return np.c_[mcep[:, 0], np.sqrt(gv_data / gv_model) * (mcep[:, 1:] - mean) + mean]


def convert_f0(f0: np.ndarray, mean_src: float, std_src: float,
               mean_trg: float, std_trg: float) -> np.ndarray:
    """Voiced frames: exp((std_trg / std_src) (log f0 - mean_src) + mean_trg);
    unvoiced frames stay 0."""
    out = np.zeros(len(f0))
    v = f0 > 0
    out[v] = np.exp(std_trg / std_src * (np.log(f0[v]) - mean_src) + mean_trg)
    return out


def continuous_f0(f0: np.ndarray):
    """(U/V flags, F0 with unvoiced frames filled by linear interpolation and
    the ends held at the first / last voiced value)."""
    f0 = np.copy(f0)
    uv = np.float32(f0 != 0)
    if not (f0 != 0).any():
        return uv, f0
    first, last = f0[f0 != 0][0], f0[f0 != 0][-1]
    f0[:np.where(f0 == first)[0][0]] = first
    f0[np.where(f0 == last)[0][-1]:] = last
    nz = np.where(f0 != 0)[0]
    return uv, interp1d(nz, f0[nz])(np.arange(len(f0)))


def low_pass(x: np.ndarray, fs: int, cutoff: float = 20.0) -> np.ndarray:
    """255-tap FIR low-pass, edges padded by repetition, group delay removed."""
    taps = 255
    fil = firwin(taps, cutoff / (fs // 2))
    y = lfilter(fil, 1, np.pad(x, (taps, taps), "edge"))
    return y[taps + taps // 2: -taps // 2]


def conditioning(src_feat: np.ndarray, mcep: np.ndarray, f0: np.ndarray,
                 shiftms: float) -> np.ndarray:
    """The vocoder's input frames for a converted utterance: the converted
    F0 and mel-cepstrum, the source's coded aperiodicities; the log of the
    continuous F0 floored at 1 Hz."""
    uv, cont = continuous_f0(f0)
    cont = np.maximum(low_pass(cont, int(1.0 / (shiftms * 0.001))), 1.0)
    n_ap = src_feat.shape[1] - 2 - mcep.shape[1]
    return np.c_[uv[:, None], np.log(cont)[:, None], src_feat[:, 2:2 + n_ap],
                 mcep].astype(np.float32)
