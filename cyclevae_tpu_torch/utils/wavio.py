"""Waveform I/O and the recipe's FIR filters (scipy only).

A copy of ``cyclevae_tpu/utils/wavio.py``. Reference semantics:
src/bin/feature_extract_vc.py:58-77 (70 Hz high-pass low-cut FIR on read)
and :174-196 (20 Hz low-pass for continuous-F0 smoothing).
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import firwin, lfilter


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70.0) -> np.ndarray:
    """255-tap FIR high-pass (low-cut) filter, zero-phase not required (matches ref)."""
    nyquist = fs // 2
    norm_cutoff = cutoff / nyquist
    fil = firwin(255, norm_cutoff, pass_zero=False)
    return lfilter(fil, 1, x)


def low_pass_filter(x: np.ndarray, fs: int, cutoff: float = 20.0, padding: bool = True) -> np.ndarray:
    """255-tap FIR low-pass with edge padding and group-delay compensation."""
    nyquist = fs // 2
    norm_cutoff = cutoff / nyquist
    numtaps = 255
    fil = firwin(numtaps, norm_cutoff)
    x_pad = np.pad(x, (numtaps, numtaps), "edge")
    lpf_x = lfilter(fil, 1, x_pad)
    return lpf_x[numtaps + numtaps // 2 : -numtaps // 2]


def read_wav(wav_file: str, cutoff: float = 70.0):
    """Read wav as float64 samples in int16 range; optional low-cut filtering."""
    fs, x = wavfile.read(wav_file)
    if x.dtype == np.int16:
        x = np.array(x, dtype=np.float64)
    elif x.dtype in (np.float32, np.float64):
        x = np.array(x, dtype=np.float64) * 32768.0
    else:
        x = np.array(x, dtype=np.float64)
    if x.ndim > 1:
        x = x[:, 0]
    if cutoff != 0:
        x = low_cut_filter(x, fs, cutoff)
    return fs, x


def write_wav(wav_file: str, fs: int, x: np.ndarray):
    """Write float samples (int16 range) to 16-bit PCM wav with clipping."""
    wav = np.clip(x, -32768, 32767)
    wavfile.write(wav_file, fs, np.int16(wav))
