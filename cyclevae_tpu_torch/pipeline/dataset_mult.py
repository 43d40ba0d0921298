"""The neural-vocoder dataset surface.

Copy of the vocoder half of ``cyclevae_tpu/pipeline/dataset_mult.py``
(reference src/utils/dataset.py:495-563: validate_length,
FeatureDatasetNeuVoco) over the port's feature store (``.npz`` files,
:mod:`cyclevae_tpu_torch.utils.store`).  The many-to-many datasets of that
module are not copied yet.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.store import read_store
from ..utils.wavio import read_wav


def validate_length(x: np.ndarray, y: np.ndarray,
                    upsampling_factor: Optional[Union[int, float]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Reconcile waveform/feature lengths, optionally via an upsampling factor
    (reference dataset.py:495-514).  Fractional factors (e.g. 110.25 samples
    per frame at 22.05 kHz / 5 ms) are handled exactly as rationals: frame
    counts round down to a multiple of the denominator so the sample count is
    an integer with zero cumulative drift."""
    if upsampling_factor is None:
        n = min(x.shape[0], y.shape[0])
        return x[:n], y[:n]
    fr = Fraction(upsampling_factor).limit_denominator(1000)
    num, den = fr.numerator, fr.denominator
    n_frames = min(x.shape[0] * den // num, y.shape[0])
    n_frames -= n_frames % den
    return x[:n_frames * num // den], y[:n_frames]


class NeuVocoDataset:
    """Waveform-sample + feature pairing for neural-vocoder training
    (reference FeatureDatasetNeuVoco, dataset.py:517-563)."""

    def __init__(self, wav_list: Sequence[str], feat_list: Sequence[str],
                 upsampling_factor: Union[int, float],
                 string_path: str = "/feat_org_lf0",
                 spk_ids: Optional[Sequence[int]] = None, n_spk: int = 0):
        if len(wav_list) != len(feat_list):
            raise ValueError(f"{len(wav_list)} wavs for {len(feat_list)} feature files")
        self.wav_list = list(wav_list)
        self.feat_list = list(feat_list)
        self.upsampling_factor = upsampling_factor
        self.string_path = string_path
        # multi-speaker vocoder: append a one-hot speaker code per frame
        # (WaveRNNConfig.n_spk conditioning surface)
        if spk_ids is not None and (len(spk_ids) != len(wav_list) or n_spk <= 0):
            raise ValueError("spk_ids needs one id per wav and n_spk > 0")
        self.spk_ids = list(spk_ids) if spk_ids is not None else None
        self.n_spk = n_spk

    def __len__(self):
        return len(self.wav_list)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        _, x = read_wav(self.wav_list[idx], cutoff=0)
        x = x / 32768.0
        feat = read_store(self.feat_list[idx], self.string_path)
        x, feat = validate_length(x, feat, self.upsampling_factor)
        if self.spk_ids is not None:
            code = np.zeros((feat.shape[0], self.n_spk), feat.dtype)
            code[:, self.spk_ids[idx]] = 1.0
            feat = np.concatenate([feat, code], axis=1)
        return {"x": x.astype(np.float32), "feat": feat.astype(np.float32),
                "featfile": self.feat_list[idx]}
