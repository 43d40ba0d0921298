"""Many-to-many, classifier-code and neural-vocoder dataset surfaces.

Copy of ``cyclevae_tpu/pipeline/dataset_mult.py`` over the port's feature
store (``.npz`` files, :mod:`cyclevae_tpu_torch.utils.store`).  Reference:
src/utils/dataset.py:101-492 (proc_multspk_data_random,
FeatureDatasetMultTrainVAE/EvalVAE and the classifier-code variants) and
:495-563 (validate_length, FeatureDatasetNeuVoco).  Speaker codes are N-dim
one-hots; the many-to-many cyclic flow picks a conversion target per cycle
from ``np.random.default_rng(seed)``, with the same draws as the JAX
package, and reads that partner's converted excitation
``/cvuvlogf0fil_ap_<spk>``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.store import read_store, shape_store
from ..utils.wavio import read_wav


def speaker_of(featfile: str) -> str:
    """Speaker identity = parent directory name (reference dataset.py:102)."""
    return os.path.basename(os.path.dirname(featfile))


def one_hot_code(spk: str, spk_list: Sequence[str], T: int) -> np.ndarray:
    code = np.zeros((T, len(spk_list)), np.float32)
    code[:, list(spk_list).index(spk)] = 1.0
    return code


def proc_multspk_data_random(featfile: str, spk_src_list: Sequence[str],
                             spk_trg_list: Sequence[str], n_cyc: int,
                             rng: np.random.Generator
                             ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                        str, str, List[str]]:
    """Per-cycle random conversion-pair selection (reference dataset.py:101-135).

    Source-group utterances convert to a random target-group speaker each
    cycle (and vice versa), reading that pair's converted excitation
    ``/cvuvlogf0fil_ap_<spk>``.  Returns (cv_src_list, trg_code_list,
    featfile_spk, featfile_src_trg, pair_spk_list).
    """
    all_spk = list(spk_src_list) + list(spk_trg_list)
    spk = speaker_of(featfile)
    T = shape_store(featfile, "/feat_org_lf0")[0]
    pool = spk_trg_list if spk in spk_src_list else spk_src_list
    cv_list, trg_codes, pair_spks = [], [], []
    for _ in range(n_cyc):
        pair_spk = pool[int(rng.integers(0, len(pool)))]
        trg_codes.append(one_hot_code(pair_spk, all_spk, T))
        cv_list.append(read_store(featfile, f"/cvuvlogf0fil_ap_{pair_spk}").astype(np.float32))
        pair_spks.append(pair_spk)
    featfile_pair = os.path.join(os.path.dirname(os.path.dirname(featfile)),
                                 pair_spks[0], os.path.basename(featfile))
    return cv_list, trg_codes, spk, featfile_pair, pair_spks


def _feats_spcidx(f: str) -> Tuple[np.ndarray, np.ndarray]:
    feats = read_store(f, "/feat_org_lf0").astype(np.float32)
    spcidx = np.asarray(read_store(f, "/spcidx_range")[0], dtype=np.int64)
    return feats, spcidx


@dataclass
class MultUtterance:
    featfile: str
    feats: np.ndarray                 # (T, in_dim)
    src_code: np.ndarray              # (T, n_spk)
    trg_codes: List[np.ndarray]       # per cycle (T, n_spk)
    cv_excits: List[np.ndarray]       # per cycle (T, stdim)
    spcidx: np.ndarray
    pair_spks: List[str]

    @property
    def flen(self) -> int:
        return self.feats.shape[0]


class MultSpkTrainDataset:
    """Many-to-many training dataset (reference FeatureDatasetMultTrainVAE,
    dataset.py:138-207): per access, the conversion pair is re-randomized."""

    def __init__(self, file_list: Sequence[str], spk_src_list: Sequence[str],
                 spk_trg_list: Sequence[str], n_cyc: int, seed: int = 0):
        self.files = list(file_list)
        self.spk_src_list = list(spk_src_list)
        self.spk_trg_list = list(spk_trg_list)
        self.all_spk = self.spk_src_list + self.spk_trg_list
        self.n_cyc = max(n_cyc, 1)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> MultUtterance:
        f = self.files[idx]
        feats, spcidx = _feats_spcidx(f)
        cv_list, trg_codes, spk, _, pair_spks = proc_multspk_data_random(
            f, self.spk_src_list, self.spk_trg_list, self.n_cyc, self.rng)
        src_code = one_hot_code(spk, self.all_spk, feats.shape[0])
        return MultUtterance(f, feats, src_code, trg_codes, cv_list, spcidx, pair_spks)


class MultSpkEvalDataset(MultSpkTrainDataset):
    """Deterministic eval pairing (reference FeatureDatasetMultEvalVAE,
    dataset.py:210-287): pair index cycles deterministically with the
    utterance index instead of being drawn randomly."""

    def __getitem__(self, idx: int) -> MultUtterance:
        f = self.files[idx]
        feats, spcidx = _feats_spcidx(f)
        spk = speaker_of(f)
        T = feats.shape[0]
        pool = self.spk_trg_list if spk in self.spk_src_list else self.spk_src_list
        pair_spk = pool[idx % len(pool)]
        trg_code = one_hot_code(pair_spk, self.all_spk, T)
        cv = read_store(f, f"/cvuvlogf0fil_ap_{pair_spk}").astype(np.float32)
        src_code = one_hot_code(spk, self.all_spk, T)
        return MultUtterance(f, feats, src_code, [trg_code] * self.n_cyc,
                             [cv] * self.n_cyc, spcidx, [pair_spk] * self.n_cyc)


# ---------------------------------------------------------------------------
# classifier-code (Cls) variants (reference dataset.py:290-492)
# ---------------------------------------------------------------------------

def class_code(spk: str, spk_list: Sequence[str], T: int) -> np.ndarray:
    """Per-frame integer speaker class (reference src_class_code etc.,
    dataset.py:297,303: ``np.ones(T, int64) * class_idx``)."""
    return np.full((T,), list(spk_list).index(spk), dtype=np.int64)


def proc_multspk_data_random_cls(featfile: str, spk_src_list: Sequence[str],
                                 spk_trg_list: Sequence[str], n_cyc: int,
                                 rng: np.random.Generator):
    """proc_multspk_data_random + per-frame class codes
    (reference dataset.py:290-330).  Returns (cv_src_list, trg_code_list,
    featfile_spk, featfile_src_trg, pair_spk_list, src_class_code,
    trg_class_code_list)."""
    all_spk = list(spk_src_list) + list(spk_trg_list)
    cv_list, trg_codes, spk, featfile_pair, pair_spks = \
        proc_multspk_data_random(featfile, spk_src_list, spk_trg_list, n_cyc, rng)
    T = trg_codes[0].shape[0]
    src_cls = class_code(spk, all_spk, T)
    trg_cls_list = [class_code(p, all_spk, T) for p in pair_spks]
    return cv_list, trg_codes, spk, featfile_pair, pair_spks, src_cls, trg_cls_list


@dataclass
class MultClsUtterance(MultUtterance):
    src_class_code: Optional[np.ndarray] = None         # (T,) int64
    trg_class_codes: Optional[List[np.ndarray]] = None  # per cycle (T,) int64


class MultSpkTrainClsDataset(MultSpkTrainDataset):
    """Classifier-code training dataset (reference
    FeatureDatasetMultTrainVAECls, dataset.py:332-385): the Train dataset plus
    per-frame integer speaker classes for source and each per-cycle target."""

    def __getitem__(self, idx: int) -> MultClsUtterance:
        f = self.files[idx]
        feats, spcidx = _feats_spcidx(f)
        cv_list, trg_codes, spk, _, pair_spks, src_cls, trg_cls_list = \
            proc_multspk_data_random_cls(f, self.spk_src_list, self.spk_trg_list,
                                         self.n_cyc, self.rng)
        src_code = one_hot_code(spk, self.all_spk, feats.shape[0])
        return MultClsUtterance(f, feats, src_code, trg_codes, cv_list, spcidx,
                                pair_spks, src_cls, trg_cls_list)


def eval_pair_schedule(n_spk_src: int, n_spk_trg: int) -> List[int]:
    """Deterministic src-speaker -> trg-speaker-index assignment for eval
    (reference dataset.py:407-429's even/odd interleave)."""
    idx_even = 1 if n_spk_trg > 1 else 0
    idx_odd = 0
    out = []
    for s in range(n_spk_src):
        if s % 2 == 0:
            if idx_even >= n_spk_trg:
                idx_even = 1 if n_spk_trg > 1 else 0
            out.append(idx_even)
            idx_even += 2
        else:
            if idx_odd >= n_spk_trg:
                idx_odd = 0
            out.append(idx_odd)
            idx_odd += 2
    return out


class MultSpkEvalClsDataset:
    """Classifier-code eval dataset (reference FeatureDatasetMultEvalVAECls,
    dataset.py:388-492): per-src-speaker file lists are paired with ONE
    deterministically-scheduled target speaker's files; each item carries both
    directions (src and trg records) with one-hot + class codes."""

    def __init__(self, file_list_src_list: Sequence[Sequence[str]],
                 file_list_trg_list: Sequence[Sequence[str]],
                 spk_src_list: Sequence[str], spk_trg_list: Sequence[str]):
        self.spk_src_list = list(spk_src_list)
        self.spk_trg_list = list(spk_trg_list)
        self.all_spk = self.spk_src_list + self.spk_trg_list
        sched = eval_pair_schedule(len(spk_src_list), len(spk_trg_list))
        self.pairs: List[Tuple[str, str]] = []
        self.count_spk_pair_cv = {
            s: {t: 0 for t in self.spk_trg_list} for s in self.spk_src_list}
        for s_idx, t_idx in enumerate(sched):
            # speakers may have unequal eval counts: pair up to the shorter list
            n_eval_utt = min(len(file_list_src_list[s_idx]), len(file_list_trg_list[t_idx]))
            for i in range(n_eval_utt):
                self.count_spk_pair_cv[self.spk_src_list[s_idx]][self.spk_trg_list[t_idx]] += 1
                self.pairs.append((file_list_src_list[s_idx][i], file_list_trg_list[t_idx][i]))

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict:
        f_src, f_trg = self.pairs[idx]
        spk_src, spk_trg = speaker_of(f_src), speaker_of(f_trg)

        def record(f, spk, other):
            feats, spcidx = _feats_spcidx(f)
            T = feats.shape[0]
            return {
                "feats": feats,
                "spcidx": spcidx,
                "code": one_hot_code(spk, self.all_spk, T),
                "pair_code": one_hot_code(other, self.all_spk, T),
                "cv_excit": read_store(f, f"/cvuvlogf0fil_ap_{other}").astype(np.float32),
                "class_code": class_code(spk, self.all_spk, T),
                "pair_class_code": class_code(other, self.all_spk, T),
                "featfile": f,
            }
        return {"src": record(f_src, spk_src, spk_trg),
                "trg": record(f_trg, spk_trg, spk_src)}


# ---------------------------------------------------------------------------
# neural-vocoder surface (reference dataset.py:495-563)
# ---------------------------------------------------------------------------

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
