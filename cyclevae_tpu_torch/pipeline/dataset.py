"""Utterance datasets + batching for training and eval.

PyTorch-side copy of ``cyclevae_tpu/pipeline/dataset.py`` over the port's
feature store (reference src/utils/dataset.py FeatureDatasetSingleVAE
pairing and padding; the train driver's generator, train…py:45-149):
utterances are read from their ``.npz`` files, zero-padded to a BUCKET
length, a multiple of quantum_segs TBPTT segments, and collated into numpy
arrays with host-side metadata.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.store import read_store


def padding(x: np.ndarray, flen: int, value: float = 0.0) -> np.ndarray:
    """Pad along axis 0 to length flen with ``value`` (reference dataset.py:23-31)."""
    diff = flen - x.shape[0]
    if diff > 0:
        if x.ndim > 1:
            x = np.concatenate([x, np.ones((diff, x.shape[1])) * value])
        else:
            x = np.concatenate([x, np.ones(diff) * value])
    return x


@dataclass
class Utterance:
    featfile: str
    featfile_pair: str
    feats: np.ndarray          # (T, 54) float32
    cv_excit: np.ndarray       # (T, 4)
    spcidx: np.ndarray         # (n_spc,) int
    src_code: np.ndarray       # (T, n_spk)
    trg_code: np.ndarray       # (T, n_spk)
    feats_pair: np.ndarray     # (T_pair, 54): the paired utterance, for eval
    spcidx_pair: np.ndarray
    is_src_speaker: bool

    @property
    def flen(self) -> int:
        return self.feats.shape[0]


def load_utterance(featfile: str, featfile_pair: str, spk_src: str,
                   n_spk: int = 2) -> Utterance:
    """One-to-one pairing contract (reference dataset.py:54-98): speaker
    identity = directory name == spk_src -> code[0], else code[1]."""
    feats = read_store(featfile, "/feat_org_lf0").astype(np.float32)
    cv = read_store(featfile, "/cvuvlogf0fil_ap").astype(np.float32)
    spcidx = np.asarray(read_store(featfile, "/spcidx_range")[0], dtype=np.int64)
    T = feats.shape[0]
    src_code = np.zeros((T, n_spk), np.float32)
    trg_code = np.zeros((T, n_spk), np.float32)
    is_src = os.path.basename(os.path.dirname(featfile)) == spk_src
    if is_src:
        src_code[:, 0] = 1
        trg_code[:, 1] = 1
    else:
        src_code[:, 1] = 1
        trg_code[:, 0] = 1
    feats_pair = read_store(featfile_pair, "/feat_org_lf0").astype(np.float32)
    spcidx_pair = np.asarray(read_store(featfile_pair, "/spcidx_range")[0],
                             dtype=np.int64)
    return Utterance(featfile, featfile_pair, feats, cv, spcidx,
                     src_code, trg_code, feats_pair, spcidx_pair, is_src)


class SingleVAEDataset:
    """Paired one-to-one dataset: file i of list A with file i of list B
    (reference dataset.py:54-98; train list = src_files + trg_files,
    train…py:458).  Utterances are read once and kept."""

    def __init__(self, files: Sequence[str], files_pair: Sequence[str],
                 spk_src: str, n_spk: int = 2):
        if len(files) != len(files_pair):
            raise ValueError(f"{len(files)} files but {len(files_pair)} pair files")
        self.files = list(files)
        self.files_pair = list(files_pair)
        self.spk_src = spk_src
        self.n_spk = n_spk
        self._cache: Dict[int, Utterance] = {}

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Utterance:
        if idx not in self._cache:
            self._cache[idx] = load_utterance(
                self.files[idx], self.files_pair[idx], self.spk_src, self.n_spk)
        return self._cache[idx]


def bucket_len(max_flen: int, seg_len: int, quantum_segs: int = 7) -> int:
    """Pad target: the smallest multiple of quantum_segs*seg_len >= max_flen,
    so a handful of bucket sizes covers every batch."""
    q = quantum_segs * seg_len
    return ((max_flen + q - 1) // q) * q


def make_batch(utts: List[Utterance], seg_len: int, quantum_segs: int = 7,
               pad_to: Optional[int] = None) -> Tuple[Dict, Dict]:
    """Collate utterances into (batch arrays, host-side metadata)."""
    max_flen = max(u.flen for u in utts)
    T = pad_to if pad_to is not None else bucket_len(max_flen, seg_len, quantum_segs)

    def pad_stack(get):
        return np.stack([padding(get(u), T).astype(np.float32) for u in utts])

    batch = {
        "feats": pad_stack(lambda u: u.feats),
        "src_code": pad_stack(lambda u: u.src_code),
        "trg_code": pad_stack(lambda u: u.trg_code),
        "cv_excit": pad_stack(lambda u: u.cv_excit),
        "flens": np.asarray([u.flen for u in utts], dtype=np.int32),
    }
    meta = {"utts": utts, "n_segs": T // seg_len, "max_flen": max_flen}
    return batch, meta


def iter_batches(dataset: Sequence[Utterance], batch_size_utt: int, seg_len: int,
                 rng: Optional[np.random.Generator] = None,
                 quantum_segs: int = 7) -> Iterator[Tuple[Dict, Dict]]:
    """Yield (batch, meta) over any sequence of utterances; shuffled when
    ``rng`` is given (DataLoader shuffle=True, train…py:459)."""
    order = np.arange(len(dataset))
    if rng is not None:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size_utt):
        utts = [dataset[i] for i in order[start:start + batch_size_utt]]
        yield make_batch(utts, seg_len, quantum_segs)
