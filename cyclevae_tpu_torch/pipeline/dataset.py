"""Utterances and batching for training and eval.

PyTorch-side copy of the HDF5-free part of ``cyclevae_tpu/pipeline/
dataset.py`` (reference src/utils/dataset.py padding; the train driver's
generator, train…py:45-149): utterances are zero-padded to a BUCKET length,
a multiple of quantum_segs TBPTT segments, and collated into numpy arrays
with host-side metadata.  Reading utterances from HDF5 feature files waits
for the port's HDF5 plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


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
