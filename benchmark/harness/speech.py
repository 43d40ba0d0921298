"""Seed-made speech-like feature matrices in the recipe's 54-d layout
[U/V, log F0, 2 coded aperiodicities, 50 mel-cepstra]: smooth random
trajectories (a random walk at 5 ms frames, plus frame noise), a voicing
pattern, log F0 around 5.3 (200 Hz)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def lengths(n: int, lo: int, hi: int, corpus_seed: int) -> List[int]:
    """``n`` utterance lengths uniform in [lo, hi]: a fixed set for a corpus
    seed, the same for every run seed."""
    return [int(x) for x in np.random.default_rng(corpus_seed).integers(lo, hi + 1, n)]


def features(rng: np.random.Generator, T: int, dim: int = 54) -> np.ndarray:
    feat = np.cumsum(rng.normal(size=(T, dim)), axis=0) * 0.05
    feat -= feat.mean(axis=0)
    feat += rng.normal(size=(T, dim)) * 0.1
    phase = rng.uniform(0, 2 * np.pi)
    feat[:, 0] = (np.sin(np.arange(T) / 37.0 + phase) > -0.3).astype(np.float64)
    feat[:, 1] += 5.3
    return feat.astype(np.float32)


def f0_track(rng: np.random.Generator, feat: np.ndarray) -> np.ndarray:
    """An F0 track in Hz (0 where unvoiced) that agrees with the features'
    U/V flags and log F0."""
    f0 = np.exp(feat[:, 1].astype(np.float64) + rng.normal(size=len(feat)) * 0.01)
    return np.where(feat[:, 0] > 0.5, f0, 0.0)


def corpus(rng: np.random.Generator, lens: Sequence[int]) -> List[np.ndarray]:
    return [features(rng, T) for T in lens]


def stats(feats: Sequence[np.ndarray]):
    """Mean and standard deviation of every feature over all frames (the
    recipe's joint statistics, which its scalers are set from)."""
    allf = np.concatenate(list(feats))
    return allf.mean(axis=0).astype(np.float32), (allf.std(axis=0) + 1e-3).astype(np.float32)
