"""The port's batching (``pipeline/dataset.py``, HDF5-free) against the JAX
package's: padding, bucket lengths, collated batches and the shuffled order."""

import numpy as np
import pytest

from cyclevae_tpu.pipeline import dataset as jd
from cyclevae_tpu_torch.pipeline import dataset as td


def _utts(mod, flens, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, T in enumerate(flens):
        f = rng.normal(size=(T, 54)).astype(np.float32)
        code = np.zeros((T, 2), np.float32)
        out.append(mod.Utterance(f"a{i}", f"b{i}", f, f[:, :4].copy(), np.arange(T),
                                 code + [1, 0], code + [0, 1], f, np.arange(T), i % 2 == 0))
    return out


@pytest.mark.parametrize("value", [0.0, -1.5])
def test_padding_matches_jax(value):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for a in (x, x[:, 0]):
        for flen in (2, 4, 9):
            np.testing.assert_array_equal(td.padding(a, flen, value), jd.padding(a, flen, value))


def test_bucket_len_matches_jax():
    for max_flen in (1, 79, 80, 560, 561, 1200):
        for q in (1, 3, 7):
            assert td.bucket_len(max_flen, 80, q) == jd.bucket_len(max_flen, 80, q)


def test_batches_match_jax():
    flens = [300, 560, 417, 333, 512, 90, 128]
    ut, uj = _utts(td, flens), _utts(jd, flens)
    got = list(td.iter_batches(ut, 3, 80, np.random.default_rng(5)))
    want = list(jd.iter_batches(uj, 3, 80, np.random.default_rng(5)))
    assert len(got) == len(want) == 3
    for (bt, mt), (bj, mj) in zip(got, want):
        assert bt.keys() == bj.keys()
        for k in bt:
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])
        assert mt["n_segs"] == mj["n_segs"] and mt["max_flen"] == mj["max_flen"]
        assert [u.featfile for u in mt["utts"]] == [u.featfile for u in mj["utts"]]
