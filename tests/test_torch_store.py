"""The port's feature store (``cyclevae_tpu_torch.utils.store``, ``.npz``
files) against the JAX package's HDF5 store (``cyclevae_tpu.utils.hdf5``):
the same datasets read back with the same dtype, shape and values, the same
overwrite rules, the same failures on a missing file or dataset."""

import os
import threading

import numpy as np
import pytest

from cyclevae_tpu.utils import hdf5 as jh
from cyclevae_tpu_torch.utils import store as ts

DATASETS = {
    "/feat_org_lf0": np.random.default_rng(0).normal(size=(7, 54)),
    "/f0_range": np.linspace(0.0, 200.0, 9),
    "/spcidx_range": np.asarray(np.where(np.arange(10) % 3 > 0)),
    "/uv_f32": (np.arange(5) % 2).astype(np.float32),
    "/codes_i32": np.arange(12, dtype=np.int32).reshape(3, 4),
    "/lf0_range_mean": np.float64(4.875),
    "/count_i64": np.int64(-3),
    "/empty": np.zeros((0, 50)),
    "/cvgv_mean_tpu-cyclevae-gauss_hl1_hu16_lr0.001_ep1": np.arange(49, dtype=np.float64),
}


@pytest.mark.parametrize("path", sorted(DATASETS))
def test_round_trip_matches_hdf5(tmp_path, path):
    """Every dtype and shape, 0-d scalars included, reads back as h5py
    reads it back."""
    npz, h5 = str(tmp_path / "u.npz"), str(tmp_path / "u.h5")
    for name, data in DATASETS.items():
        ts.write_store(npz, name, data)
        jh.write_hdf5(h5, name, data)
    got, want = ts.read_store(npz, path), jh.read_hdf5(h5, path)
    assert type(got) is type(want)
    assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
    np.testing.assert_array_equal(got, want)
    assert ts.shape_store(npz, path) == jh.shape_hdf5(h5, path)
    assert ts.check_store(npz, path) and jh.check_hdf5(h5, path)
    if np.ndim(want) == 0:
        assert float(got) == float(want)


def test_overwrite_rules(tmp_path):
    npz, h5 = str(tmp_path / "a" / "s.npz"), str(tmp_path / "a" / "s.h5")
    for write, read, name in ((ts.write_store, ts.read_store, npz),
                              (jh.write_hdf5, jh.read_hdf5, h5)):
        write(name, "/x", np.ones(3))             # creates the parent dir
        write(name, "/y", np.zeros(2))
        write(name, "/x", np.arange(4.0))         # overwrite by default
        np.testing.assert_array_equal(read(name, "/x"), np.arange(4.0))
        np.testing.assert_array_equal(read(name, "/y"), np.zeros(2))
        with pytest.raises(SystemExit):
            write(name, "/x", np.ones(1), is_overwrite=False)
        np.testing.assert_array_equal(read(name, "/x"), np.arange(4.0))
        write(name, "/z", np.ones(1), is_overwrite=False)   # a new key is fine
    with np.load(npz, allow_pickle=False) as z:
        assert sorted(z.files) == ["x", "y", "z"]
    # the rewrite leaves no temporary file behind
    assert sorted(os.listdir(tmp_path / "a")) == ["s.h5", "s.npz"]


@pytest.mark.parametrize("what", ["file", "dataset"])
def test_missing_file_or_dataset_fails_as_hdf5(tmp_path, what):
    npz, h5 = str(tmp_path / "m.npz"), str(tmp_path / "m.h5")
    if what == "dataset":
        ts.write_store(npz, "/a", np.ones(2))
        jh.write_hdf5(h5, "/a", np.ones(2))
    for name, read, shape, check in ((npz, ts.read_store, ts.shape_store, ts.check_store),
                                     (h5, jh.read_hdf5, jh.shape_hdf5, jh.check_hdf5)):
        assert check(name, "/b") is False
        with pytest.raises(SystemExit):
            read(name, "/b")
        with pytest.raises(SystemExit):
            shape(name, "/b")


def test_writes_load_without_pickle(tmp_path):
    """The store holds plain arrays: an object array cannot be stored, and
    reading never unpickles."""
    npz = str(tmp_path / "p.npz")
    ts.write_store(npz, "/ok", np.ones(2))
    with pytest.raises(ValueError):
        ts.write_store(npz, "/bad", np.array([{"a": 1}], dtype=object))
    np.testing.assert_array_equal(ts.read_store(npz, "/ok"), np.ones(2))


def test_threads_writing_one_file_each_keep_every_key(tmp_path):
    """Stage 1 writes many files at once: each write touches only the file
    it names, and an interrupted rewrite never replaces it."""
    def worker(i):
        name = str(tmp_path / f"u{i}.npz")
        for k in range(6):
            ts.write_store(name, f"/d{k}", np.full(3, i * 10 + k))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(8):
        name = str(tmp_path / f"u{i}.npz")
        for k in range(6):
            np.testing.assert_array_equal(ts.read_store(name, f"/d{k}"), np.full(3, i * 10 + k))


def test_find_files_and_read_txt_match(tmp_path):
    for sub in ("A", "B/eval"):
        os.makedirs(tmp_path / sub, exist_ok=True)
        for n in ("x.wav", "y.wav", "z.txt"):
            (tmp_path / sub / n).write_text("")
    for use_dir in (True, False):
        assert sorted(ts.find_files(str(tmp_path), "*.wav", use_dir)) == \
            sorted(jh.find_files(str(tmp_path), "*.wav", use_dir))
    lst = tmp_path / "list.txt"
    lst.write_text("a.wav\n\nb.wav  \n")
    assert ts.read_txt(str(lst)) == jh.read_txt(str(lst)) == ["a.wav", "b.wav"]
