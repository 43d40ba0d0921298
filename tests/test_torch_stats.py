"""Stages 1, a, 2 and 3 of the port (``pipeline/features.py`` extraction,
``pipeline/stats.py``) against the JAX package's, on the same wavs: every
dataset bitwise equal, the JAX side read from its HDF5 files and the port's
from its ``.npz`` files."""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from cyclevae_tpu.pipeline import features as jf
from cyclevae_tpu.pipeline import stats as jstats
from cyclevae_tpu.utils import hdf5 as jh
from cyclevae_tpu.utils.config import FeatureConfig as JaxFeatureConfig
from cyclevae_tpu_torch.pipeline import features as tf
from cyclevae_tpu_torch.pipeline import stats as tstats
from cyclevae_tpu_torch.utils import store as ts
from cyclevae_tpu_torch.utils.config import FeatureConfig
from cyclevae_tpu_torch.utils.wavio import write_wav

from test_torch_dsp import FS, synth_speechlike

FEATURE_KEYS = ("f0_range", "f0", "feat_org_lf0", "mcep_range", "npow", "npow_range",
                "mcepspc_range", "spcidx_range")
# (min F0, max F0, power threshold) per speaker
RANGES = {"SPKA": (70.0, 400.0, -25.0), "SPKB": (100.0, 500.0, -25.0)}


def _h5_all(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


def _npz_all(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_same_datasets(npz, h5, keys=None):
    got, want = _npz_all(npz), _h5_all(h5)
    assert sorted(got) == sorted(want)
    for k in keys or want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two wavs per speaker, features of both packages from extract_one."""
    root = tmp_path_factory.mktemp("stats")
    out = {"root": root, "jax": {}, "port": {}}
    for spk, f0 in (("SPKA", 120.0), ("SPKB", 220.0)):
        minf0, maxf0, pw = RANGES[spk]
        for i in range(2):
            wav = root / "wav" / spk / f"{spk}_u{i}.wav"
            os.makedirs(wav.parent, exist_ok=True)
            write_wav(str(wav), FS, synth_speechlike(f0 * (1 + 0.1 * i), 0.8 + 0.2 * i, seed=i))
            for side, mod, cfg, ext in (("jax", jf, JaxFeatureConfig(), "h5"),
                                        ("port", tf, FeatureConfig(), "npz")):
                feat = root / side / spk / f"u{i}.{ext}"
                anasyn = root / side / "anasyn" / spk / f"u{i}.wav"
                os.makedirs(anasyn.parent, exist_ok=True)
                n = mod.extract_one(str(wav), str(feat), str(anasyn), cfg, minf0, maxf0, pw)
                out[side].setdefault(spk, []).append((str(feat), str(anasyn), n))
    return out


def test_extract_one_bitwise_equal(corpus):
    for spk in RANGES:
        for (npz, anasyn_t, n_t), (h5, anasyn_j, n_j) in zip(corpus["port"][spk],
                                                             corpus["jax"][spk]):
            assert n_t == n_j > 100
            _assert_same_datasets(npz, h5, FEATURE_KEYS)
            rt, yt = wavfile.read(anasyn_t)
            rj, yj = wavfile.read(anasyn_j)
            assert rt == rj == FS
            np.testing.assert_array_equal(yt, yj)


def test_extract_features_counts_match(corpus, tmp_path):
    """The spawned fan-out over 2 workers: the same counts as the JAX
    package's, and the same files."""
    wavs = sorted(str(p) for p in (corpus["root"] / "wav").rglob("*.wav"))
    minf0, maxf0, pw = RANGES["SPKA"]
    got = tf.extract_features(wavs, str(tmp_path / "port"), str(tmp_path / "port_wav"),
                              FeatureConfig(), minf0, maxf0, pw, n_jobs=2)
    want = jf.extract_features(wavs, str(tmp_path / "jax"), str(tmp_path / "jax_wav"),
                               JaxFeatureConfig(), minf0, maxf0, pw, n_jobs=2)
    assert got == want and got[0] == len(wavs) == 4
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(f.replace(".h5", ".npz") for f in os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        _assert_same_datasets(str(tmp_path / "port" / name.replace(".h5", ".npz")),
                              str(tmp_path / "jax" / name), FEATURE_KEYS)


def _files(corpus, side, spk):
    return [f for f, _, _ in corpus[side][spk]]


def test_calc_stats_and_joint_bitwise_equal(corpus, tmp_path):
    for spk in RANGES:
        tstats.calc_stats(_files(corpus, "port", spk), str(tmp_path / f"{spk}.npz"), spkr=spk)
        jstats.calc_stats(_files(corpus, "jax", spk), str(tmp_path / f"{spk}.h5"), spkr=spk)
        _assert_same_datasets(str(tmp_path / f"{spk}.npz"), str(tmp_path / f"{spk}.h5"))
        # the scalars read back as h5py returns them
        got = ts.read_store(str(tmp_path / f"{spk}.npz"), "/lf0_range_mean")
        want = jh.read_hdf5(str(tmp_path / f"{spk}.h5"), "/lf0_range_mean")
        assert type(got) is type(want) and float(got) == float(want)
    tstats.calc_stats_joint(_files(corpus, "port", "SPKA"), _files(corpus, "port", "SPKB"),
                            str(tmp_path / "jnt.npz"))
    jstats.calc_stats_joint(_files(corpus, "jax", "SPKA"), _files(corpus, "jax", "SPKB"),
                            str(tmp_path / "jnt.h5"))
    _assert_same_datasets(str(tmp_path / "jnt.npz"), str(tmp_path / "jnt.h5"))


def test_streaming_mean_scale_equal():
    rng = np.random.default_rng(3)
    a, b = tstats.StreamingMeanScale(), jstats.StreamingMeanScale()
    for n in (5, 17, 1, 40):
        x = rng.normal(size=(n, 6)) * 3 + 1
        a.partial_fit(x)
        b.partial_fit(x)
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.scale, b.scale)
    assert tstats._ap_dims(22050) == jstats._ap_dims(22050) == (2, 4)
    assert tstats._ap_dims(44100) == jstats._ap_dims(44100)


def test_extract_cv_excitation_bitwise_equal(corpus, tmp_path):
    stats = {}
    for side, mod, ext in (("port", tstats, "npz"), ("jax", jstats, "h5")):
        for spk in RANGES:
            stats[side, spk] = str(tmp_path / f"cv_{spk}.{ext}")
            mod.calc_stats(_files(corpus, side, spk), stats[side, spk], spkr=spk)
    for side, mod in (("port", tstats), ("jax", jstats)):
        for spk, other in (("SPKA", "SPKB"), ("SPKB", "SPKA")):
            mod.extract_cv_excitation(_files(corpus, side, spk), stats[side, spk],
                                      stats[side, other], FS, 5.0)
    for spk in RANGES:
        for npz, h5 in zip(_files(corpus, "port", spk), _files(corpus, "jax", spk)):
            got = ts.read_store(npz, "/cvuvlogf0fil_ap")
            want = jh.read_hdf5(h5, "/cvuvlogf0fil_ap")
            assert got.dtype == want.dtype and got.shape == want.shape == (len(got), 4)
            np.testing.assert_array_equal(got, want)


def test_spk_stat_suggestions_equal(corpus, tmp_path):
    for spk in RANGES:
        got = tstats.spk_stat(_files(corpus, "port", spk), str(tmp_path / "port"), spk)
        want = jstats.spk_stat(_files(corpus, "jax", spk), str(tmp_path / "jax"), spk)
        assert got == want
        assert RANGES[spk][0] < got["f0_min"] < got["f0_max"] < RANGES[spk][1]
        for suffix in ("f0.txt", "pow.txt"):
            assert (tmp_path / "port" / f"{spk}.{suffix}").read_text() == \
                (tmp_path / "jax" / f"{spk}.{suffix}").read_text()
