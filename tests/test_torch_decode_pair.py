"""The port's stage-6 conversion from wavs to wavs (``analyze_pair``,
``decode_pair`` and the stage-1 analysis helpers) against the JAX package's,
on the same wavs, weights and posterior noise (CPU, small model)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from cyclevae_tpu.pipeline import decode as jd
from cyclevae_tpu.pipeline import features as jf
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.pipeline import decode as td
from cyclevae_tpu_torch.pipeline import features as tf
from cyclevae_tpu_torch.utils import profiling
from cyclevae_tpu_torch.utils.config import ExperimentConfig
from cyclevae_tpu_torch.utils.wavio import write_wav

from test_torch_dsp import FS, synth_speechlike

torch.set_num_threads(1)

N_SMPL, BUCKET, HU = 8, 64, 32
# (min F0, max F0, power threshold) of the source and target speakers
SRC_RANGE, TRG_RANGE = (70.0, 400.0, -25.0), (100.0, 500.0, -25.0)
SUFFIXES = ("_noGV", "_noGV_src", "_noGV_trg", "_GV", "_GV_src", "_GV_trg",
            "_DiffGV", "_DiffGVF0")
# the decoder outputs of the two frameworks agree to ~3e-5 (float32 scans
# summed in other orders); the int16 wavs then differ by one quantisation
# step in a few samples (relative L2 <= 3.9e-6 measured on a CPU)
WAV_REL_L2 = 1e-4
METRICS = ("lat_rmse", "lat_cos", "mcdpow_cv", "mcd_cv", "mcdpow_src", "mcd_src",
           "mcdpow_trg", "mcd_trg", "mcd_cvgv")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two speech-like wavs (source ~120 Hz, 1.0 s; target ~220 Hz, 0.9 s),
    their analyses by the JAX package, F0 and GV statistics from them."""
    root = tmp_path_factory.mktemp("wavs")
    src, trg = str(root / "src.wav"), str(root / "trg.wav")
    write_wav(src, FS, synth_speechlike(120.0, 1.0, seed=1))
    write_wav(trg, FS, synth_speechlike(220.0, 0.9, seed=2))
    ana = jd.analyze_pair(JaxExperiment(), src, trg, *SRC_RANGE[:2], *TRG_RANGE[:2],
                          SRC_RANGE[2], TRG_RANGE[2])
    lf0 = {k: np.log(ana[k]["f0"][ana[k]["f0"] > 0]) for k in ("src", "trg")}
    f0stats = {"lf0_mean_src": float(lf0["src"].mean()), "lf0_std_src": float(lf0["src"].std()),
               "lf0_mean_trg": float(lf0["trg"].mean()), "lf0_std_trg": float(lf0["trg"].std())}
    rng = np.random.default_rng(5)
    gv = {"gv_mean_src": np.var(ana["src"]["mcep"][:, 1:], axis=0),
          "gv_mean_trg": np.var(ana["trg"]["mcep"][:, 1:], axis=0)}
    for k in ("cvgv_mean", "cvgvsrc_mean", "cvgvtrg_mean"):
        gv[k] = gv["gv_mean_trg"] * (0.5 + rng.random(49))
    return SimpleNamespace(src=src, trg=trg, ana=ana, f0stats=f0stats, gv=gv)


def _args(pair, outdir):
    return dict(wav_file=pair.src, wav_trg_file=pair.trg, outdir=str(outdir),
                f0stats=pair.f0stats, gv=pair.gv, minf0=SRC_RANGE[0], maxf0=SRC_RANGE[1],
                minf0_trg=TRG_RANGE[0], maxf0_trg=TRG_RANGE[1], pow_src=SRC_RANGE[2],
                pow_trg=TRG_RANGE[2])


def _assert_tree_equal(got, want, path="analysis"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _wavs(outdir, base):
    return {s: wavfile.read(os.path.join(outdir, f"{base}{s}.wav")) for s in SUFFIXES}


# the stage-1 helpers: name -> f(features module, decode module, pair)
HELPERS = {
    "analyze_range": lambda f, d, p: f.analyze(p.x, FS, minf0=70.0, maxf0=400.0),
    "analyze_default": lambda f, d, p: f.analyze(p.x, FS),
    "mod_pow": lambda f, d, p: f.mod_pow(p.mc_cv, p.mc, alpha=0.455, irlen=1024),
    "mod_pow_ref_e": lambda f, d, p: f.mod_pow(p.mc_cv, p.mc, alpha=0.455, irlen=512,
                                               ref_e=p.ref_e),
    "spc2npow": lambda f, d, p: f.spc2npow(p.sp),
    "extfrm": lambda f, d, p: f.extfrm(p.mc_sp, f.spc2npow(p.sp), power_threshold=-25.0),
    "convert_linf0": lambda f, d, p: f.convert_linf0(p.f0, 120.0, 15.0, 220.0, 25.0),
    "convert_f0": lambda f, d, p: f.convert_f0(p.f0, 4.8, 0.1, 5.4, 0.12),
    "convert_continuos_f0": lambda f, d, p: f.convert_continuos_f0(p.f0),
    "_feat_from_wav": lambda f, d, p: d._feat_from_wav(p.x, FS, 70.0, 400.0, -25.0,
                                                       p.exp.feature),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_analysis_helpers_bitwise_equal_to_jax_package(pair, name):
    a = pair.ana
    rng = np.random.default_rng(3)
    p = SimpleNamespace(x=a["x"], f0=a["src"]["f0"], sp=a["src"]["sp"], mc_sp=a["src"]["mcep"],
                        mc=a["src"]["mcep"][:30], exp=JaxExperiment())
    p.mc_cv = p.mc + 0.05 * rng.normal(size=p.mc.shape)
    p.ref_e = np.abs(rng.normal(size=30)) + 1.0
    want = HELPERS[name](jf, jd, p)
    p.exp = ExperimentConfig()
    got = HELPERS[name](tf, td, p)
    _assert_tree_equal(got, want, name)


def test_analyze_pair_bitwise_equal_to_jax_package(pair):
    got = td.analyze_pair(ExperimentConfig(), pair.src, pair.trg, *SRC_RANGE[:2],
                          *TRG_RANGE[:2], SRC_RANGE[2], TRG_RANGE[2])
    _assert_tree_equal(got, pair.ana)
    assert got["src"]["feat"].shape == (201, 54) and got["trg"]["feat"].shape[1] == 54
    assert 0 < len(got["src"]["spcidx"]) < 201


def _device_outputs(pair, seed=0):
    """Fixed device-phase outputs of the right shapes for the pair."""
    rng = np.random.default_rng(seed)
    src, trg = pair.ana["src"], pair.ana["trg"]
    T, Tt = len(src["mcep"]), len(trg["mcep"])
    lat_src = rng.normal(size=(T, 64)).astype(np.float32)
    lat_trg = rng.normal(size=(Tt, 64)).astype(np.float32)
    cv = src["mcep"] + 0.05 * rng.normal(size=(T, 50))
    cv_src = src["mcep"] + 0.02 * rng.normal(size=(T, 50))
    cv_trg = trg["mcep"] + 0.02 * rng.normal(size=(Tt, 50))
    return lat_src, lat_trg, cv, cv_src, cv_trg


def test_latent_dtw_metrics_equal_to_jax_package(pair):
    lat_src, lat_trg = _device_outputs(pair)[:2]
    spc_s, spc_t = pair.ana["src"]["spcidx"], pair.ana["trg"]["spcidx"]
    want = jd.latent_dtw_metrics(lat_src, lat_trg, spc_s, spc_t, 32)
    got = td.latent_dtw_metrics(lat_src, lat_trg, spc_s, spc_t, 32)
    assert got == want and sorted(got) == ["lat_cos", "lat_rmse"]


def _stages(spans):
    """The stages recorded under one ``stage6.decode_pair`` span, in order;
    each lies inside it and after the one before."""
    root, = [s for s in spans if s.name == "stage6.decode_pair"]
    stages = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start_ns)
    assert all(s.name.startswith("stage6.") and s.request == root.request for s in stages)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in stages)
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    return [s.name.split(".", 1)[1] for s in stages]


def test_host_tail_of_decode_pair_equal_to_jax_package(pair, tmp_path, monkeypatch):
    """Both packages' device phase patched to return the same arrays: the
    metrics are equal and the eight wav files identical."""
    outs = _device_outputs(pair, seed=4)
    monkeypatch.setattr(jd, "device_decode_pair", lambda *a, **k: outs)
    monkeypatch.setattr(td, "device_decode_pair", lambda *a, **k: outs)
    codec = SimpleNamespace(cfg=SimpleNamespace(lat_dim=32))
    want = jd.decode_pair(codec, JaxExperiment(), None, **_args(pair, tmp_path / "jax"),
                          analysis=pair.ana)
    with profiling.recording():
        got = td.decode_pair(codec, ExperimentConfig(), None, **_args(pair, tmp_path / "port"),
                             analysis=pair.ana)
    assert got == want and sorted(got) == sorted(METRICS)
    assert _stages(profiling.spans()) == ["device", "metrics", "synthesis"]
    w_jax, w_port = _wavs(tmp_path / "jax", "src"), _wavs(tmp_path / "port", "src")
    for s in SUFFIXES:
        assert w_port[s][0] == w_jax[s][0] == FS
        np.testing.assert_array_equal(w_port[s][1], w_jax[s][1], err_msg=s)


def test_decode_pair_end_to_end_matches_jax(pair, tmp_path, monkeypatch):
    """From the two wav files to the metrics and eight wavs: the port's
    ``decode_pair`` with injected posterior noise against the JAX
    ``decode_pair`` whose device phase uses the same noise."""
    feats = [pair.ana["src"]["feat"], pair.ana["trg"]["feat"]]
    allf = np.concatenate(feats)
    mean, scale = allf.mean(axis=0), allf.std(axis=0) + 1e-3
    kw = dict(hidden_units=HU)
    jp = jax_init(jax.random.PRNGKey(0), JaxConfig(**kw), mean, scale)
    jc = jd.Codec(jp, JaxConfig(**kw), n_smpl_dec=N_SMPL, bucket=BUCKET)
    tc = td.Codec(params_from_jax(jp, device="cpu"), td.CycleVAEConfig(use_pallas=True, **kw),
                  n_smpl_dec=N_SMPL, bucket=BUCKET, device="cpu")
    lens = [len(f) for f in feats]
    eps = np.random.default_rng(6).normal(size=(N_SMPL, 2, max(lens), 32)).astype(np.float32)

    def jax_device_decode_pair(codec, key, src_feat, trg_feat):
        # the JAX device phase with the injected noise in place of its draws
        lat, _ = codec.encode_mean(jax.random.PRNGKey(0), [src_feat, trg_feat])
        z = [np.asarray(jnp.mean(l[..., :32] + jnp.exp(l[..., 32:] / 2.0) * eps[:, i, :n],
                                 axis=0)) for i, (l, n) in enumerate(zip(lat, lens))]
        T, Tt = lens
        return (*lat, *codec.decode_batch([(jd._speaker_codes(T, 2, 1), z[0]),
                                           (jd._speaker_codes(T, 2, 0), z[0]),
                                           (jd._speaker_codes(Tt, 2, 1), z[1])]))

    monkeypatch.setattr(jd, "device_decode_pair", jax_device_decode_pair)
    want = jd.decode_pair(jc, JaxExperiment(), None, **_args(pair, tmp_path / "jax"))
    with profiling.recording():
        got = td.decode_pair(tc, ExperimentConfig(), None, **_args(pair, tmp_path / "port"),
                             eps=eps)
    assert sorted(got) == sorted(METRICS)
    assert _stages(profiling.spans()) == ["analysis", "device", "metrics", "synthesis"]
    for k in METRICS:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    w_jax, w_port = _wavs(tmp_path / "jax", "src"), _wavs(tmp_path / "port", "src")
    n_out = {s: len(w_jax[s][1]) for s in SUFFIXES}
    for s in SUFFIXES:
        g, w = w_port[s][1].astype(np.float64), w_jax[s][1].astype(np.float64)
        assert g.shape == (n_out[s],) and np.abs(g).max() > 0
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < WAV_REL_L2, s

