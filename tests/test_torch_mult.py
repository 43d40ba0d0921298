"""The port's many-to-many recipe against the JAX package's, on the CPU at a
small size (hu16, ld8, n_spk 3): stage 3m (``extract_cv_excitation_mult``)
and the many-to-many and classifier datasets bitwise equal over the same
features (the JAX side's ``.h5`` files written with ``h5py`` here), one
train step with per-cycle codes on replayed draws, ``run_train_mult``'s
host logic under one deterministic stand-in step, stage 5m and the stage-6m
decodes on the same weights and injected posterior noise, and
``run_mult_stages("3456")`` end to end (plus stages 5m-6m from a JAX
checkpoint)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import cyclevae_tpu.models.gru_vae as jgv
import cyclevae_tpu.vi.train as jtrain
from cyclevae_tpu.pipeline import dataset_mult as jdm
from cyclevae_tpu.pipeline import decode as jd
from cyclevae_tpu.pipeline import decode_mult as jdec
from cyclevae_tpu.pipeline import recipe as jrecipe
from cyclevae_tpu.pipeline import stats as jstats
from cyclevae_tpu.pipeline import train_stage_mult as jtm
from cyclevae_tpu.utils import hdf5 as jh
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.config import ModelConfig as JaxModelConfig
from cyclevae_tpu.utils.config import TrainConfig as JaxTrainConfig
from cyclevae_tpu.vi.checkpoint import save_checkpoint as jax_save_checkpoint
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.pipeline import dataset_mult as tdm
from cyclevae_tpu_torch.pipeline import decode as td
from cyclevae_tpu_torch.pipeline import decode_mult as tdec
from cyclevae_tpu_torch.pipeline import recipe as trecipe
from cyclevae_tpu_torch.pipeline import recipe_mult as trm
from cyclevae_tpu_torch.pipeline import stats as tstats
from cyclevae_tpu_torch.pipeline import train_stage_mult as ttm
from cyclevae_tpu_torch.pipeline.features import extract_one
from cyclevae_tpu_torch.utils import store as ts
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
from cyclevae_tpu_torch.utils.wavio import write_wav
from cyclevae_tpu_torch.vi import train as ttrain

from test_e2e_pipeline import FS, synth_speechlike
from test_torch_train import Recorder, Replay
from test_torch_train_stage import _Stub

torch.set_num_threads(1)

SRC, TRG = ["S_A"], ["S_B", "S_C"]
ALL = SRC + TRG
HU, LAT, SEG = 16, 8, 10
TRAIN_LENS = {"S_A": [27, 21, 30], "S_B": [24, 30, 19], "S_C": [29, 22, 26]}
EVAL_LENS = {"S_A": [33, 25], "S_B": [28, 31], "S_C": [26, 34]}
LF0 = {"S_A": (4.8, 0.12), "S_B": (5.4, 0.1), "S_C": (5.15, 0.15)}
N_SMPL, BUCKET = 6, 32


def _feats(rng, T, k):
    walk = np.cumsum(rng.normal(size=(T, 54)), axis=0) * 0.05
    feat = walk - walk.mean(axis=0) + 0.1 * rng.normal(size=(T, 54)) + 0.3 * k
    feat[:, 0] = (np.arange(T) % 7 > 1)
    feat[:, 1] += 5.0
    return feat


@pytest.fixture(scope="module")
def mult_stores(tmp_path_factory):
    """The same utterances of three speakers in both stores, as the recipe
    lays them out (``hdf5/<spk>/u<i>``, ``hdf5/eval/<spk>/e<i>``, per-speaker
    statistics under ``stats/``), with stage 3m run by each package on its
    own files."""
    root = tmp_path_factory.mktemp("mult")
    rng = np.random.default_rng(0)
    sides = {"jax": (jh.write_hdf5, "h5"), "port": (ts.write_store, "npz")}

    def put(rel, data):
        for side, (write, ext) in sides.items():
            for key, v in data.items():
                write(str(root / side / f"{rel}.{ext}"), key, v)

    for k, spk in enumerate(ALL):
        lens = [(f"hdf5/{spk}/u{i}", T) for i, T in enumerate(TRAIN_LENS[spk])]
        lens += [(f"hdf5/eval/{spk}/e{i}", T) for i, T in enumerate(EVAL_LENS[spk])]
        for rel, T in lens:
            feat = _feats(rng, T, k)
            f0 = np.exp(LF0[spk][0] + LF0[spk][1] * rng.normal(size=T)) * (np.arange(T) % 6 > 0)
            put(rel, {"/feat_org_lf0": feat, "/f0_range": f0,
                      "/spcidx_range": np.asarray(np.where(feat[:, 5] > -0.05))})
        put(f"stats/stats_{spk}", {"/lf0_range_mean": np.float64(LF0[spk][0]),
                                   "/lf0_range_std": np.float64(LF0[spk][1]),
                                   "/gv_range_mean": 0.01 + rng.random(50) * 0.1})
    paths = {"jax": jrecipe.RecipePaths(wav_root=str(root / "wav"), work=str(root / "jax"),
                                        n_train=3),
             "port": trecipe.RecipePaths(wav_root=str(root / "wav"), work=str(root / "port"),
                                         n_train=3)}
    for side, mod in (("jax", jstats), ("port", tstats)):
        p = paths[side]
        for spk in ALL:
            for eval_set in (False, True):
                mod.extract_cv_excitation_mult(p.h5s(spk, eval_set), p.stats(spk),
                                               {s: p.stats(s) for s in ALL if s != spk}, 22050)
    return paths


def _h5(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


def test_extract_cv_excitation_mult_bitwise_equal(mult_stores):
    n = 0
    for spk in ALL:
        for eval_set in (False, True):
            got_files = mult_stores["port"].h5s(spk, eval_set)
            want_files = mult_stores["jax"].h5s(spk, eval_set)
            assert len(got_files) == len(want_files) > 0
            for g, w in zip(got_files, want_files):
                got, want = ts._members(g), _h5(w)
                assert sorted(got) == sorted(want)
                assert sorted(k for k in got if k.startswith("cvuvlogf0fil_ap_")) == \
                    [f"cvuvlogf0fil_ap_{s}" for s in ALL if s != spk]
                for k in want:
                    assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{g}:{k}")
                n += 1
    assert n == 15


def _train_files(paths):
    return [f for spk in ALL for f in paths.h5s(spk)]


def _eval_files(paths):
    return [f for spk in ALL for f in paths.h5s(spk, True)]


def _rel(path):
    return os.path.splitext(path)[0].split(os.sep)[-2:]


def _assert_utt_equal(got, want, fields):
    assert _rel(got.featfile) == _rel(want.featfile)
    for k in fields:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                if isinstance(b, str):
                    assert a == b, k
                else:
                    assert a.dtype == b.dtype and a.shape == b.shape, k
                    np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


MULT_FIELDS = ("feats", "src_code", "trg_codes", "cv_excits", "spcidx", "pair_spks")


@pytest.mark.parametrize("n_cyc", [1, 2])
def test_mult_datasets_identical(mult_stores, n_cyc):
    t, j = mult_stores["port"], mult_stores["jax"]
    ds_t = tdm.MultSpkTrainDataset(_train_files(t), SRC, TRG, n_cyc, seed=5)
    ds_j = jdm.MultSpkTrainDataset(_train_files(j), SRC, TRG, n_cyc, seed=5)
    # each access draws the pairs afresh: two passes in a shuffled order
    order = np.random.default_rng(1).permutation(len(ds_t)).tolist() * 2
    pairs = set()
    for i in order:
        got, want = ds_t[i], ds_j[i]
        _assert_utt_equal(got, want, MULT_FIELDS)
        pairs.add((tdm.speaker_of(got.featfile), got.pair_spks[0]))
    assert {("S_A", "S_B"), ("S_A", "S_C"), ("S_B", "S_A"), ("S_C", "S_A")} == pairs
    ev_t = tdm.MultSpkEvalDataset(_eval_files(t), SRC, TRG, n_cyc)
    ev_j = jdm.MultSpkEvalDataset(_eval_files(j), SRC, TRG, n_cyc)
    assert len(ev_t) == len(ev_j) == 6
    for i in range(len(ev_t)):
        _assert_utt_equal(ev_t[i], ev_j[i], MULT_FIELDS)
    f = _train_files(t)[0]
    got = tdm.proc_multspk_data_random(f, SRC, TRG, 3, np.random.default_rng(2))
    want = jdm.proc_multspk_data_random(_train_files(j)[0], SRC, TRG, 3,
                                        np.random.default_rng(2))
    assert got[2] == want[2] == "S_A" and got[4] == want[4]
    assert _rel(got[3]) == _rel(want[3]) == [got[4][0], "u0"]
    np.testing.assert_array_equal(tdm.one_hot_code("S_C", ALL, 4), jdm.one_hot_code("S_C", ALL, 4))


def test_cls_datasets_identical(mult_stores):
    t, j = mult_stores["port"], mult_stores["jax"]
    ds_t = tdm.MultSpkTrainClsDataset(_train_files(t), SRC, TRG, 2, seed=3)
    ds_j = jdm.MultSpkTrainClsDataset(_train_files(j), SRC, TRG, 2, seed=3)
    for i in list(range(len(ds_t))) * 2:
        _assert_utt_equal(ds_t[i], ds_j[i], MULT_FIELDS + ("src_class_code", "trg_class_codes"))
    evals = lambda p, spks: [p.h5s(s, True) for s in spks]
    for src, trg in ((SRC, TRG), (TRG, SRC), (["S_A", "S_B"], ["S_C"])):
        ev_t = tdm.MultSpkEvalClsDataset(evals(t, src), evals(t, trg), src, trg)
        ev_j = jdm.MultSpkEvalClsDataset(evals(j, src), evals(j, trg), src, trg)
        assert ev_t.count_spk_pair_cv == ev_j.count_spk_pair_cv
        assert [tuple(map(tuple, map(_rel, p))) for p in ev_t.pairs] == \
            [tuple(map(tuple, map(_rel, p))) for p in ev_j.pairs]
        for i in range(len(ev_t)):
            for side in ("src", "trg"):
                got, want = ev_t[i][side], ev_j[i][side]
                assert sorted(got) == sorted(want)
                assert _rel(got["featfile"]) == _rel(want["featfile"])
                for k in want:
                    if k != "featfile":
                        assert got[k].dtype == want[k].dtype, k
                        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_eval_pair_schedule_equal():
    for n_src in range(1, 7):
        for n_trg in range(1, 7):
            got = tdm.eval_pair_schedule(n_src, n_trg)
            assert got == jdm.eval_pair_schedule(n_src, n_trg)
            assert len(got) == n_src and all(0 <= i < n_trg for i in got)
    assert tdm.class_code("S_B", ALL, 3).tolist() == [1, 1, 1]


def _batches(mult_stores, n_cyc, idx, quantum):
    out = []
    for side, ds_mod, col in (("port", tdm, ttm._collate), ("jax", jdm, jtm._collate)):
        ds = ds_mod.MultSpkTrainDataset(_train_files(mult_stores[side]), SRC, TRG, n_cyc, seed=2)
        out.append(col([ds[i] for i in idx], n_cyc, SEG, quantum))
    return out


def test_collate_identical(mult_stores):
    (bt, nt), (bj, nj) = _batches(mult_stores, 2, [4, 0, 7], 2)
    assert nt == nj == 4
    assert bt["trg_code"].shape == (2, 3, 40, 3) and bt["cv_excit"].shape == (2, 3, 40, 4)
    assert sorted(bt) == sorted(bj)
    for k in bj:
        assert bt[k].dtype == bj[k].dtype
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_train_mult_step_matches_jax(mult_stores, monkeypatch):
    """One train step with per-cycle target codes and excitations (a batch
    of ``run_train_mult``), both packages on the same weights and replayed
    dropout masks and posterior noise.  The JAX step runs jitted: its
    segment scan traces the body once, so every segment takes the draws
    recorded at trace time, and the port replays them once per segment."""
    rec = Recorder(seed=11)
    monkeypatch.setattr(jgv, "_bernoulli_fast", rec.bernoulli)
    monkeypatch.setattr(jtrain, "sampling_vae_batch", rec.sampling)
    (batch, n_segs), (jbatch, _) = _batches(mult_stores, 2, [1, 5, 6], 3)
    assert n_segs == 3 and not np.array_equal(batch["trg_code"][0], batch["trg_code"][1])
    kw = dict(hidden_units=HU, lat_dim=LAT, n_cyc=2, n_spk=3, do_prob=0.5)
    rng = np.random.default_rng(4)
    mean = (0.1 * rng.normal(size=54)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=54).astype(np.float32)
    jc = jtrain.CycleVAEConfig(use_pallas=False, **kw)
    jp = jtrain.init_cyclevae(jax.random.PRNGKey(0), jc, mean, scale)
    tp = params_from_jax(jp, device="cpu")
    opt_j = jtrain.make_optimizer(jc, lr=1e-3)
    ts_j = jtrain.TrainState(jp, opt_j.init(jp), jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
    ts_j, met_j = jtrain.make_train_step(jc, opt_j, SEG, n_segs)(
        ts_j, {k: jnp.asarray(v) for k, v in jbatch.items()})
    assert len(rec.seq) == 22     # per cycle: 4 AR-GRU calls x 2 masks, 3 latent draws
    tc = ttrain.CycleVAEConfig(**kw)
    assert tc.use_pallas                       # the port's route: K2/K3's plain versions here
    opt_t = ttrain.make_optimizer(tc, lr=1e-3)
    ts_t = ttrain.TrainState(tp, opt_t.init(tp), torch.Generator(), 0)
    replay = Replay(rec.seq * n_segs)
    ts_t, met_t = ttrain.make_train_step(tc, opt_t, SEG, n_segs)(ts_t, batch, replay)
    assert not replay.seq                       # every recorded draw replayed, in order
    loss_j, loss_t = np.asarray(met_j["loss"]), met_t["loss"].numpy()
    np.testing.assert_array_equal(met_t["seg_valid"].numpy(), np.asarray(met_j["seg_valid"]))
    # segment 0 from the same weights: the ELBO bound; later segments from
    # weights one Adam step apart per segment (tests/test_torch_train.py)
    assert abs(loss_t[0] - loss_j[0]) / abs(loss_j[0]) < 2e-4
    assert np.all(np.abs(loss_t - loss_j) <= 2e-3 * np.abs(loss_j))
    for k in met_j:
        if k != "seg_valid":
            np.testing.assert_allclose(met_t[k].numpy(), np.asarray(met_j[k]), rtol=2e-3,
                                       atol=1e-4, err_msg=k)


def test_run_train_mult_host_logic_identical(mult_stores, tmp_path, monkeypatch):
    """history.json (per-epoch train means over valid segments, eval MCDs,
    the best epoch) and the checkpoint names are the JAX package's, both
    packages' step and eval forward replaced by one deterministic stand-in."""
    kw = dict(hidden_units=8, lat_dim=4, n_cyc=2)
    tkw = dict(batch_size=SEG, batch_size_utt=4, batch_size_utt_eval=4, epoch_count=3, seed=7)
    names_cfg = ttrain.CycleVAEConfig(hidden_units=8, n_cyc=2)
    hist, files = {}, {}
    for side, mod, exp, dev in (
            ("jax", jtm, JaxExperiment(model=JaxModelConfig(**kw), train=JaxTrainConfig(**tkw)),
             {}),
            ("port", ttm, ExperimentConfig(model=ModelConfig(**kw), train=TrainConfig(**tkw)),
             {"device": "cpu"})):
        stub = _Stub(names_cfg, side == "port")
        monkeypatch.setattr(mod, "make_train_step", stub.make_train_step)
        monkeypatch.setattr(mod, "make_eval_forward", stub.make_eval_forward)
        p = mult_stores[side]
        stats = os.path.join(p.work, "stats", f"jnt.{'h5' if side == 'jax' else 'npz'}")
        (jstats if side == "jax" else tstats).calc_stats_joint(_train_files(p), [], stats)
        out = str(tmp_path / side)
        res = mod.run_train_mult(exp, _train_files(p), _eval_files(p), SRC, TRG, stats, out,
                                 **dev)
        with open(os.path.join(out, "history.json")) as f:
            hist[side] = json.load(f)
        assert res["history"] == hist[side]["history"]
        files[side] = sorted(os.listdir(out))
    assert hist["port"] == hist["jax"]
    assert [h["epoch"] for h in hist["port"]["history"]] == [1, 2, 3]
    assert files["port"] == files["jax"] == ["checkpoint-1.pkl", "checkpoint-2.pkl",
                                             "checkpoint-3.pkl", "history.json", "model.json"]


def _codecs(mult_stores, seed=0):
    kw = dict(hidden_units=HU, lat_dim=LAT, n_spk=3)
    mean = ts.read_store(mult_stores["port"].h5s("S_A")[0], "/feat_org_lf0").mean(axis=0)
    jp = jtrain.init_cyclevae(jax.random.PRNGKey(seed), jtrain.CycleVAEConfig(**kw),
                              mean.astype(np.float32), np.ones(54, np.float32))
    jc = jd.Codec(jp, jtrain.CycleVAEConfig(**kw), n_smpl_dec=N_SMPL, bucket=BUCKET)
    tc = td.Codec(params_from_jax(jp, device="cpu"), ttrain.CycleVAEConfig(**kw),
                  n_smpl_dec=N_SMPL, bucket=BUCKET, device="cpu")
    return jc, tc


def _inject(jc, tc, eps_list):
    """Both codecs' ``encode_mean`` take the next injected noise
    (n_smpl_dec, 1, T, lat) in place of their draws."""
    it_j, it_t = iter(eps_list), iter(eps_list)
    orig_j, orig_t = jc.encode_mean, tc.encode_mean

    def enc_j(key, feats):
        (l,), _ = orig_j(key, feats)
        e = next(it_j)[:, 0]
        return [l], [np.asarray(jnp.mean(l[:, :LAT] + jnp.exp(l[:, LAT:] / 2.0) * e, axis=0))]

    jc.encode_mean = enc_j
    tc.encode_mean = lambda gen, feats: orig_t(gen, feats, eps=next(it_t))


def test_calc_cvgv_mult_matches_jax(mult_stores):
    jc, tc = _codecs(mult_stores)
    rng = np.random.default_rng(9)
    eps = [rng.normal(size=(N_SMPL, 1, T, LAT)).astype(np.float32)
           for spk in ALL for T in TRAIN_LENS[spk]]
    _inject(jc, tc, eps)
    mid = "m2m_ep1"
    want = jdec.calc_cvgv_mult(jc, mult_stores["jax"], ALL, mid, key=jax.random.PRNGKey(5))
    got = tdec.calc_cvgv_mult(tc, mult_stores["port"], ALL, mid)
    assert sorted(got) == sorted(want) == sorted(ALL)
    for s in ALL:
        for t in ALL:
            assert got[s][t].shape == (49,) and np.isfinite(got[s][t]).all()
            np.testing.assert_allclose(got[s][t], want[s][t], atol=3e-5, err_msg=f"{s}-{t}")
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    ts.read_store(mult_stores["port"].stats(s), f"/cvgv_{k}_{t}_{mid}"),
                    jh.read_hdf5(mult_stores["jax"].stats(s), f"/cvgv_{k}_{t}_{mid}"), atol=3e-5)
            np.testing.assert_array_equal(tdec.load_cvgv_mult(mult_stores["port"], s, t, mid),
                                          got[s][t])
    assert tdec.load_cvgv_mult(mult_stores["port"], "S_A", "S_B", "other") is None
    cv = np.random.default_rng(1).normal(size=(20, 50))
    np.testing.assert_array_equal(tdec.gv_postfilter_utt(cv, got["S_A"]["S_B"]),
                                  jdec.gv_postfilter_utt(cv, got["S_A"]["S_B"]))


@pytest.fixture(scope="module")
def eval_wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mult_wavs")
    paths = {}
    for spk, f0, dur in (("S_A", 120.0, 0.7), ("S_B", 220.0, 0.6)):
        paths[spk] = str(root / f"{spk}_e0.wav")
        write_wav(paths[spk], FS, synth_speechlike(f0, dur, seed=len(paths)))
    return paths


def _wav(path):
    return wavfile.read(path)[1].astype(np.float64)


@pytest.mark.parametrize("calibrated", [True, False])
def test_eval_pair_mult_matches_jax(mult_stores, eval_wavs, tmp_path, calibrated):
    jc, tc = _codecs(mult_stores, seed=1)
    frames = len(td.analyze_pair(ExperimentConfig(), eval_wavs["S_A"], eval_wavs["S_B"], 40.0,
                                 700.0, 40.0, 700.0, -20.0, -20.0)["src"]["feat"])
    eps = [np.random.default_rng(3).normal(size=(N_SMPL, 1, frames, LAT)).astype(np.float32)]
    _inject(jc, tc, eps)
    mid = "cal" if calibrated else None
    for side in ("jax", "port"):
        p = mult_stores[side]
        write = jh.write_hdf5 if side == "jax" else ts.write_store
        write(p.stats("S_A"), "/cvgv_mean_S_B_cal",
              np.full(49, 0.02) + np.linspace(0, 0.01, 49))
    want = jdec.eval_pair_mult(jc, JaxExperiment(), mult_stores["jax"], eval_wavs["S_A"],
                               eval_wavs["S_B"], "S_A", "S_B", ALL,
                               outdir=str(tmp_path / "jax"), model_id=mid)
    got = tdec.eval_pair_mult(tc, ExperimentConfig(), mult_stores["port"], eval_wavs["S_A"],
                              eval_wavs["S_B"], "S_A", "S_B", ALL,
                              outdir=str(tmp_path / "port"), model_id=mid)
    assert sorted(got) == sorted(want) == ["gv_log_rmse", "mcd_cv", "mcd_cvgv", "mcdpow_cv"]
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # the wavs, within tests/test_torch_decode_pair.py's bound
    for sfx in ("_noGV", "_GV"):
        name = f"S_A_e0_to_S_B{sfx}.wav"
        g, w = _wav(str(tmp_path / "port" / name)), _wav(str(tmp_path / "jax" / name))
        assert g.shape == w.shape and np.abs(g).max() > 0
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4, sfx


@pytest.mark.parametrize("trg", ["S_C", (0.5, 0.25, 0.25)])
def test_decode_to_speaker_matches_jax(mult_stores, eval_wavs, tmp_path, trg):
    jc, tc = _codecs(mult_stores, seed=2)
    frames = len(td.analyze_pair(ExperimentConfig(), eval_wavs["S_A"], eval_wavs["S_A"], 40.0,
                                 700.0, 40.0, 700.0, -20.0, -20.0)["src"]["feat"])
    _inject(jc, tc, [np.random.default_rng(4).normal(size=(N_SMPL, 1, frames, LAT))
                     .astype(np.float32)])
    trg_arg = trg if isinstance(trg, str) else list(trg)
    want = jdec.decode_to_speaker(jc, JaxExperiment(), mult_stores["jax"], eval_wavs["S_A"],
                                  "S_A", ALL, trg_arg, str(tmp_path / "jax"))
    got = tdec.decode_to_speaker(tc, ExperimentConfig(), mult_stores["port"], eval_wavs["S_A"],
                                 "S_A", ALL, trg_arg, str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == ["_GV", "_noGV"]
    for k in want:
        assert os.path.basename(got[k]) == os.path.basename(want[k])
        g, w = _wav(got[k]), _wav(want[k])
        assert g.shape == w.shape and np.abs(g).max() > 0
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4, k


@pytest.fixture(scope="module")
def recipe_run(tmp_path_factory):
    """Three speech-like speakers (2 train wavs and 1 eval wav each),
    analysed by the port's stage-1 function and its per-speaker statistics,
    then ``run_mult_stages("3456")`` on the CPU."""
    root = tmp_path_factory.mktemp("m2m_recipe")
    exp = ExperimentConfig(model=ModelConfig(hidden_units=HU, lat_dim=LAT, n_cyc=2),
                           train=TrainConfig(batch_size=40, batch_size_utt=2,
                                             batch_size_utt_eval=2, epoch_count=2, lr=1e-3))
    paths = trecipe.RecipePaths(wav_root=str(root / "wav"), work=str(root / "work"), n_train=2)
    conf = root / "conf"
    os.makedirs(conf)
    for k, (spk, f0) in enumerate((("S_A", 120.0), ("S_B", 220.0), ("S_C", 170.0))):
        (conf / f"{spk}.f0").write_text("70 500")
        (conf / f"{spk}.pow").write_text("-25")
        for sub, names in (("", ("u0", "u1")), ("eval", ("e0",))):
            d = root / "wav" / sub / spk
            os.makedirs(d)
            for i, name in enumerate(names):
                write_wav(str(d / f"{name}.wav"), FS,
                          synth_speechlike(f0 * (1 + 0.05 * i), 0.8, seed=10 * k + i))
                extract_one(str(d / f"{name}.wav"),
                            os.path.join(paths.h5dir(spk, sub == "eval"), f"{name}.npz"),
                            None, exp.feature, 70.0, 500.0, -25.0)
        tstats.calc_stats(paths.h5s(spk), paths.stats(spk), spkr=spk)
    trm.run_mult_stages("3456", exp, paths, SRC, TRG, conf_dir=str(conf), device="cpu")
    return exp, paths, str(conf)


def test_run_mult_stages_end_to_end(recipe_run):
    exp, paths, _ = recipe_run
    expdir = os.path.join(paths.work, "exp", exp.name() + "_m2m")
    with open(os.path.join(expdir, "history.json")) as f:
        hist = json.load(f)
    assert [h["epoch"] for h in hist["history"]] == [1, 2] and hist["best"]["epoch"] in (1, 2)
    assert sorted(hist["history"][0]["eval"]) == ["mcdpow_cyc_mean", "mcdpow_rec_mean"]
    assert all(np.isfinite(v) for h in hist["history"] for v in h["train"].values())
    with open(os.path.join(expdir, "model.json")) as f:
        assert json.load(f)["model"]["use_pallas"] is True
    assert {"checkpoint-1.pkl", "checkpoint-2.pkl"} <= set(os.listdir(expdir))
    epoch = hist["best"]["epoch"]
    mid = f"{exp.name()}_m2m_ep{epoch}"
    for s in ALL:
        assert ts.read_store(paths.h5s(s)[0], f"/cvuvlogf0fil_ap_{ALL[ALL.index(s) - 1]}") \
            .shape[1] == 4
        for t in ALL:
            for k in ("mean", "var"):
                v = ts.read_store(paths.stats(s), f"/cvgv_{k}_{t}_{mid}")
                assert v.shape == (49,) and np.isfinite(v).all()
    with open(os.path.join(expdir, f"decode_metrics_m2m_ep{epoch}.json")) as f:
        dm = json.load(f)
    assert dm["epoch"] == epoch and len(dm["per_direction"]) == 6
    assert sorted(dm["overall"]) == ["gv_log_rmse", "mcd_cv", "mcd_cvgv", "mcdpow_cv"]
    assert all(np.isfinite(v) for d in dm["per_direction"].values() for v in d.values())
    wavs = sorted(os.listdir(os.path.join(expdir, f"wav_m2m_ep{epoch}")))
    # every eval utterance is e0.wav: the directions into one target share
    # its file name, as in the JAX package
    want = {f"e0_to_{t}{sfx}.wav" for t in ALL for sfx in ("_noGV", "_GV")}
    want |= {f"e0_to_mix-{w:.2f}-{1 - w:.2f}-0.00{sfx}.wav" for w in (0.75, 0.5, 0.25)
             for sfx in ("_noGV", "_GV")}
    assert wavs == sorted(want)


def test_stages_5_6_from_a_jax_checkpoint(recipe_run, tmp_path):
    """Stages 5m and 6m load a checkpoint written by the JAX package's
    ``save_checkpoint`` (its params through ``interop.params_from_jax``)."""
    exp, paths, conf = recipe_run
    work = tmp_path / "work"
    work.mkdir()
    os.symlink(os.path.join(paths.work, "hdf5"), work / "hdf5")
    shutil.copytree(os.path.join(paths.work, "stats"), work / "stats")
    p2 = trecipe.RecipePaths(wav_root=paths.wav_root, work=str(work), n_train=2)
    expdir = work / "exp" / (exp.name() + "_m2m")
    jcfg = jtrain.CycleVAEConfig(hidden_units=HU, lat_dim=LAT, n_spk=3)
    jp = jtrain.init_cyclevae(jax.random.PRNGKey(3), jcfg, np.zeros(54, np.float32),
                              np.ones(54, np.float32))
    jax_save_checkpoint(str(expdir), jp, jtrain.make_optimizer(jcfg).init(jp),
                        jax.random.PRNGKey(0), np.random.default_rng(0), 1)
    (expdir / "history.json").write_text(json.dumps({"best": {"epoch": 1}}))
    trm.run_mult_stages("6", exp, p2, SRC, TRG, conf_dir=conf, device="cpu")
    # stage 6m found no calibration and ran 5m inline, on the JAX weights
    mid = f"{exp.name()}_m2m_ep1"
    codec = td.Codec(params_from_jax(jp, device="cpu"),
                     ttrain.CycleVAEConfig(hidden_units=HU, lat_dim=LAT, n_spk=3), device="cpu")
    want = tdec.calc_cvgv_mult(codec, paths, ALL, "check", torch.Generator().manual_seed(5))
    for s in ALL:
        for t in ALL:
            np.testing.assert_array_equal(ts.read_store(p2.stats(s), f"/cvgv_mean_{t}_{mid}"),
                                          want[s][t])
    with open(expdir / "decode_metrics_m2m_ep1.json") as f:
        assert len(json.load(f)["per_direction"]) == 6


def test_recipe_mult_cli(recipe_run, tmp_path):
    _, paths, _ = recipe_run
    base = ["--work", paths.work, "--src-speakers", "S_A", "--trg-speakers", "S_B", "S_C"]
    with pytest.raises(SystemExit):
        trm.main(base + ["--stage", "3", "--device", "cpu"])     # --wav-root has no default
    before = ts.read_store(paths.h5s("S_B")[0], "/cvuvlogf0fil_ap_S_C")
    trm.main(base + ["--stage", "3", "--device", "cpu", "--wav-root", paths.wav_root])
    np.testing.assert_array_equal(ts.read_store(paths.h5s("S_B")[0], "/cvuvlogf0fil_ap_S_C"),
                                  before)
