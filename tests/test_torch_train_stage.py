"""Stage 4's epoch driver and stage 5 in the port against the JAX package:
``load_utterance`` / ``SingleVAEDataset`` / ``iter_batches`` over the
feature store, ``_utt_eval_metrics``, ``run_train``'s host logic (batch
order, valid-segment weighting, checkpoints, eval epochs, best epoch,
resume) with both packages' train step and eval forward replaced by one
deterministic stand-in, and ``calc_cvgv`` on the same weights and noise."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.pipeline import dataset as jds
from cyclevae_tpu.pipeline import decode as jd
from cyclevae_tpu.pipeline import train_stage as jts
from cyclevae_tpu.utils import hdf5 as jh
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.config import ModelConfig as JaxModelConfig
from cyclevae_tpu.utils.config import TrainConfig as JaxTrainConfig
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.pipeline import dataset as tds
from cyclevae_tpu_torch.pipeline import decode as td
from cyclevae_tpu_torch.pipeline import train_stage as tts
from cyclevae_tpu_torch.utils import store as ts
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
from cyclevae_tpu_torch.vi.train import CycleVAEConfig, metric_names

torch.set_num_threads(1)

SEG = 20
# (speaker, utterance, frames): four training utterances per speaker of
# 31-97 frames (2-5 segments of 20), one eval utterance each
LENS = {"SPKA": [57, 31, 80, 97], "SPKB": [60, 44, 71, 90]}
EVAL_LENS = {"SPKA": 66, "SPKB": 49}


def _smooth_feats(rng, T):
    walk = np.cumsum(rng.normal(size=(T, 54)), axis=0) * 0.05
    feat = walk - walk.mean(axis=0) + 0.1 * rng.normal(size=(T, 54))
    feat[:, 0] = (np.arange(T) % 9 > 2)
    feat[:, 1] += 5.0
    return feat


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same synthetic utterances in both stores: <spk>/u<i> and
    eval/<spk>/e0, with every dataset the train stage reads, plus the stats
    files."""
    root = tmp_path_factory.mktemp("train_stage")
    rng = np.random.default_rng(0)
    files = {"jax": {}, "port": {}}

    def put(rel, data):
        for side, write, ext in (("jax", jh.write_hdf5, "h5"), ("port", ts.write_store, "npz")):
            path = str(root / side / f"{rel}.{ext}")
            for k, v in data.items():
                write(path, k, v)
            files[side][rel] = path

    utts = [(f"{spk}/u{i}", T) for spk in LENS for i, T in enumerate(LENS[spk])]
    utts += [(f"eval/{spk}/e0", T) for spk, T in EVAL_LENS.items()]
    for rel, T in utts:
        feat = _smooth_feats(rng, T)
        cv = feat[:, :4] + rng.normal(size=(T, 4)) * 0.01
        put(rel, {"/feat_org_lf0": feat, "/cvuvlogf0fil_ap": cv,
                  "/spcidx_range": np.asarray(np.where(feat[:, 5] > -0.05))})
    allf = np.concatenate([_smooth_feats(rng, 50) for _ in range(4)])
    put("stats/jnt", {"/mean_feat_org_lf0_jnt": allf.mean(axis=0),
                      "/scale_feat_org_lf0_jnt": allf.std(axis=0)})
    for spk in LENS:
        put(f"stats/{spk}", {"/gv_range_mean": 0.01 + rng.random(50) * 0.1})
    return files


def _train_kwargs(files):
    f = lambda keys: [files[k] for k in keys]
    return dict(
        feats_src=f(["SPKA/u0", "SPKA/u1"]), feats_src_pair=f(["SPKB/u0", "SPKB/u1"]),
        feats_trg=f(["SPKB/u2", "SPKB/u3"]), feats_trg_pair=f(["SPKA/u2", "SPKA/u3"]),
        feats_eval_src=f(["eval/SPKA/e0"]), feats_eval_trg=f(["eval/SPKB/e0"]),
        stats_src=files["stats/SPKA"], stats_trg=files["stats/SPKB"],
        stats_jnt=files["stats/jnt"])


def test_load_utterance_and_batches_identical(stores):
    for rel in ("SPKA/u3", "SPKB/u1", "eval/SPKA/e0"):
        pair = "SPKB/u0"
        got = tds.load_utterance(stores["port"][rel], stores["port"][pair], "SPKA")
        want = jds.load_utterance(stores["jax"][rel], stores["jax"][pair], "SPKA")
        assert got.is_src_speaker == want.is_src_speaker == rel.startswith(("SPKA", "eval/SPKA"))
        for k in ("feats", "cv_excit", "spcidx", "src_code", "trg_code", "feats_pair",
                  "spcidx_pair"):
            g, w = getattr(got, k), getattr(want, k)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    kw_t, kw_j = _train_kwargs(stores["port"]), _train_kwargs(stores["jax"])
    ds_t = tds.SingleVAEDataset(kw_t["feats_src"] + kw_t["feats_trg"],
                                kw_t["feats_src_pair"] + kw_t["feats_trg_pair"], "SPKA")
    ds_j = jds.SingleVAEDataset(kw_j["feats_src"] + kw_j["feats_trg"],
                                kw_j["feats_src_pair"] + kw_j["feats_trg_pair"], "SPKA")
    assert len(ds_t) == len(ds_j) == 4
    for epoch_seed in (1, 2):
        bt = list(tds.iter_batches(ds_t, 3, SEG, np.random.default_rng(epoch_seed)))
        bj = list(jds.iter_batches(ds_j, 3, SEG, np.random.default_rng(epoch_seed)))
        assert len(bt) == len(bj) == 2
        for (b1, m1), (b2, m2) in zip(bt, bj):
            assert m1["n_segs"] == m2["n_segs"] and m1["max_flen"] == m2["max_flen"]
            rel = lambda m: [os.path.splitext(u.featfile)[0].split(os.sep)[-2:] for u in m["utts"]]
            assert rel(m1) == rel(m2)
            for k in b2:
                np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    with pytest.raises(ValueError):
        tds.SingleVAEDataset(kw_t["feats_src"], kw_t["feats_src_pair"][:1], "SPKA")


def _eval_outs(utts, scale, n_cyc=1):
    """A stand-in eval forward's outputs: the mel-cepstra scaled, shifted
    per cycle, (n_cyc, B, T, 50) float32."""
    T = max(u.flen for u in utts)
    mc = np.zeros((len(utts), T, 50), np.float32)
    for j, u in enumerate(utts):
        mc[j, :u.flen] = u.feats[:, 4:]
    base = np.stack([mc * scale + 0.01 * c for c in range(n_cyc)])
    return {"recon": base, "conv": (base * 0.9 + 0.02).astype(np.float32),
            "cyc_recon": (base * 1.1 - 0.01).astype(np.float32)}


def test_utt_eval_metrics_equal(stores):
    u_t = tds.load_utterance(stores["port"]["SPKA/u2"], stores["port"]["SPKB/u2"], "SPKA")
    u_j = jds.load_utterance(stores["jax"]["SPKA/u2"], stores["jax"]["SPKB/u2"], "SPKA")
    outs = _eval_outs([u_t], 1.05)
    gv = ts.read_store(stores["port"]["stats/SPKB"], "/gv_range_mean")[1:]
    for gv_arg in (gv, None):
        got = tts._utt_eval_metrics(CycleVAEConfig(hidden_units=8), u_t, outs, 0, gv_arg)
        want = jts._utt_eval_metrics(JaxConfig(hidden_units=8), u_j, outs, 0, gv_arg)
        assert got == want
        assert ("gv_log_rmse_cv" in got) == (gv_arg is not None)
        assert all(np.isfinite(v) for v in got.values())


class _Stub:
    """One deterministic train step and eval forward for both packages:
    metrics from the batch's features (so they follow the batch order),
    eval outputs from the features scaled per epoch (so the criterion moves
    and the best epoch is the second)."""

    def __init__(self, cfg, torch_side):
        self.names = metric_names(cfg)
        self.torch_side = torch_side
        self.eval_calls = 0

    def make_train_step(self, cfg, opt, seg_len, n_segs):
        def step(ts_, batch):
            feats = np.asarray(batch["feats"], np.float32)
            flens = np.asarray(batch["flens"])
            segs = feats.reshape(feats.shape[0], n_segs, seg_len, -1)
            base = np.abs(segs).mean(axis=(0, 2, 3)).astype(np.float32)
            m = {k: (base * (i + 1)).astype(np.float32) for i, k in enumerate(self.names)}
            m["seg_valid"] = np.asarray([np.any(flens > s * seg_len) for s in range(n_segs)],
                                        np.float32)
            if self.torch_side:
                m = {k: torch.from_numpy(v) for k, v in m.items()}
            return ts_, m
        return step

    def make_eval_forward(self, cfg):
        def eval_fn(params, rng, batch):
            epoch = self.eval_calls // 2          # one src and one trg batch
            self.eval_calls += 1
            scale = 1.0 + 2.0 * abs(epoch - 1)
            feats = np.asarray(batch["feats"], np.float32)
            utts = [type("U", (), {"flen": int(n), "feats": feats[j, :int(n)]})
                    for j, n in enumerate(np.asarray(batch["flens"]))]
            outs = _eval_outs(utts, scale, cfg.eff_cyc)
            return {k: torch.from_numpy(v) if self.torch_side else jnp.asarray(v)
                    for k, v in outs.items()}
        return eval_fn


@pytest.mark.parametrize("eval_interval", [1, 2])
def test_run_train_host_logic_identical(stores, tmp_path, monkeypatch, eval_interval):
    """history.json, the best epoch and the checkpoint names are the JAX
    package's, for 3 epochs and for 2 epochs resumed to 3."""
    kw = dict(hidden_units=8, lat_dim=4, n_cyc=1, spk_src="SPKA", spk_trg="SPKB")
    tkw = dict(batch_size=SEG, batch_size_utt=3, batch_size_utt_eval=2, epoch_count=3,
               eval_interval=eval_interval, seed=3)
    sides = {
        "jax": (jts, JaxExperiment(model=JaxModelConfig(**kw), train=JaxTrainConfig(**tkw)),
                _Stub(CycleVAEConfig(hidden_units=8, n_cyc=1), False), {}),
        "port": (tts, ExperimentConfig(model=ModelConfig(**kw), train=TrainConfig(**tkw)),
                 _Stub(CycleVAEConfig(hidden_units=8, n_cyc=1), True), {"device": "cpu"}),
    }
    hist, ckpts = {}, {}
    for side, (mod, exp, stub, dev) in sides.items():
        monkeypatch.setattr(mod, "make_train_step", stub.make_train_step)
        monkeypatch.setattr(mod, "make_eval_forward", stub.make_eval_forward)
        full = str(tmp_path / side / "full")
        res = mod.run_train(exp, expdir=full, **_train_kwargs(stores[side]), **dev)
        with open(os.path.join(full, "history.json")) as f:
            hist[side, "full"] = json.load(f)
        ckpts[side] = sorted(os.listdir(full))
        assert res["best"] == hist[side, "full"]["best"]
        # 2 epochs, then resumed from the epoch-2 checkpoint to 3
        part = str(tmp_path / side / "part")
        exp.train.epoch_count = 2
        stub.eval_calls = 0
        mod.run_train(exp, expdir=part, **_train_kwargs(stores[side]), **dev)
        exp.train.epoch_count = 3
        mod.run_train(exp, expdir=part, resume=os.path.join(part, "checkpoint-2.pkl"),
                      **_train_kwargs(stores[side]), **dev)
        with open(os.path.join(part, "history.json")) as f:
            hist[side, "resumed"] = json.load(f)
    assert hist["port", "full"] == hist["jax", "full"]
    assert hist["port", "resumed"] == hist["jax", "resumed"]
    best = hist["port", "full"]["best"]
    assert best["epoch"] == 2 and np.isfinite(best["criterion"])
    assert [h["epoch"] for h in hist["port", "full"]["history"]] == \
        ([1, 2, 3] if eval_interval == 1 else [1, 2])
    assert ckpts["port"] == ckpts["jax"]
    assert ckpts["port"] == (["checkpoint-1.pkl", "checkpoint-2.pkl", "checkpoint-3.pkl"]
                             if eval_interval == 1 else ["checkpoint-2.pkl"]) + \
        ["checkpoint-final.pkl", "checkpoint-latest.pkl", "history.json", "model.json"]


def test_calc_cvgv_matches_jax(stores, tmp_path):
    """Stage 5 on the same weights (carried by ``params_from_jax``) and the
    same injected posterior noise: the six statistics agree within the
    Codec tolerance, and land in the source speaker's store under the
    model id."""
    n_smpl, bucket, hu, lat = 6, 32, 16, 32
    kw_t, kw_j = _train_kwargs(stores["port"]), _train_kwargs(stores["jax"])
    mean = ts.read_store(stores["port"]["stats/jnt"], "/mean_feat_org_lf0_jnt")
    scale = ts.read_store(stores["port"]["stats/jnt"], "/scale_feat_org_lf0_jnt")
    jp = jax_init(jax.random.PRNGKey(0), JaxConfig(hidden_units=hu), mean.astype(np.float32),
                  scale.astype(np.float32))
    jc = jd.Codec(jp, JaxConfig(hidden_units=hu), n_smpl_dec=n_smpl, bucket=bucket)
    tc = td.Codec(params_from_jax(jp, device="cpu"), CycleVAEConfig(hidden_units=hu),
                  n_smpl_dec=n_smpl, bucket=bucket, device="cpu")
    assert tc.cfg.use_pallas   # the port's default route: K1's plain version on the CPU
    rng = np.random.default_rng(9)
    lens = [LENS["SPKA"][0], LENS["SPKA"][1], LENS["SPKB"][2], LENS["SPKB"][3]]
    eps = [rng.normal(size=(n_smpl, 1, T, lat)).astype(np.float32) for T in lens]

    def jax_encode_mean(orig, it):
        def enc(key, feats):
            (l,), _ = orig(key, feats)
            e = next(it)[:, 0]
            return [l], [np.asarray(jnp.mean(l[:, :lat] + jnp.exp(l[:, lat:] / 2.0) * e,
                                              axis=0))]
        return enc

    def port_encode_mean(orig, it):
        return lambda gen, feats: orig(gen, feats, eps=next(it))

    jc.encode_mean = jax_encode_mean(jc.encode_mean, iter(eps))
    tc.encode_mean = port_encode_mean(tc.encode_mean, iter(eps))
    mid = "model_ep1"
    want = jd.calc_cvgv(jc, JaxExperiment(), jax.random.PRNGKey(0), kw_j["feats_src"],
                        kw_j["feats_trg"], str(tmp_path / "stats.h5"), mid)
    got = td.calc_cvgv(tc, ExperimentConfig(), None, kw_t["feats_src"], kw_t["feats_trg"],
                       str(tmp_path / "stats.npz"), mid)
    assert sorted(got) == sorted(want) == sorted(
        f"{k}_{m}" for k in ("cvgv", "cvgvsrc", "cvgvtrg") for m in ("mean", "var"))
    for k in want:
        assert got[k].shape == (49,) and np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)
        stored = ts.read_store(str(tmp_path / "stats.npz"), f"/{k}_{mid}")
        np.testing.assert_array_equal(stored, got[k])
