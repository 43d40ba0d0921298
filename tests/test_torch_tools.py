"""The port's tools (``cyclevae_tpu_torch.tools``) on the CPU at small sizes,
against the JAX package's tools where both compute the same numbers.

* every tool's ``main`` runs at a small width (monkeypatched, not flagged)
  and writes the JAX tool's JSON keys plus ``device``; without CUDA and
  without ``--device cpu`` it raises;
* ``train_eval_vocoder --eval-only --temperature 0`` on a checkpoint that
  the JAX package's ``run_train_vocoder`` wrote: copy-synthesis metrics
  within rtol 1e-4 of the JAX tool's;
* ``vocode_converted`` with the posterior noise of the device phase
  injected into both (as ``test_torch_decode_pair.py`` does) and greedy
  vocoding: metrics within rtol 1e-4 of the JAX tool's;
* ``reeval_criterion`` on an experiment of the port's ``run_train``: each
  checkpoint's replayed eval criterion equals that epoch's history entry,
  and the JAX tool, handed the same eval outputs, picks the same winners;
* the Geyer ESS estimator and ``flops_per_frame`` equal the JAX tools'.
"""

import ast
import importlib.util
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models import wavernn as jw
from cyclevae_tpu.pipeline import decode as jd
from cyclevae_tpu.pipeline import vocoder_stage as jv
from cyclevae_tpu.utils.hdf5 import write_hdf5
from cyclevae_tpu.vi import checkpoint as jc
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.pipeline import decode as td
from cyclevae_tpu_torch.pipeline import train_stage as tts
from cyclevae_tpu_torch.tools import (bench, bench_battery, bench_decode_fusion,
                                      bench_hmc_chains, bench_hmc_trajlen, bench_nuts,
                                      bench_scaling, bench_smc_particles, bench_stage6_wall,
                                      bench_step_breakdown, diag_smc_amortized,
                                      reeval_criterion, speech_corpus, train_eval_vocoder,
                                      vocode_converted)
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
from cyclevae_tpu_torch.utils.config import save_config
from cyclevae_tpu_torch.utils.store import write_store
from cyclevae_tpu_torch.utils.wavio import read_wav, write_wav

from test_torch_dsp import FS, synth_speechlike

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SRC, TRG = "VCC2SM1", "VCC2TF1"       # bundled speaker bounds: 60-199 Hz, 138-343 Hz
HU = 16
RTOL = 1e-4


def _jax_tool(name):
    """A JAX tool module, loaded from ``tools/<name>.py`` (or the root)."""
    path = ROOT / "tools" / f"{name}.py"
    if not path.exists():
        path = ROOT / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _jax_tool(name).main()


def _both_stores(path_no_ext, data):
    """One feature or stats file as the JAX package's .h5 and the port's .npz."""
    os.makedirs(os.path.dirname(path_no_ext), exist_ok=True)
    for k, v in data.items():
        write_hdf5(path_no_ext + ".h5", k, v)
        write_store(path_no_ext + ".npz", k, v)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Speech-like wavs from seeds (train: 2 of the target speaker; eval: 1
    of each), the target's train features in both stores, a WaveRNN at
    hu16 trained 1 epoch by the JAX package's ``run_train_vocoder``, and a
    hu16 CycleVAE experiment (JAX weights, epoch 1, stats in both stores)."""
    root = tmp_path_factory.mktemp("tools")
    wav_root, work = root / "wav", root / "work"
    wavs = {}
    for rel, f0, dur, seed in ((f"{TRG}/u0", 220.0, 0.4, 1), (f"{TRG}/u1", 230.0, 0.45, 2),
                               (f"eval/{SRC}/e0", 120.0, 0.3, 3),
                               (f"eval/{TRG}/e0", 215.0, 0.3, 4)):
        path = wav_root / f"{rel}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(path), FS, synth_speechlike(f0, dur, seed=seed))
        wavs[rel] = str(path)
    exp = ExperimentConfig()
    h5s = []
    for i in range(2):
        fs, x = read_wav(wavs[f"{TRG}/u{i}"], cutoff=int(exp.feature.highpass_cutoff))
        feat = td._feat_from_wav(x, fs, 138.0, 343.0, -45.5, exp.feature)["feat"]
        stem = str(work / "hdf5" / TRG / f"u{i}")
        _both_stores(stem, {"/feat_org_lf0": feat})
        h5s.append(stem + ".h5")
    voc_exp = work / "exp" / f"vocoder_{TRG}_hu{HU}"
    jv.run_train_vocoder(jw.WaveRNNConfig(hidden_units=HU), [wavs[f"{TRG}/u0"],
                                                             wavs[f"{TRG}/u1"]],
                         h5s, str(voc_exp), epochs=1, batch_size=2, clip_frames=8)

    # for vocode_converted: the same checkpoint with its output bias spread
    # (as test_torch_vocoder_train.py spreads it), so that the greedy
    # argmax over the 256 classes has no near-ties that float32 sums in
    # another order (XLA's against torch's) could flip
    ckpt = jc.load_checkpoint(str(voc_exp / "checkpoint-latest.pkl"))
    b = ckpt["params"]["fc2"]["b"]
    ckpt["params"]["fc2"]["b"] = (2.0 * np.random.default_rng(2).normal(size=b.shape)
                                  ).astype(np.float32)
    wide_exp = work / "exp" / f"vocoder_{TRG}_hu{HU}_wide"
    wide_exp.mkdir(parents=True)
    with open(wide_exp / "checkpoint-latest.pkl", "wb") as f:
        pickle.dump(ckpt, f)

    # the CycleVAE experiment for vocode_converted
    cexp = ExperimentConfig(model=ModelConfig(hidden_units=HU, spk_src=SRC, spk_trg=TRG))
    cfg_path = str(root / "exp.json")
    save_config(cexp, cfg_path)
    expdir = work / "exp" / cexp.name()
    rng = np.random.default_rng(0)
    mean, scale = rng.normal(size=54) * 0.1, 1.0 + rng.random(54)
    jc.save_checkpoint(str(expdir), jax_init(jax.random.PRNGKey(0), JaxConfig(hidden_units=HU),
                                             mean.astype(np.float32),
                                             scale.astype(np.float32)),
                       {}, jax.random.PRNGKey(1), np.random.default_rng(1), 1)
    with open(expdir / "history.json", "w") as f:
        json.dump({"history": [], "best": {"criterion": 1.0, "epoch": 1}}, f)
    model_id = f"{cexp.name()}_ep1"
    for spk, lf0 in ((SRC, np.log(120.0)), (TRG, np.log(215.0))):
        gv = 0.01 + rng.random(50) * 0.1
        stats = {"/lf0_range_mean": np.float64(lf0), "/lf0_range_std": np.float64(0.1),
                 "/gv_range_mean": gv}
        if spk == SRC:
            stats[f"/cvgv_mean_{model_id}"] = gv[1:] * (0.5 + rng.random(49))
        _both_stores(str(work / "stats" / f"stats_{spk}"), stats)
    return dict(wav_root=str(wav_root), work=str(work), voc_exp=str(voc_exp),
                wide_exp=str(wide_exp), cfg=cfg_path)


def test_train_eval_vocoder_eval_only_matches_jax(corpus, tmp_path, monkeypatch):
    argv = ["--work", corpus["work"], "--speaker", TRG, "--wav-root", corpus["wav_root"],
            "--eval-only", "--temperature", "0", "--hidden-units", str(HU),
            "--n-train", "2", "--n-eval", "1"]
    _run_jax_tool("train_eval_vocoder", argv + ["--out", str(tmp_path / "jax.json")],
                  monkeypatch)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    got = train_eval_vocoder.main(argv + ["--out", str(tmp_path / "port.json"),
                                          "--device", "cpu"])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert set(got) == set(want) | {"device", "launches"} and got["device"] == "cpu"
    assert sorted(got["copy_synthesis"]) == sorted(want["copy_synthesis"])
    for k, v in want["copy_synthesis"].items():
        np.testing.assert_allclose(got["copy_synthesis"][k], v, rtol=RTOL, equal_nan=True,
                                   err_msg=k)
    assert np.isfinite(got["copy_synthesis"]["mcd"])


def test_vocode_converted_matches_jax(corpus, tmp_path, monkeypatch):
    """The device phase's posterior noise injected into both tools (the
    draws of the two frameworks cannot match), greedy vocoding: all twelve
    metrics within rtol 1e-4.  The vocoder's output bias is spread (the
    fixture): with the checkpoint as trained, the greedy argmax flips at a
    near-tie on float32 sums taken in another order (XLA's, torch's), and
    the AR sampler's waveform parts there (mcdpow_cv_voc 1.5e-3 apart)."""
    n_smpl, lat = 300, 32
    eps = np.random.default_rng(6).normal(size=(n_smpl, 2, 200, lat)).astype(np.float32)

    def jax_device_decode_pair(codec, key, src_feat, trg_feat):
        lens = [len(src_feat), len(trg_feat)]
        lat_, _ = codec.encode_mean(jax.random.PRNGKey(0), [src_feat, trg_feat])
        z = [np.asarray(jnp.mean(l[..., :lat] + jnp.exp(l[..., lat:] / 2.0) * eps[:, i, :n],
                                 axis=0)) for i, (l, n) in enumerate(zip(lat_, lens))]
        T, Tt = lens
        return (*lat_, *codec.decode_batch([(jd._speaker_codes(T, 2, 1), z[0]),
                                            (jd._speaker_codes(T, 2, 0), z[0]),
                                            (jd._speaker_codes(Tt, 2, 1), z[1])]))

    def port_device_decode_pair(codec, generator, src_feat, trg_feat):
        n = max(len(src_feat), len(trg_feat))
        return td.device_decode_pair(codec, None, src_feat, trg_feat, eps=eps[:, :, :n])

    argv = ["--work", corpus["work"], "--config", corpus["cfg"], "--vocoder-exp",
            corpus["wide_exp"], "--hidden-units", str(HU), "--wav-root", corpus["wav_root"],
            "--n-eval", "1", "--temperature", "0"]
    monkeypatch.setattr(jd, "device_decode_pair", jax_device_decode_pair)
    _run_jax_tool("vocode_converted", argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)["metrics"]
    monkeypatch.setattr(vocode_converted, "device_decode_pair", port_device_decode_pair)
    got = vocode_converted.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert set(got) == {"model", "vocoder_exp", "temperature", "n_eval", "metrics", "device",
                        "launches"}
    assert sorted(got["metrics"]) == sorted(want) and len(want) == 12
    for k in want:
        np.testing.assert_allclose(got["metrics"][k], want[k], rtol=RTOL, atol=1e-9,
                                   equal_nan=True, err_msg=k)
    assert all(np.isfinite(v) for v in got["metrics"].values())


# ---------------------------------------------------------------------------
# reeval_criterion on an experiment of the port's run_train
# ---------------------------------------------------------------------------

SEG = 20
LENS = {"SPKA": [57, 31, 80, 97], "SPKB": [60, 44, 71, 90]}
EVAL_LENS = {"SPKA": [66, 40], "SPKB": [49, 52]}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A work directory in the recipe's layout (features and stats in both
    stores) and a hu16 experiment trained 2 epochs by the port's
    ``run_train`` (its checkpoints and history)."""
    root = tmp_path_factory.mktemp("reeval")
    work = root / "work"
    rng = np.random.default_rng(0)

    def feats(T):
        walk = np.cumsum(rng.normal(size=(T, 54)), axis=0) * 0.05
        f = walk - walk.mean(axis=0) + 0.1 * rng.normal(size=(T, 54))
        f[:, 0] = (np.arange(T) % 9 > 2)
        f[:, 1] += 5.0
        return f

    def utt(rel, T):
        f = feats(T)
        _both_stores(str(work / "hdf5" / rel),
                     {"/feat_org_lf0": f, "/cvuvlogf0fil_ap": f[:, :4] + 0.01,
                      "/spcidx_range": np.asarray(np.where(f[:, 5] > -0.05))})
        return str(work / "hdf5" / rel) + ".npz"

    files = {f"{spk}/u{i}": utt(f"{spk}/u{i}", T) for spk in LENS for i, T in
             enumerate(LENS[spk])}
    files.update({f"eval/{spk}/e{i}": utt(f"eval/{spk}/e{i}", T) for spk in EVAL_LENS
                  for i, T in enumerate(EVAL_LENS[spk])})
    allf = np.concatenate([feats(50) for _ in range(4)])
    _both_stores(str(work / "stats" / "stats_jnt"),
                 {"/mean_feat_org_lf0_jnt": allf.mean(axis=0),
                  "/scale_feat_org_lf0_jnt": allf.std(axis=0)})
    for spk in LENS:
        _both_stores(str(work / "stats" / f"stats_{spk}"),
                     {"/gv_range_mean": 0.01 + rng.random(50) * 0.1})

    exp = ExperimentConfig(
        model=ModelConfig(hidden_units=HU, spk_src="SPKA", spk_trg="SPKB"),
        train=TrainConfig(batch_size=SEG, batch_size_utt=2, batch_size_utt_eval=1,
                          epoch_count=2, lr=1e-3))
    cfg_path = str(root / "exp.json")
    save_config(exp, cfg_path)
    f = lambda keys: [files[k] for k in keys]
    expdir = str(work / "exp" / exp.name())
    tts.run_train(exp, f(["SPKA/u0", "SPKA/u1"]), f(["SPKB/u0", "SPKB/u1"]),
                  f(["SPKB/u2", "SPKB/u3"]), f(["SPKA/u2", "SPKA/u3"]),
                  f(["eval/SPKA/e0", "eval/SPKA/e1"]), f(["eval/SPKB/e0", "eval/SPKB/e1"]),
                  str(work / "stats" / "stats_SPKA.npz"), str(work / "stats" / "stats_SPKB.npz"),
                  str(work / "stats" / "stats_jnt.npz"), expdir, device="cpu")
    (root / "wav").mkdir()
    return dict(work=str(work), cfg=cfg_path, expdir=expdir, wav_root=str(root / "wav"))


def test_reeval_replays_each_eval_epoch(experiment):
    with open(os.path.join(experiment["expdir"], "history.json")) as f:
        hist = json.load(f)
    got = reeval_criterion.main(["--work", experiment["work"], "--config", experiment["cfg"],
                                 "--wav-root", experiment["wav_root"], "--device", "cpu"])
    assert [r["epoch"] for r in got["results"]] == [1, 2]
    for r, h in zip(got["results"], hist["history"]):
        assert r["epoch"] == h["epoch"]
        np.testing.assert_allclose(r["criterion_src"], h["eval"]["criterion"], rtol=1e-6)
        assert np.isfinite(r["criterion_pooled"])
    assert got["best_src"]["epoch"] == hist["best"]["epoch"]
    with open(os.path.join(experiment["expdir"], "criteria.json")) as f:
        assert set(json.load(f)) == {"results", "best_src", "device", "launches"}


def test_reeval_picks_the_jax_tools_winners(experiment, monkeypatch):
    """The JAX tool over the same checkpoints and eval features, its eval
    forward handing back the port's outputs for each batch (the same
    numbers): the same criteria, the same src-only and pooled winners, and
    ``--patch-history`` writes the same ``best``."""
    from cyclevae_tpu.vi import train as jt
    from cyclevae_tpu_torch.interop import params_from_jax
    from cyclevae_tpu_torch.models.gru_vae import Draws
    from cyclevae_tpu_torch.utils.config import load_config
    from cyclevae_tpu_torch.vi.train import make_eval_forward

    port_eval = make_eval_forward(tts.model_config(load_config(experiment["cfg"])))

    def jax_make_eval_forward(cfg):
        def eval_fn(params, key, batch):
            seed = int(np.asarray(key)[-1])          # PRNGKey(seed) holds [0, seed]
            outs = port_eval(params_from_jax(params, device="cpu"),
                             Draws(torch.Generator().manual_seed(seed)),
                             {k: np.asarray(v) for k, v in batch.items()})
            return {k: jnp.asarray(v.numpy()) for k, v in outs.items()}
        return eval_fn

    monkeypatch.setattr(jt, "make_eval_forward", jax_make_eval_forward)
    hp = os.path.join(experiment["expdir"], "history.json")
    with open(hp) as f:
        hist0 = json.load(f)
    argv = ["--work", experiment["work"], "--config", experiment["cfg"]]
    try:
        _run_jax_tool("reeval_criterion", argv + ["--patch-history"], monkeypatch)
        with open(os.path.join(experiment["expdir"], "criteria.json")) as f:
            want = json.load(f)
        with open(hp) as f:
            jax_best = json.load(f)["best"]
        with open(hp, "w") as f:
            json.dump(hist0, f)
        got = reeval_criterion.main(argv + ["--wav-root", experiment["wav_root"],
                                            "--patch-history", "--device", "cpu"])
        with open(hp) as f:
            port_best = json.load(f)["best"]
    finally:
        with open(hp, "w") as f:
            json.dump(hist0, f)
    for g, w in zip(got["results"], want["results"]):
        assert g["epoch"] == w["epoch"]
        for k in ("criterion_src", "criterion_pooled"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    assert got["best_src"]["epoch"] == want["best_src"]["epoch"]
    pooled = lambda rs: min(rs, key=lambda r: r["criterion_pooled"])["epoch"]
    assert pooled(got["results"]) == pooled(want["results"])
    assert port_best["epoch"] == jax_best["epoch"]
    np.testing.assert_allclose(port_best["criterion"], jax_best["criterion"], rtol=1e-6)


# ---------------------------------------------------------------------------
# every tool: a small run on the CPU, the JAX tool's keys plus the device
# ---------------------------------------------------------------------------

HMC_ROW = {"chains", "adapt_mass", "iter_ms", "samples_per_sec_per_chip", "accept",
           "da_step_size", "ess_fraction", "ess_per_sec_per_chip", "grad_evals_per_sec"}
NUTS_ROW = {"chains", "max_depth", "target_accept", "iter_ms", "samples_per_sec_per_chip",
            "grad_evals_per_sec_per_chip", "mean_leapfrog_per_iter", "leapfrog_cap",
            "saturation_rate", "accept_stat", "divergence_rate", "da_step_size"}
SMC_ROW = {"particles", "filter_ms", "particle_steps_per_sec_per_chip", "log_marginal",
           "mean_ess", "resample_rate"}
# name: (module, argv, the JAX tool's top-level keys; bench's nominal peak
# is the card's, not the v5e's, and bench_scaling's ranks are processes)
TOOLS = {
    "bench": (bench, [], {"metric", "platform", "value", "unit", "vs_baseline", "best_variant",
                          "variants", "model_flops_per_frame_fwd", "train_model_tflops_per_sec",
                          "nominal_bf16_peak_tflops", "measured_bf16_peak_tflops", "mfu",
                          "mfu_vs_session_probe", "measured_rtt_ms"}),
    "bench_hmc_chains": (bench_hmc_chains,
                         ["--frames", "12", "--chains", "2", "3", "--iters", "3", "--warmup",
                          "2", "--n-leapfrog", "2"],
                         {"metric", "platform", "params", "frames", "lat_dim", "n_leapfrog",
                          "n_warmup_da", "target_accept", "value", "best_chains", "best_mode",
                          "best_ess_per_sec_per_chip", "best_ess_row", "sweep"}),
    "bench_hmc_trajlen": (bench_hmc_trajlen,
                          ["--chains", "2", "--iters", "2", "--warmup", "2", "--points",
                           "2,0.9,on", "3,0.7,off"],
                          {"metric", "value", "unit", "best_point", "chains", "iters", "mode",
                           "n_faulting_points", "ess_estimator_note", "rows"}),
    "bench_nuts": (bench_nuts,
                   ["--frames", "12", "--chains", "2", "--max-depths", "2", "3", "--iters", "2",
                    "--warmup", "2"],
                   {"metric", "platform", "params", "data", "frames", "lat_dim", "max_depths",
                    "target_accepts", "value", "best_chains", "best_mode", "best_max_depth",
                    "best_saturation_rate", "headline_is_nonsaturated", "sweep"}),
    "bench_smc_particles": (bench_smc_particles,
                            ["--frames", "12", "--particles", "8", "16", "--reps", "1"],
                            {"metric", "platform", "params", "frames", "data", "obs_scale",
                             "value", "best_particles", "best_proposal", "sweep"}),
    "diag_smc_amortized": (diag_smc_amortized,
                           ["--frames", "12", "--particles", "8", "--obs-scales", "1", "50"],
                           {"params", "data", "frames", "particles",
                            "mean_kl_q_prior_per_frame", "cells"}),
    "bench_step_breakdown": (bench_step_breakdown, ["2", "--K", "1"],
                             {"metric", "config", "fwd_us", "fwd_bwd_us", "adam_us",
                              "full_step_us", "bwd_over_fwd", "frames_per_sec_full_step"}),
    "bench_scaling": (bench_scaling, ["--frames", "8", "--ranks", "1", "2"],
                      {"metric", "workload", "platform", "processes",
                       "ranks_share_one_device", "host_cores", "fixed_work", "weak_scaling",
                       "note"}),
}


@pytest.fixture
def small(monkeypatch):
    for mod in (bench_hmc_chains, bench_nuts, bench_smc_particles, diag_smc_amortized,
                bench_step_breakdown, bench_scaling):
        monkeypatch.setattr(mod, "HIDDEN_UNITS", HU)
    monkeypatch.setattr(bench, "MODEL", dict(hidden_units=HU))
    monkeypatch.setattr(bench, "TIMED_STEPS", 1)
    monkeypatch.setattr(bench, "VARIANTS", [v for v in bench.VARIANTS if v[2] <= 5] + [
        ("f32_scan_bsu2", dict(use_pallas=False), 2)])
    monkeypatch.setattr(bench_scaling, "HMC", dict(step_size=0.05, n_leapfrog=1, n_warmup=1,
                                                   n_samples=2))


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_on_cpu_with_the_jax_keys(name, small, tmp_path):
    mod, argv, keys = TOOLS[name]
    out = str(tmp_path / "out.json")
    got = mod.main(argv + ["--out", out, "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert keys | {"device"} <= set(got), keys - set(got)
    assert got["device"] == "cpu"
    if name == "bench":
        assert all(isinstance(v, float) and v > 0 for v in got["variants"].values())
        assert got["best_variant"] in got["variants"]
    elif name in ("bench_hmc_chains", "bench_nuts"):
        rows = [r for rs in got["sweep"].values() for r in rs]
        assert len(rows) == (8 if name == "bench_hmc_chains" else 2)
        assert all((HMC_ROW if name == "bench_hmc_chains" else NUTS_ROW) <= set(r)
                   and r["finite"] and r["k2_launches_per_iter"] == 0 for r in rows)
    elif name == "bench_hmc_trajlen":
        assert [r["n_leapfrog"] for r in got["rows"]] == [2, 3]
        assert got["n_faulting_points"] == 0 and HMC_ROW <= set(got["rows"][0])
    elif name == "bench_smc_particles":
        assert sorted(got["sweep"]) == ["amortized", "amortized_w0.5", "prior"]
        assert all(SMC_ROW <= set(r) for rs in got["sweep"].values() for r in rs)
    elif name == "diag_smc_amortized":
        assert [c["obs_scale"] for c in got["cells"]] == [1.0, 50.0]
        assert all(c["amortized_wins"] in (True, False) for c in got["cells"])
    elif name == "bench_step_breakdown":
        assert got["config"] == "bf16_pallas_bsu2" and got["finite"]
    elif name == "bench_scaling":
        assert sorted(got["fixed_work"]) == sorted(got["weak_scaling"]) == ["1", "2"]


def test_trajlen_records_a_failing_point_and_goes_on(small, tmp_path, monkeypatch):
    real = bench_hmc_chains.main

    def flaky(argv):
        if argv[argv.index("--n-leapfrog") + 1] == "3":
            raise RuntimeError("launch failed")
        return real(argv)

    monkeypatch.setattr(bench_hmc_chains, "main", flaky)
    got = bench_hmc_trajlen.main(["--chains", "2", "--iters", "2", "--warmup", "2", "--points",
                                  "3,0.9,on", "2,0.9,off", "--out", str(tmp_path / "t.json"),
                                  "--device", "cpu"])
    assert got["n_faulting_points"] == 1
    assert got["rows"][0] == {"n_leapfrog": 3, "target_accept": 0.9, "adapt_mass": True,
                              "fault": True, "error": "RuntimeError: launch failed"}
    assert got["best_point"]["n_leapfrog"] == 2


REQUIRED = {"train_eval_vocoder": ["--work", "w", "--wav-root", "r"],
            "vocode_converted": ["--work", "w", "--wav-root", "r", "--config", "c",
                                 "--vocoder-exp", "v"],
            "reeval_criterion": ["--work", "w", "--wav-root", "r", "--config", "c"],
            "bench_stage6_wall": ["--work", "w", "--wav-root", "r"],
            "bench_battery": ["quiet", "--work", "w", "--wav-root", "r"]}
# the fusion bench's checkpoint and model json are positional
POSITIONAL = {"bench_decode_fusion": ["ckpt.pkl", "model.json"]}
MODULES = {"train_eval_vocoder": train_eval_vocoder, "vocode_converted": vocode_converted,
           "reeval_criterion": reeval_criterion, "bench_stage6_wall": bench_stage6_wall,
           "bench_battery": bench_battery, "bench_decode_fusion": bench_decode_fusion}


@pytest.mark.parametrize("name", list(TOOLS) + list(REQUIRED) + list(POSITIONAL))
def test_tool_raises_without_cuda(name, monkeypatch, tmp_path):
    """No ``--device``: the card, and without one an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = TOOLS[name][0] if name in TOOLS else MODULES[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(REQUIRED.get(name, POSITIONAL.get(name, [])))
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", list(REQUIRED) + list(POSITIONAL))
def test_corpus_paths_are_required_flags(name):
    """No default path outside the repository: --wav-root and --work have
    none, nor the fusion bench's checkpoint and model."""
    mod = MODULES[name]
    argv = REQUIRED.get(name, POSITIONAL.get(name))
    dropped = [argv[:i] + argv[i + 2:] for i, a in enumerate(argv) if a in ("--wav-root", "--work")]
    if name in POSITIONAL:
        dropped = [argv[:1]]
    assert dropped
    for short in dropped:
        with pytest.raises(SystemExit):
            mod.main(short + ["--device", "cpu"])


def _jax_ess_fraction():
    """``ess_fraction`` as the JAX tool defines it, nested in its ``main``."""
    src = (ROOT / "tools" / "bench_hmc_chains.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "ess_fraction")
    scope = {"np": np}
    exec(compile(ast.Module([fn], []), "bench_hmc_chains.py", "exec"), scope)
    return scope["ess_fraction"]


@pytest.mark.parametrize("case", ["ar1", "white", "constant_chain", "short"])
def test_ess_estimator_equals_the_jax_tools(case):
    rng = np.random.default_rng(3)
    S, C = (48, 5) if case != "short" else (3, 2)
    if case == "ar1":
        x = np.zeros((S, C))
        for t in range(1, S):
            x[t] = 0.9 * x[t - 1] + rng.normal(size=C)
    else:
        x = rng.normal(size=(S, C))
    if case == "constant_chain":
        x[:, 1] = 2.0
    assert bench_hmc_chains.ess_fraction(x) == _jax_ess_fraction()(x)


@pytest.mark.parametrize("kw", [{}, dict(hidden_units=16, n_cyc=1), dict(n_spk=3, lat_dim=16)])
def test_flops_per_frame_equals_the_jax_bench(kw):
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig
    assert bench.flops_per_frame(CycleVAEConfig(**kw)) == \
        _jax_tool("bench").flops_per_frame(JaxConfig(**kw))


def test_speech_corpus_layout_and_seeds(tmp_path):
    """The measuring corpus: <spk>/*.wav and eval/<spk>/*.wav of each
    speaker, made from the seed (the same seed, the same samples)."""
    got = speech_corpus.main(["--root", str(tmp_path / "a"), "--n-utts", "2", "--n-eval", "1"])
    speech_corpus.main(["--root", str(tmp_path / "b"), "--n-utts", "2", "--n-eval", "1"])
    for spk, f0 in speech_corpus.SPEAKERS:
        names = sorted(os.listdir(os.path.join(got["wav_root"], spk)))
        assert names == ["utt000.wav", "utt001.wav"]
        assert os.listdir(os.path.join(got["wav_root"], "eval", spk)) == ["e0.wav"]
        fs, x = read_wav(os.path.join(got["wav_root"], spk, "utt001.wav"))
        fs_b, x_b = read_wav(str(tmp_path / "b" / "wav" / spk / "utt001.wav"))
        assert fs == fs_b == speech_corpus.FS and len(x) == int(2.5 * fs)
        np.testing.assert_array_equal(x, x_b)
