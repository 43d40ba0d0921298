"""The port's one-to-one recipe (``pipeline/recipe.py``, ``python -m
cyclevae_tpu_torch``) end to end on the CPU at a tiny size (hu16, n_cyc 1,
1.0 s synthetic wavs), against the JAX recipe on the same corpus: stages 1-3
bitwise equal, stages 4-6 complete, resume reproducing epoch 2, stages i
and v (both vocoder branches) and their artifacts, the JAX recipe's flags."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from cyclevae_tpu.pipeline import recipe as jrecipe
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.config import ModelConfig as JaxModelConfig
from cyclevae_tpu.utils.config import TrainConfig as JaxTrainConfig
from cyclevae_tpu_torch.pipeline import recipe as trecipe
from cyclevae_tpu_torch.pipeline.train_stage import run_train
from cyclevae_tpu_torch.utils.config import (ExperimentConfig, ModelConfig, TrainConfig,
                                             save_config)
from cyclevae_tpu_torch.utils.store import read_store
from cyclevae_tpu_torch.utils.wavio import write_wav

from test_e2e_pipeline import FS, synth_speechlike
from test_torch_stats import _h5_all, _npz_all

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SPEAKERS = {"SPKA": (120.0, "70 400", "-25"), "SPKB": (220.0, "100 500", "-25")}
MODEL = dict(hidden_units=16, n_cyc=1, spk_src="SPKA", spk_trg="SPKB")
TRAIN = dict(batch_size=40, batch_size_utt=2, batch_size_utt_eval=2, epoch_count=1, lr=1e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 train wavs and 1 eval wav per speaker (as tests/test_e2e_pipeline.py
    makes them), and the speakers' analysis bounds as conf files."""
    root = tmp_path_factory.mktemp("recipe")
    for spk, (f0, bounds, pw) in SPEAKERS.items():
        for d in (root / "wav" / spk, root / "wav" / "eval" / spk, root / "conf"):
            os.makedirs(d, exist_ok=True)
        for i in range(3):
            write_wav(str(root / "wav" / spk / f"u{i}.wav"), FS,
                      synth_speechlike(f0 * (1 + 0.1 * i), 1.0, seed=i))
        write_wav(str(root / "wav" / "eval" / spk / "e0.wav"), FS,
                  synth_speechlike(f0 * 1.05, 1.0, seed=99))
        (root / "conf" / f"{spk}.f0").write_text(bounds)
        (root / "conf" / f"{spk}.pow").write_text(pw)
    return root


def _port_exp(**train):
    return ExperimentConfig(model=ModelConfig(**MODEL), train=TrainConfig(**{**TRAIN, **train}))


@pytest.fixture(scope="module")
def runs(corpus):
    """The JAX recipe's stages 1-3 and the port's stages 1a23456."""
    jax_paths = jrecipe.RecipePaths(wav_root=str(corpus / "wav"), work=str(corpus / "jax"),
                                    n_train=2)
    jrecipe.run_stages("123", JaxExperiment(model=JaxModelConfig(**MODEL),
                                            train=JaxTrainConfig(**TRAIN)),
                       jax_paths, conf_dir=str(corpus / "conf"), n_jobs=2)
    paths = trecipe.RecipePaths(wav_root=str(corpus / "wav"), work=str(corpus / "port"),
                                n_train=2)
    exp = _port_exp()
    trecipe.run_stages("1a23456", exp, paths, conf_dir=str(corpus / "conf"), n_jobs=2,
                       device="cpu")
    return jax_paths, paths, exp


def test_port_recipe_end_to_end(runs):
    _, paths, exp = runs
    expdir = os.path.join(paths.work, "exp", exp.name())
    hist = json.load(open(os.path.join(expdir, "history.json")))
    assert hist["best"]["epoch"] == 1 and np.isfinite(hist["best"]["criterion"])
    assert np.isfinite(hist["history"][0]["train"]["loss"])
    assert sorted(f for f in os.listdir(expdir) if f.startswith("checkpoint")) == \
        ["checkpoint-1.pkl", "checkpoint-final.pkl", "checkpoint-latest.pkl"]
    dm = json.load(open(os.path.join(expdir, "decode_metrics_ep1.json")))
    assert len(dm) == 18 and all(np.isfinite(v) for v in dm.values())
    wavs = sorted(os.listdir(os.path.join(expdir, "wav_cv_ep1")))
    assert len(wavs) == 8 and all(w.startswith("e0_") and w.endswith(".wav") for w in wavs)
    for w in wavs:
        rate, y = wavfile.read(os.path.join(expdir, "wav_cv_ep1", w))
        assert rate == FS and len(y) > FS // 2 and np.abs(y).max() > 0
    model_id = f"{exp.name()}_ep1"
    for key in ("cvgv", "cvgvsrc", "cvgvtrg"):
        for m in ("mean", "var"):
            v = read_store(paths.stats("SPKA"), f"/{key}_{m}_{model_id}")
            assert v.shape == (49,) and np.isfinite(v).all()
    for spk in SPEAKERS:
        for name in (f"{spk}.f0.txt", f"{spk}.pow.txt"):
            assert os.path.getsize(os.path.join(paths.work, "init_spk_stat", name)) > 0
    saved = json.load(open(os.path.join(expdir, "model.json")))
    assert saved["model"]["use_pallas"] is True      # the port's default route


def test_stage_1_to_3_artifacts_bitwise_equal_to_jax(runs):
    jax_paths, paths, _ = runs
    n = 0
    for spk in SPEAKERS:
        for eval_set in (False, True):
            want_files = jax_paths.h5s(spk, eval_set)
            got_files = paths.h5s(spk, eval_set)
            assert [os.path.basename(f)[:-4] for f in got_files] == \
                [os.path.basename(f)[:-3] for f in want_files]
            for g, w in zip(got_files, want_files):
                got, want = _npz_all(g), _h5_all(w)
                assert sorted(got) == sorted(want) and "cvuvlogf0fil_ap" in got
                for k in want:
                    wk = np.asarray(want[k])
                    assert got[k].dtype == wk.dtype and got[k].shape == wk.shape, (g, k)
                    np.testing.assert_array_equal(got[k], wk, err_msg=f"{g}:{k}")
                n += 1
        for w in sorted(os.listdir(os.path.join(jax_paths.work, "wav_anasyn", spk))):
            rg, yg = wavfile.read(os.path.join(paths.work, "wav_anasyn", spk, w))
            rw, yw = wavfile.read(os.path.join(jax_paths.work, "wav_anasyn", spk, w))
            assert rg == rw
            np.testing.assert_array_equal(yg, yw)
    assert n == 8
    for got, want in ((paths.stats("SPKA"), jax_paths.stats("SPKA")),
                      (paths.stats("SPKB"), jax_paths.stats("SPKB")),
                      (paths.stats_jnt(), jax_paths.stats_jnt())):
        g, w = _npz_all(got), _h5_all(want)
        # the port's source stats also hold stage 5's cvgv statistics
        assert sorted(k for k in g if not k.startswith("cvgv")) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_resume_reproduces_trajectory(runs, tmp_path):
    """Resume from the epoch-1 checkpoint reproduces epoch 2 (the JAX
    package's bounds, tests/test_e2e_pipeline.py)."""
    _, paths, _ = runs
    kwargs = dict(
        feats_src=paths.h5s("SPKA")[:2], feats_src_pair=paths.h5s("SPKB")[:2],
        feats_trg=paths.h5s("SPKB")[:2], feats_trg_pair=paths.h5s("SPKA")[:2],
        feats_eval_src=paths.h5s("SPKA", True), feats_eval_trg=paths.h5s("SPKB", True),
        stats_src=paths.stats("SPKA"), stats_trg=paths.stats("SPKB"),
        stats_jnt=paths.stats_jnt(), device="cpu")
    res_a = run_train(_port_exp(epoch_count=2), expdir=str(tmp_path / "a"), **kwargs)
    run_train(_port_exp(epoch_count=1), expdir=str(tmp_path / "b"), **kwargs)
    res_b = run_train(_port_exp(epoch_count=2), expdir=str(tmp_path / "b"),
                      resume=str(tmp_path / "b" / "checkpoint-1.pkl"), **kwargs)
    a, b = res_a["history"][-1], res_b["history"][-1]
    assert a["epoch"] == b["epoch"] == 2
    assert [h["epoch"] for h in res_b["history"]] == [1, 2]
    assert abs(a["train"]["loss"] - b["train"]["loss"]) < 1e-3 * abs(a["train"]["loss"])
    assert abs(a["eval"]["criterion"] - b["eval"]["criterion"]) < 1e-4


@pytest.fixture
def small_hmc(monkeypatch):
    """Stage i's HMC cut to 2 chains of 2 + 2 steps (the recipe passes the
    stage's defaults: 8 chains, 100 + 100 steps of 8 leapfrogs)."""
    from cyclevae_tpu_torch.infer import HMCConfig
    from cyclevae_tpu_torch.pipeline import infer_stage

    run = infer_stage.run_infer_stage
    monkeypatch.setattr(infer_stage, "run_infer_stage", lambda *a, **k: run(
        *a, n_chains=2, n_predictive=3, hmc=HMCConfig(0.05, 2, 2, 2), **k))


def test_stage_i_writes_the_posterior(runs, small_hmc):
    """Stage i on the trained model: per eval utterance of the source
    speaker the posterior and predictive statistics, in the store."""
    _, paths, exp = runs
    trecipe.run_stages("i", exp, paths, conf_dir=None, device="cpu")
    out = os.path.join(paths.work, "exp", exp.name(), "posterior_ep1.npz")
    T = len(read_store(paths.h5s("SPKA", True)[0], "/feat_org_lf0"))
    for k, dim in (("z_mean", 32), ("z_std", 32), ("cv_mcep_mean", 50), ("cv_mcep_std", 50)):
        v = read_store(out, f"/e0/{k}")
        assert v.shape == (T, dim) and np.isfinite(v).all(), k
    assert np.all(read_store(out, "/e0/z_std") >= 0)


def _vocoder_checks(vexpdir, epochs, eval_dirs):
    hist = json.load(open(os.path.join(vexpdir, "history.json")))["history"]
    assert [h["epoch"] for h in hist] == list(range(1, epochs + 1))
    assert all(np.isfinite(h["nll"]) and h["nll"] > 0 for h in hist)
    assert sorted(f for f in os.listdir(vexpdir) if f.endswith(".pkl")) == \
        [f"checkpoint-{epochs}.pkl", "checkpoint-latest.pkl"]
    ev = json.load(open(os.path.join(vexpdir, "vocoder_eval.json")))
    assert ev["epochs"] == epochs and ev["final_nll"] == hist[-1]["nll"]
    for d in eval_dirs:
        rate, y = wavfile.read(os.path.join(vexpdir, d, "e0.wav"))
        assert rate == FS and len(y) > FS // 2
    return ev


@pytest.mark.parametrize("multispk", [False, True])
def test_stage_v_trains_and_scores(runs, multispk):
    """Stage v: the target speaker's WaveRNN (or, ``vocoder_multispk``, one
    model of both speakers under a speaker code) trained for 2 epochs on its
    train wavs and features, then copy synthesis of its eval utterance(s)."""
    _, paths, exp = runs
    trecipe.run_stages("v", exp, paths, conf_dir=None, device="cpu", vocoder_epochs=2,
                       vocoder_clip_frames=8, vocoder_n_eval=1, vocoder_hidden_units=16,
                       vocoder_multispk=multispk, vocoder_lr_decay=multispk)
    if multispk:
        ev = _vocoder_checks(os.path.join(paths.work, "exp", "vocoder_multispk_hu16"), 2,
                             ["wav_vocoded_SPKA", "wav_vocoded_SPKB"])
        assert ev["speakers"] == ["SPKA", "SPKB"] and sorted(ev["copy_synthesis"]) == \
            ["SPKA", "SPKB"]
        aggs = list(ev["copy_synthesis"].values())
    else:
        ev = _vocoder_checks(os.path.join(paths.work, "exp", "vocoder_SPKB_hu16"), 2,
                             ["wav_vocoded"])
        assert ev["speaker"] == "SPKB"
        aggs = [ev["copy_synthesis"]]
    for agg in aggs:
        assert sorted(agg) == sorted(k + s for k in ("mcdpow", "mcd", "f0_rel_err_median",
                                                     "uv_agree") for s in ("", "_std"))
        assert np.isfinite(agg["mcd"]) and 0.0 <= agg["uv_agree"] <= 1.0


def test_cli_runs_stages_i_and_v(runs, small_hmc, tmp_path):
    """``--stage iv`` through the CLI's ``main`` on a copy of the trained
    run: the posterior file and a vocoder of 1 epoch without copy synthesis."""
    import shutil
    _, paths, exp = runs
    work = tmp_path / "work"
    os.makedirs(work / "exp")
    os.symlink(os.path.join(paths.work, "hdf5"), work / "hdf5")
    shutil.copytree(os.path.join(paths.work, "exp", exp.name()), work / "exp" / exp.name())
    save_config(exp, str(tmp_path / "exp.json"))
    trecipe.main(["--stage", "iv", "--work", str(work), "--wav-root", paths.wav_root,
                  "--config", str(tmp_path / "exp.json"), "--n-train", "2",
                  "--vocoder-epochs", "1", "--vocoder-clip-frames", "8", "--vocoder-n-eval",
                  "0", "--vocoder-hidden-units", "16", "--device", "cpu"])
    assert os.path.exists(work / "exp" / exp.name() / "posterior_ep1.npz")
    ev = json.load(open(work / "exp" / "vocoder_SPKB_hu16" / "vocoder_eval.json"))
    assert ev["epochs"] == 1 and ev["copy_synthesis"] == {}


ARGV = ["--stage", "1a23456", "--work", "W", "--wav-root", "R", "--conf-dir", "C",
        "--n-jobs", "3", "--n-train", "5", "--epochs", "7", "--decode-epoch", "4",
        "--resume", "ck.pkl", "--vocoder-epochs", "11", "--vocoder-clip-frames", "48",
        "--vocoder-n-eval", "2", "--vocoder-hidden-units", "64", "--vocoder-resume", "v.pkl",
        "--vocoder-temperature", "0.5", "--vocoder-multispk", "--vocoder-lr-decay"]


def test_main_parses_the_jax_flags(monkeypatch, tmp_path):
    """The same command line reaches both recipes' ``run_stages`` with the
    same values; the port's also takes ``--device``."""
    seen = {}

    def capture(side):
        def run_stages(stages, exp, paths, **kw):
            seen[side] = (stages, exp.train.epoch_count, exp.train.resume, paths.wav_root,
                          paths.work, paths.n_train, kw)
        return run_stages

    monkeypatch.setattr(jrecipe, "run_stages", capture("jax"))
    monkeypatch.setattr(trecipe, "run_stages", capture("port"))
    cfg = tmp_path / "exp.json"
    save_config(_port_exp(), str(cfg))
    jrecipe.main(ARGV + ["--config", str(cfg)])
    trecipe.main(ARGV + ["--config", str(cfg), "--device", "cpu"])
    port_kw = seen["port"][-1]
    assert port_kw.pop("device") == "cpu"
    assert seen["port"][:-1] == seen["jax"][:-1]
    assert port_kw == seen["jax"][-1]
    assert seen["port"][:3] == ("1a23456", 7, "ck.pkl")
    trecipe.main(["--work", "W", "--wav-root", "R"])
    assert seen["port"][0] == "123456" and seen["port"][-1]["device"] is None


def test_cli_needs_cuda_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trecipe.main(["--stage", "2", "--work", str(tmp_path / "w"), "--wav-root",
                      str(tmp_path)])
    assert not os.path.exists(tmp_path / "w")


def test_python_m_entry_point_runs_a_stage(runs, tmp_path):
    """``python -m cyclevae_tpu_torch`` runs the recipe: stage a on the
    port's features, with ``--device cpu``."""
    _, paths, _ = runs
    work = tmp_path / "work"
    os.makedirs(work)
    os.symlink(os.path.join(paths.work, "hdf5"), work / "hdf5")
    save_config(_port_exp(), str(tmp_path / "exp.json"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "cyclevae_tpu_torch", "--stage", "a", "--work", str(work),
         "--wav-root", paths.wav_root, "--config", str(tmp_path / "exp.json"),
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(work / "init_spk_stat"))[:2] == ["SPKA.f0.txt", "SPKA.pow.txt"]
    assert "stage a SPKA suggested conf" in res.stderr
