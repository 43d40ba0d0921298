"""The port's last three tools on the CPU at hu16.

* stage 6 of the port's recipe with ``CYCLEVAE_PREFETCH`` 1 and 0 writes
  bitwise-equal metrics and wavs over 3 eval pairs (the premise of the
  stage-6 wall-time A/B);
* ``bench_stage6_wall`` runs both through the recipe's command line, with
  the JAX tool's keys plus ``device``, ``n_pairs`` and ``outputs_equal``;
* ``bench_decode_fusion``: the sequential path (the reference's 5 calls)
  and the fused ``device_decode_pair`` agree within 1e-5 on the same
  injected noise, and the tool writes the JAX tool's keys;
* ``bench_battery``: a failing bench or one whose last line is not JSON
  writes no artifact and the battery reports failure, a good bench's last
  line is its artifact, a bench past its limit or what it leaves running
  is stopped, ``--ref-pid`` is stopped during the quiet phase and continued
  after it, also when a bench fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.pipeline import recipe as trecipe
from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair
from cyclevae_tpu_torch.pipeline.features import extract_one
from cyclevae_tpu_torch.pipeline.train_stage import model_config
from cyclevae_tpu_torch.tools import bench_battery, bench_decode_fusion, bench_stage6_wall
from cyclevae_tpu_torch.utils.config import (ExperimentConfig, ModelConfig, TrainConfig,
                                             save_config)
from cyclevae_tpu_torch.utils.wavio import write_wav
from cyclevae_tpu_torch.vi.checkpoint import load_checkpoint, save_checkpoint
from cyclevae_tpu_torch.vi.train import CycleVAEParams, init_cyclevae, make_optimizer

from test_e2e_pipeline import FS, synth_speechlike

torch.set_num_threads(2)

SPEAKERS = {"SPKA": (120.0, "70 400", "-25"), "SPKB": (220.0, "100 500", "-25")}
MODEL = dict(hidden_units=16, n_cyc=1, spk_src="SPKA", spk_trg="SPKB")
TRAIN = dict(batch_size=40, batch_size_utt=2, batch_size_utt_eval=2, epoch_count=1, lr=1e-3)
N_PAIRS = 3
EVAL_SECONDS = 0.7
# the JAX tools' JSON keys (tools/bench_stage6_wall.py, tools/bench_decode_fusion.py)
STAGE6_KEYS = {"metric", "value", "sequential_baseline_s", "overlap_speedup", "decode_epoch",
               "r3_prefusion_quiet_host_s", "r4_contended_s"}
FUSION_KEYS = {"metric", "fused_ms", "sequential_ms", "speedup", "frames"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """3 train and 3 eval speech-like wavs per speaker (as
    tests/test_torch_recipe.py makes them), the speakers' conf files, stage
    1's features extracted in this process (``extract_one`` per wav: the
    recipe's spawned workers would pay their imports), then the port's
    recipe a2345 on them at hu16."""
    root = tmp_path_factory.mktemp("stage6")
    exp = ExperimentConfig(model=ModelConfig(**MODEL), train=TrainConfig(**TRAIN))
    paths = trecipe.RecipePaths(wav_root=str(root / "wav"), work=str(root / "work"), n_train=2)
    for spk, (f0, bounds, pw) in SPEAKERS.items():
        for d in (root / "wav" / spk, root / "wav" / "eval" / spk, root / "conf"):
            os.makedirs(d, exist_ok=True)
        for i in range(3):
            write_wav(str(root / "wav" / spk / f"u{i}.wav"), FS,
                      synth_speechlike(f0 * (1 + 0.1 * i), 1.0, seed=i))
        for i in range(N_PAIRS):
            write_wav(str(root / "wav" / "eval" / spk / f"e{i}.wav"), FS,
                      synth_speechlike(f0 * (1.02 + 0.03 * i), EVAL_SECONDS, seed=90 + i))
        (root / "conf" / f"{spk}.f0").write_text(bounds)
        (root / "conf" / f"{spk}.pow").write_text(pw)
        minf0, maxf0 = map(float, bounds.split())
        for eval_set in (False, True):
            os.makedirs(paths.h5dir(spk, eval_set))
            for wav in paths.wavs(spk, eval_set):
                store = os.path.join(paths.h5dir(spk, eval_set),
                                     os.path.basename(wav)[:-4] + ".npz")
                extract_one(wav, store, None, exp.feature, minf0, maxf0, float(pw))
    config = str(root / "exp.json")
    save_config(exp, config)
    trecipe.run_stages("a2345", exp, paths, conf_dir=str(root / "conf"), device="cpu")
    return dict(exp=exp, paths=paths, config=config, conf=str(root / "conf"),
                expdir=os.path.join(paths.work, "exp", exp.name()))


def _stage6_outputs(expdir):
    """decode_metrics_ep1.json and the bytes of every converted wav."""
    with open(os.path.join(expdir, "decode_metrics_ep1.json")) as f:
        got = {"metrics": json.load(f)}
    wavdir = os.path.join(expdir, "wav_cv_ep1")
    for name in sorted(os.listdir(wavdir)):
        with open(os.path.join(wavdir, name), "rb") as f:
            got[name] = f.read()
    return got


def test_stage6_prefetch_on_and_off_write_the_same_outputs(run, monkeypatch):
    outs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("CYCLEVAE_PREFETCH", flag)
        bench_stage6_wall.clear_outputs(run["expdir"], 1)
        trecipe.run_stages("6", run["exp"], run["paths"], conf_dir=run["conf"], n_jobs=2,
                           device="cpu")
        outs.append(_stage6_outputs(run["expdir"]))
    assert len(outs[0]) == 1 + 8 * N_PAIRS
    assert all(np.isfinite(v) for v in outs[0]["metrics"].values())
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for name in outs[0]:
        assert outs[0][name] == outs[1][name], name


def _stage6_argv(run, out):
    return ["--work", run["paths"].work, "--wav-root", run["paths"].wav_root,
            "--config", run["config"], "--conf-dir", run["conf"], "--n-jobs", "2",
            "--out", str(out), "--device", "cpu"]


def test_bench_stage6_wall_runs_both_and_holds_them_equal(run, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = tmp_path / "s6.json"
    got = bench_stage6_wall.main(_stage6_argv(run, out))
    with open(out) as f:
        assert json.load(f) == got
    assert STAGE6_KEYS | {"device", "n_pairs", "outputs_equal"} <= set(got)
    assert got["metric"] == f"stage6_wall_seconds_{N_PAIRS}_pairs_quiet_host"
    assert got["n_pairs"] == N_PAIRS and got["decode_epoch"] == 1 and got["device"] == "cpu"
    assert got["outputs_equal"] is True
    assert got["value"] > 0 and got["sequential_baseline_s"] > 0 and got["overlap_speedup"] > 0
    assert got["r3_prefusion_quiet_host_s"] is None and got["r4_contended_s"] is None
    assert len(_stage6_outputs(run["expdir"])) == 1 + 8 * N_PAIRS


def test_bench_stage6_wall_skip_baseline(run, tmp_path, monkeypatch):
    """One run, prefetch on, and a null baseline (the stage-6 process and
    its outputs stubbed)."""
    calls = []

    def stage6(work, wav_root, config, epoch, prefetch, device, conf_dir=None, n_jobs=None):
        calls.append((epoch, prefetch, device, n_jobs))
        return 1.5

    monkeypatch.setattr(bench_stage6_wall, "run_stage6", stage6)
    monkeypatch.setattr(bench_stage6_wall, "clear_outputs", lambda expdir, epoch: None)
    monkeypatch.setattr(bench_stage6_wall, "read_outputs", lambda expdir, epoch: {})
    got = bench_stage6_wall.main(_stage6_argv(run, tmp_path / "s6.json") + ["--skip-baseline"])
    assert calls == [(1, True, "cpu", 2)]
    assert got["value"] == 1.5 and got["n_pairs"] == N_PAIRS
    assert got["sequential_baseline_s"] is None and got["overlap_speedup"] is None
    assert got["outputs_equal"] is None


@pytest.fixture(scope="module")
def fusion_ckpt(tmp_path_factory):
    """A hu16 checkpoint of a fresh init, written by the port's
    ``save_checkpoint``, and its model.json."""
    d = tmp_path_factory.mktemp("fusion")
    exp = ExperimentConfig(model=ModelConfig(hidden_units=16))
    cfg = model_config(exp)
    rng = np.random.default_rng(0)
    mean, scale = 0.1 * rng.normal(size=54), 1.0 + rng.random(54)
    params = init_cyclevae(torch.Generator().manual_seed(0), cfg, mean.astype(np.float32),
                           scale.astype(np.float32), device="cpu")
    ckpt = save_checkpoint(str(d), params, make_optimizer(cfg).init(params),
                           torch.Generator().manual_seed(1), np.random.default_rng(1), 1)
    save_config(exp, str(d / "model.json"))
    return ckpt, str(d / "model.json"), cfg


@pytest.mark.parametrize("T", [600, 500])
def test_decode_fusion_paths_agree_on_injected_noise(fusion_ckpt, T):
    """Within 1e-5 everywhere but at one bucket boundary: at T = 600 the
    fused path pads the 560-frame target to the source's 1120-frame bucket,
    where sequentially it fills its own 560 frames, so its last
    rec_field / 2 = 4 latent frames see padding frames (normalized zeros)
    in place of the window's zero pad (``Codec``), and the last 8 converted
    frames see those latents through the decoder's window.  At T = 500 both
    utterances take one 560-frame bucket: every frame agrees."""
    ckpt, _, cfg = fusion_ckpt
    codec = Codec(CycleVAEParams(*load_checkpoint(ckpt)["params"]), cfg, device="cpu")
    rng = np.random.default_rng(0)          # the tool's features
    feat = rng.normal(size=(T, cfg.in_dim)).astype(np.float32)
    feat_trg = rng.normal(size=(T - 40, cfg.in_dim)).astype(np.float32)
    eps = np.random.default_rng(5).normal(
        size=(codec.n_smpl_dec, 2, T, cfg.lat_dim)).astype(np.float32)
    fused = device_decode_pair(codec, None, feat, feat_trg, eps=eps)
    seq = bench_decode_fusion.seq_pair(codec, None, feat, feat_trg, eps=eps)
    boundary = {"lat_trg": 4, "cvmcep_trg": 8} if T == 600 else {}
    names = ("lat_src", "lat_trg", "cvmcep", "cvmcep_src", "cvmcep_trg")
    for name, s, f in zip(names, seq, fused):
        assert s.shape == f.shape, name
        n = len(s) - boundary.get(name, 0)
        np.testing.assert_allclose(s[:n], f[:n], rtol=0, atol=1e-5, err_msg=name)
        if name in boundary:
            assert np.abs(s[n:] - f[n:]).max() > 1e-5, name
    assert fused[2].shape == (T, cfg.out_dim) and fused[4].shape == (T - 40, cfg.out_dim)


def test_decode_fusion_tool_writes_the_jax_keys(fusion_ckpt, tmp_path):
    ckpt, model_json, _ = fusion_ckpt
    out = tmp_path / "fusion.json"
    got = bench_decode_fusion.main([ckpt, model_json, "--frames", "100", "--reps", "2",
                                    "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == got
    assert FUSION_KEYS | {"device"} <= set(got) and got["device"] == "cpu"
    assert got["metric"] == "stage6_device_path_ms_per_pair" and got["frames"] == 100
    assert got["fused_ms"] > 0 and got["sequential_ms"] > 0 and got["speedup"] > 0
    assert got["measured_rtt_ms"] is None
    # on the CPU the wrappers run K1's plain version: no launch
    assert got["k1_launches_fused"] == got["k1_launches_sequential"] == 0


# ---------------------------------------------------------------------------
# the battery
# ---------------------------------------------------------------------------

def _py(code):
    return [sys.executable, "-c", "import json, sys, time\n" + code]


def _proc_state(pid):
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


def test_battery_writes_only_parsed_artifacts_and_reports_failures(tmp_path, monkeypatch):
    out_dir, log_dir = tmp_path / "out", tmp_path / "log"
    stubs = [
        bench_battery.Bench("good", 60, "GOOD.json", _py("print('warming up')\n"
                                                         "print(json.dumps({'a': 1}))")),
        bench_battery.Bench("fails", 60, "FAILS.json", _py("print(json.dumps({'a': 1}))\n"
                                                           "sys.exit(1)")),
        bench_battery.Bench("not_json", 60, "NOT_JSON.json", _py("print('{\"a\": 1}')\n"
                                                                 "print('done')")),
        bench_battery.Bench("own_artifact", 60, None, _py("print('wrote its own')")),
        bench_battery.Bench("too_slow", 1, "SLOW.json", _py("time.sleep(60)")),
    ]
    monkeypatch.setattr(bench_battery, "benches", lambda phase, args, device, log: stubs)
    got = bench_battery.main(["infer", "--device", "cpu", "--out-dir", str(out_dir),
                              "--log-dir", str(log_dir)])
    assert got["failed"] == ["fails", "not_json", "too_slow"] and got["ok"] is False
    assert sorted(os.listdir(out_dir)) == ["GOOD.json"]
    assert (out_dir / "GOOD.json").read_text() == '{"a": 1}\n'
    assert (log_dir / "good.out").read_text().splitlines()[0] == "warming up"
    assert [r["name"] for r in got["benches"]] == [b.name for b in stubs]


def test_battery_stops_what_a_bench_leaves_running(tmp_path):
    pid_file = tmp_path / "pid"
    bench = bench_battery.Bench("leaves_a_child", 60, None, _py(
        "import subprocess\n"
        f"p = subprocess.Popen(['sleep', '60'])\nopen({str(pid_file)!r}, 'w').write(str(p.pid))"))
    assert bench_battery.run_bench(bench, str(tmp_path), str(tmp_path))
    pid = int(pid_file.read_text())
    deadline = time.monotonic() + 10
    while os.path.exists(f"/proc/{pid}") and _proc_state(pid) != "Z":
        assert time.monotonic() < deadline, "the bench's child is still running"
        time.sleep(0.05)


def test_battery_pauses_ref_pid_around_the_quiet_phase(tmp_path, monkeypatch):
    ref = subprocess.Popen(["sleep", "60"])
    try:
        stubs = [
            bench_battery.Bench("state", 60, "STATE.json", _py(
                f"print(json.dumps(open('/proc/{ref.pid}/stat').read().rsplit(')', 1)[1]"
                ".split()[0]))")),
            bench_battery.Bench("fails", 60, "FAILS.json", _py("sys.exit(3)")),
        ]
        monkeypatch.setattr(bench_battery, "benches", lambda phase, args, device, log: stubs)
        got = bench_battery.main(["quiet", "--work", str(tmp_path), "--wav-root", str(tmp_path),
                                  "--ref-pid", str(ref.pid), "--device", "cpu",
                                  "--out-dir", str(tmp_path / "out")])
        assert got["failed"] == ["fails"]
        assert (tmp_path / "out" / "STATE.json").read_text() == '"T"\n'
        assert _proc_state(ref.pid) in ("S", "R")
    finally:
        ref.kill()
        ref.wait()


def test_battery_quiet_table_and_runner_on_the_fusion_tool(run, fusion_ckpt, tmp_path):
    """The quiet phase's benches from the experiment (its best epoch's
    checkpoint and model.json), and the runner on the real fusion tool as a
    process: its artifact is its last stdout line."""
    class Args:
        work, wav_root, config = run["paths"].work, run["paths"].wav_root, run["config"]
        decode_epoch, conf_dir, n_jobs, out_dir = None, run["conf"], 2, str(tmp_path)

    table = bench_battery.benches("quiet", Args, "cpu", str(tmp_path))
    assert [(b.name, b.timeout, b.artifact) for b in table] == [
        ("bench", 2400, "BENCH_TORCH_TRAIN.json"),
        ("bench_step_breakdown", 1800, "BENCH_TORCH_STEP_BREAKDOWN.json"),
        ("bench_decode_fusion", 1200, "BENCH_TORCH_DECODE_FUSION.json"),
        ("bench_stage6_wall", 2400, "BENCH_TORCH_STAGE6_WALL.json")]
    fusion = table[2].cmd
    assert fusion[:3] == [sys.executable, "-m", "cyclevae_tpu_torch.tools.bench_decode_fusion"]
    assert fusion[3:5] == [os.path.join(run["expdir"], "checkpoint-1.pkl"),
                           os.path.join(run["expdir"], "model.json")]
    assert all(os.path.exists(p) for p in fusion[3:5]) and fusion[-2:] == ["--device", "cpu"]
    assert table[3].cmd[table[3].cmd.index("--decode-epoch") + 1] == "1"

    ckpt, model_json, _ = fusion_ckpt
    bench = bench_battery.Bench("bench_decode_fusion", 300, "FUSION.json", [
        sys.executable, "-m", "cyclevae_tpu_torch.tools.bench_decode_fusion", ckpt, model_json,
        "--frames", "60", "--reps", "1", "--out", str(tmp_path / "own.json"), "--device", "cpu"])
    assert bench_battery.run_bench(bench, str(tmp_path), str(tmp_path))
    last = (tmp_path / "bench_decode_fusion.out").read_text().splitlines()[-1]
    assert (tmp_path / "FUSION.json").read_text() == last + "\n"
    assert json.loads(last) == json.loads((tmp_path / "own.json").read_text())
