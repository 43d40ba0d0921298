"""``cyclevae_tpu_torch.utils.profiling`` on the CPU: ``measure_steps`` counts
its calls and carries the state, ``trace`` writes a Chrome trace; the span
and counter recorder is off unless a profiler or ``recording()`` is on,
nests spans by thread into requests, and the program records its spans and
counters where the work happens (the conversion engine's device waits, the
vocoder stage, the inference stage's log-joint evaluations, the kernel
build)."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.utils import profiling
from cyclevae_tpu_torch.utils.profiling import measure_steps, trace


def test_measure_steps_counts_calls_and_carries_state():
    calls = []

    def step(state, batch):
        calls.append(state)
        return state + batch, {"loss": torch.tensor(float(state))}

    out = measure_steps(step, 0, 2, n_steps=5, warmup=3)
    assert calls == [0, 2, 4, 6, 8, 10, 12, 14]        # 3 warm-up + 5 timed, chained
    assert out["state"] == 16
    assert len(out["step_seconds"]) == 5 and all(s >= 0 for s in out["step_seconds"])
    assert sorted(out["step_seconds"])[2] == out["median_seconds"]
    assert abs(out["seconds_per_step"] * 5 - sum(out["step_seconds"])) < 1e-9
    assert abs(out["steps_per_sec"] * out["seconds_per_step"] - 1.0) < 1e-9


def test_measure_steps_syncs_once_after_warmup_and_once_after_the_window():
    syncs = []
    out = measure_steps(lambda s, b: (s, None), 1, None, n_steps=4, warmup=2,
                        sync=lambda: syncs.append(1))
    assert syncs == [1, 1] and out["state"] == 1


def test_measure_steps_times_on_the_card_by_default(monkeypatch):
    """With CUDA available and nothing passed, the steps are timed with CUDA
    events (one before the window, one after each step) and the window ends
    with ``torch.cuda.synchronize``."""
    log = []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing
            self.at = None

        def record(self):
            self.at = len(log)
            log.append("record")

        def elapsed_time(self, other):
            return float(other.at - self.at)      # milliseconds

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.append("sync"))

    def step(state, batch):
        log.append("step")
        return state + 1, None

    out = measure_steps(step, 0, None, n_steps=3, warmup=1)
    assert log == ["step", "sync", "record", "step", "record", "step", "record", "step",
                   "record", "sync"]
    assert out["state"] == 4
    assert out["step_seconds"] == [2e-3, 2e-3, 2e-3] and out["median_seconds"] == 2e-3


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "t" / "trace.json"
    assert os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages() is not None


def _by_name(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp)
    return out


def test_nothing_is_recorded_when_off():
    profiling.reset()
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b                      # one shared null context
    with a:
        profiling.count("c", 3)
        assert torch.equal(profiling.fetch(torch.ones(2)), torch.ones(2))
    assert profiling.spans() == [] and profiling.counters() == {}


def test_spans_nest_into_requests_under_recording():
    with profiling.recording():
        with profiling.span("root"):
            with profiling.span("child"):
                with profiling.span("leaf"):
                    profiling.count("n")
                profiling.count("n", 2)
            with profiling.span("child"):
                pass
        with profiling.span("root"):
            pass
    assert profiling.counters() == {"n": 3}
    got = _by_name(profiling.spans())
    r1, r2 = got["root"]
    c1, c2 = got["child"]
    (leaf,) = got["leaf"]
    assert r1.parent is None and r2.parent is None and r1.request != r2.request
    assert r1.request == r1.id and r2.request == r2.id
    assert c1.parent == c2.parent == r1.id and leaf.parent == c1.id
    assert {c1.request, c2.request, leaf.request} == {r1.request}
    assert r1.start_ns <= c1.start_ns <= leaf.start_ns <= leaf.end_ns <= c1.end_ns \
        <= c2.start_ns <= c2.end_ns <= r1.end_ns <= r2.start_ns
    assert [sp.name for sp in profiling.spans()] == ["leaf", "child", "child", "root", "root"]
    # recording() starts from an empty store and leaves recording off
    with profiling.recording():
        assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.span("x") is profiling.span("y")


def test_threads_keep_separate_stacks():
    """Two threads open spans at once: each thread's spans nest in its own
    root, and the roots are two requests."""
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"root.{tag}"):
            barrier.wait()           # both roots open
            with profiling.span(f"child.{tag}"):
                barrier.wait()       # both children open

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {sp.name: sp for sp in profiling.spans()}
    assert len(got) == 4
    for tag in "ab":
        root, child = got[f"root.{tag}"], got[f"child.{tag}"]
        assert root.parent is None and child.parent == root.id
        assert child.request == root.request
    assert got["root.a"].request != got["root.b"].request


def test_the_store_is_capped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3 and profiling.counters() == {"spans.dropped": 2}


def test_spans_are_profiler_ranges_around_their_operations():
    """Under ``torch.profiler`` (no ``recording()``) the spans record, and
    each is a range among the profiler's events that holds the operations
    issued inside it; ``trace`` empties the store on entry."""
    profiling.reset()
    with profiling.recording():
        with profiling.span("stale"):
            pass
    x = torch.ones(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.reset()
        with profiling.span("t.outer"):
            y = x @ x
            with profiling.span("t.inner"):
                profiling.count("t.n")
                z = torch.relu(y)
    assert float(z.sum()) > 0
    got = _by_name(profiling.spans())
    assert sorted(got) == ["t.inner", "t.outer"] and profiling.counters() == {"t.n": 1}
    events = prof.events()
    ranges = {e.name: e.time_range for e in events if e.name in got}
    assert sorted(ranges) == ["t.inner", "t.outer"]
    inside = lambda op, span: any(
        e.name == op and ranges[span].start <= e.time_range.start
        and e.time_range.end <= ranges[span].end for e in events)
    assert inside("aten::mm", "t.outer") and inside("aten::relu", "t.outer")
    assert inside("aten::relu", "t.inner") and not inside("aten::mm", "t.inner")
    # off again once the profiler has stopped
    assert profiling.span("a") is profiling.span("b")


def test_trace_resets_the_store_and_carries_the_spans(tmp_path):
    with profiling.recording():
        with profiling.span("stale"):
            pass
    with trace(str(tmp_path / "t")):
        with profiling.span("t.span"):
            torch.ones(4) + 1
    assert [sp.name for sp in profiling.spans()] == ["t.span"]
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "t.span" for e in events)


@pytest.fixture(scope="module")
def tiny_cyclevae():
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae
    cfg = CycleVAEConfig(hidden_units=8, lat_dim=4)
    return cfg, init_cyclevae(torch.Generator().manual_seed(0), cfg, device="cpu")


def test_a_conversion_request_waits_on_the_device_three_times(tiny_cyclevae):
    """``device_decode_pair`` on a CPU ``Codec``: one request, its spans
    under its root, and since its device phase is one run of
    ``Codec.convert_pair``'s phase (a graph replay on a card) one ``fetch``
    span, a child of the root, counted as one device wait, and no replay
    (the CPU runs the phase directly: a count of 0), where the encode and the decode
    fetched three times (the name is kept from then)."""
    from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair
    cfg, params = tiny_cyclevae
    codec = Codec(params, cfg, n_smpl_dec=4, bucket=16, device="cpu")
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(n, 54)).astype(np.float32) for n in (20, 13)]
    with profiling.recording():
        out = device_decode_pair(codec, torch.Generator().manual_seed(1), *feats)
    assert [o.shape for o in out] == [(20, 8), (13, 8), (20, 50), (20, 50), (13, 50)]
    spans = profiling.spans()
    got = _by_name(spans)
    (root,) = got["decode.device_decode_pair"]
    assert root.parent is None and {sp.request for sp in spans} == {root.request}
    assert profiling.counters() == {"device_waits": 1, "codec.pair_replays": 0}
    (wait,), (conv,), (pack,) = got["fetch"], got["codec.convert_pair"], got["codec.pack"]
    assert wait.parent == conv.parent == root.id and pack.parent == conv.id
    assert conv.end_ns <= wait.start_ns
    assert set(got) == {"decode.device_decode_pair", "codec.convert_pair", "codec.pack",
                        "fetch"}


def test_hmc_counts_L_logjoint_evaluations_a_transition_plus_one_a_run(tiny_cyclevae):
    """``posterior_convert_hmc`` on the tiny CPU log-joint: L batched
    evaluations a transition, warm-up and sampling alike, and one at the
    run's start (each point's value and gradient are carried), and its
    spans: two warm-up phases, the sampling and the predictive under one
    request."""
    from cyclevae_tpu_torch.infer import Draws, HMCConfig
    from cyclevae_tpu_torch.pipeline.infer_stage import posterior_convert_hmc
    cfg, params = tiny_cyclevae
    feats = np.random.default_rng(2).normal(size=(6, 54)).astype(np.float32)
    for L, warm, n in ((2, 3, 2), (3, 4, 1)):
        with profiling.recording():
            out = posterior_convert_hmc(params, cfg, feats, 0, 1,
                                        Draws(torch.Generator().manual_seed(3)), n_chains=2,
                                        hmc=HMCConfig(0.05, L, warm, n), n_predictive=2)
        assert out["cv_mcep_mean"].shape == (6, 50)
        assert profiling.counters() == {"logjoint.evals": 1 + L * (warm + n),
                                        "device_waits": 6}
        got = _by_name(profiling.spans())
        (root,) = got["infer.posterior_convert_hmc"]
        assert len(got["hmc.warmup"]) == 2 and len(got["hmc.sample"]) == 1
        (pred,) = got["infer.predictive"]
        assert all(sp.parent == pred.id for sp in got["fetch"])
        assert {sp.request for sp in profiling.spans()} == {root.request}


def test_the_vocoder_stage_records_its_spans():
    from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, init_wavernn
    from cyclevae_tpu_torch.pipeline.decode import gv_postfilter
    from cyclevae_tpu_torch.pipeline.features import convert_f0
    from cyclevae_tpu_torch.pipeline.vocoder_stage import (converted_conditioning,
                                                           synthesize_vocoder)
    cfg = WaveRNNConfig(hidden_units=8, n_classes=16, embed_dim=4, cond_dim=4, fc_dim=4)
    params = init_wavernn(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    src = rng.normal(size=(6, 54)).astype(np.float32)
    cv = rng.normal(size=(6, 50))
    with profiling.recording():
        cv = gv_postfilter(cv, np.ones(49), np.full(49, 2.0))
        f0 = convert_f0(np.array([0.0, 120, 130, 0, 125, 0]), 4.8, 0.2, 5.3, 0.25)
        feat = converted_conditioning(src, cv, f0, 5.0)
        y = synthesize_vocoder(params, cfg, feat, seed=1, device="cpu")
    assert y.shape[0] > 0 and profiling.counters() == {"device_waits": 1}
    got = _by_name(profiling.spans())
    roots = [sp.name for sp in profiling.spans() if sp.parent is None]
    assert roots == ["vocoder.postfilter", "vocoder.convert_f0", "vocoder.conditioning",
                     "vocoder.synthesize"]
    (synth,) = got["vocoder.synthesize"]
    assert [sp.parent for n in ("vocoder.upsample", "vocoder.generate", "fetch")
            for sp in got[n]] == [synth.id] * 3


def test_a_kernel_build_is_a_span(monkeypatch):
    """``ops._build.load`` records ``kernel.build`` around the build and
    the load of a library it has not opened yet, and nothing once it has."""
    from cyclevae_tpu_torch.ops import _build

    class Lib:
        def __init__(self, path):
            self.cuda_error_string = type("F", (), {})()

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", lambda names, defines: {n: "lib.so" for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    with profiling.recording():
        first = _build.load("k")
        assert _build.load("k") is first
    assert [sp.name for sp in profiling.spans()] == ["kernel.build"]
