"""``cyclevae_tpu_torch.utils.profiling`` on the CPU: ``measure_steps`` counts
its calls and carries the state, ``trace`` writes a Chrome trace."""

import json
import os

import torch

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
