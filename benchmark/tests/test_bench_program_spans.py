"""The readers of the program's own spans and counters: over a synthetic
store their arithmetic, against a program without the recorder nothing
(the parent commit's case), and in a traced run of each cell at a tiny size
on the CPU the counts the program makes."""

import types

import pytest

from benchmark.harness import core
from benchmark.tests._small import SMALL, run_small
from cyclevae_tpu_torch.utils import profiling
from cyclevae_tpu_torch.utils.profiling import Span

NEW = ("convert.host_ms", "convert.device_wait_ms", "convert.device_waits_per_request",
       "vocode.host_ms", "infer.logjoint_evals_per_transition")
READERS = {n: core.load_module(core.HERE / "metrics" / f"{n}.py", f"t_metric_{n}") for n in NEW}
MS = 1_000_000     # ns


def _window(**totals):
    w = core.Window({}, {})
    w.units = [dict(totals)]
    return w


def _store(monkeypatch, spans, counts):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))


def _request(first_id, t0, root, parts):
    """A root span at ``t0`` ms and its children, each (name, start ms,
    length ms) from the root's start; ids from ``first_id``."""
    r = first_id
    out = [Span(n, (t0 + s) * MS, (t0 + s + d) * MS, r + 1 + i, r, r)
           for i, (n, s, d) in enumerate(parts)]
    end = max([t0 * MS] + [sp.end_ns for sp in out]) + MS
    return out + [Span(root, t0 * MS, end, r, None, r)]


def test_conversion_readers_over_a_synthetic_store(monkeypatch):
    # two requests: 10 ms with waits of 3 + 1 ms; 20 ms with waits of 5 + 2 + 1 ms
    a = _request(0, 0, "decode.device_decode_pair",
                 [("codec.encode_mean", 0, 6), ("fetch", 2, 3), ("fetch", 5, 1),
                  ("codec.decode_batch", 6, 3)])
    b = _request(10, 50, "decode.device_decode_pair",
                 [("codec.encode_mean", 0, 12), ("fetch", 3, 5), ("fetch", 8, 2),
                  ("fetch", 15, 1), ("codec.unpack", 17, 2)])
    # a span of another root is not a conversion request's
    other = _request(20, 100, "vocoder.synthesize", [("fetch", 0, 40)])
    _store(monkeypatch, a + b + other, {"device_waits": 6, "logjoint.evals": 90})
    assert [sp.seconds for sp in (a[-1], b[-1])] == [0.010, 0.020]
    w = _window(requests=2, transitions=5)
    assert READERS["convert.host_ms"].read(w) == pytest.approx(((10 - 4) + (20 - 8)) / 2)
    assert READERS["convert.device_wait_ms"].read(w) == pytest.approx((4 + 8) / 2)
    assert READERS["convert.device_waits_per_request"].read(w) == 3.0
    assert READERS["infer.logjoint_evals_per_transition"].read(w) == 18.0
    # every root (41 ms with a 40 ms wait besides the two) over two requests
    assert READERS["vocode.host_ms"].read(w) == pytest.approx((6 + 12 + 1) / 2)


def test_vocoder_reader_sums_every_top_level_span(monkeypatch):
    spans = (_request(0, 0, "decode.device_decode_pair", [("fetch", 1, 2)])     # 4 ms
             + [Span("vocoder.postfilter", 5 * MS, 6 * MS, 5, None, 5)]       # 1 ms
             + _request(6, 7, "vocoder.synthesize",
                        [("vocoder.upsample", 0, 1), ("vocoder.generate", 1, 2),
                         ("fetch", 3, 30)]))                                    # 34 ms
    _store(monkeypatch, spans, {})
    assert READERS["vocode.host_ms"].read(_window(requests=1)) == pytest.approx(2 + 1 + 4)
    assert READERS["convert.device_waits_per_request"].read(_window(requests=1)) is None
    assert READERS["infer.logjoint_evals_per_transition"].read(_window(transitions=1)) is None


def test_an_empty_store_reads_nothing(monkeypatch):
    _store(monkeypatch, [], {})
    w = _window(requests=3, transitions=3)
    assert all(READERS[n].read(w) is None for n in NEW)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The parent commit's ``utils.profiling`` has no store: every reader
    gives None and raises nothing."""
    bare = types.ModuleType("profiling")
    for r in READERS.values():
        monkeypatch.setattr(r, "profiling", bare)
    w = _window(requests=3, transitions=3)
    assert all(READERS[n].read(w) is None for n in NEW)


@pytest.mark.parametrize("cell,want", [
    ("o2o-convert", {"convert.device_waits_per_request": 3.0}),
    ("voc-vocode", {}),
    ("o2o-infer-hmc",
     {"infer.logjoint_evals_per_transition": 2.0 * SMALL["traffic"]["n_leapfrog"] + 2}),
])
def test_traced_runs_read_the_program_counts(cell, want):
    """A traced tiny run: the spans record only inside the profiled window
    (set-up's warm-up and the check after the window are not in the store),
    so the counts come out exactly; the times are positive."""
    profiling.reset()
    r = run_small(cell, trace=True)
    got = {n: m["value"] for n, m in r["metrics"].items() if n in NEW}
    assert set(got) == {m["name"] for m in core.Cell(cell).per_layer if m["name"] in NEW}
    for name, value in got.items():
        assert value == want[name] if name in want else value > 0, (name, value)
