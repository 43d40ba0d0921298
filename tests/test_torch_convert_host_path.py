"""The host path of ``device_decode_pair`` (``Codec.convert_pair``: the
device phase of each padded length, a CUDA graph on a card, run directly
here) on the CPU: its five outputs bitwise those of ``Codec.encode_mean``
then ``Codec.decode_batch`` on the same draws, with their dtypes; its
counter ``codec.pair_replays``, one a graph replay, which records nothing
untraced and 0 where the phase runs directly; and the benchmark's reader
of that counter, in traced runs of the cell ``o2o-convert`` at a tiny size
with and without a stand-in for the graph, and against a program without
the counter."""

import types

import numpy as np
import pytest
import torch

from benchmark.harness import core
from cyclevae_tpu_torch.pipeline import decode
from cyclevae_tpu_torch.pipeline.decode import Codec, _speaker_codes, device_decode_pair
from cyclevae_tpu_torch.utils import profiling
from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

REPLAYS = "convert.pair_replays_per_request"


@pytest.fixture(scope="module")
def codec():
    cfg = CycleVAEConfig(hidden_units=8, lat_dim=4)
    params = init_cyclevae(torch.Generator().manual_seed(0), cfg, device="cpu")
    return Codec(params, cfg, n_smpl_dec=4, bucket=16, device="cpu")


def _eager(codec, generator, src, trg, eps):
    """The composition the host path replaced: the fused encode and
    posterior mean, then the batched decode of the three directions."""
    (lat_src, lat_trg), (z_src, z_trg) = codec.encode_mean(generator, [src, trg], eps)
    T, Tt, n_spk = len(src), len(trg), codec.cfg.n_spk
    return (lat_src, lat_trg, *codec.decode_batch([(_speaker_codes(T, n_spk, 1), z_src),
                                                   (_speaker_codes(T, n_spk, 0), z_src),
                                                   (_speaker_codes(Tt, n_spk, 1), z_trg)]))


@pytest.mark.parametrize("noise", ["generator", "eps"])
@pytest.mark.parametrize("lens,Tp", [((20, 13), 32), ((27, 40), 48)])
def test_the_host_path_is_encode_mean_then_decode_batch(codec, noise, lens, Tp):
    """Bitwise the old composition's five outputs at two padded lengths,
    the source longer or shorter than the target, from a generator's draws
    or injected ones: float32 latents, float64 decodes, each trimmed to its
    utterance; twice over the phase's buffers, which the codec keeps one a
    padded length."""
    rng = np.random.default_rng(sum(lens))
    src, trg = (rng.normal(size=(n, 54)).astype(np.float32) for n in lens)
    eps = rng.normal(size=(codec.n_smpl_dec, 2, max(lens), codec.cfg.lat_dim))

    def noise_kw():
        if noise == "eps":
            return {"generator": None, "eps": eps}
        return {"generator": torch.Generator().manual_seed(3), "eps": None}

    kw = noise_kw()
    want = _eager(codec, kw["generator"], src, trg, kw["eps"])
    T, Tt = lens
    shapes = [(T, 2 * codec.cfg.lat_dim), (Tt, 2 * codec.cfg.lat_dim),
              (T, codec.cfg.out_dim), (T, codec.cfg.out_dim), (Tt, codec.cfg.out_dim)]
    for _ in range(2):
        got = device_decode_pair(codec, src_feat=src, trg_feat=trg, **noise_kw())
        assert [g.shape for g in got] == shapes
        assert [g.dtype for g in got] == [np.float32] * 2 + [np.float64] * 3
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert Tp in codec._pair_phases


class _StandInGraph:
    """A CUDA graph's part on the CPU: ``replay`` runs the phase's body
    into the output buffer that the phase returns, and launches no kernel.
    A new buffer each replay: on a card the one ``fetch`` copies the
    graph's buffer to the host, where a CPU tensor's fetch copies
    nothing."""

    def __init__(self, phase, codec):
        self.phase, self.codec = phase, codec

    def replay(self):
        self.phase.flat = self.phase._body(self.codec)


def _use_stand_in_graphs(monkeypatch):
    """Each phase a codec makes from here on replays a stand-in graph."""
    init = decode._PairPhase.__init__

    def with_graph(self, codec, Tp):
        init(self, codec, Tp)
        self.flat, self.launches = self._body(codec), 0
        self.graph = _StandInGraph(self, codec)

    monkeypatch.setattr(decode._PairPhase, "__init__", with_graph)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    _use_stand_in_graphs(monkeypatch)


def test_the_replay_counter_records_nothing_untraced(codec, monkeypatch):
    """Untraced, a request records no counter and no span, with a graph to
    replay or without; under ``recording()`` one wait, and one replay
    where a graph is replayed: a phase the CPU runs directly counts 0."""
    feats = [np.ones((20, 54), np.float32), np.ones((13, 54), np.float32)]
    run = Codec(codec.params, codec.cfg, n_smpl_dec=4, bucket=16, device="cpu")
    direct = device_decode_pair(run, torch.Generator().manual_seed(1), *feats)
    assert run._pair_phases[32].graph is None
    _use_stand_in_graphs(monkeypatch)
    replayed = Codec(codec.params, codec.cfg, n_smpl_dec=4, bucket=16, device="cpu")
    for c in (run, replayed):
        profiling.reset()
        device_decode_pair(c, torch.Generator().manual_seed(1), *feats)
        assert profiling.counters() == {} and profiling.spans() == []
    assert isinstance(replayed._pair_phases[32].graph, _StandInGraph)
    for c, want in ((run, {"codec.pair_replays": 0, "device_waits": 1}),
                    (replayed, {"codec.pair_replays": 1, "device_waits": 1})):
        with profiling.recording():
            got = device_decode_pair(c, torch.Generator().manual_seed(1), *feats)
            assert profiling.counters() == want
        for g, d in zip(got, direct):
            np.testing.assert_array_equal(g, d)


def _reader():
    return core.load_module(core.HERE / "metrics" / f"{REPLAYS}.py", "t_metric_pair_replays")


def _tiny_traced_run(seed):
    """The cell ``o2o-convert`` at a tiny size, traced, on the CPU (the
    store emptied first, as a fresh process has it): a sound run."""
    torch.set_num_threads(2)
    profiling.reset()
    small = {"config": {"model": {"hidden_units": 16}, "n_smpl_dec": 4, "bucket": 40},
             "traffic": {"frames": [30, 60], "pool_utts": 6, "pairs": 4}}
    r = core.run_cell(core.Cell("o2o-convert"), seed, 0.3, True, torch.device("cpu"),
                      overrides=small)
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["convert.device_waits_per_request"]["value"] == 1.0
    return r["metrics"]


def test_the_replay_reader_reads_one_a_request_in_a_traced_run(stand_in_graphs):
    """Where each request replays its padded length's graph (a stand-in
    here, as the card's CUDA graph): one replay and one device wait a
    request."""
    assert _tiny_traced_run(2**31 + 13)[REPLAYS] == {"value": 1.0, "unit": "replays"}


def test_the_replay_reader_reads_zero_where_no_graph_runs():
    """Where the phase runs directly (a CPU codec) no graph replays: 0.0
    a request, and the one wait a request stays."""
    assert _tiny_traced_run(2**31 + 29)[REPLAYS] == {"value": 0.0, "unit": "replays"}


def test_the_replay_reader_reads_nothing_without_the_counter(monkeypatch):
    """A program whose ``utils.profiling`` has no store, or whose store has
    no such counter (the parent commit's host path): None, nothing raised."""
    reader = _reader()
    w = core.Window({}, {})
    w.units = [{"requests": 3.0}]
    monkeypatch.setattr(reader, "profiling", types.ModuleType("profiling"))
    assert reader.read(w) is None
    monkeypatch.setattr(reader, "profiling",
                        types.SimpleNamespace(counters=lambda: {"device_waits": 9}))
    assert reader.read(w) is None
    monkeypatch.setattr(reader, "profiling",
                        types.SimpleNamespace(counters=lambda: {"codec.pair_replays": 3}))
    assert reader.read(w) == 1.0
