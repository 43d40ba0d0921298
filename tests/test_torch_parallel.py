"""The port's data-parallel layer (``cyclevae_tpu_torch.parallel``) on the CPU,
with gloo ranks spawned by ``parallel.spawn``: the sharded train step against
the port's single-device step and against the JAX package's
``make_sharded_train_step``, the many-to-many batch, ``replicate``, the
same-host-value check, the launcher and the dry run.

The ranks import this module (the ``spawn`` start method pickles their
function by name), so it imports JAX only inside test bodies.  Every spawn
has a time limit and every group a timeout: a hang fails the test.
"""

import os
import re
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.models.gru_vae import Draws
from cyclevae_tpu_torch.parallel import (make_mesh, make_sharded_train_step, replicate,
                                         shard_batch)
from cyclevae_tpu_torch.parallel.mesh import Mesh, batch_spec, shard_rows
from cyclevae_tpu_torch.parallel.spawn import spawn_ranks
from cyclevae_tpu_torch.vi import train as ttrain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
H, SEG, N_SEGS, B = 32, 20, 3, 8
T = SEG * N_SEGS
LR = 1e-4
# rank 0 holds rows 0-3, rank 1 rows 4-7: only rank 0's rows reach the last
# segment (frames 40-59), so rank 1 joins a segment it has no frame of
FLENS = np.array([60, 45, 33, 50, 40, 25, 38, 21], dtype=np.int32)
SPAWN_S = 240.0


def _batch(seed=0, n_spk=2, m2m=False):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[None, :, None]
    feats = (np.sin(t * 0.05 + np.arange(54)[None, None, :])
             + 0.3 * rng.normal(size=(B, T, 54))).astype(np.float32)
    eye = np.eye(n_spk, dtype=np.float32)
    batch = {"feats": feats, "src_code": np.tile(eye[0], (B, T, 1)),
             "trg_code": np.tile(eye[1], (B, T, 1)), "cv_excit": feats[..., :4] + 0.3,
             "flens": FLENS.copy()}
    if m2m:     # one target speaker per cycle: (n_cyc, B, T, .)
        batch["trg_code"] = np.stack([np.tile(eye[1], (B, T, 1)), np.tile(eye[2], (B, T, 1))])
        batch["cv_excit"] = np.stack([feats[..., :4] + 0.3, feats[..., :4] - 0.2])
    return batch


def _cfg(do_prob=0.5, n_spk=2):
    return ttrain.CycleVAEConfig(hidden_units=H, n_cyc=2, do_prob=do_prob, n_spk=n_spk)


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    mean = (0.1 * rng.normal(size=54)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=54).astype(np.float32)
    return ttrain.init_cyclevae(torch.Generator().manual_seed(seed), cfg, mean, scale,
                                device="cpu")


def _result(ts, metrics):
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "w_hh": ts.params.encoder["gru"][0]["w_hh"].detach().numpy().copy(),
            "params": [t.detach().numpy().copy() for t in ttrain.trainable_leaves(ts.params)],
            "rng": ts.rng.get_state().numpy()}


def _single(cfg, batch, draws=None, params=None):
    params = _params(cfg) if params is None else params
    opt = ttrain.make_optimizer(cfg, lr=LR)
    ts = ttrain.TrainState(params, opt.init(params), torch.Generator().manual_seed(7), 0)
    return _result(*ttrain.make_train_step(cfg, opt, SEG, N_SEGS)(ts, batch, draws))


class ReplayEps(Draws):
    """Posterior noise recorded where the JAX package draws it, in order."""

    def __init__(self, seq):
        self.seq = list(seq)

    def eps(self, shape, laplace):
        a = self.seq.pop(0)
        assert a.shape == tuple(shape) and not laplace, (a.shape, shape)
        return torch.tensor(a)


# ---------------------------------------------------------------------------
# The rank function: every scenario of this file in one spawn
# ---------------------------------------------------------------------------

def _sharded(mesh, cfg, batch, seed_offset=0, draws=None, params=None):
    """One sharded step from rank-dependent starting values that
    ``replicate`` must overwrite with rank 0's."""
    params = _params(cfg, seed=seed_offset * mesh.rank) if params is None else params
    params = replicate(mesh, params)
    opt = ttrain.make_optimizer(cfg, lr=LR)
    gen = replicate(mesh, torch.Generator().manual_seed(7 + seed_offset * mesh.rank))
    ts = ttrain.TrainState(params, opt.init(params), gen, 0)
    step = make_sharded_train_step(cfg, opt, SEG, N_SEGS, mesh)
    return _result(*step(ts, batch, draws))


def _rank(rank, world, jax_npz, jax_params):
    mesh = make_mesh(device="cpu")
    out = {}
    # the main step, from a global host batch; record the rows the forward sees
    seen, segment_loss = [], ttrain.segment_loss

    def recording(params, cfg, draws, seg, state, do=True):
        seen.append(seg["feats"].shape[0])
        return segment_loss(params, cfg, draws, seg, state, do)

    ttrain.segment_loss = recording
    try:
        out["main"] = _sharded(mesh, _cfg(), _batch(), seed_offset=100)
    finally:
        ttrain.segment_loss = segment_loss
    out["rows_seen"] = seen
    out["local_flens"] = shard_batch(mesh, _batch())["flens"]
    # the same step from a batch shard_batch already cut
    out["presharded"] = _sharded(mesh, _cfg(), shard_batch(mesh, _batch()))
    # the many-to-many batch: (n_cyc, B, T, .) arrays shard on axis 1
    out["m2m"] = _sharded(mesh, _cfg(n_spk=3), _batch(n_spk=3, m2m=True))
    # against the JAX package's sharded step, its posterior noise replayed
    eps = np.load(jax_npz)["eps"]
    out["jax"] = _sharded(mesh, _cfg(do_prob=0.0), _batch(seed=1),
                          draws=ReplayEps(list(eps) * N_SEGS),
                          params=ttrain.params_to(jax_params, "cpu"))
    # the same-host-value check: equal batches pass, a rank-dependent one raises
    os.environ["CYCLEVAE_VERIFY_GLOBAL"] = "1"
    try:
        shard_batch(mesh, _batch())
        replicate(mesh, {"w": torch.ones(3)})
        errors = []
        for bad in (lambda: shard_batch(mesh, _batch(seed=rank)),
                    lambda: replicate(mesh, {"w": torch.full((3,), float(rank))})):
            try:
                bad()
                errors.append(None)
            except AssertionError as e:
                errors.append(str(e))
        out["verify_errors"] = errors
    finally:
        del os.environ["CYCLEVAE_VERIFY_GLOBAL"]
    return out


def _jax_side(workdir):
    """JAX's make_sharded_train_step on the conftest's 8-device mesh at
    do_prob 0, its posterior noise recorded (``test_torch_train.Recorder``):
    the recorded noise (one jitted trace of the segment scan draws it once,
    so every segment replays the same), its params and its results."""
    import jax
    import jax.numpy as jnp

    import cyclevae_tpu.vi.train as jtrain
    from cyclevae_tpu.parallel import make_mesh as jmake_mesh
    from cyclevae_tpu.parallel import make_sharded_train_step as jmake_step
    from cyclevae_tpu.parallel import replicate as jreplicate
    from cyclevae_tpu.parallel import shard_batch as jshard_batch
    from cyclevae_tpu_torch.interop import params_from_jax
    from test_torch_train import Recorder

    rec = Recorder(seed=11)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "sampling_vae_batch", rec.sampling)
    try:
        kw = dict(hidden_units=H, n_cyc=2, do_prob=0.0)
        jc = jtrain.CycleVAEConfig(**kw)
        rng = np.random.default_rng(0)
        mean = (0.1 * rng.normal(size=54)).astype(np.float32)
        scale = rng.uniform(0.5, 2.0, size=54).astype(np.float32)
        jp = jtrain.init_cyclevae(jax.random.PRNGKey(0), jc, mean, scale)
        tp = params_from_jax(jp, device="cpu")
        opt = jtrain.make_optimizer(jc, lr=LR)
        mesh = jmake_mesh(8)
        ts = jtrain.TrainState(jreplicate(mesh, jp), jreplicate(mesh, opt.init(jp)),
                               jreplicate(mesh, jax.random.PRNGKey(7)),
                               jreplicate(mesh, jnp.zeros((), jnp.int32)))
        with mesh:
            ts, met = jmake_step(jc, opt, SEG, N_SEGS, mesh)(ts, jshard_batch(mesh, _batch(seed=1)))
        eps = np.stack([a for kind, a in rec.seq])
        assert [kind for kind, _ in rec.seq] == ["eps"] * 6 and eps.shape == (6, B, SEG, 32)
    finally:
        mp.undo()
    path = os.path.join(workdir, "eps.npz")
    np.savez(path, eps=eps)
    return {"npz": path, "params": tp,
            "metrics": {k: np.asarray(v) for k, v in met.items()},
            "w_hh": np.asarray(ts.params.encoder["gru"][0]["w_hh"])}


def _jax_then_ranks(workdir):
    """``_jax_side``, then the ranks on what it recorded."""
    jax_side = _jax_side(workdir)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_rank, WORLD, (jax_side["npz"], jax_side["params"]), timeout_s=SPAWN_S,
                        threads=1, workdir=workdir)
    assert time.perf_counter() - t0 < SPAWN_S
    return jax_side, ranks


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The JAX side and the ranks run in a thread from this module's first
    test on, while the tests that need neither run; the tests that need
    them come last and wait for them."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_then_ranks, str(tmp_path_factory.mktemp("jax_ranks")))


@pytest.fixture(scope="module")
def jax_side(background):
    return background.result()[0]


@pytest.fixture(scope="module")
def ranks(background):
    return background.result()[1]


@pytest.fixture(scope="module")
def single_main():
    """The port's single-device step on the main scenario's batch and seeds."""
    return _single(_cfg(), _batch())


def _assert_metrics_close(got, want, rtol=2e-4):
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# Single-process pieces
# ---------------------------------------------------------------------------

def test_batch_spec_and_shard_rows():
    assert [batch_spec(n) for n in (1, 2, 3, 4)] == [0, 0, 0, 1]
    mesh = Mesh(None, 1, 2, torch.device("cpu"), "gloo")
    x = np.arange(12).reshape(2, 6)
    np.testing.assert_array_equal(shard_rows(mesh, x, axis=1), x[:, 3:])
    with pytest.raises(ValueError, match="does not shard"):
        shard_rows(mesh, np.zeros(5))
    with pytest.raises(ValueError, match="does not shard"):
        shard_batch(mesh, {"feats": np.zeros((3, 4, 54))})


def test_make_mesh_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and mesh.all(torch.tensor([True])) and \
        not mesh.any(torch.tensor([False]))
    with pytest.raises(ValueError, match="NCCL"):
        make_mesh(backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="n_dp=2"):
        make_mesh(n_dp=2, device="cpu")


def test_one_process_sharded_step_is_the_single_device_step(single_main):
    """Without a group the sharded step is the single-device step, bit for
    bit."""
    mesh = make_mesh(device="cpu")
    cfg = _cfg()
    params = _params(cfg)
    opt = ttrain.make_optimizer(cfg, lr=LR)
    ts = ttrain.TrainState(params, opt.init(params), torch.Generator().manual_seed(7), 0)
    got = _result(*make_sharded_train_step(cfg, opt, SEG, N_SEGS, mesh)(ts, _batch()))
    want = single_main
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, err_msg=k)
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# spawn's time limit and failure path, the launcher, the dry run
# ---------------------------------------------------------------------------

def _sleepy_rank(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    make_mesh(device="cpu").all_reduce(torch.zeros(1))     # waits on rank 1, which never joins


def _hung_rank(rank, world):
    time.sleep(600)


def test_spawn_fails_fast_and_times_out(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(_sleepy_rank, 2, timeout_s=120, workdir=str(tmp_path))
    assert time.perf_counter() - t0 < 60          # not the collective's 120 s timeout
    with pytest.raises(TimeoutError, match="still running"):
        spawn_ranks(_hung_rank, 1, timeout_s=3, workdir=str(tmp_path))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_two_processes_same_loss():
    """``python -m cyclevae_tpu_torch.parallel.launch`` runs the smoke
    worker in 2 CPU processes (explicit env-var convention, the same-host-
    value check on): both print SMOKE_OK with the same loss."""
    env = dict(os.environ, PYTHONPATH=REPO, CYCLEVAE_PLATFORM="cpu", CYCLEVAE_NUM_PROCESSES="2",
               CYCLEVAE_VERIFY_GLOBAL="1", CYCLEVAE_COORDINATOR="127.0.0.1",
               CYCLEVAE_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cyclevae_tpu_torch.parallel.launch", "-m",
         "cyclevae_tpu_torch.parallel.smoke_worker"],
        env=dict(env, CYCLEVAE_PROCESS_ID=str(r)), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    losses = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        m = re.search(r"SMOKE_OK proc=%d/2 devices=2 loss=([-\d.]+)" % r, out)
        assert m, out[-2000:]
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_launcher_env_conventions():
    from cyclevae_tpu_torch.parallel.launch import group_from_env
    assert group_from_env({}) == (1, 0, "tcp://127.0.0.1:8476")
    assert group_from_env({"CYCLEVAE_NUM_PROCESSES": "4", "CYCLEVAE_PROCESS_ID": "3",
                           "CYCLEVAE_COORDINATOR": "h0", "CYCLEVAE_PORT": "99"}) == \
        (4, 3, "tcp://h0:99")
    with pytest.raises(SystemExit, match="requires CYCLEVAE_PROCESS_ID"):
        group_from_env({"CYCLEVAE_NUM_PROCESSES": "2"})
    with pytest.raises(SystemExit, match="out of range"):
        group_from_env({"CYCLEVAE_NUM_PROCESSES": "2", "CYCLEVAE_PROCESS_ID": "2"})
    assert group_from_env({"SLURM_JOB_NUM_NODES": "2", "SLURM_PROCID": "1",
                           "SLURM_JOB_NODELIST": "node[1-2],x"}) == (2, 1, "tcp://node:8476")


def test_dryrun_multichip_backend_follows_the_device(monkeypatch):
    """Off the CPU the dry run takes NCCL, one card per rank: more ranks
    than cards, or no card, raise before any rank starts."""
    from cyclevae_tpu_torch.parallel import dryrun
    monkeypatch.setattr(dryrun, "spawn_ranks", lambda *a, **k: pytest.fail("spawned"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs one card per rank: 2 ranks, 1 cards"):
        dryrun.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def test_dryrun_multichip_cpu(capfd):
    """The JAX dry run's work (hu32 and hu1024 steps, sharded HMC and SMC at
    hu1024 over 16 frames) in 2 gloo ranks; rank 0 prints its lines."""
    from cyclevae_tpu_torch.parallel.dryrun import dryrun_multichip
    res = dryrun_multichip(2, device="cpu", timeout_s=SPAWN_S)
    out = capfd.readouterr().out
    for tag in ("tiny hu=32", "flagship hu=1024", "sharded HMC hu=1024", "sharded SMC hu=1024"):
        assert f"dryrun_multichip(2) [{tag}]" in out, out
    assert [len(r["train"]) for r in res] == [2, 2]
    assert res[0]["hmc"]["samples"].shape == (2, 2, 16, 32)
    assert res[0]["smc"]["log_marginal"] == res[1]["smc"]["log_marginal"]


# ---------------------------------------------------------------------------
# The sharded step against the single-device step
# ---------------------------------------------------------------------------

def test_sharded_step_matches_single_device(ranks, single_main):
    """2 gloo ranks at hu32, 2 cycles, do_prob 0.5, B = 8, 3 segments of 20:
    the same draws (each rank keeps its rows of the global draws), so
    losses and metrics within 2e-4 relative, w_hh within 2e-5
    (``tests/test_parallel.py``'s bounds)."""
    want = single_main
    for r in ranks:
        _assert_metrics_close(r["main"]["metrics"], want["metrics"])
        np.testing.assert_allclose(r["main"]["w_hh"], want["w_hh"], atol=2e-5)
        for a, b in zip(r["main"]["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=2e-5)


def test_last_segment_valid_on_one_rank_only(ranks):
    """seg_valid comes from every rank's flens: rank 1's utterances all end
    before segment 2, yet it runs segment 2's forward and all-reduce."""
    assert max(ranks[1]["local_flens"]) <= 2 * SEG < max(ranks[0]["local_flens"])
    for r in ranks:
        np.testing.assert_array_equal(r["main"]["metrics"]["seg_valid"], [1.0, 1.0, 1.0])
        assert r["rows_seen"] == [B // WORLD] * N_SEGS
    np.testing.assert_array_equal(ranks[0]["main"]["metrics"]["loss"],
                                  ranks[1]["main"]["metrics"]["loss"])


def test_ranks_end_with_the_same_state(ranks):
    """Every rank takes the same update and its generator made the same
    draws, so the ranks end bit for bit equal."""
    for a, b in zip(ranks[0]["main"]["params"], ranks[1]["main"]["params"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ranks[0]["main"]["rng"], ranks[1]["main"]["rng"])


def test_host_batch_runs_sharded(ranks):
    """A host batch that was not sharded still runs sharded (each rank's
    forward saw B / 2 rows, above), and gives what a batch ``shard_batch``
    cut gives."""
    for r in ranks:
        for k, v in r["main"]["metrics"].items():
            np.testing.assert_array_equal(r["presharded"]["metrics"][k], v, err_msg=k)


def test_replicate_overwrites_rank_dependent_state(ranks, single_main):
    """Rank 1 started from other params and another generator seed;
    ``replicate`` made them rank 0's, so the step matches the single-device
    step from rank 0's (test above) and its generator ends where it does."""
    np.testing.assert_array_equal(ranks[1]["main"]["rng"], single_main["rng"])


def test_sharded_step_m2m_batch(ranks):
    """The 4-D many-to-many arrays (n_cyc, B, T, .) shard on axis 1."""
    want = _single(_cfg(n_spk=3), _batch(n_spk=3, m2m=True))
    for r in ranks:
        _assert_metrics_close(r["m2m"]["metrics"], want["metrics"])
        np.testing.assert_allclose(r["m2m"]["w_hh"], want["w_hh"], atol=2e-5)


def test_sharded_step_matches_jax_sharded_step(ranks, jax_side):
    """Against JAX's make_sharded_train_step on its 8-device mesh at
    do_prob 0, the same posterior noise: losses and metrics within 2e-4
    relative, w_hh within 2e-5."""
    for r in ranks:
        _assert_metrics_close(r["jax"]["metrics"], jax_side["metrics"])
        np.testing.assert_allclose(r["jax"]["w_hh"], jax_side["w_hh"], atol=2e-5)


def test_verify_global_raises_on_rank_dependent_values(ranks):
    """``CYCLEVAE_VERIFY_GLOBAL=1``: a batch, or a value to replicate, that
    differs between ranks raises with every rank's CRC."""
    for r in ranks:
        assert len(r["verify_errors"]) == 2
        for msg in r["verify_errors"]:
            assert msg is not None and "crc32 per process" in msg
            crcs = [int(c) for c in re.findall(r"-?\d+", msg.split("process: ")[1])[:WORLD]]
            assert len(set(crcs)) == WORLD
