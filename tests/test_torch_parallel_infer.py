"""The port's sharded samplers on the CPU, with 2 gloo ranks
(``parallel.spawn``): ``hmc_sample_sharded``, ``nuts_sample_sharded`` and
``smc_filter_sharded`` against the single-process samplers on the same
generator, against the JAX package's sharded samplers on the conftest's
8-device mesh with JAX's draws replayed, and the JAX package's moment and
Kalman checks (``tests/test_infer.py``); and the chains samplers' output
layout against the JAX package's.

The ranks import this module, so it imports JAX only inside test bodies and
fixtures: the JAX draws reach the ranks as numpy arrays (``Replay``).
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.infer import (Draws, HMCConfig, NUTSConfig, SMCConfig, hmc_sample_chains,
                                      hmc_sample_sharded, make_decoder_ssm, nuts_sample_chains,
                                      nuts_sample_sharded, smc_filter, smc_filter_sharded)
from cyclevae_tpu_torch.infer.logjoint import make_gaussian_logjoint
from cyclevae_tpu_torch.infer.smc import smc_smoothed_trajectories, trace_ancestry
from cyclevae_tpu_torch.parallel import make_mesh
from cyclevae_tpu_torch.parallel.spawn import spawn_ranks
from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

torch.set_num_threads(1)

WORLD = 2
# tests/test_infer.py's target
MEAN = torch.tensor([1.0, -2.0, 0.5, 3.0])
COV = torch.tensor([0.5, 2.0, 1.0, 0.25])
HMC_CMP = HMCConfig(step_size=0.2, n_leapfrog=4, n_warmup=20, n_samples=10)
NUTS_CMP = NUTSConfig(step_size=0.3, max_depth=4, n_warmup=10, n_samples=10)
HMC_MOM = HMCConfig(step_size=0.2, n_leapfrog=8, n_warmup=150, n_samples=400)
NUTS_MOM = NUTSConfig(step_size=0.2, max_depth=5, n_warmup=100, n_samples=200)
Q, R, T_KF = 1.0, 0.5, 25
# the JAX comparison: chains and particles over the conftest's 8 devices
C_JAX, N_JAX = 8, 64


def _draws(seed):
    return Draws(torch.Generator().manual_seed(seed))


class Replay(Draws):
    """Draws precomputed from the JAX package's key splits (``jax_side``),
    step-major numpy arrays with the chain or particle axis last but the
    draw's own: HMC ``mom`` (n, C, ...) and ``acc`` (n, C); NUTS ``mom``,
    ``dir`` / ``swap`` (n, depth, C) and ``leaf`` (n, depth, leaves, C); SMC
    ``noise`` (T, n, ...) and ``u`` (T,).  A momentum starts a transition,
    a direction a doubling, a leaf is the doubling's next one."""

    def __init__(self, arrays):
        super().__init__(None)
        self.a, self.i, self.t, self.s = arrays, -1, 0, 0

    def _get(self, name, *index):
        return torch.from_numpy(np.ascontiguousarray(self.a[name][index]))

    def momentum(self, shape):
        self.i, self.d = self.i + 1, -1
        return self._get("mom", self.i).reshape(shape)

    def accept(self, shape):
        return self._get("acc", self.i).reshape(shape)

    def direction(self, shape):
        self.d, self.j = self.d + 1, 0
        return self._get("dir", self.i, self.d).reshape(shape)

    def leaf(self, shape):
        self.j += 1
        return self._get("leaf", self.i, self.d, self.j - 1).reshape(shape)

    def swap(self, shape):
        return self._get("swap", self.i, self.d).reshape(shape)

    def normal(self, shape):
        self.t += 1
        return self._get("noise", self.t - 1).reshape(shape)

    def uniform(self, shape):
        self.s += 1
        return self._get("u", self.s - 1).reshape(shape)


def _kalman():
    """tests/test_infer.py's iid linear-Gaussian SSM: (ys, exact log p(y))."""
    ys = torch.tensor(np.random.default_rng(1).normal(0, np.sqrt(Q + R), size=T_KF),
                      dtype=torch.float32)
    var = Q + R
    exact = float(np.sum(-0.5 * (np.log(2 * np.pi * var) + ys.numpy() ** 2 / var)))

    def init(n):
        return {"x": torch.zeros(n)}

    def propagate(draws, state, t):
        return {"x": draws.normal(state["x"].shape) * math.sqrt(Q)}

    def log_weight(state, t):
        return -0.5 * (math.log(2 * math.pi * R) + (ys[t] - state["x"]) ** 2 / R)

    return (init, propagate, log_weight), exact


def _decoder_ssm():
    cfg = CycleVAEConfig(hidden_units=16, n_cyc=1)
    params = init_cyclevae(torch.Generator().manual_seed(0), cfg, device="cpu")
    feats = torch.tensor(np.random.default_rng(0).normal(size=(12, 54)), dtype=torch.float32)
    code = torch.tensor([[1.0, 0.0]] * 12)
    return make_decoder_ssm(params, cfg, feats, code, obs_scale=50.0)


def _smc_out(states, info):
    out = {k: v.numpy() for k, v in info.items() if torch.is_tensor(v)}
    if "stored" in info:
        traj, w = smc_smoothed_trajectories(info)
        out["traj"], out["w"] = traj.numpy(), w.numpy()
        out["traced"] = trace_ancestry(info["stored"], info["ancestors"]).numpy()
    out["states"] = {k: v.numpy() for k, v in states.items()}
    return out


def _rank(rank, world, replay):
    mesh = make_mesh(device="cpu")
    lj = make_gaussian_logjoint(MEAN, COV)
    out = {}
    # JAX's draws replayed, for the comparison with JAX's sharded samplers
    for name, sample in (("hmc", hmc_sample_sharded), ("nuts", nuts_sample_sharded)):
        cfg = HMC_CMP if name == "hmc" else NUTS_CMP
        s, info = sample(mesh, Replay(replay[name]), lj, torch.zeros((C_JAX, 4)), cfg)
        out[name + "_jax"] = (s.numpy(), {k: v.numpy() for k, v in info.items()})
    (init, prop, logw), _ = _kalman()
    out["smc_jax"] = _smc_out(*smc_filter_sharded(mesh, Replay(replay["smc"]), T_KF, init, prop,
                                                  logw, SMCConfig(n_particles=N_JAX),
                                                  store=lambda s: s["x"]))
    s, info = hmc_sample_sharded(mesh, _draws(1), lj, torch.zeros((4, 4)), HMC_CMP)
    out["hmc"] = (s.numpy(), {k: v.numpy() for k, v in info.items()})
    s, info = nuts_sample_sharded(mesh, _draws(2), lj, torch.zeros((4, 4)), NUTS_CMP)
    out["nuts"] = (s.numpy(), {k: v.numpy() for k, v in info.items()})
    (init, prop, logw), _ = _kalman()
    out["smc"] = _smc_out(*smc_filter_sharded(mesh, _draws(3), T_KF, init, prop, logw,
                                              SMCConfig(n_particles=64),
                                              store=lambda s: s["x"]))
    init, prop, logw = _decoder_ssm()
    out["smc_dec"] = _smc_out(*smc_filter_sharded(mesh, _draws(4), 12, init, prop, logw,
                                                  SMCConfig(n_particles=32)))
    # the moment checks of tests/test_infer.py, sharded
    s, info = hmc_sample_sharded(mesh, _draws(5), lj, torch.zeros((16, 4)), HMC_MOM)
    out["hmc_mom"] = s.numpy()
    s, info = nuts_sample_sharded(mesh, _draws(9), lj, torch.zeros((8, 4)), NUTS_MOM)
    out["nuts_mom"] = s.numpy()
    _, info = smc_filter_sharded(mesh, _draws(0), T_KF, init=_kalman()[0][0],
                                 propagate=_kalman()[0][1], log_weight=_kalman()[0][2],
                                 cfg=SMCConfig(n_particles=4096, ess_threshold=0.5))
    out["kalman"] = float(info["log_marginal"])
    return out


def _jax_draws():
    """The draws of the JAX package's sharded samplers in ``_jax_runs``,
    made from the same keys as those samplers split them (``Replay``):
    HMC's and NUTS's per-chain key trees, SMC's per-device noise streams and
    its shared resampling keys."""
    import jax
    import jax.numpy as jnp

    rnd = jax.random

    def per_chain(key, n, transition):
        """transition(key) of every chain's n transitions: chain c splits
        split(key, C)[c] into n + 1 and runs transition i on the i-th."""
        chain = lambda k: jax.vmap(transition)(rnd.split(k, n + 1)[:n])
        return jax.jit(jax.vmap(chain))(rnd.split(key, C_JAX))

    def hmc_step(k):                 # jhmc.hmc_sample's one_step
        k_mom, k_acc = rnd.split(k)
        return rnd.normal(k_mom, (4,)), rnd.uniform(k_acc, ())

    def nuts_transition(k):          # jnuts.nuts_kernel's key tree
        k_mom, run = rnd.split(k)
        dirs, swaps, leaves = [], [], []
        for _ in range(NUTS_CMP.max_depth):
            run, k_dir, sub, k_swap = rnd.split(run, 4)
            dirs.append(rnd.bernoulli(k_dir))
            swaps.append(rnd.uniform(k_swap))
            row = []
            for _ in range(1 << (NUTS_CMP.max_depth - 1)):
                sub, k_acc = rnd.split(sub)
                row.append(rnd.uniform(k_acc))
            leaves.append(jnp.stack(row))
        return rnd.normal(k_mom, (4,)), jnp.stack(dirs), jnp.stack(swaps), jnp.stack(leaves)

    @jax.jit
    def smc_draws(key):
        # jsmc.smc_filter_sharded: device d's stream from split(key, 8)[d]
        # after its k_init, each step's k_prop split over the device's
        # particles; the resampling uniform from fold_in(shared_key, t)
        key, shared = rnd.split(key)

        def device(kd):
            def step(kd, _):
                kd, k_prop = rnd.split(kd)
                return kd, jax.vmap(rnd.normal)(rnd.split(k_prop, N_JAX // 8))
            return jax.lax.scan(step, rnd.split(kd)[0], None, length=T_KF)[1]
        noise = jax.vmap(device)(rnd.split(key, 8))               # (8, T, n / 8)
        u = jax.vmap(lambda t: rnd.uniform(rnd.fold_in(shared, t), ()))(jnp.arange(T_KF))
        return jnp.moveaxis(noise, 0, 1).reshape(T_KF, N_JAX), u

    step_major = lambda x: np.moveaxis(np.asarray(x), 0, -1)   # (C, n, ...) -> (n, ..., C)
    mom, acc = per_chain(rnd.PRNGKey(31), HMC_CMP.n_warmup + HMC_CMP.n_samples, hmc_step)
    replay = {"hmc": {"mom": np.moveaxis(np.asarray(mom), 0, 1), "acc": np.asarray(acc).T}}
    mom, dirs, swaps, leaves = per_chain(rnd.PRNGKey(32), NUTS_CMP.n_warmup + NUTS_CMP.n_samples,
                                         nuts_transition)
    replay["nuts"] = {"mom": np.moveaxis(np.asarray(mom), 0, 1), "dir": step_major(dirs),
                      "swap": step_major(swaps), "leaf": step_major(leaves)}
    noise, u = smc_draws(rnd.PRNGKey(33))
    replay["smc"] = {"noise": np.asarray(noise), "u": np.asarray(u)}
    return replay


def _jax_runs():
    """The JAX package's sharded samplers on the conftest's 8-device mesh,
    on the keys of ``_jax_draws``: HMC and NUTS over C_JAX chains of
    tests/test_infer.py's target, SMC over N_JAX particles of its
    linear-Gaussian SSM (storing x)."""
    import jax
    import jax.numpy as jnp

    from cyclevae_tpu.infer import hmc as jhmc
    from cyclevae_tpu.infer import nuts as jnuts
    from cyclevae_tpu.infer import smc as jsmc
    from cyclevae_tpu.infer.logjoint import make_gaussian_logjoint as jgauss
    from cyclevae_tpu.parallel import make_mesh as jmake_mesh

    rnd = jax.random
    mesh = jmake_mesh(8)
    lj = jgauss(jnp.asarray(MEAN.numpy()), jnp.asarray(COV.numpy()))
    z0 = jnp.zeros((C_JAX, 4))
    host = lambda info: {k: np.asarray(v) for k, v in info.items()}
    s, info = jhmc.hmc_sample_sharded(mesh, rnd.PRNGKey(31), lj, z0, jhmc.HMCConfig(*HMC_CMP))
    out = {"hmc": (np.asarray(s), host(info))}
    s, info = jnuts.nuts_sample_sharded(mesh, rnd.PRNGKey(32), lj, z0,
                                        jnuts.NUTSConfig(*NUTS_CMP))
    out["nuts"] = (np.asarray(s), host(info))
    ys = jnp.asarray(np.random.default_rng(1).normal(0, np.sqrt(Q + R), size=T_KF))
    _, info = jsmc.smc_filter_sharded(
        mesh, rnd.PRNGKey(33), T_KF, lambda k: {"x": jnp.zeros(())},
        lambda k, st, t: {"x": rnd.normal(k) * jnp.sqrt(Q)},
        lambda st, t: -0.5 * (jnp.log(2 * jnp.pi * R) + (ys[t] - st["x"]) ** 2 / R),
        jsmc.SMCConfig(n_particles=N_JAX), store=lambda st: st["x"])
    out["smc"] = host(info)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, the JAX package's sharded runs): the ranks
    run in a thread while JAX compiles and runs its samplers."""
    replay = _jax_draws()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, _rank, WORLD, (replay,), timeout_s=240, threads=1,
                            workdir=str(tmp_path_factory.mktemp("ranks")))
        jax_out = _jax_runs()
        return ranks.result(), jax_out


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_side(runs):
    return runs[1]


def _rows(rank, n):
    return slice(rank * n // WORLD, (rank + 1) * n // WORLD)


# ---------------------------------------------------------------------------
# Sharded against single-process, the same generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_sharded_chains_match_single_process(ranks, name):
    """Each rank's chains are the single-process chains sampler's chains of
    its rows (samples within 1e-5), with one shared step size (rtol 1e-6);
    info is the mean over the ranks of the per-chain values."""
    lj = make_gaussian_logjoint(MEAN, COV)
    if name == "hmc":
        s, info = hmc_sample_chains(_draws(1), lj, torch.zeros((4, 4)), HMC_CMP)
    else:
        s, info = nuts_sample_chains(_draws(2), lj, torch.zeros((4, 4)), NUTS_CMP)
    for r, res in enumerate(ranks):
        got, ginfo = res[name]
        assert got.shape == (2,) + tuple(s.shape[1:])
        np.testing.assert_allclose(got, s[_rows(r, 4)].numpy(), atol=1e-5)
        np.testing.assert_allclose(ginfo["step_size"], info["step_size"][:2].numpy(), rtol=1e-6)
        assert {k: v.shape for k, v in ginfo.items()} == \
            {k: tuple(v[_rows(r, 4)].shape) for k, v in info.items()}
    mean = lambda k: np.mean([res[name][1][k] for res in ranks], axis=0)
    for k in ("accept_prob",) if name == "hmc" else ("accept_stat", "mean_depth"):
        np.testing.assert_allclose(mean(k), ((info[k][:2] + info[k][2:]) / 2).numpy(), rtol=1e-5)


def test_sharded_smc_matches_single_process(ranks):
    """Linear-Gaussian SSM, 64 particles over 2 ranks: the log-marginal
    within 1e-5, the same (global) ancestors, the same smoothed
    trajectories through ``trace_ancestry``; each rank's final particles are
    its rows of the single-process filter's."""
    (init, prop, logw), _ = _kalman()
    want = _smc_out(*smc_filter(_draws(3), T_KF, init, prop, logw, SMCConfig(n_particles=64),
                                store=lambda s: s["x"]))
    assert want["resampled"].any() and not want["resampled"].all()
    for r, got in enumerate(ranks):
        g = got["smc"]
        assert abs(float(g["log_marginal"]) - float(want["log_marginal"])) < 1e-5
        np.testing.assert_array_equal(g["ancestors"], want["ancestors"])
        np.testing.assert_array_equal(g["resampled"], want["resampled"])
        np.testing.assert_allclose(g["ess"], want["ess"], rtol=1e-5)
        for k in ("traj", "traced", "stored", "w", "log_w"):
            np.testing.assert_allclose(g[k], want[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["states"]["x"], want["states"]["x"][_rows(r, 64)],
                                   atol=1e-6)


def test_sharded_smc_decoder_ssm(ranks):
    """The decoder SSM (hu16, 12 frames, 32 particles) sharded: the
    single-process filter's log-marginal and particles."""
    init, prop, logw = _decoder_ssm()
    want = _smc_out(*smc_filter(_draws(4), 12, init, prop, logw, SMCConfig(n_particles=32)))
    for r, got in enumerate(ranks):
        g = got["smc_dec"]
        assert abs(float(g["log_marginal"]) - float(want["log_marginal"])) < 1e-5 * max(
            1.0, abs(float(want["log_marginal"])))
        np.testing.assert_array_equal(g["resampled"], want["resampled"])
        for k, v in want["states"].items():
            np.testing.assert_allclose(g["states"][k], v[_rows(r, 32)], atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Sharded against the JAX package's sharded samplers, JAX's draws replayed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_sharded_chains_match_jax_sharded(ranks, jax_side, name):
    """8 chains, 4 on each of 2 ranks here and 1 on each of 8 devices in
    JAX's ``*_sample_sharded``, with JAX's per-chain keys replayed: the
    chains in JAX's order within 1e-4 and the info within 1e-4 relative
    (the single-process replays' tolerances).  The info's layout follows
    the shard (a value per local chain, the mean over the ranks or
    devices), so its mean over the chains is compared."""
    want, winfo = jax_side[name]
    got = np.concatenate([r[name + "_jax"][0] for r in ranks])
    assert got.shape == want.shape == (C_JAX, 10, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)
    moved = lambda x: np.any(np.abs(np.diff(x, axis=1)) > 0, axis=2)
    assert 0 < moved(want).sum() < moved(want).size       # moves and rejections both
    np.testing.assert_array_equal(moved(got), moved(want))
    for r in ranks:
        ginfo = r[name + "_jax"][1]
        assert set(winfo) <= set(ginfo)
        for k, v in winfo.items():
            np.testing.assert_allclose(ginfo[k].mean(0), v.mean(0), rtol=1e-4, atol=1e-7,
                                       err_msg=k)


def test_sharded_smc_matches_jax_sharded(ranks, jax_side):
    """The linear-Gaussian SSM over 64 particles, 32 on each of 2 ranks here
    and 8 on each of 8 devices in JAX's ``smc_filter_sharded``, its
    propagation noise and shared resampling uniform replayed: the
    log-marginal within 1e-4 relative, the same resampling steps and the
    same (global) ancestors, the ESS within 1e-3 relative (the
    single-process replay's tolerances), the stored genealogy within 1e-6."""
    want = jax_side["smc"]
    assert 0 < want["resampled"].sum() < T_KF
    for got in ranks:
        g = got["smc_jax"]
        np.testing.assert_allclose(float(g["log_marginal"]), float(want["log_marginal"]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(g["resampled"], want["resampled"])
        np.testing.assert_array_equal(g["ancestors"], want["ancestors"])
        np.testing.assert_allclose(g["ess"], want["ess"], rtol=1e-3)
        np.testing.assert_allclose(g["stored"], want["stored"], atol=1e-6)
        np.testing.assert_allclose(g["log_w"], want["log_w"], rtol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_infer.py's checks, sharded
# ---------------------------------------------------------------------------

def test_hmc_sharded_moments(ranks):
    """16 chains over 2 ranks (tests/test_infer.py:178-188): mean within
    0.15, variance within 35%."""
    s = np.concatenate([r["hmc_mom"] for r in ranks]).reshape(-1, 4)
    np.testing.assert_allclose(s.mean(0), MEAN.numpy(), atol=0.15)
    np.testing.assert_allclose(s.var(0), COV.numpy(), rtol=0.35)


def test_nuts_sharded_moments(ranks):
    """8 chains over 2 ranks (tests/test_infer.py:234-245): mean within 0.2."""
    s = np.concatenate([r["nuts_mom"] for r in ranks]).reshape(-1, 4)
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s.mean(0), MEAN.numpy(), atol=0.2)


def test_smc_sharded_matches_kalman(ranks):
    """4096 particles over 2 ranks (tests/test_infer.py:133-152): the
    log-marginal within 0.25 of the exact one, the same on both ranks."""
    _, exact = _kalman()
    assert ranks[0]["kalman"] == ranks[1]["kalman"]
    assert abs(ranks[0]["kalman"] - exact) < 0.25, (ranks[0]["kalman"], exact)


# ---------------------------------------------------------------------------
# The chains samplers' layout, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_chains_layout_matches_jax(name):
    """C = 3 chains of 5 samples on a 2-d target: the port's
    ``*_sample_chains`` lay their samples out as the JAX package's vmap
    does, chains first (C, n_samples, ...), and every info value the JAX
    package returns has its shape."""
    import jax
    import jax.numpy as jnp

    from cyclevae_tpu.infer import hmc as jhmc
    from cyclevae_tpu.infer import nuts as jnuts
    from cyclevae_tpu.infer.logjoint import make_gaussian_logjoint as jgauss

    mean, cov = [1.0, -2.0], [0.5, 2.0]
    if name == "hmc":
        cfg = HMCConfig(step_size=0.2, n_leapfrog=3, n_warmup=4, n_samples=5)
        js, jinfo = jhmc.hmc_sample_chains(jax.random.PRNGKey(0), jgauss(jnp.asarray(mean),
                                                                         jnp.asarray(cov)),
                                           jnp.zeros((3, 2)), jhmc.HMCConfig(*cfg))
        s, info = hmc_sample_chains(_draws(0), make_gaussian_logjoint(torch.tensor(mean),
                                                                      torch.tensor(cov)),
                                    torch.zeros((3, 2)), cfg)
    else:
        cfg = NUTSConfig(step_size=0.2, max_depth=3, n_warmup=4, n_samples=5)
        js, jinfo = jnuts.nuts_sample_chains(jax.random.PRNGKey(0), jgauss(jnp.asarray(mean),
                                                                           jnp.asarray(cov)),
                                             jnp.zeros((3, 2)), jnuts.NUTSConfig(*cfg))
        s, info = nuts_sample_chains(_draws(0), make_gaussian_logjoint(torch.tensor(mean),
                                                                       torch.tensor(cov)),
                                     torch.zeros((3, 2)), cfg)
    assert tuple(s.shape) == js.shape == (3, 5, 2)
    assert set(jinfo) <= set(info)
    for k, v in jinfo.items():
        assert tuple(info[k].shape) == v.shape, k
    assert tuple(info["step_size"].shape) == (3,) and tuple(info["inv_mass"].shape) == (3, 2)
