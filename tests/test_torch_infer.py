"""The port's HMC, log-joint and SMC (``cyclevae_tpu_torch.infer``) against
the JAX package's on the CPU: the log-joint's value and gradient against
``jax.grad``, HMC and the decoder SSM with JAX's key splits replayed into
their draws, and the Kalman and RTS checks of ``tests/test_infer.py`` at its
tolerances (the moment checks: ``test_torch_infer_moments.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.infer import hmc as jhmc
from cyclevae_tpu.infer import logjoint as jlj
from cyclevae_tpu.infer import smc as jsmc
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.infer import Draws, HMCConfig, SMCConfig
from cyclevae_tpu_torch.infer import hmc, logjoint, smc
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.models.gru_vae import gru_rnn_apply
from cyclevae_tpu_torch.vi.train import CycleVAEConfig

torch.set_num_threads(1)

MEAN = torch.tensor([1.0, -2.0, 0.5, 3.0])
COV = torch.tensor([0.5, 2.0, 1.0, 0.25])
GRAD_SCALE_TOL = 2e-4      # tests/test_gru_ar_vjp.py's gradient bound


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


class JaxHMCDraws(Draws):
    """Replays the JAX samplers' key splits: step i's momentum from
    split(keys[i])[0], its accept uniforms from split(keys[i])[1]."""

    def __init__(self, key, n_steps, batched=True):
        super().__init__(None)
        self.keys, self.i, self.batched = jax.random.split(key, n_steps + 1), 0, batched

    def momentum(self, shape):
        k_mom, self.k_acc = jax.random.split(self.keys[self.i])
        self.i += 1
        return _t(jax.random.normal(k_mom, shape if self.batched else shape[1:])).reshape(shape)

    def accept(self, shape):
        return _t(jax.random.uniform(self.k_acc, shape if self.batched else ())).reshape(shape)


def _models(hidden=16, lat=4, T=12, seed=0):
    """A JAX CycleVAE and the port's copy of it (kernel route: the fused
    K2/K3 path's plain versions on the CPU), features and a speaker code."""
    kw = dict(hidden_units=hidden, lat_dim=lat)
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=54).astype(np.float32)
    scale = (0.5 + rng.random(54)).astype(np.float32)
    jp = jax_init(jax.random.PRNGKey(seed), JaxConfig(**kw), mean, scale)
    tp = params_from_jax(jp, device="cpu")
    feats = (mean + scale * rng.normal(size=(T, 54))).astype(np.float32)
    code = np.tile([0.0, 1.0], (T, 1)).astype(np.float32)
    return JaxConfig(**kw), jp, CycleVAEConfig(**kw), tp, feats, code


@pytest.mark.parametrize("use_pallas", [True, False])
def test_logjoint_value_and_gradient_match_jax(use_pallas):
    """Batched and single log-joint: value within 1e-5 relative, gradient
    w.r.t. z within 2e-4 of its scale, against ``jax.value_and_grad``; the
    frozen parameters get no gradient."""
    jcfg, jp, tcfg, tp, feats, code = _models(hidden=24, lat=8, T=32)
    tcfg = CycleVAEConfig(hidden_units=24, lat_dim=8, use_pallas=use_pallas)
    z = np.random.default_rng(1).normal(size=(3, 32, 8)).astype(np.float32)
    jl = jlj.make_utterance_logjoint_batched(jp, jcfg, jnp.asarray(feats), jnp.asarray(code),
                                             obs_scale=50.0)
    want_v = np.asarray(jl(jnp.asarray(z)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jl(x)))(jnp.asarray(z)))
    tl = logjoint.make_utterance_logjoint_batched(tp, tcfg, _t(feats), _t(code), obs_scale=50.0)
    got_v, got_g = logjoint.value_and_grad(tl, _t(z))
    assert got_v.shape == (3,) and got_g.shape == z.shape
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5)
    assert np.max(np.abs(got_g.numpy() - want_g)) <= GRAD_SCALE_TOL * np.max(np.abs(want_g))
    assert all(t.grad is None for t in jax.tree_util.tree_leaves(tp))
    # the single-chain log-joint is the batched one at C = 1
    sl = logjoint.make_utterance_logjoint(tp, tcfg, _t(feats), _t(code), obs_scale=50.0)
    js = jlj.make_utterance_logjoint(jp, jcfg, jnp.asarray(feats), jnp.asarray(code),
                                     obs_scale=50.0)
    v1, g1 = logjoint.value_and_grad(sl, _t(z[1]))
    np.testing.assert_allclose(float(v1), float(js(jnp.asarray(z[1]))), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), got_g[1].numpy(), atol=1e-6)


def test_hmc_batch_replays_jax_draws():
    """``hmc_sample_batch`` on the decoder's log-joint for 7 steps (4
    windowed warmup + 3 sampling) with JAX's draws replayed: the same
    accept decisions, z within 1e-4 relative L2 (the adapted step grows to
    ~1.4, so 28 leapfrogs carry the float32 differences of the two
    decoders' sums: max abs 2e-4), the same adapted step size."""
    jcfg, jp, tcfg, tp, feats, code = _models()
    cfg = HMCConfig(step_size=0.02, n_leapfrog=4, n_warmup=4, n_samples=3)
    jl = jlj.make_utterance_logjoint_batched(jp, jcfg, jnp.asarray(feats), jnp.asarray(code),
                                             obs_scale=50.0)
    key = jax.random.PRNGKey(7)
    z0 = 0.5 * np.random.default_rng(2).normal(size=(4, 12, 4)).astype(np.float32)
    want, winfo = jax.jit(lambda k, z: jhmc.hmc_sample_batch(
        k, jl, z, jhmc.HMCConfig(*cfg)))(key, jnp.asarray(z0))
    tl = logjoint.make_utterance_logjoint_batched(tp, tcfg, _t(feats), _t(code), obs_scale=50.0)
    got, info = hmc.hmc_sample_batch(JaxHMCDraws(key, 7), tl, _t(z0), cfg)
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 4, 12, 4)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel
    moved = lambda s: np.any(np.abs(np.diff(s, axis=0)) > 0, axis=(2, 3))
    np.testing.assert_array_equal(moved(got.numpy()), moved(want))
    assert 0 < moved(want).sum() < moved(want).size      # accepts and rejects both
    for k in ("accept_prob", "warmup_accept_prob", "step_size"):
        np.testing.assert_allclose(float(info[k]), float(winfo[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(info["inv_mass"].numpy(), np.asarray(winfo["inv_mass"]),
                               rtol=1e-4, atol=1e-6)


def test_hmc_single_chain_replays_jax_draws():
    """``hmc_sample`` (one phase of warmup, C = 1) on a Gaussian with JAX's
    draws replayed: the same samples within 1e-4."""
    lj = logjoint.make_gaussian_logjoint(MEAN, COV)
    cfg = HMCConfig(step_size=0.7, n_leapfrog=5, n_warmup=6, n_samples=8)
    key = jax.random.PRNGKey(3)
    want, winfo = jax.jit(lambda k, z: jhmc.hmc_sample(
        k, jlj.make_gaussian_logjoint(jnp.asarray(MEAN.numpy()), jnp.asarray(COV.numpy())),
        z, jhmc.HMCConfig(*cfg)))(key, jnp.zeros(4))
    got, info = hmc.hmc_sample(JaxHMCDraws(key, 14, batched=False), lj, torch.zeros(4), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(info["step_size"]), float(winfo["step_size"]), rtol=1e-4)


def test_leapfrog_reversibility_and_energy():
    lj = logjoint.make_gaussian_logjoint(MEAN, COV)
    vg = lambda z: logjoint.value_and_grad(lj, z)
    z = torch.tensor([0.3, 0.1, -0.5, 1.0])
    p = torch.tensor([1.0, -0.3, 0.2, 0.4])
    z1, p1 = hmc._leapfrog(vg, z, p, 0.05, 30, torch.ones(4), list(vg(z)))
    z2, p2 = hmc._leapfrog(vg, z1, -p1, 0.05, 30, torch.ones(4), list(vg(z1)))
    np.testing.assert_allclose(z2.numpy(), z.numpy(), atol=1e-5)
    np.testing.assert_allclose((-p2).numpy(), p.numpy(), atol=1e-5)
    h0 = -lj(z) + 0.5 * torch.sum(p ** 2)
    h1 = -lj(z1) + 0.5 * torch.sum(p1 ** 2)
    assert abs(float(h1 - h0)) < 0.01


def test_hmc_batch_utterance_logjoint():
    """Batched-chain HMC through the tiny decoder's batch axis."""
    _, _, tcfg, tp, feats, code = _models(T=10)
    lj = logjoint.make_utterance_logjoint_batched(tp, tcfg, _t(feats), _t(code), obs_scale=50.0)
    cfg = HMCConfig(step_size=0.05, n_leapfrog=4, n_warmup=10, n_samples=10)
    s, info = hmc.hmc_sample_batch(Draws(torch.Generator().manual_seed(1)), lj,
                                   torch.zeros((3, 10, 4)), cfg)
    assert s.shape == (10, 3, 10, 4) and torch.isfinite(s).all()
    assert 0.0 <= float(info["accept_prob"]) <= 1.0


def test_systematic_resampling_unbiased():
    log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    draws = Draws(torch.Generator().manual_seed(0))
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(smc.systematic_resample_indices(draws, log_w).numpy(),
                              minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.02)
    # a uniform at the top of [0, 1) indexes no particle past the end
    top = Draws(None)
    top.uniform = lambda shape: torch.tensor(1.0 - 2 ** -24)
    assert int(smc.systematic_resample_indices(top, torch.log(torch.full((7,), 1 / 7))).max()) <= 6


def _kalman_log_marginal(ys, q, r):
    """Exact log p(y_{1:T}) for x_t ~ N(0, q) iid latent, y_t ~ N(x_t, r)."""
    var = q + r
    return float(np.sum(-0.5 * (np.log(2 * np.pi * var) + ys ** 2 / var)))


def test_smc_log_marginal_matches_exact():
    q, r, T = 1.0, 0.5, 25
    ys = torch.as_tensor(np.random.default_rng(0).normal(0, np.sqrt(q + r), size=T),
                         dtype=torch.float32)
    n = 4096
    _, info = smc.smc_filter(
        Draws(torch.Generator().manual_seed(0)), T,
        lambda n: {"x": torch.zeros(n)},
        lambda draws, state, t: {"x": draws.normal((n,)) * np.sqrt(q)},
        lambda state, t: -0.5 * (np.log(2 * np.pi * r) + (ys[t] - state["x"]) ** 2 / r),
        SMCConfig(n_particles=n, ess_threshold=0.5))
    exact = _kalman_log_marginal(ys.numpy().astype(np.float64), q, r)
    assert abs(float(info["log_marginal"]) - exact) < 0.25, (float(info["log_marginal"]), exact)


def _ar1_ssm(a, q, r, ys):
    """SMC callables for x_0~N(0,q), x_t = a x_{t-1} + N(0,q), y_t~N(x_t,r)."""
    def propagate(draws, state, t):
        mean = a * state["x"] if t > 0 else torch.zeros_like(state["x"])
        return {"x": mean + draws.normal(state["x"].shape) * np.sqrt(q)}

    def log_weight(state, t):
        return -0.5 * (np.log(2 * np.pi * r) + (ys[t] - state["x"]) ** 2 / r)

    return lambda n: {"x": torch.zeros(n)}, propagate, log_weight


def _rts_smoother(ys, a, q, r):
    """Exact Kalman filter + Rauch-Tung-Striebel smoother (scalar SSM)."""
    T = len(ys)
    mf, pf, mp_, pp = np.zeros(T), np.zeros(T), np.zeros(T), np.zeros(T)
    m, p = 0.0, q
    for t in range(T):
        if t > 0:
            m, p = a * m, a * a * p + q
        mp_[t], pp[t] = m, p
        k = p / (p + r)
        m = m + k * (ys[t] - m)
        p = (1 - k) * p
        mf[t], pf[t] = m, p
    ms, ps = mf.copy(), pf.copy()
    for t in range(T - 2, -1, -1):
        g = pf[t] * a / pp[t + 1]
        ms[t] = mf[t] + g * (ms[t + 1] - mp_[t + 1])
        ps[t] = pf[t] + g * g * (ps[t + 1] - pp[t + 1])
    return ms, ps, mf


def test_smc_smoother_matches_rts():
    a, q, r, T = 0.9, 0.1, 0.05, 20
    rng = np.random.default_rng(3)
    xs = np.zeros(T)
    xs[0] = rng.normal(0, np.sqrt(q))
    for t in range(1, T):
        xs[t] = a * xs[t - 1] + rng.normal(0, np.sqrt(q))
    ys_np = xs + rng.normal(0, np.sqrt(r), size=T)
    init, propagate, log_weight = _ar1_ssm(a, q, r, torch.as_tensor(ys_np, dtype=torch.float32))
    _, info = smc.smc_filter(Draws(torch.Generator().manual_seed(0)), T, init, propagate,
                             log_weight, SMCConfig(n_particles=4096, ess_threshold=0.6),
                             store=lambda s: s["x"])
    traj, w = smc.smc_smoothed_trajectories(info)
    sm_mean = torch.einsum("n,tn->t", w, traj).numpy()
    ms, ps, mf = _rts_smoother(ys_np, a, q, r)
    err = np.abs(sm_mean - ms)
    assert np.all(err < 2.5 * np.sqrt(ps) / 3), (err, np.sqrt(ps))
    assert err.mean() < 0.05, err.mean()
    # ... and it must genuinely SMOOTH
    t_star = int(np.argmax(np.abs(ms - mf)[:-1]))
    assert abs(sm_mean[t_star] - ms[t_star]) < abs(mf[t_star] - ms[t_star])


class JaxSMCDraws(Draws):
    """Replays ``smc_filter``'s key splits: k_init first; then each step's
    propagation noise (one normal per particle from split(k_prop, n)) and
    its resampling uniform from k_res."""

    def __init__(self, key):
        super().__init__(None)
        self.key, _ = jax.random.split(key)

    def normal(self, shape):
        self.key, k_prop, self.k_res = jax.random.split(self.key, 3)
        keys = jax.random.split(k_prop, shape[0])
        return _t(jax.vmap(lambda k: jax.random.normal(k, shape[1:]))(keys))

    def uniform(self, shape):
        return _t(jax.random.uniform(self.k_res, shape))


@pytest.mark.parametrize("proposal", ["prior", "amortized"])
def test_decoder_ssm_replays_jax_draws(proposal):
    """SMC over the decoder SSM with JAX's draws replayed: the log marginal
    within 1e-4 relative, the same resampling steps."""
    jcfg, jp, tcfg, tp, feats, code = _models(T=12)
    kw = dict(obs_scale=10.0)
    jkw, tkw = dict(kw), dict(kw)
    if proposal == "amortized":
        enc, _, _ = gru_rnn_apply(tp.encoder, tcfg.enc_cfg, _t(feats)[None],
                                  torch.zeros((1, 8)), clamp_vae=True, lat_dim=4,
                                  use_pallas=False)
        jkw.update(proposal="amortized", enc_lat=jnp.asarray(enc[0].numpy()), guide_weight=0.5)
        tkw.update(proposal="amortized", enc_lat=enc[0], guide_weight=0.5)
    cfg = SMCConfig(n_particles=128, ess_threshold=0.8)
    ji, jpp, jw = jsmc.make_decoder_ssm(jp, jcfg, jnp.asarray(feats), jnp.asarray(code), **jkw)
    key = jax.random.PRNGKey(1)
    _, want = jax.jit(lambda k: jsmc.smc_filter(k, 12, ji, jpp, jw, jsmc.SMCConfig(*cfg)))(key)
    init, prop, logw = smc.make_decoder_ssm(tp, tcfg, _t(feats), _t(code), **tkw)
    states, got = smc.smc_filter(JaxSMCDraws(key), 12, init, prop, logw, cfg)
    assert states["h"].shape == (128, 1, 16)
    np.testing.assert_allclose(float(got["log_marginal"]), float(want["log_marginal"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(got["resampled"].numpy(), np.asarray(want["resampled"]))
    assert 0 < int(got["resampled"].sum()) < 12
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want["ess"]), rtol=1e-3)


def test_decoder_ssm_smoothing_runs():
    """Genealogy smoothing through the decoder SSM: shapes, finiteness, weights."""
    _, _, tcfg, tp, feats, code = _models(T=12)
    tcfg = CycleVAEConfig(hidden_units=16)
    tp = params_from_jax(jax_init(jax.random.PRNGKey(0), JaxConfig(hidden_units=16),
                                  np.zeros(54, np.float32), np.ones(54, np.float32)),
                         device="cpu")
    init, prop, logw = smc.make_decoder_ssm(tp, tcfg, _t(feats), _t(code))
    _, info = smc.smc_filter(Draws(torch.Generator().manual_seed(1)), 12, init, prop, logw,
                             SMCConfig(n_particles=64, ess_threshold=0.8),
                             store=lambda s: s["z"])
    traj, w = smc.smc_smoothed_trajectories(info)
    assert traj.shape == (12, 64, tcfg.lat_dim) and torch.isfinite(traj).all()
    np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-5)
    # every lane is an ancestral path: lane j at the end is final particle j
    np.testing.assert_array_equal(traj[-1].numpy(), info["stored"][-1][
        info["ancestors"][-1]].numpy())


def test_guided_smc_keeps_ess():
    """The amortized proposal runs and keeps comparable ESS with an
    untrained encoder (tests/test_infer.py's guided-SMC check)."""
    _, _, tcfg, tp, _, _ = _models(T=16)
    T = 16
    feats = _t(np.random.default_rng(0).normal(size=(T, 54)).astype(np.float32))
    code = _t(np.tile([1.0, 0.0], (T, 1)).astype(np.float32))
    enc, _, _ = gru_rnn_apply(tp.encoder, tcfg.enc_cfg, feats[None], torch.zeros((1, 8)),
                              clamp_vae=True, lat_dim=4, use_pallas=False)
    ess = {}
    for name, kw in (("prior", {}), ("amortized", {"proposal": "amortized",
                                                   "enc_lat": enc[0]})):
        init, prop, logw = smc.make_decoder_ssm(tp, tcfg, feats, code, obs_scale=10.0, **kw)
        _, info = smc.smc_filter(Draws(torch.Generator().manual_seed(1)), T, init, prop, logw,
                                 SMCConfig(n_particles=128))
        ess[name] = float(info["ess"].mean())
        assert np.isfinite(float(info["log_marginal"]))
    assert ess["amortized"] > 0.2 * ess["prior"], ess
