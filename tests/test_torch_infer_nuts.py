"""The port's NUTS (``infer/nuts.py``, ``infer/nuts_batch.py``) against the
JAX package's on the CPU: single-chain and batched transitions with JAX's
key splits replayed into their draws (the same trees, so the same samples),
the helpers, chains of a single-chain target, and the batched sampler on a
Gaussian (``tests/test_infer.py``'s tolerances) and on the decoder."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.infer import logjoint as jlj
from cyclevae_tpu.infer import nuts as jnuts
from cyclevae_tpu.infer import nuts_batch as jnb
from cyclevae_tpu_torch.infer import Draws, NUTSConfig
from cyclevae_tpu_torch.infer import logjoint, nuts, nuts_batch

from test_torch_infer import COV, MEAN, _models, _t

torch.set_num_threads(1)


class JaxNUTSDraws(Draws):
    """Replays the JAX NUTS key tree: per transition split(keys[i]) ->
    (k_mom, k_run); per doubling split(k_run, 4) -> (k_run, k_dir, k_sub,
    k_swap); per leaf split(k_sub) -> (k_sub, k_acc).  ``batched``: draws of
    shape (C,) as ``nuts_batch``; else shape () as ``nuts`` (C = 1)."""

    def __init__(self, key, n_transitions, batched):
        super().__init__(None)
        self.keys, self.i, self.batched = jax.random.split(key, n_transitions + 1), 0, batched

    def _shape(self, shape):
        return shape if self.batched else ()

    def momentum(self, shape):
        k_mom, self.run = jax.random.split(self.keys[self.i])
        self.i += 1
        return _t(jax.random.normal(k_mom, shape if self.batched else shape[1:])).reshape(shape)

    def direction(self, shape):
        self.run, k_dir, self.sub, self.k_swap = jax.random.split(self.run, 4)
        return _t(jax.random.bernoulli(k_dir, shape=self._shape(shape))).reshape(shape)

    def leaf(self, shape):
        self.sub, k_acc = jax.random.split(self.sub)
        return _t(jax.random.uniform(k_acc, self._shape(shape))).reshape(shape)

    def swap(self, shape):
        return _t(jax.random.uniform(self.k_swap, self._shape(shape))).reshape(shape)


def _jax_gauss():
    return jlj.make_gaussian_logjoint(jnp.asarray(MEAN.numpy()), jnp.asarray(COV.numpy()))


def test_nuts_single_chain_replays_jax_draws():
    """``nuts_sample`` with JAX's draws replayed: the same trees (depths,
    leapfrogs) and samples within 1e-4."""
    cfg = NUTSConfig(step_size=0.3, max_depth=5, n_warmup=8, n_samples=12)
    key = jax.random.PRNGKey(21)
    want, winfo = jax.jit(lambda k, z: jnuts.nuts_sample(k, _jax_gauss(), z,
                                                         jnuts.NUTSConfig(*cfg)))(
        key, jnp.zeros(4))
    got, info = nuts.nuts_sample(JaxNUTSDraws(key, 20, batched=False),
                                 logjoint.make_gaussian_logjoint(MEAN, COV), torch.zeros(4), cfg)
    assert got.shape == (12, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for k in ("accept_stat", "warmup_accept_stat", "mean_depth", "step_size"):
        np.testing.assert_allclose(float(info[k]), float(winfo[k]), rtol=1e-4, err_msg=k)
    assert float(info["mean_depth"]) > 1.0


@pytest.mark.parametrize("target", ["gauss", "decoder"])
def test_nuts_batch_replays_jax_draws(target):
    """``nuts_sample_batch`` (windowed warmup, chains in lockstep) with JAX's
    draws replayed: the same samples, on a Gaussian within 1e-4 and on the
    decoder's log-joint within 1e-4 relative L2."""
    key = jax.random.PRNGKey(5)
    if target == "gauss":
        C, shape = 3, (4,)
        cfg = NUTSConfig(step_size=0.3, max_depth=5, n_warmup=6, n_samples=6)
        jl = lambda z: -0.5 * jnp.sum((z - jnp.asarray(MEAN.numpy())) ** 2
                                      / jnp.asarray(COV.numpy()), axis=-1)
        tl = lambda z: -0.5 * torch.sum((z - MEAN) ** 2 / COV, dim=-1)
    else:
        jcfg, jp, tcfg, tp, feats, code = _models(T=8)
        C, shape = 3, (8, 4)
        cfg = NUTSConfig(step_size=0.05, max_depth=3, n_warmup=2, n_samples=3)
        jl = jlj.make_utterance_logjoint_batched(jp, jcfg, jnp.asarray(feats),
                                                 jnp.asarray(code), obs_scale=50.0)
        tl = logjoint.make_utterance_logjoint_batched(tp, tcfg, _t(feats), _t(code),
                                                      obs_scale=50.0)
    n = cfg.n_warmup + cfg.n_samples
    want, winfo = jax.jit(lambda k, z: jnb.nuts_sample_batch(k, jl, z, jnuts.NUTSConfig(*cfg)))(
        key, jnp.zeros((C,) + shape))
    got, info = nuts_batch.nuts_sample_batch(JaxNUTSDraws(key, n, batched=True), tl,
                                             torch.zeros((C,) + shape), cfg)
    want = np.asarray(want)
    assert got.shape == want.shape == (cfg.n_samples, C) + shape
    if target == "gauss":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    else:
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < 1e-4, rel
    for k in ("accept_stat", "divergence_rate", "mean_leapfrog", "saturation_rate",
              "step_size"):
        np.testing.assert_allclose(float(info[k]), float(winfo[k]), rtol=1e-4, err_msg=k)


def test_nuts_helpers():
    assert [nuts._tz(n, 8) for n in (0, 1, 2, 3, 4, 6, 8, 12, 256, 1024)] == \
        [8, 0, 1, 0, 2, 1, 3, 2, 8, 8]
    assert [nuts._tz(n, 8) for n in range(16)] == \
        [int(jnuts._tz(jnp.int32(n), 8)) for n in range(16)]
    z, p = torch.tensor([1.0, 0.0]), torch.tensor([1.0, 0.0])
    assert not bool(nuts._uturn(z, p, -z, p))
    assert bool(nuts._uturn(z, -p, -z, p))


def test_nuts_chains_shared_adaptation():
    """Chains of a single-chain target: one shared step size, moments."""
    cfg = NUTSConfig(step_size=0.3, max_depth=5, n_warmup=100, n_samples=200)
    s, info = nuts.nuts_sample_chains(Draws(torch.Generator().manual_seed(9)),
                                      logjoint.make_gaussian_logjoint(MEAN, COV),
                                      torch.zeros((4, 4)), cfg)
    assert s.shape == (200, 4, 4) and info["step_size"].shape == (4,)
    np.testing.assert_allclose(info["step_size"].numpy(), float(info["step_size"][0]))
    np.testing.assert_allclose(s.reshape(-1, 4).mean(0).numpy(), MEAN.numpy(), atol=0.2)


def test_nuts_batched_chains_gaussian():
    cfg = NUTSConfig(step_size=0.3, max_depth=6, n_warmup=200, n_samples=600)
    s, info = nuts_batch.nuts_sample_batch(
        Draws(torch.Generator().manual_seed(13)),
        lambda z: -0.5 * torch.sum((z - MEAN) ** 2 / COV, dim=-1), torch.zeros((8, 4)), cfg)
    s = s.reshape(-1, 4).numpy()
    assert float(info["divergence_rate"]) < 0.05
    np.testing.assert_allclose(s.mean(0), MEAN.numpy(), atol=0.12)
    np.testing.assert_allclose(s.var(0), COV.numpy(), rtol=0.4)


def test_nuts_batched_utterance_logjoint():
    _, _, tcfg, tp, feats, code = _models(T=8)
    lj = logjoint.make_utterance_logjoint_batched(tp, tcfg, _t(feats), _t(code), obs_scale=50.0)
    cfg = NUTSConfig(step_size=0.05, max_depth=4, n_warmup=5, n_samples=8)
    s, info = nuts_batch.nuts_sample_batch(Draws(torch.Generator().manual_seed(1)), lj,
                                           torch.zeros((3, 8, 4)), cfg)
    assert s.shape == (8, 3, 8, 4) and torch.isfinite(s).all()
    # one transition of the kernel alone
    z, st = nuts_batch.nuts_kernel_batch(Draws(torch.Generator().manual_seed(2)), lj, s[-1],
                                         info["step_size"], info["inv_mass"], cfg)
    assert z.shape == (3, 8, 4) and st["accept_stat"].shape == (3,)
