"""Moment checks of the port's samplers (``cyclevae_tpu_torch.infer``) on
Gaussian targets, as ``tests/test_infer.py`` makes them for the JAX
package, at its tolerances: single-chain, chained and batched HMC, and
single-chain NUTS."""

import jax
import numpy as np
import torch

from cyclevae_tpu_torch.infer import Draws, HMCConfig, NUTSConfig
from cyclevae_tpu_torch.infer import hmc, logjoint, nuts

from test_torch_infer import COV, MEAN, JaxHMCDraws

torch.set_num_threads(1)


class JaxChainsDraws(Draws):
    """Replays ``hmc_sample_chains``'s key splits: chain c runs
    ``hmc_sample`` on split(key, C)[c]."""

    def __init__(self, key, n_chains, n_steps):
        super().__init__(None)
        self.chains = [JaxHMCDraws(k, n_steps, batched=False)
                       for k in jax.random.split(key, n_chains)]

    def momentum(self, shape):
        return torch.stack([c.momentum((1,) + tuple(shape[1:]))[0] for c in self.chains])

    def accept(self, shape):
        return torch.stack([c.accept((1,))[0] for c in self.chains])


def test_hmc_gaussian_moments():
    lj = logjoint.make_gaussian_logjoint(MEAN, COV)
    cfg = HMCConfig(step_size=0.2, n_leapfrog=8, n_warmup=300, n_samples=2000)
    s, info = hmc.hmc_sample(Draws(torch.Generator().manual_seed(0)), lj, torch.zeros(4), cfg)
    assert float(info["accept_prob"]) > 0.5
    np.testing.assert_allclose(s.mean(0).numpy(), MEAN.numpy(), atol=0.15)
    np.testing.assert_allclose(s.var(0).numpy(), COV.numpy(), rtol=0.35)


def test_hmc_chains():
    """Chains of a single-chain target, with ``tests/test_infer.py``'s JAX
    draws replayed (HMC's L * step ~ one period of the 4th coordinate makes
    its mean a slow, seed-dependent estimate; the replay makes it the JAX
    test's own estimate)."""
    lj = logjoint.make_gaussian_logjoint(MEAN, COV)
    cfg = HMCConfig(step_size=0.2, n_leapfrog=8, n_warmup=200, n_samples=500)
    s, info = hmc.hmc_sample_chains(JaxChainsDraws(jax.random.PRNGKey(1), 4, 700), lj,
                                    torch.zeros((4, 4)), cfg)
    assert s.shape == (4, 500, 4)
    np.testing.assert_allclose(s.reshape(-1, 4).mean(0).numpy(), MEAN.numpy(), atol=0.15)
    # shared adaptation -> identical step size across chains
    ss = info["step_size"].numpy()
    assert ss.shape == (4,)
    np.testing.assert_allclose(ss, ss[0], rtol=1e-6)
    # without it each chain adapts its own
    _, own = hmc.hmc_sample_chains(Draws(torch.Generator().manual_seed(1)), lj,
                                   torch.zeros((3, 4)), HMCConfig(0.2, 4, 20, 5),
                                   shared_adaptation=False)
    assert len(set(own["step_size"].tolist())) == 3


def test_hmc_batched_chains_gaussian():
    cfg = HMCConfig(step_size=0.2, n_leapfrog=8, n_warmup=300, n_samples=800)
    s, info = hmc.hmc_sample_batch(Draws(torch.Generator().manual_seed(6)),
                                   lambda z: -0.5 * torch.sum((z - MEAN) ** 2 / COV, dim=-1),
                                   torch.zeros((16, 4)), cfg)
    s = s.reshape(-1, 4).numpy()
    assert float(info["accept_prob"]) > 0.5
    np.testing.assert_allclose(s.mean(0), MEAN.numpy(), atol=0.1)
    # autocorrelated draws -> wide variance CI; check the right scale only
    np.testing.assert_allclose(s.var(0), COV.numpy(), rtol=0.5)


def test_nuts_gaussian_moments():
    cfg = NUTSConfig(step_size=0.2, max_depth=6, n_warmup=300, n_samples=1500)
    s, info = nuts.nuts_sample(Draws(torch.Generator().manual_seed(2)),
                               logjoint.make_gaussian_logjoint(MEAN, COV), torch.zeros(4), cfg)
    assert float(info["divergence_rate"]) < 0.05
    assert float(info["mean_depth"]) >= 1.0
    np.testing.assert_allclose(s.mean(0).numpy(), MEAN.numpy(), atol=0.15)
    np.testing.assert_allclose(s.var(0).numpy(), COV.numpy(), rtol=0.35)
