"""NUTS of the port (``infer/nuts.py``, ``infer/nuts_batch.py``) on
targets that need long trajectories or adaptation, as ``tests/test_infer.py``
checks the JAX package's, at its tolerances: dual averaging into the target
acceptance, and correlated 2-D Gaussians for the single-chain and the
batched sampler."""

import numpy as np
import torch

from cyclevae_tpu_torch.infer import Draws, NUTSConfig
from cyclevae_tpu_torch.infer import logjoint, nuts, nuts_batch

from test_torch_infer import COV, MEAN

torch.set_num_threads(1)


def test_nuts_adapts_into_target_accept():
    cfg = NUTSConfig(step_size=1.5, max_depth=6, n_warmup=400, n_samples=300,
                     target_accept=0.8)
    _, info = nuts.nuts_sample(Draws(torch.Generator().manual_seed(3)),
                               logjoint.make_gaussian_logjoint(MEAN, COV), torch.zeros(4), cfg)
    assert 0.6 < float(info["accept_stat"]) <= 1.0


def test_nuts_correlated_gaussian():
    """Correlated 2-D Gaussian: mean and covariance (off-diagonal included);
    trajectories longer than one step."""
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)
    mean = torch.tensor([1.0, -1.0])

    def lj(z):
        d = z - mean
        return -0.5 * d @ prec @ d

    cfg = NUTSConfig(step_size=0.3, max_depth=6, n_warmup=300, n_samples=2000)
    s, info = nuts.nuts_sample(Draws(torch.Generator().manual_seed(11)), lj, torch.zeros(2),
                               cfg)
    s = s.numpy()
    np.testing.assert_allclose(s.mean(0), mean.numpy(), atol=0.1)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.2)
    assert float(info["mean_depth"]) >= 1.5  # correlation forces longer trees


def test_nuts_batched_correlated():
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)
    mean = torch.tensor([1.0, -1.0])

    def lj(z):
        d = z - mean
        return -0.5 * torch.einsum("ci,ij,cj->c", d, prec, d)

    cfg = NUTSConfig(step_size=0.3, max_depth=6, n_warmup=200, n_samples=800)
    s, _ = nuts_batch.nuts_sample_batch(Draws(torch.Generator().manual_seed(14)), lj,
                                        torch.zeros((6, 2)), cfg)
    s = s.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(0), mean.numpy(), atol=0.12)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.25)
