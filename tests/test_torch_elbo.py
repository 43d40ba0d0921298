"""The port's ELBO algebra (``vi/elbo.py``, ``models.gru_vae.loss_vae*``)
against the JAX package's, with and without masks (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyclevae_tpu.models import gru_vae as jgv
from cyclevae_tpu.vi import elbo as je
from cyclevae_tpu_torch.models import gru_vae as tgv
from cyclevae_tpu_torch.vi import elbo as te

torch.set_num_threads(1)

# float32 reductions over a few hundred values in another order
RTOL, ATOL = 1e-5, 1e-5


def _data(seed, masked):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 17, 8)).astype(np.float32)
    y = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    mask = (np.arange(17)[None] < np.array([[17], [9], [0]])).astype(np.float32) if masked else None
    return x, y, mask


def _both(fn_j, fn_t, *arrays, **kw):
    j = fn_j(*(None if a is None else jnp.asarray(a) for a in arrays), **kw)
    t = fn_t(*(None if a is None else torch.tensor(a) for a in arrays), **kw)
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    for a, b in zip(t, j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["mcd_l1", "mcd_l2", "rmse_corr", "rmse_corr_l1"])
def test_pairwise_metrics_match_jax(name, masked):
    x, y, mask = _data(1, masked)
    kw = {"l2": False} if name == "rmse_corr_l1" else {}
    name = name.replace("_l1", "") if name == "rmse_corr_l1" else name
    _both(getattr(je, name), getattr(te, name), x, y, mask, **kw)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ddof", [0, 1])
def test_variance_metrics_match_jax(masked, ddof):
    x, _, mask = _data(2, masked)
    _both(je.masked_var, te.masked_var, x, mask, ddof=ddof)
    gv = (0.5 + np.random.default_rng(2).random(8)).astype(np.float32)
    if masked:   # the all-padding utterance has no variance to take the log of
        x, mask = x[:2], mask[:2]
    _both(je.gv_log_rmse, te.gv_log_rmse, x, gv, mask, ddof=ddof)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_mean_matches_jax(masked):
    x, _, mask = _data(3, masked)
    _both(je.masked_mean, te.masked_mean, x[..., 0], mask)
    assert te.mcd_constant() == je.mcd_constant()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("laplace", [False, True])
@pytest.mark.parametrize("relu_vae", [False, True])
def test_kl_terms_match_jax(laplace, relu_vae, masked):
    rng = np.random.default_rng(4)
    param = rng.normal(size=(3, 17, 12)).astype(np.float32)
    if relu_vae:   # the aux lanes hold a variance / scale: positive
        param[..., 6:] = np.abs(param[..., 6:]) + 1e-3
    _, _, mask = _data(4, masked)
    name = "loss_vae_laplace" if laplace else "loss_vae"
    _both(getattr(jgv, name), getattr(tgv, name), param, 6, mask, relu_vae=relu_vae)
