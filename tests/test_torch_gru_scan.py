"""The port's plain AR-GRU scan against the JAX package's ``gru_ar_scan`` (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models.layers import init_dense, init_gru_stack
from cyclevae_tpu.ops.gru_scan import gru_ar_scan as jax_scan
from cyclevae_tpu_torch.ops.gru_scan import gru_ar_scan

torch.set_num_threads(1)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("n_layers,mask,res", [
    (1, False, False), (2, False, False), (1, True, False), (2, True, True),
    (1, False, True)])
def test_gru_ar_scan_matches_jax(n_layers, mask, res):
    conv_dim, out_dim, H, B, T = 14, 6, 32, 3, 20
    k1, k2 = jax.random.split(jax.random.PRNGKey(n_layers))
    rng = np.random.default_rng(n_layers + 2 * mask + 4 * res)
    gru = init_gru_stack(k1, conv_dim + out_dim, H, n_layers)
    for layer in gru:   # nonzero biases exercise every bias path
        layer["b_ih"] = jnp.asarray(rng.normal(size=3 * H).astype(np.float32) * 0.1)
        layer["b_hh"] = jnp.asarray(rng.normal(size=3 * H).astype(np.float32) * 0.1)
    out = init_dense(k2, H, out_dim)
    conv = rng.normal(size=(B, T, conv_dim)).astype(np.float32)
    y0 = rng.normal(size=(B, out_dim)).astype(np.float32)
    h0 = rng.normal(size=(n_layers, B, H)).astype(np.float32) * 0.5
    m = ((rng.random((B, T, H)) > 0.3) / 0.7).astype(np.float32) if mask else None
    r = rng.normal(size=(B, T, out_dim)).astype(np.float32) if res else None

    want = jax_scan(gru, out, jnp.asarray(conv), jnp.asarray(y0), jnp.asarray(h0),
                    None if m is None else jnp.asarray(m),
                    None if r is None else jnp.asarray(r))
    got = gru_ar_scan(_t(gru), _t(out), torch.tensor(conv), torch.tensor(y0),
                      torch.tensor(h0), None if m is None else torch.tensor(m),
                      None if r is None else torch.tensor(r))
    # the JAX package's scan tolerance (tests/test_layers.py, test_pallas_gru.py)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
