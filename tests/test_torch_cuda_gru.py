"""The plain version of the port's fused AR-GRU (``gru_ar_reference``, what
``cuda_gru_ar`` runs on CPU tensors) against the JAX package's Pallas kernel
``pallas_gru_ar`` in TPU interpret mode (CPU).  The CUDA kernel itself is held
against the same plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models import GRURNNConfig, init_gru_rnn
from cyclevae_tpu.ops.gru_scan import precompute_input_gates
from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar, gru_ar_reference

torch.set_num_threads(1)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _problem(H, out, B, T, seed):
    cfg = GRURNNConfig(in_dim=6, out_dim=out, hidden_units=H,
                       scale_in=False, scale_out=False)
    params = init_gru_rnn(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    layer = dict(params["gru"][0])
    layer["b_hh"] = jnp.asarray(rng.normal(size=3 * H).astype(np.float32) * 0.1)
    proj = dict(params["out"])
    proj["b"] = jnp.asarray(rng.normal(size=out).astype(np.float32) * 0.1)
    conv = jnp.asarray(rng.normal(size=(B, T, 6 * 9)).astype(np.float32)) * 0.3
    gx = precompute_input_gates(layer, conv)
    y0 = jnp.asarray(rng.normal(size=(B, out)).astype(np.float32) * 0.5)
    h0 = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32) * 0.5)
    return layer, proj, gx, y0, h0


def _run_pallas(layer, proj, gx, y0, h0, wdt):
    from jax.experimental.pallas import tpu as pltpu
    from cyclevae_tpu.ops.pallas_gru import pallas_gru_ar
    with pltpu.force_tpu_interpret_mode():
        return pallas_gru_ar(layer, proj, gx, y0, h0, weight_dtype=wdt)


@pytest.mark.parametrize("H,out,B,T", [(32, 8, 2, 12), (64, 10, 3, 40)])
def test_reference_matches_pallas_f32(H, out, B, T):
    layer, proj, gx, y0, h0 = _problem(H, out, B, T, seed=H)
    want = _run_pallas(layer, proj, gx, y0, h0, jnp.float32)
    got = gru_ar_reference(_t(layer), _t(proj), _t(gx), _t(y0), _t(h0))
    # tests/test_pallas_gru.py's tolerance for the kernel vs the scan
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("H,out,B,T", [(32, 8, 2, 12), (64, 10, 3, 40)])
def test_reference_matches_pallas_bf16(H, out, B, T):
    layer, proj, gx, y0, h0 = _problem(H, out, B, T, seed=H + 1)
    want = _run_pallas(layer, proj, gx, y0, h0, jnp.bfloat16)
    got = gru_ar_reference(_t(layer), _t(proj), _t(gx), _t(y0), _t(h0),
                           torch.bfloat16)
    # both round the same operands to bf16; a sum on a rounding boundary may
    # round the other way and then differs at bf16 precision: the JAX
    # package's bf16 bounds (tests/test_gru_ar_vjp.py)
    for g, w in zip(got, want):
        g, w = g.numpy().ravel(), np.asarray(w).ravel()
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 3e-2
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    layer, proj, gx, y0, h0 = (_t(a) for a in _problem(32, 8, 2, 12, seed=5))
    before = cuda_gru_ar.launches
    got = cuda_gru_ar(layer, proj, gx, y0, h0)
    want = gru_ar_reference(layer, proj, gx, y0, h0)
    assert cuda_gru_ar.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=0, rtol=0)
