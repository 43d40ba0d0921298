"""The port's fused AR-GRU with its hand-derived gradient (``gru_ar_fused``, a
``torch.autograd.Function`` over K2 and K3; their plain versions on the CPU)
against ``jax.grad`` of the JAX package's ``gru_ar_fused(..., "xla")`` and
against torch autograd of the port's plain ``gru_ar_scan``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.ops.gru_ar_vjp import gru_ar_fused as jax_fused
from cyclevae_tpu_torch.ops.gru_ar_vjp import gru_ar_fused
from cyclevae_tpu_torch.ops.gru_scan import gru_ar_scan

torch.set_num_threads(1)

NAMES = ("w_ih_y", "w_hh", "b_hh", "w_out", "b_out", "gates_x", "y0", "h0", "out_mask")


def _problem(B, T, H, out, seed):
    rng = np.random.default_rng(seed)
    f = lambda scale, *s: (scale * rng.normal(size=s)).astype(np.float32)
    a = 1.0 / np.sqrt(H)
    return dict(w_ih_y=f(a, 3 * H, out), w_hh=f(a, 3 * H, H), b_hh=f(0.1, 3 * H),
                w_out=f(a, out, H), b_out=f(0.1, out), gates_x=f(0.5, B, T, 3 * H),
                y0=f(0.1, B, out), h0=f(0.1, B, H),
                out_mask=((rng.random((B, T, H)) < 0.7) / 0.7).astype(np.float32))


def _loss(trj, y_T, h_T, lib):
    return lib.sum(trj ** 2) + lib.sum(lib.sin(y_T)) + lib.sum(h_T ** 2)


def _torch_grads(p, fn):
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    _loss(*fn(ts), torch).backward()
    return [ts[k].grad.numpy() for k in NAMES]


def _fused(ts, wdt=torch.float32):
    return gru_ar_fused(*(ts[k] for k in NAMES), weight_dtype=wdt)


def _scan(ts):
    """The same function through the plain scan: gates_x enters as the conv
    part of the input with an identity projection."""
    B, T, G = ts["gates_x"].shape
    layer = {"w_ih": torch.cat([torch.eye(G), ts["w_ih_y"]], dim=1), "w_hh": ts["w_hh"],
             "b_ih": torch.zeros(G), "b_hh": ts["b_hh"]}
    trj, y_T, h_T = gru_ar_scan([layer], {"w": ts["w_out"], "b": ts["b_out"]},
                                ts["gates_x"], ts["y0"], ts["h0"][None], ts["out_mask"])
    return trj, y_T, h_T[0]


def _assert_close(got, want):
    # the JAX package's gradient tolerance (tests/test_gru_ar_vjp.py:53-73):
    # float32 sums in another order, scaled by the largest value of each leaf
    for g, w in zip(got, want):
        scale = max(float(np.max(np.abs(w))), 1e-3)
        np.testing.assert_allclose(g, w, atol=2e-4 * scale, rtol=2e-4)


@pytest.mark.parametrize("B,T,H,out", [(3, 12, 16, 6), (2, 40, 24, 10), (2, 9, 64, 8)])
def test_gradients_match_jax_and_autograd_of_scan(B, T, H, out):
    p = _problem(B, T, H, out, seed=B * T + H)
    want = jax.grad(lambda a: _loss(*jax_fused(*a, "xla"), jnp),
                    argnums=0)(tuple(jnp.asarray(p[k]) for k in NAMES))
    got = _torch_grads(p, _fused)
    _assert_close(got, [np.asarray(w) for w in want])
    _assert_close(got, _torch_grads(p, _scan))


def test_forward_matches_jax():
    p = _problem(2, 15, 32, 8, seed=1)
    want = jax_fused(*(jnp.asarray(p[k]) for k in NAMES), "xla")
    got = _fused({k: torch.tensor(v) for k, v in p.items()})
    for g, w in zip(got, want):
        # tests/test_gru_ar_vjp.py's forward tolerance
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_bf16_gradients_track_f32_reference():
    """bf16 weights round the products' operands, the residuals and the gate
    cotangents to bf16 (as the JAX package's bf16 path does): every
    gradient must keep the f32 reference's direction (cosine > 0.999) and
    scale (rel L2 < 3e-2), the bounds of tests/test_gru_ar_vjp.py:128-161."""
    p = _problem(2, 16, 16, 6, seed=7)
    want = _torch_grads(p, _scan)
    got = _torch_grads(p, lambda ts: _fused(ts, torch.bfloat16))
    for g, w in zip(got, want):
        g, w = g.astype(np.float64).ravel(), w.astype(np.float64).ravel()
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 3e-2


def test_bf16_gradients_are_rounded_like_jax():
    """The returned gradients are bf16 values (JAX's ``_bwd`` casts them to
    its bf16 input dtypes); those of inputs that need none stay None."""
    p = _problem(2, 8, 16, 6, seed=8)
    ts = {k: torch.tensor(v, requires_grad=k in ("w_hh", "gates_x")) for k, v in p.items()}
    _loss(*_fused(ts, torch.bfloat16), torch).backward()
    for k in ("w_hh", "gates_x"):
        g = ts[k].grad
        torch.testing.assert_close(g, g.to(torch.bfloat16).float(), atol=0, rtol=0)
    assert all(ts[k].grad is None for k in NAMES if k not in ("w_hh", "gates_x"))
