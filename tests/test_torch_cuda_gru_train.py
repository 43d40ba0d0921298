"""The plain versions of the port's training kernels (what ``cuda_gru_ar_train``
and ``cuda_gru_ar_bwd`` run on CPU tensors) against the JAX package's Pallas
kernels ``pallas_gru_ar_train`` (K2) and ``pallas_gru_ar_bwd`` (K3) in TPU
interpret mode (CPU).  The CUDA kernels themselves are held against the same
plain versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from cyclevae_tpu.ops.pallas_gru import pallas_gru_ar_bwd, pallas_gru_ar_train
from cyclevae_tpu_torch.ops.cuda_gru import (
    cuda_gru_ar_bwd,
    cuda_gru_ar_train,
    gru_ar_bwd_reference,
    gru_ar_train_reference,
)

from test_torch_cuda_gru import _problem, _t

torch.set_num_threads(1)

SHAPES = [(32, 8, 2, 12), (64, 10, 3, 40), (16, 6, 2, 9)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _mask(rng, B, T, H, keep=0.5):
    return ((rng.random((B, T, H)) < keep) / keep).astype(np.float32)


def _close(got, want, wdt):
    """float32: tests/test_pallas_gru.py's atol 2e-5.  bf16: both sides round
    the same operands, but a sum on a rounding boundary may round the other
    way, and the streams are bf16: the JAX package's bf16 bounds
    (tests/test_gru_ar_vjp.py)."""
    g = got.to(torch.float32).numpy().astype(np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    if wdt == "f32":
        np.testing.assert_allclose(g, w, atol=2e-5)
    else:
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 3e-2
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999


@pytest.mark.parametrize("wdt", list(DTYPES))
@pytest.mark.parametrize("H,out,B,T", SHAPES)
def test_train_reference_matches_pallas(H, out, B, T, wdt):
    jdt, tdt = DTYPES[wdt]
    layer, proj, gx, y0, h0 = _problem(H, out, B, T, seed=H + T)
    mask = _mask(np.random.default_rng(T), B, T, H)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gru_ar_train(layer, proj, gx, y0, h0, jnp.asarray(mask), weight_dtype=jdt)
    got = gru_ar_train_reference(_t(layer), _t(proj), _t(gx), _t(y0), _t(h0),
                                 torch.tensor(mask), tdt)
    assert got[3].dtype == tdt     # h_seq streams at the weight dtype
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, wdt)


def _bwd_problem(H, out, B, T, seed):
    layer, proj, gx, y0, h0 = _problem(H, out, B, T, seed)
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mask = _mask(rng, B, T, H)
    wy = np.asarray(layer["w_ih"])[:, -out:]
    return dict(wout=np.asarray(proj["w"]), whh=np.asarray(layer["w_hh"]), wy=wy,
                bhh=np.asarray(layer["b_hh"]), d_trj=f(B, T, out), gates_x=np.asarray(gx),
                y_prev=0.5 * f(B, T, out), h_prev=0.5 * f(B, T, H), out_mask=mask,
                d_hT=f(B, H), d_yT=f(B, out))


@pytest.mark.parametrize("wdt", list(DTYPES))
@pytest.mark.parametrize("H,out,B,T", SHAPES)
def test_bwd_reference_matches_pallas(H, out, B, T, wdt):
    jdt, tdt = DTYPES[wdt]
    a = _bwd_problem(H, out, B, T, seed=3 * H + T)
    w = ("wout", "whh", "wy")
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gru_ar_bwd(**{k: jnp.asarray(v, jdt if k in w else jnp.float32)
                                    for k, v in a.items()})
    got = gru_ar_bwd_reference(**{k: torch.tensor(v).to(tdt if k in w else torch.float32)
                                  for k, v in a.items()})
    assert got[0].dtype == tdt and got[1].dtype == tdt   # dgx, dgh at the weight dtype
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape
        _close(g, w_, wdt)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    layer, proj, gx, y0, h0 = (_t(a) for a in _problem(16, 6, 2, 9, seed=4))
    mask = torch.tensor(_mask(np.random.default_rng(4), 2, 9, 16))
    a = {k: torch.tensor(v) for k, v in _bwd_problem(16, 6, 2, 9, seed=4).items()}
    before = cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches
    got = cuda_gru_ar_train(layer, proj, gx, y0, h0, mask)
    want = gru_ar_train_reference(layer, proj, gx, y0, h0, mask)
    got_b, want_b = cuda_gru_ar_bwd(**a), gru_ar_bwd_reference(**a)
    assert (cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches) == before
    for g, w in zip(got + got_b, want + want_b):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
