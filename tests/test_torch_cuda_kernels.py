"""The port's CUDA AR-GRU kernels (K1 inference forward, K2 training forward,
K3 reverse-time scan) against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from cyclevae_tpu_torch.models.layers import init_dense, init_gru_stack
from cyclevae_tpu_torch.ops import _build
from cyclevae_tpu_torch.ops.cuda_gru import (
    cuda_gru_ar,
    cuda_gru_ar_bwd,
    cuda_gru_ar_train,
    gru_ar_bwd_reference,
    gru_ar_reference,
    gru_ar_train_reference,
    plan,
    plan_bwd,
)
from cyclevae_tpu_torch.ops.gru_ar_vjp import gru_ar_fused
from cyclevae_tpu_torch.ops.gru_scan import precompute_input_gates


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(dev, B, T, H, out, conv_dim=20, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    layer = init_gru_stack(gen, conv_dim + out, H, 1)[0]
    layer["b_ih"].uniform_(-0.1, 0.1, generator=gen)
    layer["b_hh"].uniform_(-0.1, 0.1, generator=gen)
    proj = init_dense(gen, H, out)
    proj["b"].uniform_(-0.1, 0.1, generator=gen)
    gx = precompute_input_gates(
        layer, torch.randn((B, T, conv_dim), generator=gen, device=dev))
    y0 = 0.5 * torch.randn((B, out), generator=gen, device=dev)
    h0 = 0.5 * torch.randn((B, H), generator=gen, device=dev)
    return layer, proj, gx, y0, h0


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,out", [
    (1, 12, 32, 8),      # one unit per block
    (5, 40, 64, 8),      # batch beyond one accumulation chunk of 4
    (2, 25, 200, 64),    # two units per block
    (3, 30, 1030, 50),   # flagship width plus a ragged last block
    (8, 20, 1024, 64),   # y partials summed in several passes through smem
    (2, 10, 1100, 16),   # Whh rows in shared memory, two units per warp
])
def test_kernel_matches_plain(cuda_device, wdt, B, T, H, out):
    args = _problem(cuda_device, B, T, H, out) + (wdt,)
    got = cuda_gru_ar(*args)
    want = gru_ar_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        if wdt == torch.float32:
            # sums of up to H+out products taken in another order
            torch.testing.assert_close(g, w, atol=5e-5, rtol=0)
        else:
            # the same bf16 roundings on both sides, but a sum that lands on
            # a rounding boundary can round the other way: the JAX package's
            # bf16 bounds
            rel = torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)
            cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0)
            assert rel < 3e-2 and cos > 0.999


@pytest.mark.cuda
def test_counter_counts_launches_and_bad_input_raises(cuda_device):
    args = _problem(cuda_device, 2, 6, 32, 8)
    before = cuda_gru_ar.launches
    cuda_gru_ar(*args)
    cuda_gru_ar(*args, torch.bfloat16)
    assert cuda_gru_ar.launches == before + 2
    with pytest.raises(ValueError):
        cuda_gru_ar(*args, torch.float16)
    layer, proj, gx, y0, h0 = args
    with pytest.raises(ValueError):
        cuda_gru_ar(layer, proj, gx, y0[:1], h0)
    assert cuda_gru_ar.launches == before + 2


def _mask(dev, B, T, H, seed=1, keep=0.5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand((B, T, H), generator=gen, device=dev) < keep).float() / keep


def _assert_matches(g, w, wdt, scale_tol=5e-5):
    """float32: sums of up to 3H+out products taken in another order (atol
    scaled by the largest value).  bf16: the same roundings on both sides,
    but a sum on a rounding boundary can round the other way, and bf16
    streams: the JAX package's bf16 bounds."""
    assert g.dtype == w.dtype and g.shape == w.shape
    g, w = g.float(), w.float()
    assert bool(torch.isfinite(g).all())
    if wdt == torch.float32:
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g, w, atol=scale_tol * scale, rtol=0)
    else:
        rel = torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)
        cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0)
        assert rel < 3e-2 and cos > 0.999


TRAIN_SHAPES = [
    (1, 20, 1024, 64),   # one batch row
    (5, 30, 1024, 64),   # the encoder calls of a bsu-5 train step
    (10, 30, 1024, 50),  # the fused 2B decoder call
    (16, 12, 1024, 50),  # beyond the main path's widest batch
    (3, 25, 1030, 50),   # a ragged last block, Whh rows in shared memory
    (2, 10, 40, 8),      # a small width
    (3, 1, 64, 7),       # one step; B*out not a multiple of 4
    (5, 560, 1024, 3),   # the speaker classifier: out padded to 4, whole-utterance T
    (5, 560, 1024, 32),  # the VQ encoder's latent width, whole-utterance T
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,out", TRAIN_SHAPES)
def test_train_kernel_matches_plain(cuda_device, wdt, B, T, H, out):
    layer, proj, gx, y0, h0 = _problem(cuda_device, B, T, H, out)
    mask = _mask(cuda_device, B, T, H)
    got = cuda_gru_ar_train(layer, proj, gx, y0, h0, mask, wdt)
    want = gru_ar_train_reference(layer, proj, gx, y0, h0, mask, wdt)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_matches(g, w, wdt)


def _bwd_args(dev, B, T, H, out, wdt, seed=2):
    layer, proj, gx, _, _ = _problem(dev, B, T, H, out, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    return (proj["w"].to(wdt), layer["w_hh"].to(wdt), layer["w_ih"][:, -out:].to(wdt),
            layer["b_hh"], r(B, T, out), gx, 0.5 * r(B, T, out), torch.tanh(r(B, T, H)),
            _mask(dev, B, T, H, seed), r(B, H), r(B, out))


# K3 also at the shapes its exchange has edges: the step-parity buffers (T=1,
# 2 and odd T, at the flagship width), a width whose units do not fill a
# multiple of 4 (H=900: 7 units per block, the dh partials written one
# column at a time; h_prev copied without cp.async in bf16) and a small odd
# width (rows padded, no Whh rows in registers)
BWD_SHAPES = TRAIN_SHAPES + [
    (2, 1, 1024, 50),    # one step at the flagship width
    (5, 2, 1024, 64),    # two steps: both parities once
    (10, 7, 1024, 50),   # the fused 2B decoder call, odd T
    (4, 9, 900, 50),     # 7 units per block, ragged last block
    (2, 5, 37, 9),       # small odd width, B*out odd
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,out", BWD_SHAPES)
def test_bwd_kernel_matches_plain(cuda_device, wdt, B, T, H, out):
    args = _bwd_args(cuda_device, B, T, H, out, wdt)
    got = cuda_gru_ar_bwd(*args)
    want = gru_ar_bwd_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_matches(g, w, wdt, scale_tol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_bwd_kernel_two_launches_bitwise_equal(cuda_device, wdt):
    """Every sum of K3 runs in a fixed order and no atomic touches a value."""
    args = _bwd_args(cuda_device, 10, 40, 1024, 50, wdt)
    first = [g.clone() for g in cuda_gru_ar_bwd(*args)]
    second = cuda_gru_ar_bwd(*args)
    torch.cuda.synchronize()
    for g, w in zip(second, first):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_bwd_kernel_largest_batch_and_one_above(cuda_device, wdt):
    """At the flagship width K3 runs the largest B its plan accepts (the dh
    partials then sum in several passes through shared memory), and the
    next B raises rather than run."""
    lib = _build.load("gru_ar_bwd")

    def fits(B):
        try:
            plan_bwd(lib, B, 1024, 50, wdt)
        except RuntimeError:
            return False
        return True

    lo, hi = 1, 4096   # fits(lo); not fits(hi)
    assert fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    largest = lo
    assert largest >= 16
    args = _bwd_args(cuda_device, largest, 3, 1024, 50, wdt)
    got = cuda_gru_ar_bwd(*args)
    want = gru_ar_bwd_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_matches(g, w, wdt, scale_tol=2e-4)
    before = cuda_gru_ar_bwd.launches
    with pytest.raises(RuntimeError):
        cuda_gru_ar_bwd(*_bwd_args(cuda_device, largest + 1, 3, 1024, 50, wdt))
    assert cuda_gru_ar_bwd.launches == before


def _forward(dev, train, B, T, H, out, wdt):
    """K1 (or, ``train``, K2) and its plain version on one problem."""
    layer, proj, gx, y0, h0 = _problem(dev, B, T, H, out)
    if train:
        args = (layer, proj, gx, y0, h0, _mask(dev, B, T, H), wdt)
        return cuda_gru_ar_train, gru_ar_train_reference, args
    return cuda_gru_ar, gru_ar_reference, (layer, proj, gx, y0, h0, wdt)


# K1 and K2 at the shapes where their exchange has edges: one and two frames
# (each parity once), K1's conversion call (1120 frames: many parity and tag
# wraps), B*out below the grid (most blocks own no y slice), odd T with a
# ragged last block
FWD_EDGE_SHAPES = [
    (False, 3, 1, 1024, 50), (True, 3, 1, 1024, 50),
    (False, 2, 2, 1024, 64), (True, 5, 2, 1024, 64),
    (False, 3, 1120, 1024, 50),
    (False, 1, 9, 1024, 8), (True, 1, 9, 1024, 8),
    (False, 4, 7, 1030, 50), (True, 10, 7, 1030, 50),
    (False, 1, 560, 1024, 3),    # the classifier's eval forward: 4 y values in all
    (False, 3, 560, 1024, 50),   # stage 5m: N = 3 directions in one batch
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train,B,T,H,out", FWD_EDGE_SHAPES)
def test_forward_kernel_exchange_edges(cuda_device, wdt, train, B, T, H, out):
    fn, ref, args = _forward(cuda_device, train, B, T, H, out, wdt)
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_matches(g, w, wdt)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_forward_kernel_two_launches_bitwise_equal(cuda_device, wdt, train):
    """Every sum of K1 and K2 runs in a fixed order and no atomic touches a
    value."""
    fn, _, args = _forward(cuda_device, train, 10 if train else 3, 40, 1024, 50, wdt)
    first = [g.clone() for g in fn(*args)]
    second = fn(*args)
    torch.cuda.synchronize()
    for g, w in zip(second, first):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_forward_kernel_largest_batch_and_one_above(cuda_device, wdt, train):
    """At the flagship width K1 and K2 run the largest B their plan accepts
    (several passes of the gate phase over the (row, unit) pairs), and the
    next B raises rather than run."""
    lib = _build.load("gru_ar")

    def fits(B):
        try:
            plan(lib, B, 1024, 50, wdt, train)
        except RuntimeError:
            return False
        return True

    lo, hi = 1, 4096   # fits(lo); not fits(hi)
    assert fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    largest = lo
    assert largest >= 16
    fn, ref, args = _forward(cuda_device, train, largest, 3, 1024, 50, wdt)
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_matches(g, w, wdt)
    before = fn.launches
    with pytest.raises(RuntimeError):
        fn(*_forward(cuda_device, train, largest + 1, 3, 1024, 50, wdt)[2])
    assert fn.launches == before


@pytest.mark.cuda
def test_train_counters_count_launches_and_bad_input_raises(cuda_device):
    layer, proj, gx, y0, h0 = _problem(cuda_device, 2, 6, 32, 8)
    mask = _mask(cuda_device, 2, 6, 32)
    before = cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches, cuda_gru_ar.launches
    cuda_gru_ar_train(layer, proj, gx, y0, h0, mask)
    cuda_gru_ar_bwd(*_bwd_args(cuda_device, 2, 6, 32, 8, torch.bfloat16))
    assert (cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches, cuda_gru_ar.launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    with pytest.raises(ValueError):
        cuda_gru_ar_train(layer, proj, gx, y0, h0, mask[:, :3])
    bad = list(_bwd_args(cuda_device, 2, 6, 32, 8, torch.float32))
    bad[9] = bad[9][:1]
    with pytest.raises(ValueError):
        cuda_gru_ar_bwd(*bad)
    assert (cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_fused_function_cuda_backward_matches_cpu_plain(cuda_device, wdt):
    """gradcheck-style: the Function's gradients through K2 and K3 on the
    card against the same Function on the CPU (the plain versions), same
    inputs; bf16 at the JAX package's bf16 bounds."""
    B, T, H, out = 5, 16, 1024, 64
    layer, proj, gx, y0, h0 = _problem(cuda_device, B, T, H, out)
    mask = _mask(cuda_device, B, T, H)
    vals = (layer["w_ih"][:, -out:], layer["w_hh"], layer["b_hh"], proj["w"], proj["b"],
            gx, y0, h0, mask)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        ts = [v.detach().to(dev).requires_grad_(True) for v in vals]
        trj, y_T, h_T = gru_ar_fused(*ts, weight_dtype=wdt)
        (trj.pow(2).sum() + y_T.sin().sum() + h_T.pow(2).sum()).backward()
        grads[dev.type] = [t.grad.to("cpu") for t in ts]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        _assert_matches(g, w, wdt, scale_tol=2e-4)
