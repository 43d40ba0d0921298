"""The training path's saved gates on the card: K2 keeps r, z, n and gh_n of
every frame (``cuda_gru_ar_train_gates``), and K3 reads them
(``cuda_gru_ar_bwd(..., gates=)``) instead of recomputing them.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_saved_gates.py -q
"""

import pytest
import torch

from cyclevae_tpu_torch.models.layers import init_dense, init_gru_stack
from cyclevae_tpu_torch.ops.cuda_gru import (
    cuda_gru_ar_bwd,
    cuda_gru_ar_train,
    cuda_gru_ar_train_gates,
    gru_ar_gates_reference,
    gru_ar_train_reference,
    max_batch,
)
from cyclevae_tpu_torch.ops.gru_ar_vjp import gru_ar_fused
from cyclevae_tpu_torch.ops.gru_scan import precompute_input_gates
from cyclevae_tpu_torch.utils import profiling

WDTS = pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
# the step-parity buffers (T = 1, 2 and odd T at the flagship width), 7
# units a block (H = 900: the gates copied 4 bytes at a time, a ragged last
# block), a small odd width, and B = 47, past K2's float32 rows a launch
SHAPES = [
    (2, 1, 1024, 50),
    (5, 2, 1024, 64),
    (8, 9, 1024, 50),
    (4, 9, 900, 50),
    (2, 5, 37, 9),
    (47, 3, 1024, 50),
]


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
    gx = precompute_input_gates(layer, torch.randn((B, T, conv_dim), generator=gen, device=dev))
    y0 = 0.5 * torch.randn((B, out), generator=gen, device=dev)
    h0 = 0.5 * torch.randn((B, H), generator=gen, device=dev)
    mask = (torch.rand((B, T, H), generator=gen, device=dev) < 0.5).float() * 2.0
    return layer, proj, gx, y0, h0, mask


def _pair(dev, B, T, H, out, wdt, seed=0):
    """K2 with its gates on one problem, and K3's inputs as the training
    path builds them from it."""
    layer, proj, gx, y0, h0, mask = _problem(dev, B, T, H, out, seed=seed)
    trj, _, _, h_seq, gates = cuda_gru_ar_train_gates(layer, proj, gx, y0, h0, mask, wdt)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    args = (proj["w"].to(wdt), layer["w_hh"].to(wdt), layer["w_ih"][:, -out:].to(wdt),
            layer["b_hh"], r(B, T, out), gx, torch.cat([y0[:, None], trj[:, :-1]], dim=1).to(wdt),
            torch.cat([h0[:, None].to(wdt), h_seq[:, :-1]], dim=1), mask, r(B, H), r(B, out))
    return (layer, proj, gx, y0, h0, mask), gates, args


def _assert_matches(g, w, wdt, scale_tol=2e-4, plain=False):
    """float32: within ``scale_tol`` of the largest value.  bf16: K3 on the
    saved gates against K3 recomputing them, cosine similarity above
    0.99999; a kernel against its plain version (``plain``), where a sum on
    a rounding boundary can round the other way in either, the bounds of
    ``test_torch_cuda_kernels.py``."""
    assert g.dtype == w.dtype and g.shape == w.shape
    g, w = g.float(), w.float()
    assert bool(torch.isfinite(g).all())
    if wdt == torch.float32:
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g, w, atol=scale_tol * scale, rtol=0)
        return
    cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0)
    if plain:
        rel = torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)
        assert rel < 3e-2 and cos > 0.999
    else:
        assert cos > 0.99999


@pytest.mark.cuda
@WDTS
@pytest.mark.parametrize("B,T,H,out", SHAPES)
def test_forward_keeps_the_plain_forwards_gates(cuda_device, wdt, B, T, H, out):
    """K2's gates against the plain forward's (computed on the CPU), and
    K2's other outputs as ``cuda_gru_ar_train`` gives them, bitwise."""
    fwd, gates, _ = _pair(cuda_device, B, T, H, out, wdt)
    assert gates.shape == (B, T, 4, H) and gates.dtype == torch.float32
    cpu = [a.cpu() if torch.is_tensor(a) else {k: v.cpu() for k, v in a.items()} for a in fwd]
    want = cuda_gru_ar_train_gates(*cpu, wdt)[4]
    torch.cuda.synchronize()
    _assert_matches(gates.cpu(), want, wdt, 5e-5, plain=True)
    got = cuda_gru_ar_train_gates(*fwd, wdt)
    for g, w in zip(got[:4], cuda_gru_ar_train(*fwd, wdt)):
        assert torch.equal(g, w)
    assert torch.equal(got[4], gates)
    for g, w in zip(got[:4], gru_ar_train_reference(*cpu, wdt)):
        _assert_matches(g.cpu(), w, wdt, 5e-5, plain=True)


@pytest.mark.cuda
@WDTS
@pytest.mark.parametrize("B,T,H,out", SHAPES)
def test_backward_on_saved_gates_matches_the_recompute(cuda_device, wdt, B, T, H, out):
    """K3 on the forward's gates against K3 recomputing them, the same
    inputs: the gates differ only in the order of their sums (K3's bounds
    against its plain version: float32 2e-4 of scale, bf16 cosine above
    0.99999)."""
    _, gates, args = _pair(cuda_device, B, T, H, out, wdt, seed=3)
    saved = cuda_gru_ar_bwd(*args, gates=gates)
    recomputed = cuda_gru_ar_bwd(*args)
    torch.cuda.synchronize()
    for g, w in zip(saved, recomputed):
        _assert_matches(g, w, wdt)
    # the forward's gates against the plain recompute from its residuals
    plain = gru_ar_gates_reference(*(a.cpu() for a in args[1:4]),
                                   *(a.cpu() for a in args[5:8]))
    _assert_matches(gates.cpu(), plain, wdt, 5e-5, plain=True)


@pytest.mark.cuda
@WDTS
def test_fused_gradients_match_the_plain_path(cuda_device, wdt):
    """``gru_ar_fused`` on the card (K2 keeps the gates, K3 reads them)
    against the same Function on the CPU, same inputs; one K2 and one K3
    launch, the K3 launch counted as saved (the plain versions count
    nothing)."""
    B, T, H, out = 5, 16, 1024, 64
    layer, proj, gx, y0, h0, mask = _problem(cuda_device, B, T, H, out, seed=5)
    vals = (layer["w_ih"][:, -out:], layer["w_hh"], layer["b_hh"], proj["w"], proj["b"],
            gx, y0, h0, mask)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        ts = [v.detach().to(dev).requires_grad_(True) for v in vals]
        before = cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches
        with profiling.recording():
            trj, y_T, h_T = gru_ar_fused(*ts, weight_dtype=wdt)
            (trj.pow(2).sum() + y_T.sin().sum() + h_T.pow(2).sum()).backward()
            counts = profiling.counters()
        on_card = dev.type == "cuda"
        assert counts == ({"gru_bwd.gates_saved": 1} if on_card else {})
        assert (cuda_gru_ar_train.launches - before[0],
                cuda_gru_ar_bwd.launches - before[1]) == ((1, 1) if on_card else (0, 0))
        grads[dev.type] = [t.grad.to("cpu") for t in ts]
    profiling.reset()
    for g, w in zip(grads["cuda"], grads["cpu"]):
        _assert_matches(g, w, wdt, plain=True)


@pytest.mark.cuda
@WDTS
def test_pair_two_launches_bitwise_equal(cuda_device, wdt):
    """Every sum of K2 and K3 runs in a fixed order and no atomic touches a
    value: K2's gates and K3's outputs on them, twice, bitwise."""
    fwd, gates, args = _pair(cuda_device, 8, 40, 1024, 50, wdt, seed=7)
    first = [g.clone() for g in cuda_gru_ar_bwd(*args, gates=gates)]
    _, gates2, args2 = _pair(cuda_device, 8, 40, 1024, 50, wdt, seed=7)
    second = cuda_gru_ar_bwd(*args2, gates=gates2)
    torch.cuda.synchronize()
    assert torch.equal(gates, gates2)
    for g, w in zip(second, first):
        assert torch.equal(g, w)


@pytest.mark.cuda
@WDTS
def test_both_kernels_in_row_blocks(cuda_device, wdt):
    """Past both kernels' rows a launch: K2 and K3 each run in row blocks,
    the gates sliced by rows like every per-row tensor; each K3 launch
    counts one saved (or, alone, one recomputed)."""
    limit = max(max_batch("k2", 1024, 50, wdt), max_batch("k3", 1024, 50, wdt))
    B = limit + 1
    n2, n3 = (-(-B // max_batch(k, 1024, 50, wdt)) for k in ("k2", "k3"))
    assert n2 >= 2 and n3 >= 2
    before = cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches
    _, gates, args = _pair(cuda_device, B, 3, 1024, 50, wdt, seed=9)
    with profiling.recording():
        saved = cuda_gru_ar_bwd(*args, gates=gates)
        recomputed = cuda_gru_ar_bwd(*args)
        counts = profiling.counters()
    profiling.reset()
    torch.cuda.synchronize()
    assert counts == {"gru_bwd.gates_saved": n3, "gru_bwd.gates_recomputed": n3}
    assert (cuda_gru_ar_train.launches - before[0],
            cuda_gru_ar_bwd.launches - before[1]) == (n2, 2 * n3)
    for g, w in zip(saved, recomputed):
        _assert_matches(g, w, wdt)
