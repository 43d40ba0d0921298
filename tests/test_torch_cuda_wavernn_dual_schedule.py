"""The dual sampler's step schedule (``csrc/wavernn.cu`` ``wavernn_kernel_dual``)
against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wavernn_dual_schedule.py -q

Each cluster rank owns a share of every row's first-layer values, sums them
over the clusters of the half and forms their partial logits of every
class, which the class's owner sums in rank order; so the kernel sums in
another order than its plain version (``wavernn_generate_reference``) and
is held sample by sample by ``first_divergence``: equal, or a first
difference where the plain version's two best scores of the head that
differs lie within 1e-4 of its largest |score|.  The Whh products are
split around a phase's wait, each lane's sums carried over:
``wavernn_dual_gh_check`` holds that gh bitwise to the whole product's.
"""

import ctypes

import pytest
import torch

from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, init_wavernn, split16
from cyclevae_tpu_torch.ops import _build
from cyclevae_tpu_torch.ops.cuda_gru import _ptr, _stream
from cyclevae_tpu_torch.ops.cuda_wavernn import (
    cuda_wavernn_generate,
    first_divergence,
    plan,
    wavernn_generate_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(dev, B, T, H, seed):
    cfg = WaveRNNConfig(hidden_units=H, dual=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_wavernn(gen, cfg)
    # every input weight drawn, the masked ones too: the wrapper masks them
    params["gru"]["w_ih"].uniform_(-0.3, 0.3, generator=gen)
    for k in ("b_ih", "b_hh"):
        params["gru"][k].uniform_(-0.5, 0.5, generator=gen)
    for k in ("O1", "O3"):
        params[k]["b"].uniform_(-0.1, 0.1, generator=gen)
    for k in ("O2", "O4"):
        params[k]["b"].uniform_(-0.02, 0.02, generator=gen)
    cond = torch.tanh(torch.randn((B, T, cfg.cond_dim), generator=gen, device=dev))
    return params, cfg, cond


def _hold(params, cfg, cond, seed, temperature):
    before = cuda_wavernn_generate.launches
    got = cuda_wavernn_generate(params, cfg, cond, seed=seed, temperature=temperature)
    launches = cuda_wavernn_generate.launches - before
    want, gap, scale = wavernn_generate_reference(params, cfg, cond, seed=seed,
                                                  temperature=temperature, margins=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == cond.shape[:2]
    assert launches == 1
    if not torch.equal(got, want):
        steps, ok = first_divergence(got, want, gap, scale)
        assert ok, steps
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 8])
def test_published_width_sample_by_sample(cuda_device, B, temperature):
    """H = 896 (448 + 448 units), two 256-way heads, 4,000 samples, up to 8
    rows (which the value split's smaller stage lets fit)."""
    params, cfg, cond = _problem(cuda_device, B, 4000, 896, seed=100 + B)
    got = _hold(params, cfg, cond, 2**31 + 11 * B, temperature)
    c, f = split16(got.long())
    assert int(c.max()) < 256 and int(f.max()) < 256


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 872])
def test_padded_and_small_widths(cuda_device, H):
    """H = 872: halves of 436 units in 55 blocks (the last with 4 units)
    padded to 56, each rank 56 values of a row, the last rank 44.  H = 16:
    halves of one block in a cluster of padding blocks; ranks past the second
    own no values.  (H = 904 asks for 128 blocks in clusters of 8, more than
    the card keeps resident: the plan refuses it, as it did before.)"""
    for B in (1, 3):
        grid, units, cluster, _, _ = plan(_build.load("wavernn"), B, H, 256, 0, dual=True)
        assert grid % (2 * cluster) == 0 and grid // 2 * units >= H // 2
        params, cfg, cond = _problem(cuda_device, B, 600, H, seed=H + B)
        for temperature in (0.0, 0.8):
            _hold(params, cfg, cond, 23 + B, temperature)


@pytest.mark.cuda
def test_more_rows_than_warps(cuda_device):
    """B = 12 at H = 64: a warp scores two rows, and the Whh sums of rows
    past the first four are taken whole."""
    params, cfg, cond = _problem(cuda_device, 12, 400, 64, seed=12)
    for temperature in (0.0, 0.8):
        _hold(params, cfg, cond, 2**31 + 3, temperature)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2])
def test_shortest_runs(cuda_device, T):
    params, cfg, cond = _problem(cuda_device, 2, T, 896, seed=40 + T)
    for temperature in (0.0, 0.8):
        _hold(params, cfg, cond, 37, temperature)


@pytest.mark.cuda
def test_two_launches_are_bitwise_equal(cuda_device):
    params, cfg, cond = _problem(cuda_device, 3, 3000, 896, seed=50)
    first = cuda_wavernn_generate(params, cfg, cond, seed=2**31 + 5, temperature=0.8)
    second = cuda_wavernn_generate(params, cfg, cond, seed=2**31 + 5, temperature=0.8)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 4, 6, 12])
@pytest.mark.parametrize("H", [16, 896, 1024])
def test_split_whh_products_equal_the_whole(cuda_device, B, H):
    """gh = h Whh^T + b_hh as the dual computes it, the coarse columns' sums
    carried to the fine ones (rows past 4 whole), against K4's gate_dots."""
    gen = torch.Generator(device=cuda_device).manual_seed(H + B)
    whh = torch.randn((3 * H, H), generator=gen, device=cuda_device) / H ** 0.5
    bhh = torch.randn((3 * H,), generator=gen, device=cuda_device)
    h = torch.tanh(torch.randn((B, H), generator=gen, device=cuda_device))
    whole = torch.full((B, 3, H), float("nan"), device=cuda_device)
    split = torch.full((B, 3, H), float("nan"), device=cuda_device)
    lib = _build.load("wavernn")
    fn = lib.wavernn_dual_gh_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    _build.check(lib, fn(_ptr(whh), _ptr(bhh), _ptr(h), B, H, _ptr(whole), _ptr(split),
                         _stream(cuda_device)), "wavernn_dual_gh_check")
    torch.cuda.synchronize()
    assert torch.equal(whole, split)
    want = (h @ whh.T + bhh).view(B, 3, H)
    torch.testing.assert_close(whole, want, rtol=1e-5, atol=1e-5)
