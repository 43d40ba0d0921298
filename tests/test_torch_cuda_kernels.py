"""The port's CUDA AR-GRU kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from cyclevae_tpu_torch.models.layers import init_dense, init_gru_stack
from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar, gru_ar_reference
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
