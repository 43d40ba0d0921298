"""The dual instantiation of the WaveRNN sampler (``csrc/wavernn.cu``
``wavernn_kernel_dual``: the published WaveRNN-896's coarse and fine softmax
over 16-bit audio) against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wavernn_dual.py -q

The kernel and its plain version draw the same Philox uniforms (the coarse
head K4's stream, the fine head counter word 3 = 1), so their 16-bit samples
are held sample by sample: equal, or (``first_divergence``) a first
difference where the plain version's two best scores of the head that
differs lie within 1e-4 of its largest |score| (a float32 near-tie, the two
summing in different orders).
"""

import pytest
import torch

from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, init_wavernn, split16
from cyclevae_tpu_torch.ops import _build
from cyclevae_tpu_torch.ops.cuda_wavernn import (
    cuda_wavernn_generate,
    first_divergence,
    plan,
    wavernn_generate_reference,
)
from cyclevae_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(dev, B, T, H, seed=0):
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
@pytest.mark.parametrize("B", [1, 4])
def test_published_width_long_run(cuda_device, B, temperature):
    """H = 896 (448 + 448 units), two 256-way heads, 4,000 samples: one
    launch, the plain version's samples."""
    params, cfg, cond = _problem(cuda_device, B, 4000, 896, seed=B)
    got = _hold(params, cfg, cond, 2**31 + 7, temperature)
    c, f = split16(got.long())
    assert int(c.max()) < 256 and int(f.max()) < 256
    if temperature > 0:
        assert len(torch.unique(f)) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 64, 200])
def test_small_and_padded_widths(cuda_device, H):
    """Halves of one block, of 4 blocks, and of 13 blocks (the last with 4
    units) padded to whole clusters."""
    grid, units, cluster, _, _ = plan(_build.load("wavernn"), 2, H, 256, 0, dual=True)
    assert grid % (2 * cluster) == 0 and grid // 2 * units >= H // 2
    params, cfg, cond = _problem(cuda_device, 2, 300, H, seed=H)
    for temperature in (0.0, 0.8):
        _hold(params, cfg, cond, 19, temperature)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2])
def test_shortest_runs(cuda_device, T):
    params, cfg, cond = _problem(cuda_device, 3, T, 896, seed=T)
    for temperature in (0.0, 0.8):
        _hold(params, cfg, cond, 31, temperature)


@pytest.mark.cuda
def test_two_launches_are_identical(cuda_device):
    params, cfg, cond = _problem(cuda_device, 2, 2000, 896, seed=12)
    first = cuda_wavernn_generate(params, cfg, cond, seed=3, temperature=0.8)
    second = cuda_wavernn_generate(params, cfg, cond, seed=3, temperature=0.8)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_bad_input_raises_before_a_launch(cuda_device):
    """Refused calls launch nothing and count no ``wavernn.steps``; a launch
    counts its rows x samples."""
    params, cfg, cond = _problem(cuda_device, 2, 20, 64)
    before = cuda_wavernn_generate.launches
    with profiling.recording():
        with pytest.raises(ValueError):
            cuda_wavernn_generate(params, cfg, cond[..., :5], seed=0)
        bad = {**params, "O2": {"w": params["O2"]["w"][:, :-1], "b": params["O2"]["b"]}}
        with pytest.raises(ValueError):
            cuda_wavernn_generate(bad, cfg, cond, seed=0)
        assert cuda_wavernn_generate.launches == before
        assert "wavernn.steps" not in profiling.counters()
        cuda_wavernn_generate(params, cfg, cond, seed=0)
        assert profiling.counters()["wavernn.steps"] == 2 * 20
