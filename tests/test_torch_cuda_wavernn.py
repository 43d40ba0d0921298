"""The port's CUDA WaveRNN sampling kernel (K4, ``csrc/wavernn.cu``) against
its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wavernn.py -q

The kernel and its plain version draw the same Philox uniforms, so greedy and
sampled output are held index by index, by the near-tie rule of
``ops/cuda_wavernn.first_divergence``: a float32 near-tie may flip one index
(the two sum in different orders), and only where the plain version's two
best scores lie within 1e-4 of its largest |score|.
"""

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, init_wavernn
from cyclevae_tpu_torch.ops import _build
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


def _problem(dev, B, T, H, K, seed=0):
    cfg = WaveRNNConfig(n_classes=K, hidden_units=H)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_wavernn(gen, cfg)
    params["gru"]["b_ih"].uniform_(-0.5, 0.5, generator=gen)
    params["gru"]["b_hh"].uniform_(-0.5, 0.5, generator=gen)
    params["fc1"]["b"].uniform_(-0.1, 0.1, generator=gen)
    params["fc2"]["b"].uniform_(-0.02, 0.02, generator=gen)
    cond = torch.tanh(torch.randn((B, T, cfg.cond_dim), generator=gen, device=dev))
    return params, cfg, cond


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("H", [32, 896, 900])   # 900: a ragged last block of 4 units
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_kernel_matches_plain(cuda_device, B, H, K, temperature):
    params, cfg, cond = _problem(cuda_device, B, 300, H, K, seed=B + H + K)
    got = cuda_wavernn_generate(params, cfg, cond, seed=17, temperature=temperature)
    want, gap, scale = wavernn_generate_reference(params, cfg, cond, seed=17,
                                                  temperature=temperature, margins=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, 300)
    assert int(got.min()) >= 0 and int(got.max()) < K
    steps, ok = first_divergence(got, want, gap, scale)
    assert ok, steps


@pytest.mark.cuda
def test_long_run(cuda_device):
    """4,000 samples at the recipe's width, greedy and sampled."""
    params, cfg, cond = _problem(cuda_device, 1, 4000, 896, 256, seed=3)
    for temperature in (0.0, 0.8):
        got = cuda_wavernn_generate(params, cfg, cond, seed=5, temperature=temperature)
        want, gap, scale = wavernn_generate_reference(params, cfg, cond, seed=5,
                                                      temperature=temperature, margins=True)
        steps, ok = first_divergence(got, want, gap, scale)
        assert ok, steps


@pytest.mark.cuda
def test_64bit_offsets(cuda_device):
    """Conditioning gates of more than 2^31 elements (B=3 x T=270,000 x
    3H=2688): row 2's last steps are read through 64-bit offsets.  With no
    feedback (embed = 0, Whh = 0, the update gate shut by a bias of -30)
    each step's sample depends on its own conditioning alone, so row 2 of
    the big call must give what the same row gives alone, where every offset
    is small; only isolated near-ties of the separately computed gates may
    differ, where wrong offsets would read other rows' gates."""
    B, T, H = 3, 270_000, 896
    params, cfg, _ = _problem(cuda_device, 1, 1, H, 256, seed=6)
    params["embed"].zero_()
    params["gru"]["w_hh"].zero_()
    params["gru"]["b_ih"][H:2 * H] = -30.0
    cond = torch.tanh(torch.randn((B, T, cfg.cond_dim), device=cuda_device,
                                  generator=torch.Generator(device=cuda_device).manual_seed(7)))
    assert B * T * 3 * H > 2**31
    big = cuda_wavernn_generate(params, cfg, cond, seed=9, temperature=0.0)
    alone = cuda_wavernn_generate(params, cfg, cond[2:].contiguous(), seed=9, temperature=0.0)
    torch.cuda.synchronize()
    tail = slice(T - 20_000, T)
    mismatch = float((big[2, tail] != alone[0, tail]).float().mean())
    assert mismatch < 1e-2, mismatch
    assert len(torch.unique(alone[0, tail])) > 10


@pytest.mark.cuda
def test_sampled_kernel_is_categorical_softmax(cuda_device):
    """fc2.w = 0: the logits are b2 at every step, so 200,000 kernel draws
    are i.i.d. categorical(softmax(b2 / T)); Pearson's chi-square below its
    0.999 quantile.  And a hot class of logit 10 is picked in > 90% of draws."""
    from scipy import stats

    params, cfg, cond = _problem(cuda_device, 4, 50_000, 896, 256, seed=4)
    params["fc2"]["w"].zero_()
    b2 = torch.randn(256, generator=torch.Generator().manual_seed(1))
    params["fc2"]["b"].copy_(b2)
    idx = cuda_wavernn_generate(params, cfg, cond, seed=23, temperature=0.8)
    counts = np.bincount(idx.cpu().numpy().ravel(), minlength=256)
    p = np.exp(b2.double().numpy() / 0.8)
    expected = p / p.sum() * idx.numel()
    keep = expected >= 5
    chi2 = float((((counts - expected) ** 2) / expected)[keep].sum())
    assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1), chi2

    params["fc2"]["b"].zero_()
    params["fc2"]["b"][5] = 10.0
    idx = cuda_wavernn_generate(params, cfg, cond[:, :2000], seed=11, temperature=1.0)
    assert float((idx == 5).float().mean()) > 0.9


@pytest.mark.cuda
def test_counter_counts_launches_and_bad_input_raises(cuda_device):
    params, cfg, cond = _problem(cuda_device, 2, 20, 32, 64)
    before = cuda_wavernn_generate.launches
    cuda_wavernn_generate(params, cfg, cond, seed=0, temperature=0.0)
    cuda_wavernn_generate(params, cfg, cond, seed=0, temperature=1.0)
    assert cuda_wavernn_generate.launches == before + 2
    with pytest.raises(ValueError):
        cuda_wavernn_generate(params, cfg, cond[..., :5], seed=0)
    cpu_params = {k: {n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu()
                  for k, v in params.items()}
    with pytest.raises(ValueError):
        cuda_wavernn_generate(cpu_params, cfg, cond, seed=0)
    wide = WaveRNNConfig(n_classes=64, hidden_units=2048)
    with pytest.raises(RuntimeError):   # the plan refuses H > 1024
        cuda_wavernn_generate(init_wavernn(torch.Generator(device=cuda_device), wide), wide,
                              cond, seed=0)
    assert cuda_wavernn_generate.launches == before + 2


def _hold(params, cfg, cond, seed, temperature):
    got = cuda_wavernn_generate(params, cfg, cond, seed=seed, temperature=temperature)
    want, gap, scale = wavernn_generate_reference(params, cfg, cond, seed=seed,
                                                  temperature=temperature, margins=True)
    torch.cuda.synchronize()
    assert got.shape == cond.shape[:2]
    steps, ok = first_divergence(got, want, gap, scale)
    assert ok, steps
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("H", [42, 900])
def test_grid_padded_to_whole_clusters(cuda_device, H):
    """The grid is padded to whole clusters with blocks that own no units:
    H=900 gives 113 blocks of 8 units (the last with 4), H=42 gives 6 (the
    last with 2, and a row padded from 42 to 44 floats)."""
    B = 2
    grid, units, cluster, _, _ = plan(_build.load("wavernn"), B, H, 256, 128)
    blocks = -(-H // units)
    assert grid % cluster == 0 and blocks <= grid < blocks + cluster
    params, cfg, cond = _problem(cuda_device, B, 300, H, 256, seed=H)
    for temperature in (0.0, 0.8):
        _hold(params, cfg, cond, 19, temperature)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [896, 1024])
def test_batch_of_eight(cuda_device, H):
    """B=8 at the recipe's width and at H=1024, where the plan may take
    clusters smaller than 8 and sum f in passes through shared memory."""
    params, cfg, cond = _problem(cuda_device, 8, 300, H, 256, seed=H + 8)
    _hold(params, cfg, cond, 29, 0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2])
def test_shortest_runs(cuda_device, T):
    """T=1 and T=2: the gates prefetched one step ahead stop at the last
    step, and the last sample is drawn after the loop."""
    params, cfg, cond = _problem(cuda_device, 3, T, 896, 256, seed=T)
    for temperature in (0.0, 0.8):
        _hold(params, cfg, cond, 31, temperature)


@pytest.mark.cuda
def test_two_launches_are_identical(cuda_device):
    """No atomics on the value path: the same call gives the same indices."""
    params, cfg, cond = _problem(cuda_device, 4, 2000, 896, 256, seed=12)
    first = cuda_wavernn_generate(params, cfg, cond, seed=3, temperature=0.8)
    second = cuda_wavernn_generate(params, cfg, cond, seed=3, temperature=0.8)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_exact_tie_across_cluster_ranks_goes_to_the_lowest_class(cuda_device):
    """Greedy, fc2.w = 0: the logits are b2, with an exact tie of the
    largest value at classes 40, 100 and 250, which lie in different
    ranks' class slices (32 classes a rank in clusters of 8): every sample
    is 40, as torch.argmax takes it."""
    params, cfg, cond = _problem(cuda_device, 2, 200, 896, 256, seed=13)
    _, _, cluster, _, _ = plan(_build.load("wavernn"), 2, 896, 256, 128)
    params["fc2"]["w"].zero_()
    params["fc2"]["b"].uniform_(-1.0, 1.0)
    params["fc2"]["b"][[40, 100, 250]] = 2.0
    if cluster > 1:
        per = 256 // cluster
        assert len({40 // per, 100 // per, 250 // per}) > 1
    got = _hold(params, cfg, cond, 0, 0.0)
    assert bool((got == 40).all())
