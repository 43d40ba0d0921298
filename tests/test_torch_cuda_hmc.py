"""The HMC sampler's carry on the card: ``hmc_sample_batch`` on the flagship
decoder's batched log-joint (K2 forward, K3 backward) launches each kernel
1 + L x transitions times, and its samples, accept probabilities, step size
and inverse mass are bitwise those of the sampler that recomputes each
point's value and gradient (2L + 2 evaluations a transition:
``tests/test_torch_hmc_carry.py``'s oracle) from the same draws.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_hmc.py -q
"""

import pytest
import torch

from cyclevae_tpu_torch.infer import HMCConfig, hmc, logjoint
from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar_bwd, cuda_gru_ar_train
from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

from test_torch_hmc_carry import accepts_and_rejects, assert_bitwise, carry_and_oracle


def launches():
    return {"K2": cuda_gru_ar_train.launches, "K3": cuda_gru_ar_bwd.launches}


@pytest.mark.cuda
def test_the_carry_on_the_card_launches_L_a_transition_and_changes_no_sample(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = CycleVAEConfig(use_pallas=True)           # hu 1024, lat 32: the kernel route
    params = init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    T, C = 48, 8
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn((T, 54), generator=g, device=dev)
    code = torch.tensor([1.0, 0.0], device=dev).expand(T, 2)
    lj = logjoint.make_utterance_logjoint_batched(params, cfg, feats, code, obs_scale=50.0)
    hcfg = HMCConfig(step_size=0.02, n_leapfrog=4, n_warmup=6, n_samples=6)
    z0 = torch.zeros((C, T, cfg.lat_dim), device=dev)
    logjoint.value_and_grad(lj, z0)                  # the kernels' builds
    (carry, n_carry), (oracle, n_oracle) = carry_and_oracle(
        monkeypatch, hmc.hmc_sample_batch, 2, lj, z0, hcfg, device=dev, meter=launches)
    transitions = hcfg.n_warmup + hcfg.n_samples
    L = hcfg.n_leapfrog
    assert n_carry == {"K2": 1 + L * transitions, "K3": 1 + L * transitions}
    assert n_oracle == {"K2": (2 * L + 2) * transitions, "K3": 2 * L * transitions}
    assert_bitwise(carry, oracle)
    assert accepts_and_rejects(carry[0]).any()
