"""The plain version of the port's WaveRNN sampling kernel (what
``cuda_wavernn_generate`` runs on CPU tensors) against the JAX package's
Pallas kernel ``pallas_wavernn_generate`` (K4) in TPU interpret mode (CPU),
its Philox generator against Random123's known answers, and its sampled
output against the distribution it samples.  The CUDA kernel itself is held
against the same plain version on the card (tests/test_torch_cuda_wavernn.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from cyclevae_tpu.models import wavernn as jw
from cyclevae_tpu.ops.pallas_wavernn import pallas_wavernn_generate
from cyclevae_tpu_torch.interop import wavernn_params_from_jax
from cyclevae_tpu_torch.models import wavernn as tw
from cyclevae_tpu_torch.ops.cuda_wavernn import (
    cuda_wavernn_generate,
    philox4x32_10,
    philox_uniforms,
    wavernn_generate_reference,
)

torch.set_num_threads(1)

TINY = dict(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=32, fc_dim=16,
            feat_dim=10, hop=20)     # tests/test_wavernn.py's tiny config


BIAS_SCALE = {("gru", "b_ih"): 0.5, ("gru", "b_hh"): 0.5, ("fc1", "b"): 0.1, ("fc2", "b"): 0.02}


def _params(seed, **over):
    """JAX parameters with non-zero biases (small on fc2, so that the greedy
    trajectory does not settle on its largest bias), as numpy arrays."""
    kw = dict(TINY, **over)
    params = jax.tree_util.tree_map(
        np.asarray, jw.init_wavernn(jax.random.PRNGKey(seed), jw.WaveRNNConfig(**kw)))
    rng = np.random.default_rng(seed)
    for (net, name), scale in BIAS_SCALE.items():
        params[net][name] = (scale * rng.normal(size=params[net][name].shape)).astype(np.float32)
    return jw.WaveRNNConfig(**kw), params, tw.WaveRNNConfig(**kw)


@pytest.mark.parametrize("B,T", [(1, 40), (2, 40)])
def test_greedy_reference_matches_pallas_interpret(B, T):
    """Greedy (temperature 0): the same indices as the Pallas kernel, exactly."""
    jcfg, params, tcfg = _params(seed=2 + B)
    cond = np.tanh(np.random.default_rng(B).normal(size=(B, T, TINY["cond_dim"]))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_wavernn_generate(
            jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(cond), seed=7,
            temperature=0.0))
    tp = wavernn_params_from_jax(params, device="cpu")
    before = cuda_wavernn_generate.launches
    got = cuda_wavernn_generate(tp, tcfg, torch.from_numpy(cond), seed=7, temperature=0.0)
    assert cuda_wavernn_generate.launches == before   # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (B, T)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1                    # not stuck on one class
    # the port's two plain samplers agree in greedy mode
    for b in range(B):
        np.testing.assert_array_equal(
            tw.generate_reference(tp, tcfg, torch.from_numpy(cond[b]), 0.0).numpy(), want[b])


RANDOM123 = [  # (counter, key) -> Philox4x32-10 output, Random123's known answers
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", RANDOM123)
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10(torch.tensor(counter), torch.tensor(key))
    assert tuple(int(v) for v in got) == want


def _philox_python(c, k):
    """Philox4x32-10 on Python integers (Salmon et al., SC'11)."""
    c, k = list(c), list(k)
    for i in range(10):
        if i:
            k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


def test_philox_uniforms_follow_the_counter_layout():
    """u[t, b, k] = (word k%4 of Philox((t, b, k//4, 0), (seed, 0)) & 0x7fffff)
    * 2^-23, on random counters, keys and a K that is not a multiple of 4."""
    rng = np.random.default_rng(0)
    cs = rng.integers(0, 2**32, size=(50, 4), dtype=np.uint64)
    ks = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint64)
    got = philox4x32_10(torch.from_numpy(cs.astype(np.int64)), torch.from_numpy(ks.astype(np.int64)))
    for c, k, g in zip(cs.tolist(), ks.tolist(), got.tolist()):
        assert g == _philox_python(c, k)
    seed, T, B, K, t0 = 0x1234ABCD, 3, 2, 10, 5
    u = philox_uniforms(seed, t0, T, B, K)
    for t in range(T):
        for b in range(B):
            for k in range(K):
                bits = _philox_python((t0 + t, b, k // 4, 0), (seed, 0))[k % 4]
                assert float(u[t, b, k]) == (bits & 0x7FFFFF) * 2.0**-23


def _constant_logits(tp, b2):
    """Parameters whose logits are b2 at every step: fc2.w = 0."""
    tp = dict(tp)
    tp["fc2"] = {"w": torch.zeros_like(tp["fc2"]["w"]), "b": torch.as_tensor(b2, dtype=torch.float32)}
    return tp


def test_sampled_reference_respects_logits():
    """One class with logit 10 (P ~ 0.86 among 63 zero-logit others at K=64)
    must be picked in most draws (tests/test_wavernn.py's guard against a
    generator whose uniforms ignore the logits)."""
    jcfg, params, tcfg = _params(seed=3)
    tp = wavernn_params_from_jax(params, device="cpu")
    hot = 5
    b2 = np.zeros(TINY["n_classes"], np.float32)
    b2[hot] = 10.0
    cond = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 200, 16)).astype(np.float32))
    idx = wavernn_generate_reference(_constant_logits(tp, b2), tcfg, cond, seed=11, temperature=1.0)
    frac_hot = float((idx == hot).float().mean())
    p_hot = np.exp(10.0) / (np.exp(10.0) + TINY["n_classes"] - 1)
    assert frac_hot > 0.75 and abs(frac_hot - p_hot) < 0.1, (frac_hot, p_hot)


@pytest.mark.parametrize("temperature", [0.8, 1.0])
def test_sampled_reference_is_categorical_softmax(temperature):
    """Logits fixed to a bias vector: the draws are i.i.d.
    categorical(softmax(b2 / temperature)).  Pearson's chi-square over the
    classes expected at least 5 times lies below its 0.999 quantile."""
    jcfg, params, tcfg = _params(seed=4)
    tp = wavernn_params_from_jax(params, device="cpu")
    K = TINY["n_classes"]
    b2 = np.random.default_rng(5).normal(size=K).astype(np.float32)
    B, T = 250, 400
    cond = torch.zeros((B, T, 16))
    idx = wavernn_generate_reference(_constant_logits(tp, b2), tcfg, cond, seed=3,
                                     temperature=temperature)
    counts = np.bincount(idx.numpy().ravel(), minlength=K)
    p = np.exp(b2.astype(np.float64) / temperature)
    expected = p / p.sum() * B * T
    keep = expected >= 5
    chi2 = float((((counts - expected) ** 2) / expected)[keep].sum())
    assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1), chi2


def test_margins_report_the_top_two_gap():
    jcfg, params, tcfg = _params(seed=6)
    tp = wavernn_params_from_jax(params, device="cpu")
    cond = torch.from_numpy(np.tanh(np.random.default_rng(6).normal(size=(2, 25, 16))).astype(np.float32))
    for temperature in (0.0, 0.8):
        idx, gap, scale = wavernn_generate_reference(tp, tcfg, cond, seed=1, temperature=temperature,
                                                     margins=True)
        np.testing.assert_array_equal(
            idx.numpy(), wavernn_generate_reference(tp, tcfg, cond, seed=1,
                                                    temperature=temperature).numpy())
        assert (gap >= 0).all() and (gap <= 2 * scale).all() and (scale > 0).all()
