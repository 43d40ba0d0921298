"""The port's WaveRNN (``cyclevae_tpu_torch.models.wavernn``) against the JAX
package's (``cyclevae_tpu.models.wavernn``): the same parameters and inputs,
made from a numpy seed, through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models import wavernn as jw
from cyclevae_tpu_torch.interop import wavernn_params_from_jax, wavernn_params_to_jax
from cyclevae_tpu_torch.models import wavernn as tw

torch.set_num_threads(1)

TINY = dict(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=32, fc_dim=16,
            feat_dim=10, hop=20)     # tests/test_wavernn.py's tiny config
WIDE = dict(n_classes=256, embed_dim=16, cond_dim=16, hidden_units=64, fc_dim=32,
            feat_dim=10, hop=20)     # all 256 mu-law classes, a wider GRU


BIAS_SCALE = {("cond", "b"): 0.1, ("gru", "b_ih"): 0.5, ("gru", "b_hh"): 0.5, ("fc1", "b"): 0.1,
              ("fc2", "b"): 0.02}


def _params(cfg_kw, seed=0):
    """JAX parameters with non-zero biases (small on fc2, so that a greedy
    trajectory does not settle on its largest bias) and the port's copy."""
    jcfg = jw.WaveRNNConfig(**cfg_kw)
    params = jax.tree_util.tree_map(np.asarray, jw.init_wavernn(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for (net, name), scale in BIAS_SCALE.items():
        params[net][name] = (scale * rng.normal(size=params[net][name].shape)).astype(np.float32)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, params), tw.WaveRNNConfig(**cfg_kw),
            wavernn_params_from_jax(params, device="cpu"))


def _cond(rng, T, dim):
    return np.tanh(rng.normal(size=(T, dim))).astype(np.float32)


def test_mulaw_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-1.0, 1.0, 2001), rng.uniform(-1, 1, 5000)]).astype(np.float32)
    for K in (256, 64):
        want = np.asarray(jw.mulaw_encode(jnp.asarray(x), K))
        got = tw.mulaw_encode(torch.from_numpy(x), K)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        idx = np.arange(K, dtype=np.int32)
        np.testing.assert_allclose(tw.mulaw_decode(torch.from_numpy(idx), K).numpy(),
                                   np.asarray(jw.mulaw_decode(jnp.asarray(idx), K)), atol=1e-6)


@pytest.mark.parametrize("hop", [110.25, 20, 80.0, 441 / 4])
def test_hop_fraction_and_lengths_match_jax(hop):
    jcfg, tcfg = jw.WaveRNNConfig(hop=hop), tw.WaveRNNConfig(hop=hop)
    assert tw.hop_fraction(tcfg) == jw.hop_fraction(jcfg)
    for F in (0, 1, 4, 7, 441, 1200, 900):
        assert tw.n_samples_for(tcfg, F) == jw.n_samples_for(jcfg, F)
    if hop == 110.25:
        assert tw.hop_fraction(tcfg) == (441, 4)
        assert tw.n_samples_for(tcfg, 1200) == 132300


def test_upsample_cond_matches_jax():
    """At the recipe's fractional hop 110.25 and 54-d features; atol 1e-5:
    the dense is a float32 product summed in another order."""
    cfg_kw = dict(hop=110.25, feat_dim=54, cond_dim=128, hidden_units=32)
    jcfg, jp, tcfg, tp = _params(cfg_kw, seed=1)
    feats = np.random.default_rng(1).normal(size=(2, 37, 54)).astype(np.float32)
    want = np.asarray(jw.upsample_cond(jp, jcfg, jnp.asarray(feats)))
    got = tw.upsample_cond(tp, tcfg, torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, tw.n_samples_for(tcfg, 37), 128)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gate_table_and_logits_match_jax():
    """float32 products of up to 128 terms in another order: atol 1e-5."""
    jcfg, jp, tcfg, tp = _params(WIDE, seed=2)
    np.testing.assert_allclose(tw.embed_gate_table(tp).numpy(),
                               np.asarray(jw.embed_gate_table(jp)), atol=1e-5)
    h = np.tanh(np.random.default_rng(2).normal(size=(5, 64))).astype(np.float32)
    np.testing.assert_allclose(tw._logits(tp, torch.from_numpy(h)).numpy(),
                               np.asarray(jw._logits(jp, jnp.asarray(h))), atol=1e-5)


def _to_torch_grad(tp):
    return jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)


def test_teacher_forced_loss_and_gradients_match_jax():
    """Teacher-forced logits (atol 1e-5) and NLL (rtol 1e-5) at the tiny
    config; autograd's gradients against jax.grad within 2e-4 of each leaf's
    largest value (the JAX package's gradient tolerance)."""
    jcfg, jp, tcfg, tp = _params(TINY, seed=3)
    rng = np.random.default_rng(3)
    F = 4
    feats = rng.normal(size=(2, F, TINY["feat_dim"])).astype(np.float32)
    t = np.arange(F * TINY["hop"])
    wav = np.stack([0.5 * np.sin(2 * np.pi * t / 40), 0.3 * np.cos(2 * np.pi * t / 17)]).astype(np.float32)

    cond = jw.upsample_cond(jp, jcfg, jnp.asarray(feats))
    prev = jnp.asarray(rng.integers(0, TINY["n_classes"], size=wav.shape), jnp.int32)
    want_logits, want_h = jw.teacher_forced_logits(jp, jcfg, cond, prev)
    got_logits, got_h = tw.teacher_forced_logits(
        tp, tcfg, torch.from_numpy(np.array(cond)), torch.from_numpy(np.array(prev)))
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits), atol=1e-5)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), atol=1e-5)

    want_loss, want_grad = jax.value_and_grad(
        lambda p: jw.wavernn_loss(p, jcfg, jnp.asarray(feats), jnp.asarray(wav)))(jp)
    leaves = _to_torch_grad(tp)
    loss = tw.wavernn_loss(leaves, tcfg, torch.from_numpy(feats), torch.from_numpy(wav))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got_grad = wavernn_params_to_jax(jax.tree_util.tree_map(lambda t: t.grad, leaves))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_grad),
                            jax.tree_util.tree_leaves(got_grad)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        assert np.abs(g - w).max() <= 2e-4 * scale, (path, np.abs(g - w).max(), scale)


@pytest.mark.parametrize("cfg_kw,T,seed", [(TINY, 30, 4), (WIDE, 500, 5)])
def test_generate_greedy_matches_generate_xla(cfg_kw, T, seed):
    """Greedy (temperature 0): the same indices, exactly."""
    jcfg, jp, tcfg, tp = _params(cfg_kw, seed=seed)
    cond = _cond(np.random.default_rng(seed), T, cfg_kw["cond_dim"])
    want = np.asarray(jw.generate_xla(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(cond),
                                      temperature=0.0))
    got = tw.generate_reference(tp, tcfg, torch.from_numpy(cond), temperature=0.0)
    assert got.dtype == torch.int32 and got.shape == (T,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 3                    # not stuck on one class


@pytest.mark.parametrize("cfg_kw,T,temperature", [(TINY, 30, 1.0), (WIDE, 200, 0.8)])
def test_generate_sampled_matches_generate_xla_with_its_uniforms(cfg_kw, T, temperature):
    """Sampled: the uniforms generate_xla draws (its keys,
    split(PRNGKey(s), T), each uniform(k, (K,), 1e-9, 1)) injected into the
    port's sampler give the same indices, exactly."""
    jcfg, jp, tcfg, tp = _params(cfg_kw, seed=6)
    cond = _cond(np.random.default_rng(6), T, cfg_kw["cond_dim"])
    key = jax.random.PRNGKey(11)
    want = np.asarray(jw.generate_xla(jp, jcfg, key, jnp.asarray(cond), temperature=temperature))
    K = cfg_kw["n_classes"]
    u = np.stack([np.asarray(jax.random.uniform(k, (K,), minval=1e-9, maxval=1.0))
                  for k in jax.random.split(key, T)])
    got = tw.generate_reference(tp, tcfg, torch.from_numpy(cond), temperature=temperature,
                                u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    # the draws matter: greedy gives another sequence
    assert (tw.generate_reference(tp, tcfg, torch.from_numpy(cond), 0.0).numpy() != want).any()


def test_init_wavernn_shapes_match_jax():
    for n_spk in (0, 2):
        kw = dict(TINY, n_spk=n_spk)
        jp = jw.init_wavernn(jax.random.PRNGKey(0), jw.WaveRNNConfig(**kw))
        tp = tw.init_wavernn(torch.Generator().manual_seed(0), tw.WaveRNNConfig(**kw))
        shapes = lambda p: [tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(p)]
        assert shapes(wavernn_params_to_jax(tp)) == shapes(jp)
