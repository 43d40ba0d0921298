"""The port's GRU-VAE inference forward and samplers against the JAX package (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models import gru_vae as jv
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.models import gru_vae as tv
from cyclevae_tpu_torch.vi.train import CycleVAEConfig

torch.set_num_threads(1)

H, B, T = 32, 2, 30


def _models(compute_dtype="float32", seed=0):
    kw = dict(hidden_units=H, compute_dtype=compute_dtype)
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=54).astype(np.float32)
    scale = (0.5 + rng.random(54)).astype(np.float32)
    jp = jax_init(jax.random.PRNGKey(seed), JaxConfig(**kw), mean, scale)
    return JaxConfig(**kw), CycleVAEConfig(**kw), jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_gru_rnn_apply_matches_jax(net, use_pallas):
    jc, tc, jp, tp = _models()
    rng = np.random.default_rng(1)
    if net == "encoder":
        cfg_j, cfg_t, p_j, p_t = jc.enc_cfg, tc.enc_cfg, jp.encoder, tp.encoder
        kw = dict(lat_dim=32, clamp_vae=True)
    else:
        cfg_j, cfg_t, p_j, p_t = jc.dec_cfg, tc.dec_cfg, jp.decoder, tp.decoder
        kw = {}
    x = rng.normal(size=(B, T, cfg_j.in_dim)).astype(np.float32)
    y0 = rng.normal(size=(B, cfg_j.out_dim)).astype(np.float32) * 0.3
    h0 = rng.normal(size=(1, B, H)).astype(np.float32) * 0.3
    want = jv.gru_rnn_apply(p_j, cfg_j, jnp.asarray(x), jnp.asarray(y0),
                            jnp.asarray(h0), use_pallas=use_pallas, **kw)
    got = tv.gru_rnn_apply(p_t, cfg_t, torch.tensor(x), torch.tensor(y0),
                           torch.tensor(h0), use_pallas=use_pallas, **kw)
    # float32 scan over 30 frames: the JAX package's scan tolerance; the
    # decoder's scale_out multiplies by scales up to 1.5
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_a_conv_composed_once_gives_the_same_outputs(net, compute_dtype):
    """``gru_rnn_apply(..., conv=compose_conv(params, cfg))``, as the
    ``Codec`` calls it with its frozen params, equals the call that
    composes the conv stack itself, bit for bit."""
    _, tc, _, tp = _models(compute_dtype)
    cfg, p = (tc.enc_cfg, tp.encoder) if net == "encoder" else (tc.dec_cfg, tp.decoder)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(B, T, cfg.in_dim)).astype(np.float32))
    y0 = torch.tensor(rng.normal(size=(B, cfg.out_dim)).astype(np.float32) * 0.3)
    conv = tv.compose_conv(p, cfg)
    for g, w in zip(tv.gru_rnn_apply(p, cfg, x, y0, use_pallas=True, conv=conv),
                    tv.gru_rnn_apply(p, cfg, x, y0, use_pallas=True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("head", ["softmax", "sigmoid", "exp", "relu_vae",
                                  "clamp_vae_laplace"])
def test_heads_match_jax(head):
    jc, tc, jp, tp = _models(seed=2)
    x = np.random.default_rng(2).normal(size=(B, T, 54)).astype(np.float32)
    kw = {"clamp_vae_laplace": True, "relu_vae": True} if head == "relu_vae" \
        else {head: True}
    want, _, _ = jv.gru_rnn_apply(jp.encoder, jc.enc_cfg, jnp.asarray(x),
                                  jnp.zeros((B, 64)), lat_dim=32, **kw)
    got, _, _ = tv.gru_rnn_apply(tp.encoder, tc.enc_cfg, torch.tensor(x),
                                 torch.zeros(B, 64), lat_dim=32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_res_mode_matches_jax():
    kw = dict(in_dim=60, out_dim=50, hidden_units=H, scale_out=False)
    p_j = jv.init_gru_rnn(jax.random.PRNGKey(3), jv.GRURNNConfig(**kw))
    p_t = params_from_jax((p_j, p_j), device="cpu").encoder
    x = np.random.default_rng(3).normal(size=(B, T, 60)).astype(np.float32)
    want, _, _ = jv.gru_rnn_apply(p_j, jv.GRURNNConfig(**kw), jnp.asarray(x),
                                  jnp.zeros((B, 50)), res=True, res_stdim=4,
                                  use_pallas=True)
    got, _, _ = tv.gru_rnn_apply(p_t, tv.GRURNNConfig(**kw), torch.tensor(x),
                                 torch.zeros(B, 50), res=True, res_stdim=4,
                                 use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_bf16_scan_path_matches_jax():
    """compute_dtype="bfloat16" on the scan path: the same dtype flow as the
    JAX package (bf16-rounded params and input, taps composed in bf16,
    float32 products of the rounded values)."""
    jc, tc, jp, tp = _models("bfloat16", seed=4)
    x = np.random.default_rng(4).normal(size=(B, T, 54)).astype(np.float32)
    want, _, _ = jv.gru_rnn_apply(jp.encoder, jc.enc_cfg, jnp.asarray(x),
                                  jnp.zeros((B, 64)), lat_dim=32, clamp_vae=True)
    got, _, _ = tv.gru_rnn_apply(tp.encoder, tc.enc_cfg, torch.tensor(x),
                                 torch.zeros(B, 64), lat_dim=32, clamp_vae=True)
    w, g = np.asarray(want).ravel(), got.numpy().ravel()
    # bf16 products composing the conv taps round at other places in the
    # two frameworks: the JAX package's bf16 bound
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 3e-2


def test_init_and_scale_stats_match_jax_structure():
    """The port's fresh params have the JAX package's tree (keys, list
    order, shapes); baked stats land in the same leaves and then drive the
    forward the same way."""
    kw = dict(in_dim=6, out_dim=4, hidden_units=H, hidden_layers=2)
    p_j = jv.init_gru_rnn(jax.random.PRNGKey(7), jv.GRURNNConfig(**kw))
    p_t = tv.init_gru_rnn(torch.Generator().manual_seed(7), tv.GRURNNConfig(**kw))
    assert jax.tree_util.tree_structure(p_j) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda a: a.numpy(), p_t))
    for a, b in zip(jax.tree_util.tree_leaves(p_j),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.numpy(), p_t))):
        assert a.shape == b.shape and b.dtype == np.float32
    assert tuple(tv.init_hidden(tv.GRURNNConfig(**kw), 3).shape) == \
        jv.init_hidden(jv.GRURNNConfig(**kw), 3).shape
    rng = np.random.default_rng(7)
    stats = [rng.normal(size=6), 0.5 + rng.random(6), rng.normal(size=4), 0.5 + rng.random(4)]
    stats = [s.astype(np.float32) for s in stats]
    p_j = jv.set_scale_stats(p_j, *stats)
    p_t = tv.set_scale_stats(params_from_jax((p_j, p_j), device="cpu").encoder, *stats)
    for key in ("scale_in", "scale_out"):
        for leaf in ("mean", "scale"):
            np.testing.assert_array_equal(p_t[key][leaf].numpy(), np.asarray(p_j[key][leaf]))
    x = rng.normal(size=(B, 12, 6)).astype(np.float32)
    want, _, _ = jv.gru_rnn_apply(p_j, jv.GRURNNConfig(**kw), jnp.asarray(x), jnp.zeros((B, 4)))
    got, _, _ = tv.gru_rnn_apply(p_t, tv.GRURNNConfig(**kw), torch.tensor(x), torch.zeros(B, 4))
    # two-layer float32 scan over 12 frames: the JAX package's scan tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_training_arguments_raise():
    """Dropout and input noise draw from an explicit ``Draws``: without one
    they raise rather than take the global RNG.  (``differentiable`` needs
    no draws; tests/test_torch_train.py covers the training path.)"""
    _, tc, _, tp = _models()
    x, y = torch.zeros(1, 4, 54), torch.zeros(1, 64)
    cfg = dataclasses.replace(tc.enc_cfg, do_prob=0.5)
    for kw in ({"do": True}, {"noise": 0.1}):
        with pytest.raises(ValueError):
            tv.gru_rnn_apply(tp.encoder, cfg, x, y, **kw)
    out, _, _ = tv.gru_rnn_apply(tp.encoder, cfg, x, y, differentiable=True, use_pallas=True)
    assert out.shape == (1, 4, 64)


@pytest.mark.parametrize("laplace", [False, True])
def test_sampling_with_injected_eps_matches_jax_formula(laplace):
    rng = np.random.default_rng(5)
    param = rng.normal(size=(3, 7, 8)).astype(np.float32)
    if laplace:
        eps = rng.uniform(-0.4999, 0.5, size=(3, 7, 4)).astype(np.float32)
        mu, ls = param[..., :4], param[..., 4:]
        want = mu - np.exp(ls) * np.sign(eps) * np.log1p(-2.0 * np.abs(eps))
        got = tv.sampling_vae_laplace_batch(torch.tensor(param), 4, eps=torch.tensor(eps))
    else:
        eps = rng.normal(size=(3, 7, 4)).astype(np.float32)
        want = param[..., :4] + np.exp(param[..., 4:] / 2.0) * eps
        got = tv.sampling_vae_batch(torch.tensor(param), 4, eps=torch.tensor(eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("laplace", [False, True])
def test_generator_draws_have_posterior_moments(laplace):
    """A torch.Generator's draws cannot match jax.random's, so their mean and
    spread are held to the posterior's: within 5 standard errors."""
    n = 20000
    rng = np.random.default_rng(6)
    lat = np.concatenate([rng.normal(size=6), rng.normal(size=6) * 0.5]).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    param = torch.tensor(lat).expand(n, 12)
    fn = tv.sampling_vae_laplace_batch if laplace else tv.sampling_vae_batch
    draws = fn(param, 6, generator=gen).numpy().astype(np.float64)
    mu = lat[:6]
    sd = np.sqrt(2.0) * np.exp(lat[6:]) if laplace else np.exp(lat[6:] / 2.0)
    assert np.all(np.abs(draws.mean(0) - mu) < 5 * sd / np.sqrt(n))
    assert np.all(np.abs(draws.std(0) / sd - 1.0) < 0.05)
    with pytest.raises(ValueError):
        fn(param, 6)   # no generator, no eps: never the global RNG
