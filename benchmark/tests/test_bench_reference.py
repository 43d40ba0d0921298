"""The plain reference against the port's plain paths, at a tiny size on the
CPU (the port's kernel wrappers take their plain versions on CPU tensors).
The tests may import the port; the reference may not (test_bench_imports)."""

import numpy as np
import pytest
import torch

from benchmark.harness import speech, weights
from benchmark.reference import cyclevae as ref
from benchmark.reference import dsp as ref_dsp
from benchmark.reference import wavernn as ref_voc

M = dict(in_dim=54, out_dim=50, lat_dim=32, n_spk=2, hidden_units=16, hidden_layers=1,
         kernel_size=3, dilation_size=2, n_cyc=2, do_prob=0.5, stdim=4)


def _model(seed=0, T=40):
    rng = np.random.default_rng(seed)
    feats = speech.corpus(rng, [T, T - 7, T + 5])
    mean, scale = speech.stats(feats)
    p = weights.cyclevae(torch.Generator().manual_seed(seed), M, torch.as_tensor(mean),
                         torch.as_tensor(scale))
    return p, feats


def _port_cfg(dtype="float32"):
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig
    return CycleVAEConfig(**M, use_pallas=True, compute_dtype=dtype)


@pytest.mark.parametrize("encoder", [True, False])
def test_net_matches_port(encoder):
    from cyclevae_tpu_torch.models.gru_vae import gru_rnn_apply
    p, feats = _model()
    port = weights.as_port(p)
    cfg = _port_cfg()
    net = "encoder" if encoder else "decoder"
    ncfg = cfg.enc_cfg if encoder else cfg.dec_cfg
    x = torch.as_tensor(np.stack([f[:33] for f in feats]))
    if not encoder:
        x = x[..., :34]
    y0 = torch.zeros((3, ncfg.out_dim))
    h0 = torch.zeros((3, 16))
    want, _, _ = gru_rnn_apply(port[net], ncfg, x, y0, h0[None], use_pallas=True,
                               clamp_vae=encoder)
    got, _, _ = ref.net_apply(p[net], ref.Model.of(M), x, y0, h0, encoder)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conversion_matches_port():
    from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair
    from cyclevae_tpu_torch.vi.train import CycleVAEParams
    p, feats = _model(1)
    codec = Codec(CycleVAEParams(**weights.as_port(p)), _port_cfg(), n_smpl_dec=4, bucket=16,
                  device="cpu")
    src, trg = feats[0], feats[1]
    Tp = 48
    eps = torch.randn((4, 2, Tp, 32), generator=torch.Generator().manual_seed(5))
    got = device_decode_pair(codec, None, src, trg,
                             eps=eps[:, :, :max(len(src), len(trg))].numpy())
    want = ref.convert_pair(p, ref.Model.of(M), torch.as_tensor(src), torch.as_tensor(trg), Tp,
                            eps)
    for g, w in zip(got, want):
        assert np.allclose(g, w.numpy(), rtol=1e-5, atol=1e-5)


def test_train_steps_match_port():
    from cyclevae_tpu_torch.models.gru_vae import Draws
    from cyclevae_tpu_torch.vi.train import (CycleVAEParams, TrainState, make_optimizer,
                                             make_train_step)
    p, feats = _model(2, T=30)
    p0 = weights.clone(p)
    B, seg, n_segs = 3, 10, 4
    x = np.zeros((B, seg * n_segs, 54), np.float32)
    for b, f in enumerate(feats):
        x[b, :len(f)] = f[:seg * n_segs]
    code = np.zeros((B, seg * n_segs, 2), np.float32)
    batch = {"feats": x, "src_code": code + [1, 0], "trg_code": code + [0, 1],
             "cv_excit": x[..., :4], "flens": np.asarray([30, 23, 35])}

    class Rec(Draws):
        def bernoulli(self, keep, shape):
            t = super().bernoulli(keep, shape)
            self.log.append(("bernoulli", t))
            return t

        def normal(self, shape):
            t = super().normal(shape)
            self.log.append(("normal", t))
            return t

    cfg = _port_cfg()
    params = CycleVAEParams(**weights.as_port(p))
    opt = make_optimizer(cfg, lr=1e-3)
    ts = TrainState(params, opt.init(params), torch.Generator().manual_seed(3), 0)
    step = make_train_step(cfg, opt, seg, n_segs)
    logs, losses = [], []
    for _ in range(2):
        d = Rec(ts.rng)
        d.log = []
        ts, m = step(ts, batch, draws=d)
        logs.append(d.log)
        losses.append(m["loss"].tolist())
    q = weights.clone(p0)
    want, grads = ref.train_steps(q, ref.Model.of(M), [batch, batch], logs, 1e-3, seg, n_segs)
    for got_s, want_s in zip(losses, want):
        for a, b in zip(got_s, want_s):
            assert b is not None and a == pytest.approx(b, rel=1e-5)
    # Adam moves an element by about lr whatever its gradient's size, so an
    # element whose gradient is nought to rounding may move either way:
    # compare each leaf's change by its norm, and nearly every element
    for got, want_t, start in zip(ref.trainable(p), ref.trainable(q), ref.trainable(p0)):
        d_got, d_want = got.detach() - start, want_t - start
        assert float(d_got.norm()) == pytest.approx(float(d_want.norm()), rel=1e-3)
        assert float(((d_got - d_want).abs() > 1e-6).float().mean()) < 0.01


def test_philox_and_upsampling_match_port():
    from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, upsample_cond
    from cyclevae_tpu_torch.ops.cuda_wavernn import philox_uniforms
    u = philox_uniforms(12345, 7, 5, 1, 16)[:, 0]
    g = -torch.log(-torch.log(u + 1e-9) + 1e-9)
    assert torch.equal(ref_voc.gumbel(12345, 7, 5, 16, "cpu"), g)
    v = dict(hidden_units=16, n_classes=16, embed_dim=8, cond_dim=8, fc_dim=8, feat_dim=54,
             n_spk=0, hop=110.25)
    vp = weights.wavernn(torch.Generator().manual_seed(0), v)
    feats = torch.randn(9, 54)
    want = upsample_cond(vp, WaveRNNConfig(**v), feats[None])[0]
    assert torch.allclose(ref_voc.upsample(vp, feats, 110.25), want, rtol=1e-6, atol=1e-6)


def test_rendering_scores_nothing_below_the_best():
    from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig
    from cyclevae_tpu_torch.pipeline.vocoder_stage import synthesize_vocoder
    v = dict(hidden_units=16, n_classes=16, embed_dim=8, cond_dim=8, fc_dim=8, feat_dim=54,
             n_spk=0, hop=110.25)
    vp = weights.wavernn(torch.Generator().manual_seed(1), v)
    feats = np.random.default_rng(0).normal(size=(6, 54)).astype(np.float32)
    wave = synthesize_vocoder(vp, WaveRNNConfig(**v), feats, seed=99, temperature=0.8,
                              device="cpu")
    cond = ref_voc.upsample(vp, torch.as_tensor(feats), 110.25)
    idx = ref_voc.classes_of(torch.as_tensor(wave), 16)
    gaps = ref_voc.score_gaps(vp, cond, idx, 99, 0.8)
    assert gaps.shape[0] == len(wave) and float(gaps.max()) < 1e-5
    wrong = idx.clone()
    wrong[3] = (wrong[3] + 1) % 16
    assert float(ref_voc.score_gaps(vp, cond, wrong, 99, 0.8)[3]) > 1e-3


def test_host_steps_match_port():
    from cyclevae_tpu_torch.pipeline.decode import gv_postfilter
    from cyclevae_tpu_torch.pipeline.features import convert_f0
    from cyclevae_tpu_torch.pipeline.vocoder_stage import converted_conditioning
    rng = np.random.default_rng(4)
    feat = speech.features(rng, 300)
    f0 = speech.f0_track(rng, feat)
    mcep = rng.normal(size=(300, 50))
    gv_d, gv_m = rng.uniform(0.5, 1.0, 49), rng.uniform(0.5, 1.0, 49)
    assert np.array_equal(ref_dsp.gv_postfilter(mcep, gv_d, gv_m), gv_postfilter(mcep, gv_d, gv_m))
    stats = (5.3, 0.2, 5.5, 0.25)
    cf0 = ref_dsp.convert_f0(f0, *stats)
    assert np.array_equal(cf0, convert_f0(f0, *stats))
    assert np.array_equal(ref_dsp.conditioning(feat, mcep, cf0, 5.0),
                          converted_conditioning(feat, mcep, cf0, 5.0))
