"""Parallel WaveGAN's gated residual layer kernel (``csrc/pwg.cu``) against its
plain PyTorch version, and the whole generator on the kernel against the
plain float32 reference (``benchmark/reference/pwg.py``), on the card; and
a vocoded conversion kept on the device from the encode to the waveform
against the host path.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pwg.py -q

Tolerances: the kernel sums each of a layer's products (256 and 64 terms)
in order with FMA, the plain version through cuBLAS in another order, both
float32: a few ulps of the larger partial sums, ~1e-6 of the layer's
largest output, so a layer is held within 1e-5 of it.  Through the 30
layers the residual stream carries those differences on (each layer adds
its own and scales the sum by sqrt(1/2)); the waveform is held within 2e-5
of its largest |value|.  TF32 (10 mantissa bits) reads ~1e-3 there.
"""

import math

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.models.pwg import PWGConfig, pack_layers, pwg_generate, upsample
from cyclevae_tpu_torch.ops.cuda_pwg import cuda_pwg_layer, pwg_layer_reference
from cyclevae_tpu_torch.utils import profiling

from benchmark.drivers.vocode_pwg import pwg_weights
from benchmark.reference import pwg as ref

LAYER_TOL = 1e-5
WAVE_TOL = 2e-5
HOP = 256
V = dict(layers=30, stacks=3, kernel_size=3, residual_channels=64, gate_channels=128,
         skip_channels=64, aux_channels=54, aux_context_window=2, upsample_scales=[4, 4, 4, 4])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _weights(dev, seed=0):
    return pwg_weights(torch.Generator(device=dev).manual_seed(seed), V)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [130 * HOP, 390 * HOP, 130 * HOP + 77])
@pytest.mark.parametrize("dilation", [1, 16, 512])
@pytest.mark.parametrize("first", [True, False], ids=["first", "accumulate"])
def test_layer_kernel_matches_plain(cuda_device, n, dilation, first):
    dev = cuda_device
    cfg = PWGConfig()
    p = _weights(dev)
    w1, b1, w2, b2 = pack_layers(p, cfg)
    g = torch.Generator(device=dev).manual_seed(n + dilation)
    B = 2 if n % HOP else 1
    x = torch.randn((B, 64, n), generator=g, device=dev)
    c = torch.randn((B, 54, n), generator=g, device=dev)
    skip = None if first else torch.randn((B, 64, n), generator=g, device=dev)
    l = {1: 0, 16: 4, 512: 9}[dilation]
    want = pwg_layer_reference(x, c, skip, w1[l], b1[l], w2[l], b2[l], dilation)
    before = cuda_pwg_layer.launches
    got = cuda_pwg_layer(x, c, None if first else skip.clone(), w1[l], b1[l], w2[l], b2[l],
                         dilation)
    torch.cuda.synchronize()
    assert cuda_pwg_layer.launches - before == 1
    for gt, wt in zip(got, want):
        assert _gap(gt, wt) <= LAYER_TOL


@pytest.mark.cuda
def test_generator_matches_reference(cuda_device):
    """390 frames (99,840 samples), the published widths, weights from a
    seed: the upsampled conditioning, each layer's residual stream and the
    waveform, the kernel's path against the plain reference's."""
    dev = cuda_device
    cfg = PWGConfig()
    p = _weights(dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn((390, 54), generator=g, device=dev)
    z = torch.randn((1, 390 * HOP), generator=g, device=dev)
    c = upsample(p, cfg, feats.t()[None])
    c_ref = ref.upsample(p, feats.t()[None], V["upsample_scales"], V["aux_context_window"])
    assert _gap(c, c_ref) <= LAYER_TOL
    x = (p["first"]["w"][None] * z[:, None, :] + p["first"]["b"][None, :, None]).contiguous()
    x_ref = x.clone()
    w1, b1, w2, b2 = pack_layers(p, cfg)
    skip = None
    for l in range(cfg.layers):
        x, skip = cuda_pwg_layer(x, c, skip, w1[l], b1[l], w2[l], b2[l], cfg.dilation(l))
        x_ref, _ = ref.layer(p, l, x_ref, c_ref, cfg.dilation(l))
        assert _gap(x, x_ref) <= WAVE_TOL, l
    before = cuda_pwg_layer.launches
    wave = pwg_generate(p, cfg, c, z)[0]
    assert cuda_pwg_layer.launches - before == cfg.layers
    want = ref.generate(p, V, feats, z[0])
    assert _gap(wave, want) <= WAVE_TOL
    assert _gap(ref.generate(p, V, feats, z[0], precision_name="tf32"), want) > WAVE_TOL


@pytest.mark.cuda
def test_kernel_counts_launches_and_refuses_bad_inputs(cuda_device):
    dev = cuda_device
    cfg = PWGConfig()
    w1, b1, w2, b2 = pack_layers(_weights(dev), cfg)
    x = torch.randn((1, 64, 1000), device=dev)
    c = torch.randn((1, 54, 1000), device=dev)
    with profiling.recording():
        cuda_pwg_layer(x, c, None, w1[0], b1[0], w2[0], b2[0], 1)
        assert profiling.counters()["pwg.layer_launches"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pwg_layer(x[:, :, ::2], c[:, :, ::2], None, w1[0], b1[0], w2[0], b2[0], 1)
    with pytest.raises(ValueError, match="is not"):
        cuda_pwg_layer(x[:, :32].contiguous(), c, None, w1[0], b1[0], w2[0], b2[0], 1)
    with pytest.raises(ValueError, match="float32"):
        cuda_pwg_layer(x.double(), c, None, w1[0], b1[0], w2[0], b2[0], 1)
    assert math.isfinite(float(cuda_pwg_layer(x, c, None, w1[0], b1[0], w2[0], b2[0],
                                              4000)[0].abs().max()))


@pytest.mark.cuda
def test_a_request_kept_on_the_device_matches_the_host_path(cuda_device):
    """The conversion (K1 at hu 1024, the captured graph of
    ``Codec.convert_pair``), the postfilter, the conditioning and
    the rendering (the layer kernel) kept on the device: at the capture,
    and at a replay queued behind ~50 ms of other work, so that every
    upload is still queued when its host buffer is dropped and written
    over.  Each gives the host path's values (its conversion as
    ``encode_mean`` then ``decode_batch``, which capture nothing), the
    conversion bitwise, with one wait on the device, the waveform's, and
    two K1 launches counted a replay."""
    from cyclevae_tpu_torch.pipeline.decode import (Codec, _speaker_codes, device_decode_pair,
                                                    gv_postfilter)
    from cyclevae_tpu_torch.pipeline.vocoder_stage import (converted_conditioning,
                                                           synthesize_vocoder)
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae
    dev = cuda_device
    cfg = CycleVAEConfig()
    codec = Codec(init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
                  cfg, n_smpl_dec=300, bucket=560, device=dev)
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(n, 54)).astype(np.float32) for n in (390, 130)]
    gv_data = rng.uniform(0.5, 2.0, 49)
    gv_model = gv_data * rng.uniform(0.5, 1.0, 49)
    f0 = np.where(rng.random(390) < 0.7, rng.uniform(80.0, 250.0, 390), 0.0)
    vcfg = PWGConfig()
    vp = _weights(dev)

    def chain(on_device):
        g = torch.Generator(device=dev).manual_seed(5)
        if on_device:
            out = device_decode_pair(codec, g, *feats, on_device=True)
        else:
            (ls, lt), (zs, zt) = codec.encode_mean(g, feats)
            out = (ls, lt, *codec.decode_batch([(_speaker_codes(390, cfg.n_spk, 1), zs),
                                                (_speaker_codes(390, cfg.n_spk, 0), zs),
                                                (_speaker_codes(130, cfg.n_spk, 1), zt)]))
        cv = gv_postfilter(out[2], gv_data, gv_model)
        c = converted_conditioning(feats[0], cv, f0, 11.61)
        # host buffers of the uploads' sizes, made and written over while
        # the device still sleeps: a copy that read its buffer late reads 7s
        junk = [np.full(shape, 7.0, dt) for shape, dt in (((2, 560, 54), np.float32),
                                                           ((390, 2), np.float32),
                                                           ((49,), np.float64),
                                                           ((390, 4), np.float32))]
        del junk
        return out, cv, c, synthesize_vocoder(vp, vcfg, c, seed=9, device=dev)

    out_h, pf_h, c_h, w_h = chain(False)
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    runs = []
    for queued_behind in (False, True):
        torch.cuda.synchronize(dev)
        if queued_behind:
            torch.cuda._sleep(100_000_000)
        before = cuda_gru_ar.launches
        with profiling.recording():
            runs.append(chain(True))
            runs[-1] += (profiling.counters()["device_waits"], cuda_gru_ar.launches - before)
    assert len(codec._pair_phases) == 1
    # the capture's own run off the graph launched K1 twice as well
    for (out_d, pf_d, c_d, w_d, waits, launches), want in zip(runs, (4, 2)):
        assert waits == 1 and launches == want
        for h, d in zip(out_h, out_d):
            assert d.device == dev and np.array_equal(d.cpu().numpy(),
                                                      np.asarray(h, np.float32))
        pf_d, c_d = pf_d.cpu().numpy(), c_d.cpu().numpy()
        np.testing.assert_allclose(pf_d, pf_h, rtol=0, atol=1e-12 * np.abs(pf_h).max())
        np.testing.assert_allclose(c_d, c_h, rtol=1e-6, atol=0)
        assert w_d.shape == w_h.shape == (390 * HOP,)
        assert float(np.abs(w_d - w_h).max() / np.abs(w_h).max()) <= WAVE_TOL
