"""Parallel WaveGAN's generator in the port (``models/pwg.py``, the plain
layer of ``ops/cuda_pwg.py``) against the plain float32 reference
``benchmark/reference/pwg.py``, which shares no code with it, on seeded
random weights at a small size on the CPU (2 stacks of 3 layers, 8 / 16 / 8
channels, 5 aux channels, scales [2, 3], 5 frames); the load of a trained
generator's state dict with weight norm; ``synthesize_vocoder``'s dispatch
and spans; the request kept on the device from the conversion to the
waveform (``device_decode_pair(..., on_device=True)`` and the vocoder chain
on its tensors) against the host path; and the cell ``voc-vocode-pwg`` at a
tiny size, which passes a sound run and fails each planted fault
(``benchmark/faults_pwg.py``).

Tolerances: the port and the reference compute the same float32 sums in
other orders (a matrix product over the packed taps against cuDNN's or
oneDNN's convolutions): a few ulps of the largest partial sum, so each
comparison holds within 1e-5 of the largest |value| it compares, and the
waveform after 6 layers within 2e-5.
"""

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import faults_pwg
from benchmark.harness import core, peaks
from benchmark.reference import pwg as ref
from cyclevae_tpu_torch.models import pwg
from cyclevae_tpu_torch.models.pwg import PWGConfig
from cyclevae_tpu_torch.ops import _build, cuda_pwg
from cyclevae_tpu_torch.pipeline import vocoder_stage
from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair, gv_postfilter
from cyclevae_tpu_torch.utils import profiling

TOL = 1e-5
WAVE_TOL = 2e-5
CFG = PWGConfig(layers=6, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
                aux_channels=5, upsample_scales=(2, 3))
V = dict(layers=6, stacks=2, upsample_scales=[2, 3], aux_context_window=2)
FRAMES = 5
ROOT = Path(__file__).resolve().parent.parent


def _params(cfg=CFG, seed=0):
    """``init_pwg``'s weights with every bias and upsampling kernel drawn
    (they start at 0 and the box), so that every path carries a signal."""
    g = torch.Generator().manual_seed(seed)
    p = pwg.init_pwg(g, cfg)
    for k, v in p["layers"].items():
        if k.endswith("_b"):
            v.uniform_(-0.2, 0.2, generator=g)
    p["first"]["b"].uniform_(-0.2, 0.2, generator=g)
    for k in ("b1", "b2"):
        p["last"][k].uniform_(-0.2, 0.2, generator=g)
    for k in p["upsample"]["kernels"]:
        k.mul_(1.0 + 0.5 * torch.empty_like(k).uniform_(-1.0, 1.0, generator=g))
    return p


def _inputs(cfg=CFG, seed=1, frames=FRAMES):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((frames, cfg.aux_channels), generator=g)
    z = torch.randn((1, frames * cfg.hop), generator=g)
    return feats, z


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_published_v1_shape():
    cfg = PWGConfig()
    assert cfg.hop == 256
    assert [cfg.dilation(l) for l in range(cfg.layers)] == [2 ** i for i in range(10)] * 3
    p = pwg.init_pwg(torch.Generator().manual_seed(0), cfg)
    n = sum(t.numel() for t in _leaves(p))
    # 39,936 a layer (dilated 3 x 64 -> 128 with bias, aux 54 -> 128, out and
    # skip 64 -> 64 with bias), conv_in 54 x 54 x 5, four 9-tap kernels, the
    # first and last convolutions
    assert n == 30 * 39_936 + 54 * 54 * 5 + 4 * 9 + 128 + 64 * 64 + 64 + 64 + 1 == 1_217_049


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_same_weights(got, want, tol=1e-6):
    """Every leaf of ``got`` within ``tol`` of its largest |value| from
    ``want``'s leaf at the same key path."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _assert_same_weights(got[k], want[k], tol)
    elif isinstance(got, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_weights(a, b, tol)
    else:
        assert got.shape == want.shape and _gap(got, want) <= tol


def test_upsampled_conditioning_matches_reference():
    p = _params()
    feats, _ = _inputs()
    got = pwg.upsample(p, CFG, feats.t()[None])
    want = ref.upsample(p, feats.t()[None], V["upsample_scales"], V["aux_context_window"])
    assert got.shape == (1, CFG.aux_channels, FRAMES * CFG.hop)
    assert _gap(got, want) <= TOL


def test_residual_stream_after_each_layer_matches_reference():
    p = _params()
    feats, z = _inputs()
    c = ref.upsample(p, feats.t()[None], V["upsample_scales"], V["aux_context_window"])
    x = (p["first"]["w"][None] * z[:, None, :] + p["first"]["b"][None, :, None]).contiguous()
    x_ref = x.clone()
    w1, b1, w2, b2 = pwg.pack_layers(p, CFG)
    assert w1.shape == (6, 32, 16) and w2.shape == (6, 8, 16)    # K = 3 x 8 + 5, padded to 32
    skip, skip_ref = None, 0
    for l in range(CFG.layers):
        x, skip = cuda_pwg.cuda_pwg_layer(x, c, skip, w1[l], b1[l], w2[l], b2[l],
                                          CFG.dilation(l))
        x_ref, s = ref.layer(p, l, x_ref, c, CFG.dilation(l))
        skip_ref = skip_ref + s
        assert _gap(x, x_ref) <= TOL, l
        assert _gap(skip, skip_ref) <= TOL, l


def test_waveform_matches_reference_on_the_same_noise():
    p = _params()
    feats, z = _inputs()
    c = pwg.upsample(p, CFG, feats.t()[None])
    got = pwg.pwg_generate(p, CFG, c, z)[0]
    want = ref.generate(p, V, feats, z[0])
    assert got.shape == (FRAMES * CFG.hop,)
    assert _gap(got, want) <= WAVE_TOL


def _conv_state(sd, name, w, b, style, g):
    """Module ``name``'s entries of a ParallelWaveGAN state dict holding w
    under weight norm (torch's own), its g scaled by 0.5-1.5 per output
    channel; returns the weight torch's weight norm then gives."""
    cls = torch.nn.Conv2d if w.dim() == 4 else torch.nn.Conv1d
    m = cls(w.shape[1], w.shape[0], tuple(w.shape[2:]), bias=b is not None)
    with torch.no_grad():
        m.weight.copy_(w)
        if b is not None:
            m.bias.copy_(b)
    if style == "weight_g":
        torch.nn.utils.weight_norm(m)
        gp, vp = m.weight_g, m.weight_v
    else:
        torch.nn.utils.parametrizations.weight_norm(m)
        gp, vp = m.parametrizations.weight.original0, m.parametrizations.weight.original1
    with torch.no_grad():
        gp.mul_(0.5 + torch.rand(gp.shape, generator=g))
    sd.update({f"{name}.{k}": v.detach().clone() for k, v in m.state_dict().items()})
    return torch._weight_norm(vp, gp, 0).detach()


def _state_dict(p, cfg, style, seed=5):
    """A ParallelWaveGANGenerator state dict of p under weight norm, and the
    weights it stands for, in the port's layout."""
    g = torch.Generator().manual_seed(seed)
    sd, lp = {}, p["layers"]
    eff = {"upsample": {"conv_in": _conv_state(sd, "upsample_net.conv_in",
                                               p["upsample"]["conv_in"], None, style, g),
                        "kernels": []},
           "layers": {k: [] for k in lp}, "first": {}, "last": {}}
    for i, k in enumerate(p["upsample"]["kernels"]):
        w = _conv_state(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}",
                        k.reshape(1, 1, 1, -1), None, style, g)
        eff["upsample"]["kernels"].append(w.reshape(-1))
    eff["first"]["w"] = _conv_state(sd, "first_conv", p["first"]["w"][..., None],
                                    p["first"]["b"], style, g)[..., 0]
    eff["first"]["b"] = p["first"]["b"]
    for l in range(cfg.layers):
        name = lambda m: f"conv_layers.{l}.{m}"
        eff["layers"]["dil_w"].append(_conv_state(sd, name("conv"), lp["dil_w"][l],
                                                  lp["dil_b"][l], style, g))
        eff["layers"]["aux_w"].append(_conv_state(sd, name("conv1x1_aux"),
                                                  lp["aux_w"][l][..., None], None, style,
                                                  g)[..., 0])
        for m, key in (("conv1x1_out", "out"), ("conv1x1_skip", "skip")):
            eff["layers"][f"{key}_w"].append(_conv_state(
                sd, name(m), lp[f"{key}_w"][l][..., None], lp[f"{key}_b"][l], style, g)[..., 0])
            eff["layers"][f"{key}_b"].append(lp[f"{key}_b"][l])
        eff["layers"]["dil_b"].append(lp["dil_b"][l])
    eff["layers"] = {k: torch.stack(v) for k, v in eff["layers"].items()}
    for i, (w, b) in enumerate((("w1", "b1"), ("w2", "b2"))):
        eff["last"][w] = _conv_state(sd, f"last_conv_layers.{2 * i + 1}",
                                     p["last"][w][..., None], p["last"][b], style, g)[..., 0]
        eff["last"][b] = p["last"][b]
    return sd, eff


@pytest.mark.parametrize("style", ["weight_g", "parametrizations"])
def test_folding_weight_norm_leaves_the_output_alone(style):
    """A trained generator's state dict (weight norm's g and v, either of
    torch's two namings) loads with the norm folded: the port renders what
    the reference renders with the weights weight norm stands for."""
    p = _params()
    sd, eff = _state_dict(p, CFG, style)
    got_p = pwg.from_state_dict(sd, CFG)
    _assert_same_weights(got_p, eff)
    feats, z = _inputs()
    got = pwg.pwg_generate(got_p, CFG, pwg.upsample(got_p, CFG, feats.t()[None]), z)[0]
    assert _gap(got, ref.generate(eff, V, feats, z[0])) <= WAVE_TOL
    assert _gap(got, ref.generate(p, V, feats, z[0])) > 1e-2    # g was moved: not p


def test_synthesize_vocoder_dispatches_pwg_without_k4(monkeypatch):
    def k4(*a, **k):
        raise AssertionError("K4 launched for a PWG config")

    monkeypatch.setattr(vocoder_stage, "cuda_wavernn_generate", k4)
    monkeypatch.setattr(vocoder_stage, "generate_reference", k4)
    p = _params()
    feats, _ = _inputs()
    before = cuda_pwg.cuda_pwg_layer.launches
    y = vocoder_stage.synthesize_vocoder(p, CFG, feats.numpy(), seed=7, device="cpu")
    assert cuda_pwg.cuda_pwg_layer.launches == before          # the plain layer: no launch
    z = torch.randn((1, FRAMES * CFG.hop), generator=torch.Generator().manual_seed(7))[0]
    assert y.shape == (FRAMES * CFG.hop,) and y.dtype == "float32"
    assert _gap(torch.as_tensor(y), ref.generate(p, V, feats, z)) <= WAVE_TOL
    with pytest.raises(ValueError, match="temperature"):
        vocoder_stage.synthesize_vocoder(p, CFG, feats.numpy(), temperature=0.8, device="cpu")
    with pytest.raises(ValueError, match="speaker"):
        vocoder_stage.synthesize_vocoder(p, CFG, feats.numpy(), spk_id=1, device="cpu")


def test_spans_and_counters_cost_nothing_untraced_and_nest_when_recorded():
    p = _params()
    feats, _ = _inputs()
    profiling.reset()
    vocoder_stage.synthesize_vocoder(p, CFG, feats.numpy(), seed=1, device="cpu")
    assert profiling.spans() == [] and profiling.counters() == {}
    with profiling.recording():
        vocoder_stage.synthesize_vocoder(p, CFG, feats.numpy(), seed=1, device="cpu")
        spans = {s.name: s for s in profiling.spans()}
        counts = profiling.counters()
    root = spans["vocoder.synthesize"]
    assert root.parent is None
    for name in ("vocoder.upsample", "vocoder.generate", "vocoder.assemble"):
        assert spans[name].parent == root.id and spans[name].request == root.id
    assert spans["fetch"].parent == spans["vocoder.assemble"].id
    # the plain layer launches nothing: the counter of launches stays unset
    assert counts == {"pwg.samples": FRAMES * CFG.hop, "device_waits": 1}
    profiling.reset()


# --- the request kept on the device ---------------------------------------

@pytest.fixture(scope="module")
def tiny_codec():
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae
    cfg = CycleVAEConfig(hidden_units=8, lat_dim=4)
    params = init_cyclevae(torch.Generator().manual_seed(0), cfg, device="cpu")
    return Codec(params, cfg, n_smpl_dec=4, bucket=16, device="cpu")


def _pair(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 54)).astype(np.float32) for n in (40, 27)]


@pytest.mark.parametrize("noise", ["generator", "eps"])
def test_a_conversion_kept_on_the_device_gives_the_host_paths_values(tiny_codec, noise):
    """``device_decode_pair(..., on_device=True)`` (``Codec.convert_pair``,
    the phase a CUDA codec captures, run directly here): the five outputs
    as float32 tensors, equal to the host path's arrays (the same inputs,
    draws and zero padding reach the same K1 calls), from the generator's
    draws or from injected ones, twice over the same buffers, and without
    one wait on the device and no graph replay."""
    feats = _pair(0)
    if noise == "eps":
        kw = lambda: {"generator": None, "eps": np.random.default_rng(7).normal(
            size=(tiny_codec.n_smpl_dec, 2, 40, tiny_codec.cfg.lat_dim))}
    else:
        kw = lambda: {"generator": torch.Generator().manual_seed(1)}
    host = device_decode_pair(tiny_codec, src_feat=feats[0], trg_feat=feats[1], **kw())
    for _ in range(2):
        with profiling.recording():
            dev = device_decode_pair(tiny_codec, src_feat=feats[0], trg_feat=feats[1],
                                     on_device=True, **kw())
            names = {s.name for s in profiling.spans()}
            counts = profiling.counters()
        for h, d in zip(host, dev):
            assert isinstance(d, torch.Tensor) and d.dtype == torch.float32
            assert np.array_equal(d.numpy(), np.asarray(h, np.float32))
        assert counts == {"codec.pair_replays": 0}      # run directly: no replay
        assert names == {"decode.device_decode_pair", "codec.convert_pair", "codec.pack"}


def test_the_vocoder_chain_on_a_device_conversion_matches_the_host_chain(tiny_codec):
    """``gv_postfilter``, ``converted_conditioning`` and a PWG
    ``synthesize_vocoder`` on the device conversion's tensors: the same
    values as the host chain (the postfilter in float64, so within 1e-12 of
    its scale; the conditioning within float32 rounding of the host's; the
    waveform within 1e-6 of its scale, the plain layers on the same noise),
    and one wait on the device in the whole chain, the waveform's fetch."""
    feats = _pair(3)
    rng = np.random.default_rng(4)
    gv_data = rng.uniform(0.5, 2.0, 49)
    gv_model = gv_data * rng.uniform(0.5, 1.0, 49)
    f0 = np.where(rng.random(40) < 0.7, rng.uniform(80.0, 250.0, 40), 0.0)
    cfg = PWGConfig(layers=6, stacks=2, residual_channels=8, gate_channels=16,
                    skip_channels=8, aux_channels=54, upsample_scales=(2, 3))
    p = pwg.init_pwg(torch.Generator().manual_seed(6), cfg)

    def chain(on_device):
        cv = device_decode_pair(tiny_codec, torch.Generator().manual_seed(5), *feats,
                                on_device=on_device)[2]
        cv = gv_postfilter(cv, gv_data, gv_model)
        c = vocoder_stage.converted_conditioning(feats[0], cv, f0, 5.0)
        return cv, c, vocoder_stage.synthesize_vocoder(p, cfg, c, seed=9, device="cpu")

    pf_h, c_h, w_h = chain(False)
    with profiling.recording():
        pf_d, c_d, w_d = chain(True)
        counts = profiling.counters()
    assert counts["device_waits"] == 1
    assert pf_d.dtype == torch.float64 and c_d.dtype == torch.float32
    np.testing.assert_allclose(pf_d.numpy(), pf_h, rtol=0, atol=1e-12 * np.abs(pf_h).max())
    np.testing.assert_allclose(c_d.numpy(), c_h, rtol=1e-6, atol=0)
    assert w_d.shape == w_h.shape == (40 * cfg.hop,) and w_d.dtype == np.float32
    np.testing.assert_allclose(w_d, w_h, rtol=0, atol=1e-6 * np.abs(w_h).max())


def test_the_launch_refuses_cpu_tensors():
    w1, b1, w2, b2 = pwg.pack_layers(pwg.init_pwg(torch.Generator().manual_seed(0),
                                                  PWGConfig()), PWGConfig())
    x, c = torch.zeros((1, 64, 10)), torch.zeros((1, 54, 10))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pwg.launch(None, x, c, None, w1[0], b1[0], w2[0], b2[0], 1)


def test_layer_work_equals_chip_smoke_bound():
    """``benchmark/work/pwg.py`` counts what ``chip_smoke.py``'s kernel table
    bounds: 79,360 FLOP a sample and layer, 2,389,248 the generator."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    work = core.load_module(core.HERE / "work" / "pwg.py", "t_work_pwg")
    v = core.load_json(core.HERE / "configs" / "cyclevae-o2o-hu1024-pwg.json")["vocoder"]
    assert work.layer_flops(v) == 2 * (246 * 128 + 64 * 128) == 79_360
    assert work.generator_flops(v) == 2_389_248
    n = 390 * 256
    first_ms, by = chip_smoke.pwg_layer_bound_ms(n, PWGConfig(), first=True)
    later_ms, _ = chip_smoke.pwg_layer_bound_ms(n, PWGConfig(), first=False)
    assert by == "operations"
    # one layer is the first (skip written, not read); two are it and a later one
    assert peaks.bound_s(*work.layers_work({**v, "layers": 1}, n)) * 1e3 == pytest.approx(
        first_ms, rel=1e-12)
    assert peaks.bound_s(*work.layers_work({**v, "layers": 2}, n)) * 1e3 == pytest.approx(
        first_ms + later_ms, rel=1e-12)


def test_tool_loads_a_pwg_checkpoint(tmp_path):
    """``vocode_converted --vocoder pwg`` loads a ParallelWaveGAN checkpoint
    (v1's widths, weight norm folded) and refuses a hop that is not the
    recipe's frame shift."""
    from cyclevae_tpu_torch.tools import vocode_converted
    cfg = PWGConfig()
    sd, eff = _state_dict(_params(cfg), cfg, "weight_g")
    torch.save({"model": {"generator": sd}, "steps": 10}, tmp_path / "checkpoint-10steps.pkl")
    args = SimpleNamespace(vocoder="pwg", vocoder_exp=str(tmp_path))
    params, vcfg = vocode_converted.load_vocoder(
        args, SimpleNamespace(fs=22050, shiftms=256 / 22.05), torch.device("cpu"))
    assert vcfg == cfg
    _assert_same_weights(params, eff)
    with pytest.raises(ValueError, match="hop"):
        vocode_converted.load_vocoder(args, SimpleNamespace(fs=22050, shiftms=5.0),
                                      torch.device("cpu"))


# --- the cell at a tiny size -----------------------------------------------

CELL = "voc-vocode-pwg"
SMALL = {"config": {"model": {"hidden_units": 16},
                    "vocoder": {"layers": 6, "stacks": 2, "residual_channels": 8,
                                "gate_channels": 16, "skip_channels": 8,
                                "upsample_scales": [2, 3], "hop": 6},
                    "n_smpl_dec": 4, "bucket": 40},
         "traffic": {"frames": [12, 20], "pool_utts": 6, "pairs": 4}}


def _run(seed=2**31 + 29, dtype=None, trace=False):
    torch.set_num_threads(2)
    return core.run_cell(core.Cell(CELL), seed, 0.3, trace, torch.device("cpu"), dtype=dtype,
                         overrides=SMALL)


def test_a_sound_run_passes():
    r = _run(trace=True)
    assert r["correct"] is True, r["compared"]
    assert set(r["compared"]) == {"convert_gap", "pwg_gap"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    m = r["metrics"]
    assert m["vocode_pwg.pwg_launches_per_request"]["value"] == 0.0      # the CPU's plain layer
    assert m["vocode.host_ms"]["value"] > 0 and m["vocode.mfu_pct"]["value"] > 0
    assert "vocode_pwg.pwg_roofline_pct" not in m                     # no device trace


@pytest.mark.parametrize("fault", sorted(faults_pwg.FAULTS))
def test_a_planted_fault_fails_the_check(monkeypatch, fault):
    faults_pwg.FAULTS[fault](monkeypatch.setattr)
    r = _run()
    assert r["correct"] is False
    c = r["compared"]["pwg_gap"]
    assert not c["value"] <= c["limit"], r["compared"]


def test_the_control_fails():
    """The conversion on the program's bfloat16 path: its gap, and the
    rendering's through the conditioning, exceed their limits."""
    r = _run(dtype="bfloat16")
    assert r["correct"] is False
    for name in ("convert_gap", "pwg_gap"):
        c = r["compared"][name]
        assert c["value"] > c["limit"], r["compared"]


def test_the_sqrt_half_fault_scales_every_layer():
    """The fault as planted: each layer's x' is sqrt(2) times the sound one."""
    p = _params()
    w1, b1, w2, b2 = pwg.pack_layers(p, CFG)
    x = torch.randn((1, 8, 30), generator=torch.Generator().manual_seed(3))
    c = torch.randn((1, 5, 30), generator=torch.Generator().manual_seed(4))
    sound = cuda_pwg.cuda_pwg_layer(x, c, None, w1[0], b1[0], w2[0], b2[0], 1)[0]
    mp = pytest.MonkeyPatch()
    faults_pwg.pwg_sqrt_half_dropped(mp.setattr)
    try:
        broken = cuda_pwg.cuda_pwg_layer(x, c, None, w1[0], b1[0], w2[0], b2[0], 1)[0]
        # the stand-in keeps a launch count for the card's launch to add to
        _build.count_launch(cuda_pwg.cuda_pwg_layer)
    finally:
        mp.undo()
    assert torch.allclose(broken, sound * math.sqrt(2.0))
