"""The published WaveRNN-896's output layer in the port (``WaveRNNConfig.dual``:
a coarse and a fine 8-bit softmax over 16-bit audio, Kalchbrenner et al.,
arXiv:1802.08435, eq. 2), held at a small size on the CPU (H = 16: halves of
8 units, two 256-way heads, ~200 samples, seeded weights) against the plain
reference ``benchmark/reference/wavernn_dual.py``, which shares no code with
the port: the teacher-forced logits, the mask, the loss and its gradients,
the plain sampler's choices and its noise, the 16-bit codec; then stage v
and ``synthesize_vocoder`` end to end; and the single mu-law softmax's
renderings as they were before the dual output was added.

The JAX package has no dual output, so nothing here compares with it."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from benchmark.reference import wavernn as ref_single
from benchmark.reference import wavernn_dual as ref
from cyclevae_tpu_torch.models import wavernn as tw
from cyclevae_tpu_torch.ops import cuda_wavernn as cw
from cyclevae_tpu_torch.pipeline import recipe as trecipe
from cyclevae_tpu_torch.pipeline import vocoder_stage as tv

torch.set_num_threads(1)

CFG = tw.WaveRNNConfig(hidden_units=16, cond_dim=8, dual=True)
T = 200
FS = 22050
# float32 teacher-forced logits of the port (its plain loop, the input gates
# hoisted) and the reference (torch.nn.GRU) sum in different orders: a few
# ulps of values of order 1, over 200 dependent steps
ATOL = 2e-5


def _params(seed=0, masked_entries=0.3):
    """Seeded weights with every bias non-zero; ``w_ih``'s masked entries
    drawn too (non-zero), which the port and the reference must mask."""
    g = torch.Generator().manual_seed(seed)
    p = tw.init_wavernn(g, CFG)
    p["gru"]["w_ih"] = torch.empty_like(p["gru"]["w_ih"]).uniform_(
        -masked_entries, masked_entries, generator=g)
    for k in ("b_ih", "b_hh"):
        p["gru"][k].uniform_(-0.5, 0.5, generator=g)
    for k in ("O1", "O2", "O3", "O4"):
        p[k]["b"].uniform_(-0.1, 0.1, generator=g)
    return p


def _cond(seed=1, B=1, n=T):
    return torch.tanh(torch.randn((B, n, CFG.cond_dim), generator=torch.Generator().manual_seed(seed)))


def _samples(seed=2, B=1, n=T):
    return torch.randint(0, 65536, (B, n), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("head", [0, 1], ids=["coarse", "fine"])
def test_teacher_forced_logits_match_reference(head):
    p, cond, u16 = _params(), _cond(B=2), _samples(B=2)
    got = tw.dual_teacher_forced_logits(p, CFG, cond, u16)[head]
    c, f = ref.bytes_of(ref.decode16(u16))
    hs = ref.teacher_forced(p, cond, c, f)
    Hh = CFG.hidden_units // 2
    want = ref.head_logits(p, head, hs[..., head * Hh:(head + 1) * Hh])
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_the_mask_keeps_the_current_coarse_sample_from_the_coarse_half():
    """c_t changed at every step (f and the previous samples kept): the
    coarse half and the coarse logits are bitwise the same, the fine ones
    move."""
    p, cond, u16 = _params(), _cond(), _samples()
    c, f = tw.split16(u16)
    x = tw.dual_inputs(torch.cat([torch.full_like(c[:, :1], 128), c[:, :-1]], 1),
                       torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], 1), c)
    other = x.clone()
    other[..., 2] = tw.scaled_byte((c + 77) % 256)
    h0 = torch.zeros((1, CFG.hidden_units))
    Hh = CFG.hidden_units // 2
    a = tw.plain_recurrence(p, CFG, cond, x, h0)[:, :1]
    b = tw.plain_recurrence(p, CFG, cond, other, h0)[:, :1]
    assert torch.equal(a[..., :Hh], b[..., :Hh])
    assert torch.equal(tw.dual_head(p, 0, a[..., :Hh]), tw.dual_head(p, 0, b[..., :Hh]))
    assert not torch.equal(a[..., Hh:], b[..., Hh:])
    assert not torch.equal(tw.dual_head(p, 1, a[..., Hh:]), tw.dual_head(p, 1, b[..., Hh:]))
    # the whole recurrence: the mask's zeros are where the paper puts them
    m = tw.dual_input_mask(CFG)
    assert m.shape == (3 * CFG.hidden_units, 3 + CFG.cond_dim)
    for g in range(3):
        rows = slice(g * CFG.hidden_units, (g + 1) * CFG.hidden_units)
        assert torch.equal(m[rows, 2], torch.cat([torch.zeros(Hh), torch.ones(Hh)]))
    assert float(m.sum()) == m.numel() - 3 * Hh


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_sampler_takes_the_reference_best(B, temperature):
    """The kernel's plain version renders (c, f); teacher-forced on them, the
    reference's scores (same Philox noise, the head in counter word 3) put
    every taken byte at its head's best: gaps of 0 in both heads."""
    p, cond = _params(3), _cond(4, B)
    out = cw.cuda_wavernn_generate(p, CFG, cond, seed=2**31 + 5, temperature=temperature)
    assert out.dtype == torch.int32 and out.shape == (B, T)
    for b in range(B):
        c, f = tw.split16(out[b].long())
        gc, gf = ref.score_gaps(p, cond[b], c, f, (2**31 + 5) % 2**32, temperature, row=b)
        assert float(gc.max()) == 0.0 and float(gf.max()) == 0.0, (b, gc.max(), gf.max())
    if temperature > 0:   # sampled: the noise spreads the samples
        assert len(torch.unique(out)) > T // 4


def test_coarse_stream_is_k4s_and_fine_stream_its_own():
    single = cw.philox_uniforms(9, 3, 5, 2, 256)
    assert torch.equal(cw.philox_uniforms(9, 3, 5, 2, 256, head=0), single)
    fine = cw.philox_uniforms(9, 3, 5, 2, 256, head=1)
    assert not torch.equal(fine, single)
    for b in range(2):
        for head, u in ((0, single), (1, fine)):
            g = -torch.log(-torch.log(u[:, b] + 1e-9) + 1e-9)
            assert torch.equal(ref.gumbel(9, 3, 5, 256, "cpu", row=b, head=head), g)
    # K4's reference draws the coarse words
    assert torch.equal(ref_single.gumbel(9, 3, 5, 256, "cpu", row=1),
                       ref.gumbel(9, 3, 5, 256, "cpu", row=1, head=0))


# a small single mu-law softmax, for the tests that hold both output layers
MULAW = tw.WaveRNNConfig(n_classes=64, embed_dim=16, cond_dim=8, hidden_units=16, fc_dim=16)


@pytest.mark.parametrize("dual", [False, True], ids=["mulaw", "dual"])
def test_plain_sampler_is_the_model_sampler(dual):
    """Greedy, the kernel's plain version and the model's own sampler
    (``generate_reference``) take the same samples, row by row, for both
    output layers."""
    if dual:
        cfg, p = CFG, _params(5)
    else:
        cfg, g = MULAW, torch.Generator().manual_seed(5)
        p = tw.init_wavernn(g, cfg)
        for k in ("b_ih", "b_hh"):
            p["gru"][k].uniform_(-0.5, 0.5, generator=g)
    cond = _cond(6, 2)
    got = cw.wavernn_generate_reference(p, cfg, cond, seed=0, temperature=0.0)
    assert got.shape == (2, T)
    for b in range(2):
        assert torch.equal(got[b], tw.generate_reference(p, cfg, cond[b], 0.0))


def test_codec_round_trips_every_int16():
    s = torch.arange(-32768, 32768, dtype=torch.int64)
    x = s.to(torch.float32) / 32768.0
    u16 = tw.pcm16_encode(x)
    assert torch.equal(u16.long(), s + 32768)
    assert torch.equal(tw.pcm16_decode(u16), x)
    c, f = tw.split16(u16)
    assert torch.equal(c * 256 + f, u16) and int(c.max()) == 255 and int(f.max()) == 255
    rc, rf = ref.bytes_of(x)
    assert torch.equal(rc, c.long()) and torch.equal(rf, f.long())
    assert torch.equal(ref.decode16(u16), x)


def test_loss_and_gradients_match_reference():
    """The dual ``wavernn_loss`` (the two heads' mean cross-entropies) and
    its gradient in every parameter; the masked entries get none."""
    p = _params(7)
    feats = torch.randn((2, 3, 54), generator=torch.Generator().manual_seed(8))
    n = tw.n_samples_for(CFG, 3)
    wav = tw.pcm16_decode(_samples(9, 2, n))
    leaves = {(a, b): t for a, sub in p.items() for b, t in sub.items()}
    for t in leaves.values():
        t.requires_grad_(True)
    got = tw.wavernn_loss(p, CFG, feats, wav)
    g_got = torch.autograd.grad(got, list(leaves.values()))
    cond = ref.upsample({"cond": p["cond"]}, feats[0], CFG.hop)[None]
    cond = torch.cat([cond, ref.upsample({"cond": p["cond"]}, feats[1], CFG.hop)[None]])
    want = ref.loss(p, cond, wav)
    g_want = torch.autograd.grad(want, list(leaves.values()))
    # the loss: float32 sums of 2 x 661 terms of order 5
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for (name, a, b) in zip(leaves, g_got, g_want):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-5 * scale, name
    w_ih = g_got[list(leaves).index(("gru", "w_ih"))]
    assert float(w_ih[:CFG.hidden_units // 2, 2].abs().max()) == 0.0
    assert float(w_ih[CFG.hidden_units // 2:CFG.hidden_units, 2].abs().max()) > 0.0


def _corpus(root, spk, n_train=3):
    """A tiny speaker: train wavs with their feature files, one short eval wav."""
    from cyclevae_tpu_torch.utils.store import write_store
    from cyclevae_tpu_torch.utils.wavio import write_wav
    rng = np.random.default_rng(0)
    os.makedirs(root / "wav" / spk)
    os.makedirs(root / "wav" / "eval" / spk)
    paths = trecipe.RecipePaths(wav_root=str(root / "wav"), work=str(root / "work"),
                                n_train=n_train)
    for i in range(n_train):
        F = 30 + 5 * i
        n = tw.n_samples_for(CFG, F) + 40
        write_wav(str(root / "wav" / spk / f"u{i}.wav"), FS,
                  8000 * np.sin(np.arange(n) * 0.05 * (i + 1)) + 2000 * rng.normal(size=n))
        feat = rng.normal(size=(F, 54)).astype(np.float32)
        feat[:, 0] = rng.random(F) > 0.4
        feat[:, 1] += 5.0
        write_store(os.path.join(paths.h5dir(spk), f"u{i}.npz"), "/feat_org_lf0", feat)
    t = np.arange(int(0.35 * FS)) / FS
    write_wav(str(root / "wav" / "eval" / spk / "e0.wav"), FS,
              6000 * np.sin(2 * np.pi * 160 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
              + 300 * rng.normal(size=len(t)))
    return paths


def test_stage_v_trains_and_renders_the_dual_model(tmp_path, monkeypatch):
    """``--vocoder-dual`` on the command line reaches the config; stage v
    trains the dual model a step (one epoch of one batch) and renders its
    eval utterance through ``synthesize_vocoder``; the rendering is 16-bit
    audio."""
    from cyclevae_tpu_torch.utils.config import ExperimentConfig
    seen = {}
    real_train, real_eval = tv.run_train_vocoder, tv.eval_copy_synthesis

    def train(cfg, *a, **k):
        seen["cfg"] = cfg
        return real_train(cfg, *a, batch_size=4, **k)

    def render(params, cfg, exp, wavs, *a, **k):
        seen["eval"] = wavs
        return real_eval(params, cfg, exp, wavs, *a, **k)

    monkeypatch.setattr(tv, "run_train_vocoder", train)
    monkeypatch.setattr(tv, "eval_copy_synthesis", render)
    exp = ExperimentConfig()
    spk = exp.model.spk_trg
    paths = _corpus(tmp_path, spk)
    kw = {}
    monkeypatch.setattr(trecipe, "run_stages", lambda stages, e, p, **k: kw.update(k))
    trecipe.main(["--stage", "v", "--work", paths.work, "--wav-root", paths.wav_root,
                  "--vocoder-dual", "--vocoder-hidden-units", "16", "--device", "cpu"])
    assert kw["vocoder_dual"] is True
    monkeypatch.undo()
    monkeypatch.setattr(tv, "run_train_vocoder", train)
    monkeypatch.setattr(tv, "eval_copy_synthesis", render)
    trecipe.run_stages("v", exp, paths, device="cpu", vocoder_epochs=1, vocoder_clip_frames=8,
                       vocoder_n_eval=1, vocoder_hidden_units=16, vocoder_dual=True)
    assert seen["cfg"].dual and seen["cfg"].hidden_units == 16
    vexp = os.path.join(paths.work, "exp", f"vocoder_{spk}_hu16_dual")
    assert os.path.exists(os.path.join(vexp, "checkpoint-1.pkl"))
    wav = os.path.join(vexp, "wav_vocoded", "e0.wav")
    assert os.path.exists(wav)
    from cyclevae_tpu_torch.utils.wavio import read_wav
    _, y = read_wav(wav, cutoff=0)
    # ~70 frames of the 0.35 s utterance, 110.25 samples each
    assert len(y) > 7000 and np.all(np.abs(y) <= 32768)


def test_synthesize_vocoder_renders_16bit_audio():
    p, feats = _params(10), np.random.default_rng(1).normal(size=(4, 54)).astype(np.float32)
    y = tv.synthesize_vocoder(p, CFG, feats, seed=3, temperature=0.8, device="cpu")
    n = tw.n_samples_for(CFG, 4)
    assert y.dtype == np.float32 and y.shape == (n,)
    s = y * 32768.0
    assert np.array_equal(s, np.round(s)) and s.min() >= -32768 and s.max() <= 32767
    cond = tw.upsample_cond(p, CFG, torch.as_tensor(feats)[None])
    want = cw.cuda_wavernn_generate(p, CFG, cond, seed=3, temperature=0.8)[0]
    assert torch.equal(tw.pcm16_encode(torch.as_tensor(y)), want)
    assert len(tv.synthesize_vocoder(p, CFG, feats, seed=3, temperature=0.8, use_pallas=False,
                                     device="cpu")) == n


# sha256 (first 16 hex digits) of ``synthesize_vocoder``'s float32 samples
# for the single mu-law softmax below, read from the tree before the dual
# output was added: (temperature, use_pallas) -> digest
SINGLE = {(0.8, True): "730dd3848dc63cc1", (0.8, False): "380c33c8614fe12c",
          (0.0, True): "ceca9023a2381afd"}


@pytest.mark.parametrize("temperature,use_pallas", sorted(SINGLE))
def test_single_softmax_renders_as_before(temperature, use_pallas):
    cfg = tw.WaveRNNConfig(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=24, fc_dim=16)
    assert not cfg.dual and dataclasses.replace(cfg, dual=False) == cfg
    p = tw.init_wavernn(torch.Generator().manual_seed(11), cfg)
    feats = np.random.default_rng(5).normal(size=(6, 54)).astype(np.float32)
    y = tv.synthesize_vocoder(p, cfg, feats, seed=7, temperature=temperature,
                              use_pallas=use_pallas, device="cpu")
    assert hashlib.sha256(y.tobytes()).hexdigest()[:16] == SINGLE[(temperature, use_pallas)]


def test_dual_config_needs_256_classes_and_even_halves():
    with pytest.raises(ValueError):
        tw.WaveRNNConfig(dual=True, n_classes=64)
    with pytest.raises(ValueError):
        tw.WaveRNNConfig(dual=True, hidden_units=20)
