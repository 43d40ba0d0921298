"""The port's vocoder training stage (``pipeline/dataset_mult.py``,
``pipeline/vocoder_stage.py``: ``NeuVocoDataset``, ``sample_clips``,
``run_train_vocoder``, ``eval_copy_synthesis``) against the JAX package's,
on the CPU at a small width: the same items and clips, the same losses and
gradient from the same initial weights, optax's cosine schedule, resume, and
the same copy-synthesis metrics."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cyclevae_tpu.models import wavernn as jw
from cyclevae_tpu.pipeline import dataset_mult as jdm
from cyclevae_tpu.pipeline import vocoder_stage as jv
from cyclevae_tpu.pipeline.recipe import SpeakerConf as JaxSpeakerConf
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.hdf5 import write_hdf5
from cyclevae_tpu_torch.interop import wavernn_params_from_jax
from cyclevae_tpu_torch.models import wavernn as tw
from cyclevae_tpu_torch.pipeline import dataset_mult as tdm
from cyclevae_tpu_torch.pipeline import vocoder_stage as tv
from cyclevae_tpu_torch.pipeline.recipe import SpeakerConf
from cyclevae_tpu_torch.utils.config import ExperimentConfig
from cyclevae_tpu_torch.utils.store import write_store
from cyclevae_tpu_torch.utils.wavio import write_wav

from test_e2e_pipeline import FS, synth_speechlike

torch.set_num_threads(1)

SMALL = dict(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=24, fc_dim=16,
             feat_dim=54, hop=110.25)
# the utterances: (frames of features, samples of wav); lengths that are not
# multiples of the hop's denominator, and wavs a little longer or shorter
# than their features
UTTS = [(37, 4100), (29, 3150), (45, 4950), (22, 2500)]
CLIP = 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Each utterance as a wav, a JAX .h5 and a port .npz feature file."""
    root = tmp_path_factory.mktemp("voc")
    rng = np.random.default_rng(0)
    wavs, h5s, npzs = [], [], []
    for i, (F, n) in enumerate(UTTS):
        w = str(root / f"u{i}.wav")
        write_wav(w, FS, (8000 * np.sin(np.arange(n) * 0.05 * (i + 1))
                          + 2000 * rng.normal(size=n)))
        feat = rng.normal(size=(F, 54)).astype(np.float32)
        feat[:, 0] = rng.random(F) > 0.4
        feat[:, 1] += 5.0
        write_hdf5(str(root / f"u{i}.h5"), "/feat_org_lf0", feat)
        write_store(str(root / f"u{i}.npz"), "/feat_org_lf0", feat)
        wavs.append(w)
        h5s.append(str(root / f"u{i}.h5"))
        npzs.append(str(root / f"u{i}.npz"))
    return root, wavs, h5s, npzs


@pytest.mark.parametrize("spk", [False, True])
def test_dataset_items_and_clips_bitwise_equal(corpus, spk):
    _, wavs, h5s, npzs = corpus
    kw = dict(spk_ids=[0, 1, 1, 0], n_spk=2) if spk else {}
    jds = jdm.NeuVocoDataset(wavs, h5s, 110.25, **kw)
    tds = tdm.NeuVocoDataset(wavs, npzs, 110.25, **kw)
    assert len(jds) == len(tds) == len(UTTS)
    for i in range(len(UTTS)):
        a, b = tds[i], jds[i]
        for k in ("x", "feat"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        assert a["feat"].shape[0] % 4 == 0 and a["feat"].shape[1] == 54 + (2 if spk else 0)
    for x, y in ((np.zeros(10), np.zeros(3)), (np.zeros(1000), np.zeros(13))):
        for f in (None, 110.25, 2):
            for g, w in zip(tdm.validate_length(x, y, f), jdm.validate_length(x, y, f)):
                np.testing.assert_array_equal(g, w)
    jcfg, tcfg = jw.WaveRNNConfig(**SMALL, n_spk=2 if spk else 0), \
        tw.WaveRNNConfig(**SMALL, n_spk=2 if spk else 0)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for idxs in ([0, 1, 2, 3], [3, 3, 1, 0], [2, 0]):
        fj, wj = jv.sample_clips(jds, idxs, CLIP, jcfg, rj)
        ft, wt = tv.sample_clips(tds, idxs, CLIP, tcfg, rt)
        assert ft.dtype == wt.dtype == torch.float32
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    # a clip longer than the shortest utterance pads both
    fj, wj = jv.sample_clips(jds, [3], 40, jcfg, rj)
    ft, wt = tv.sample_clips(tds, [3], 40, tcfg, rt)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def _jax_init(seed=1):
    """The JAX trainer's initial weights (its seed), with non-zero biases so
    that every parameter's gradient is exercised."""
    params = jw.init_wavernn(jax.random.PRNGKey(seed), jw.WaveRNNConfig(**SMALL))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for name in ("b_ih", "b_hh"):
        params["gru"][name] = (0.3 * rng.normal(size=params["gru"][name].shape)
                               ).astype(np.float32)
    return params


@pytest.fixture
def same_init(monkeypatch):
    """Both trainers start from ``_jax_init``'s weights."""
    params = _jax_init()
    monkeypatch.setattr(jv, "init_wavernn",
                        lambda key, cfg: jax.tree_util.tree_map(jnp.asarray, params))
    monkeypatch.setattr(tv, "init_wavernn",
                        lambda gen, cfg: wavernn_params_from_jax(params, device=gen.device))
    return params


@pytest.mark.parametrize("lr_decay", [False, True])
def test_three_steps_match_jax(corpus, tmp_path, same_init, lr_decay):
    """3 epochs of one step each (4 utterances, batch 4): the losses within
    1e-5 relative of the JAX trainer's, from the same weights and clips."""
    _, wavs, h5s, npzs = corpus
    kw = dict(epochs=3, batch_size=4, clip_frames=CLIP, lr=3e-3, lr_decay=lr_decay)
    want = jv.run_train_vocoder(jw.WaveRNNConfig(**SMALL), wavs, h5s, str(tmp_path / "j"), **kw)
    got = tv.run_train_vocoder(tw.WaveRNNConfig(**SMALL), wavs, npzs, str(tmp_path / "t"),
                               device="cpu", **kw)
    nll_j = [h["nll"] for h in want["history"]]
    nll_t = [h["nll"] for h in got["history"]]
    assert [h["epoch"] for h in got["history"]] == [1, 2, 3]
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5)
    assert nll_t[2] < nll_t[0]               # the steps moved the weights
    # the weights after 3 Adam steps: within 2e-4 of each leaf's scale
    got_p = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tw_to_np(got["params"])))
    for g, w in zip(got_p, jax.tree_util.tree_leaves(want["params"])):
        w = np.asarray(w)
        assert np.max(np.abs(g - w)) <= 2e-4 * max(np.max(np.abs(w)), 1e-3)
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == ["checkpoint-3.pkl", "checkpoint-latest.pkl", "history.json"]


def tw_to_np(params):
    from cyclevae_tpu_torch.interop import wavernn_params_to_jax
    return wavernn_params_to_jax(params)


def test_step_one_gradient_matches_jax(corpus, same_init):
    """The gradient of the first batch's loss, every leaf within 2e-4 of its
    scale (the JAX package's gradient bound, tests/test_gru_ar_vjp.py)."""
    _, wavs, h5s, npzs = corpus
    jcfg, tcfg = jw.WaveRNNConfig(**SMALL), tw.WaveRNNConfig(**SMALL)
    feats, wav = jv.sample_clips(jdm.NeuVocoDataset(wavs, h5s, 110.25), [2, 0, 1, 3], CLIP,
                                 jcfg, np.random.default_rng(1))
    jp = jax.tree_util.tree_map(jnp.asarray, same_init)
    loss_j, g_j = jax.value_and_grad(jw.wavernn_loss)(jp, jcfg, feats, wav)
    tp = wavernn_params_from_jax(same_init, device="cpu")
    leaves = jax.tree_util.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss_t = tw.wavernn_loss(tp, tcfg, torch.as_tensor(np.array(feats)),
                             torch.as_tensor(np.array(wav)))
    grads = torch.autograd.grad(loss_t, leaves)
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for g, w in zip(grads, jax.tree_util.tree_leaves(g_j)):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= 2e-4 * np.max(np.abs(w)), np.max(np.abs(w))


def test_cosine_schedule_matches_optax():
    """The LambdaLR factor of ``run_train_vocoder`` against
    ``optax.cosine_decay_schedule`` at every step (and past the end): within
    1e-7 absolute, and within 1e-6 relative of optax's value (optax takes
    the cosine of a float32 argument in float32, a few 1e-7 relative off the
    exact value the port computes in double)."""
    lr, steps = 2e-4, 37
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.1)
    factor = tv.cosine_decay(steps)
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=lr)
    lam = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    for k in range(steps + 5):
        got = opt.param_groups[0]["lr"]
        want = float(sched(k))
        assert abs(got - want) <= min(1e-7, 1e-6 * want), (k, got, want)
        opt.step()
        lam.step()


@pytest.mark.parametrize("lr_decay", [False, True])
def test_resume_reproduces_history(corpus, tmp_path, lr_decay):
    """A 4-epoch run resumed from its epoch-2 checkpoint (as after a crash)
    gives the unbroken run's history and weights: the Adam state, the lr
    schedule's position and the numpy stream of the clips come back."""
    import shutil
    _, wavs, _, npzs = corpus
    cfg = tw.WaveRNNConfig(**SMALL)
    kw = dict(epochs=4, batch_size=4, clip_frames=CLIP, lr=3e-3, lr_decay=lr_decay,
              ckpt_every=2, device="cpu")
    full = tv.run_train_vocoder(cfg, wavs, npzs, str(tmp_path / "a"), **kw)
    assert sorted(os.listdir(tmp_path / "a")) == [
        "checkpoint-2.pkl", "checkpoint-4.pkl", "checkpoint-latest.pkl", "history.json"]
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    res = tv.run_train_vocoder(cfg, wavs, npzs, str(tmp_path / "b"),
                               resume=str(tmp_path / "b" / "checkpoint-2.pkl"), **kw)
    hist = json.load(open(tmp_path / "b" / "history.json"))["history"]
    assert [h["epoch"] for h in hist] == [1, 2, 3, 4]
    assert [h["epoch"] for h in res["history"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([h["nll"] for h in hist], [h["nll"] for h in full["history"]],
                               rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(tw_to_np(res["params"])),
                    jax.tree_util.tree_leaves(tw_to_np(full["params"]))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_copy_synthesis_matches_jax(tmp_path):
    """``eval_copy_synthesis`` at temperature 0 (argmax on both sides): the
    same metrics within 1e-6, the vocoded wav written."""
    f = str(tmp_path / "e0.wav")
    write_wav(f, FS, synth_speechlike(180.0, 0.3, seed=3))
    params = _jax_init(2)
    rng = np.random.default_rng(2)
    params["fc2"]["b"] = (2.0 * rng.normal(size=params["fc2"]["b"].shape)).astype(np.float32)
    kw = dict(temperature=0.0)
    want = jv.eval_copy_synthesis(jax.tree_util.tree_map(jnp.asarray, params),
                                  jw.WaveRNNConfig(**SMALL), JaxExperiment(), [f],
                                  JaxSpeakerConf(70.0, 400.0, -25.0), str(tmp_path / "j"), **kw)
    got = tv.eval_copy_synthesis(wavernn_params_from_jax(params, device="cpu"),
                                 tw.WaveRNNConfig(**SMALL), ExperimentConfig(), [f],
                                 SpeakerConf(70.0, 400.0, -25.0), str(tmp_path / "t"),
                                 device="cpu", **kw)
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, equal_nan=True,
                                   err_msg=k)
    assert np.isfinite(got["mcd"]) and np.isfinite(got["uv_agree"])
    assert os.listdir(tmp_path / "t") == ["e0.wav"]
    assert tv.eval_copy_synthesis(None, None, ExperimentConfig(), [], None,
                                  str(tmp_path / "none"), device="cpu") == {}


def test_cudnn_recurrence_is_the_plain_loop(monkeypatch):
    """The call the card makes (one ``torch._VF.gru`` over concat(embed[prev],
    cond)) computes the plain loop's hidden states: here through torch's own
    GRU on the CPU, with cuDNN's presence faked."""
    cfg = tw.WaveRNNConfig(**SMALL)
    params = wavernn_params_from_jax(_jax_init(3), device="cpu")
    g = torch.Generator().manual_seed(0)
    cond = torch.randn((3, 70, cfg.cond_dim), generator=g)
    prev = torch.randint(0, cfg.n_classes, (3, 70), generator=g)
    h0 = torch.randn((3, cfg.hidden_units), generator=g)
    want = tw.plain_recurrence(params, cfg, cond, prev, h0)
    monkeypatch.setattr(torch.backends.cudnn, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuDNN"):
        tw.cudnn_recurrence(params, cfg, cond, prev, h0)
    monkeypatch.setattr(torch.backends.cudnn, "is_available", lambda: True)
    got = tw.cudnn_recurrence(params, cfg, cond, prev, h0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    logits, h_T = tw.teacher_forced_logits(params, cfg, cond, prev, h0)
    np.testing.assert_array_equal(h_T.numpy(), want[:, -1].numpy())
