"""The port's neural-vocoder synthesis (``cyclevae_tpu_torch.pipeline.
vocoder_stage``) against the JAX package's, and a vocoder checkpoint written
by the JAX package's trainer read and rendered by the port without JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models import wavernn as jw
from cyclevae_tpu.pipeline import vocoder_stage as jv
from cyclevae_tpu_torch.interop import wavernn_params_from_jax
from cyclevae_tpu_torch.models import wavernn as tw
from cyclevae_tpu_torch.pipeline import vocoder_stage as tv

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

# the recipe's feature layout and fractional hop, at a small width
SMALL = dict(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=32, fc_dim=16,
             feat_dim=54, hop=110.25)


def _params(n_spk, seed=0):
    kw = dict(SMALL, n_spk=n_spk)
    params = jax.tree_util.tree_map(
        np.asarray, jw.init_wavernn(jax.random.PRNGKey(seed), jw.WaveRNNConfig(**kw)))
    rng = np.random.default_rng(seed)
    params["gru"]["b_ih"] = (0.5 * rng.normal(size=params["gru"]["b_ih"].shape)).astype(np.float32)
    params["fc1"]["b"] = (0.1 * rng.normal(size=params["fc1"]["b"].shape)).astype(np.float32)
    return jw.WaveRNNConfig(**kw), params, tw.WaveRNNConfig(**kw)


def _feats(rng, F):
    f = rng.normal(size=(F, 54)).astype(np.float32) * 0.5
    f[:, 0] = (np.arange(F) % 5 > 1)
    f[:, 1] += 5.0
    return f


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n_spk", [0, 2])
def test_synthesize_vocoder_greedy_matches_jax(n_spk, use_pallas):
    """Greedy: the same mu-law indices as the JAX package's plain path
    (``use_pallas=False``), so the waveforms agree to mu-law decoding's
    float32 rounding (atol 1e-6).  On the CPU, ``use_pallas`` runs the
    kernel's plain version."""
    jcfg, params, tcfg = _params(n_spk, seed=n_spk)
    feats = _feats(np.random.default_rng(n_spk), 7)
    spk = 1 if n_spk else None
    want = jv.synthesize_vocoder(jax.tree_util.tree_map(jnp.asarray, params), jcfg, feats,
                                 seed=3, temperature=0.0, use_pallas=False, spk_id=spk)
    got = tv.synthesize_vocoder(wavernn_params_from_jax(params, device="cpu"), tcfg, feats,
                                seed=3, temperature=0.0, use_pallas=use_pallas, spk_id=spk,
                                device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (tw.n_samples_for(tcfg, 7),)
    np.testing.assert_array_equal(np.asarray(jw.mulaw_encode(jnp.asarray(got), 64)),
                                  np.asarray(jw.mulaw_encode(jnp.asarray(want), 64)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert len(np.unique(got)) > 1


def test_multispeaker_vocoder_needs_speaker():
    _, params, tcfg = _params(2)
    with pytest.raises(ValueError):
        tv.synthesize_vocoder(wavernn_params_from_jax(params, device="cpu"), tcfg,
                              _feats(np.random.default_rng(0), 3), device="cpu")


@pytest.mark.parametrize("voicing", ["island", "all_unvoiced", "all_voiced"])
def test_converted_conditioning_matches_jax(voicing):
    rng = np.random.default_rng(0)
    T, n_codeap, mcep_dim1 = 80, 2, 50
    src_feat = rng.normal(size=(T, 2 + n_codeap + mcep_dim1)).astype(np.float32)
    cvmcep = rng.normal(size=(T, mcep_dim1)).astype(np.float32)
    cvf0 = np.zeros(T)
    if voicing == "island":
        cvf0[10:40] = 180.0 + 20 * np.sin(np.arange(30) / 5.0)
    elif voicing == "all_voiced":
        cvf0[:] = 120.0 + 30 * np.cos(np.arange(T) / 7.0)
    want = jv.converted_conditioning(src_feat, cvmcep, cvf0, shiftms=5.0)
    got = tv.converted_conditioning(src_feat, cvmcep, cvf0, shiftms=5.0)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_f0_helpers_match_jax():
    from cyclevae_tpu.pipeline import features as jf
    from cyclevae_tpu_torch.pipeline import features as tf

    f0 = np.zeros(60)
    f0[7:50] = 150.0 + 10 * np.sin(np.arange(43) / 3.0)
    f0[20:24] = 0.0
    for a, b in zip(tf.convert_continuos_f0(f0), jf.convert_continuos_f0(f0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf.convert_f0(f0, 5.0, 0.2, 5.4, 0.25),
                                  jf.convert_f0(f0, 5.0, 0.2, 5.4, 0.25))


READER = """
import sys
for m in ("jax", "jaxlib", "optax", "cyclevae_tpu", "h5py"):
    sys.modules[m] = None
import numpy as np
from cyclevae_tpu_torch.interop import wavernn_params_from_jax
from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig
from cyclevae_tpu_torch.pipeline.vocoder_stage import synthesize_vocoder
from cyclevae_tpu_torch.vi.checkpoint import latest_checkpoint, load_checkpoint

ckpt_dir, data_path = sys.argv[1], sys.argv[2]
path = latest_checkpoint(ckpt_dir)
assert path.endswith("checkpoint-latest.pkl"), path
ckpt = load_checkpoint(path)
assert ckpt["epoch"] == 2, ckpt["epoch"]
params = wavernn_params_from_jax(ckpt["params"], device="cpu")
data = np.load(data_path)
cfg = WaveRNNConfig(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=32, fc_dim=16,
                    feat_dim=10, hop=20)
for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
    np.testing.assert_array_equal(params["gru"][name].numpy(), data["gru_" + name])
for use_pallas in (True, False):
    y = synthesize_vocoder(params, cfg, data["feats"], seed=5, temperature=0.0,
                           use_pallas=use_pallas, device="cpu")
    np.testing.assert_allclose(y, data["want"], atol=1e-6)
print("ok", len(y))
"""


def test_jax_vocoder_checkpoint_renders_in_the_port_without_jax(tmp_path):
    """A checkpoint written by the JAX package's ``run_train_vocoder`` loads
    through the port's ``load_checkpoint`` in a process where jax, optax,
    cyclevae_tpu and h5py cannot be imported, and renders the same greedy
    waveform as the JAX package renders from it."""
    from cyclevae_tpu.utils.hdf5 import write_hdf5
    from cyclevae_tpu.utils.wavio import write_wav
    from cyclevae_tpu.vi.checkpoint import load_checkpoint

    cfg = jw.WaveRNNConfig(n_classes=64, embed_dim=16, cond_dim=16, hidden_units=32,
                           fc_dim=16, feat_dim=10, hop=20)
    rng = np.random.default_rng(0)
    wavs, h5s = [], []
    for i in range(2):
        F = 24 + 4 * i
        x = 8000.0 * np.sin(2 * np.pi * np.arange(F * 20) / (30.0 + i))
        wavs.append(str(tmp_path / f"u{i}.wav"))
        write_wav(wavs[-1], 22050, x)
        h5s.append(str(tmp_path / f"u{i}.h5"))
        write_hdf5(h5s[-1], "/feat_org_lf0", rng.normal(size=(F, cfg.feat_dim)))
    ckpt_dir = tmp_path / "voc"
    jv.run_train_vocoder(cfg, wavs, h5s, str(ckpt_dir), epochs=2, batch_size=2,
                         clip_frames=8, ckpt_every=1)

    params = load_checkpoint(str(ckpt_dir / "checkpoint-latest.pkl"))["params"]
    feats = rng.normal(size=(6, cfg.feat_dim)).astype(np.float32)
    want = jv.synthesize_vocoder(jax.tree_util.tree_map(jnp.asarray, params), cfg, feats,
                                 seed=5, temperature=0.0, use_pallas=False)
    np.savez(tmp_path / "data.npz", feats=feats, want=want,
             **{"gru_" + k: np.asarray(v) for k, v in params["gru"].items()})

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", READER, str(ckpt_dir), str(tmp_path / "data.npz")],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok", str(len(want))]
