"""The port's stage-6 conversion engine (``Codec``, ``device_decode_pair``)
against the JAX package's, on the same params, features and noise (CPU), and
the rules of the port: no JAX import, no silent CPU fallback."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.pipeline import decode as jd
from cyclevae_tpu.pipeline.train_stage import model_config as jax_model_config
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import CycleVAEParams as JaxParams
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.interop import params_from_jax, params_to_jax
from cyclevae_tpu_torch.pipeline import decode as td
from cyclevae_tpu_torch.pipeline.train_stage import model_config
from cyclevae_tpu_torch.utils.config import ExperimentConfig, load_config
from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N_SMPL, BUCKET, LENS = 8, 16, (23, 37)


def _codecs(use_pallas=True, seed=0):
    kw = dict(hidden_units=32, use_pallas=use_pallas)
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=54).astype(np.float32)
    scale = (0.5 + rng.random(54)).astype(np.float32)
    jp = jax_init(jax.random.PRNGKey(seed), JaxConfig(**kw), mean, scale)
    jc = jd.Codec(jp, JaxConfig(**kw), n_smpl_dec=N_SMPL, bucket=BUCKET)
    tc = td.Codec(params_from_jax(jp, device="cpu"), CycleVAEConfig(**kw),
                  n_smpl_dec=N_SMPL, bucket=BUCKET, device="cpu")
    feats = [(mean + scale * rng.normal(size=(n, 54))).astype(np.float32) for n in LENS]
    eps = rng.normal(size=(N_SMPL, 2, max(LENS), 32)).astype(np.float32)
    return jc, tc, feats, eps


def _jax_mean_of_draws(lat: np.ndarray, eps: np.ndarray) -> np.ndarray:
    # the JAX sampler's formula with the injected noise
    return np.asarray(jnp.mean(lat[..., :32] + jnp.exp(lat[..., 32:] / 2.0) * eps, axis=0))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_codec_matches_jax(use_pallas):
    jc, tc, feats, eps = _codecs(use_pallas)
    lat_j, _ = jc.encode_mean(jax.random.PRNGKey(0), feats)
    lat_t, z_t = tc.encode_mean(None, feats, eps=eps)
    for i, n in enumerate(LENS):
        assert lat_t[i].shape == (n, 64) and z_t[i].shape == (n, 32)
        # float32 AR scans over <= 48 frames: the JAX package's scan tolerance
        np.testing.assert_allclose(lat_t[i], lat_j[i], atol=2e-5)
        np.testing.assert_allclose(z_t[i], _jax_mean_of_draws(lat_j[i], eps[:, i, :n]),
                                   atol=2e-5)
    # all three decode directions on the same z
    z = [_jax_mean_of_draws(lat_j[i], eps[:, i, :n]) for i, n in enumerate(LENS)]
    pairs = [(td._speaker_codes(LENS[0], 2, 1), z[0]),
             (td._speaker_codes(LENS[0], 2, 0), z[0]),
             (td._speaker_codes(LENS[1], 2, 1), z[1])]
    want = jc.decode_batch(pairs)
    got = tc.decode_batch(pairs)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        # outputs un-normalized by scale_out (scales up to 1.5)
        np.testing.assert_allclose(g, w, atol=3e-5)
    # the single-utterance API rides the same device functions
    np.testing.assert_allclose(tc.encode(feats[0]), lat_j[0], atol=2e-5)
    np.testing.assert_allclose(tc.decode(*pairs[2]), want[2], atol=3e-5)
    np.testing.assert_allclose(tc.latent_mean(None, lat_j[1], eps=eps[:, 1]), z[1],
                               atol=2e-5)


def test_device_decode_pair_matches_jax():
    jc, tc, feats, eps = _codecs()
    got = td.device_decode_pair(tc, None, feats[0], feats[1], eps=eps)
    lat_j, _ = jc.encode_mean(jax.random.PRNGKey(0), feats)
    z = [_jax_mean_of_draws(lat_j[i], eps[:, i, :n]) for i, n in enumerate(LENS)]
    T, Tt = LENS
    want = list(lat_j) + jc.decode_batch([
        (jd._speaker_codes(T, 2, 1), z[0]),
        (jd._speaker_codes(T, 2, 0), z[0]),
        (jd._speaker_codes(Tt, 2, 1), z[1])])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-5)


def test_codec_generator_path_is_seeded_and_unbiased():
    """The port's own draws: a seeded generator repeats itself, and the
    posterior mean from many draws sits within MC error of mu."""
    jc, tc, feats, _ = _codecs()
    a = td.device_decode_pair(tc, torch.Generator().manual_seed(1), *feats)
    b = td.device_decode_pair(tc, torch.Generator().manual_seed(1), *feats)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    n = 4000
    big = td.Codec(tc.params, tc.cfg, n_smpl_dec=n, bucket=BUCKET, device="cpu")
    lat = tc.encode(feats[0])
    z = big.latent_mean(torch.Generator().manual_seed(2), lat)
    sd = np.exp(lat[:, 32:] / 2.0)
    assert np.all(np.abs(z - lat[:, :32]) < 5 * sd / np.sqrt(n))


def test_interpolation_and_gv_postfilter_match_jax():
    jc, tc, feats, _ = _codecs()
    np.testing.assert_array_equal(td.speaker_interp_code(5, 2, [0.3, 0.7]),
                                  jd.speaker_interp_code(5, 2, [0.3, 0.7]))
    out = td.decode_interpolated(tc, torch.Generator().manual_seed(0), feats[0], [0.5, 0.5])
    assert out.shape == (LENS[0], 50) and np.isfinite(out).all()
    rng = np.random.default_rng(3)
    mc, gv_d, gv_m = rng.normal(size=(20, 50)), rng.random(49) + 0.1, rng.random(49) + 0.1
    np.testing.assert_array_equal(td.gv_postfilter(mc, gv_d, gv_m),
                                  jd.gv_postfilter(mc, gv_d, gv_m))


def test_params_round_trip_and_model_config(tmp_path):
    cfg = JaxConfig(hidden_units=16)
    jp = jax_init(jax.random.PRNGKey(0), cfg)
    back = JaxParams(*params_to_jax(params_from_jax(jp, device="cpu")))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # model.json written by the JAX package reads back into the same config
    from cyclevae_tpu.utils.config import save_config
    exp = JaxExperiment()
    exp.model.hidden_units, exp.model.use_pallas = 64, True
    save_config(exp, str(tmp_path / "model.json"))
    mine = model_config(load_config(str(tmp_path / "model.json")))
    assert dataclasses.asdict(mine) == dataclasses.asdict(jax_model_config(exp))
    assert isinstance(load_config(str(tmp_path / "model.json")), ExperimentConfig)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc, _, _ = _codecs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.Codec(tc.params, tc.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cyclevae(torch.Generator(), CycleVAEConfig(hidden_units=8))
    assert init_cyclevae(torch.Generator(), CycleVAEConfig(hidden_units=8),
                         device="cpu").encoder["out"]["w"].device.type == "cpu"


def test_package_imports_without_jax():
    """Every module of the port imports with jax, optax, cyclevae_tpu and
    h5py blocked, the vocoder slice's, the host DSP's, the recipe's (the
    feature store, stats, train stage, recipe and the CLI module, which runs
    nothing on import), stages i and v's (the samplers, the inference
    stage, the vocoder's dataset and trainer), and the model variants' (the
    many-to-many recipe, its trainer and decode, the classifier and VQ
    trainers, the VQ helpers, the GMM) among them; one HMC step, one vocoder
    train step, one classifier step, one VQ step and one EM step run there."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'optax', 'cyclevae_tpu', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "import cyclevae_tpu_torch\n"
        "for mod in pkgutil.walk_packages(cyclevae_tpu_torch.__path__, 'cyclevae_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and (\n"
        "    m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'cyclevae_tpu', 'h5py'))]\n"
        "assert not loaded, loaded\n"
        "for m in ('models.wavernn', 'ops.cuda_wavernn', 'pipeline.vocoder_stage',\n"
        "          'pipeline.features', 'pipeline.decode', 'utils.wavio', 'interop',\n"
        "          'dsp', 'dsp._lib', 'dsp.sptk', 'dsp.world', 'dsp.dtw', 'dsp.mlpg',\n"
        "          'dsp.torch_ops', 'utils.store', 'utils.prefetch', 'pipeline.stats',\n"
        "          'pipeline.summary', 'pipeline.train_stage', 'pipeline.recipe', '__main__',\n"
        "          'infer', 'infer.draws', 'infer.dual_averaging', 'infer.logjoint', 'infer.hmc',\n"
        "          'infer.nuts', 'infer.nuts_batch', 'infer.smc', 'pipeline.infer_stage',\n"
        "          'pipeline.dataset_mult', 'pipeline.train_stage_mult', 'pipeline.decode_mult',\n"
        "          'pipeline.recipe_mult', 'pipeline.train_stage_cls', 'pipeline.train_stage_vq',\n"
        "          'models.vq', 'models.gmm'):\n"
        "    assert 'cyclevae_tpu_torch.' + m in sys.modules, m\n"
        "import numpy as np\n"
        "from cyclevae_tpu_torch.dsp import sptk\n"
        "assert sptk.mc2sp(np.zeros((1, 25)), 0.455, 64).shape == (1, 33)\n"
        "import os, tempfile\n"
        "from cyclevae_tpu_torch.utils.store import read_store, write_store\n"
        "path = os.path.join(tempfile.mkdtemp(), 's.npz')\n"
        "write_store(path, '/lf0_range_mean', np.float64(4.5))\n"
        "assert float(read_store(path, '/lf0_range_mean')) == 4.5\n"
        "import torch\n"
        "from cyclevae_tpu_torch.infer import Draws, HMCConfig, hmc_sample_batch\n"
        "from cyclevae_tpu_torch.infer.logjoint import make_utterance_logjoint_batched\n"
        "from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae\n"
        "cfg = CycleVAEConfig(hidden_units=8, lat_dim=4)\n"
        "params = init_cyclevae(torch.Generator().manual_seed(0), cfg, device='cpu')\n"
        "lj = make_utterance_logjoint_batched(params, cfg, torch.randn(6, 54),\n"
        "                                     torch.eye(2)[[0] * 6], obs_scale=50.0)\n"
        "s, info = hmc_sample_batch(Draws(torch.Generator().manual_seed(1)), lj,\n"
        "                           torch.zeros(2, 6, 4), HMCConfig(0.05, 2, 0, 1))\n"
        "assert s.shape == (1, 2, 6, 4) and torch.isfinite(s).all()\n"
        "from cyclevae_tpu_torch.models.gru_vae import init_gru_rnn\n"
        "from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig\n"
        "from cyclevae_tpu_torch.pipeline.vocoder_stage import run_train_vocoder\n"
        "from cyclevae_tpu_torch.utils.wavio import write_wav\n"
        "d = tempfile.mkdtemp()\n"
        "write_wav(os.path.join(d, 'u.wav'), 22050, 3000 * np.sin(np.arange(1200) * 0.1))\n"
        "write_store(os.path.join(d, 'u.npz'), '/feat_org_lf0', np.ones((12, 54), np.float32))\n"
        "vcfg = WaveRNNConfig(n_classes=16, embed_dim=4, cond_dim=4, hidden_units=8, fc_dim=4)\n"
        "res = run_train_vocoder(vcfg, [os.path.join(d, 'u.wav')], [os.path.join(d, 'u.npz')],\n"
        "                        os.path.join(d, 'voc'), epochs=1, batch_size=1, clip_frames=4,\n"
        "                        device='cpu')\n"
        "assert np.isfinite(res['history'][0]['nll'])\n"
        "from cyclevae_tpu_torch.models.gmm import gmm_em_update, init_gmm\n"
        "from cyclevae_tpu_torch.pipeline import train_stage_cls, train_stage_vq\n"
        "from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig\n"
        "from cyclevae_tpu_torch.vi.train import _leaves\n"
        "exp = ExperimentConfig(model=ModelConfig(hidden_units=8, lat_dim=4, do_prob=0.0))\n"
        "ccfg = train_stage_cls.classifier_config(exp, 3)\n"
        "cp = init_gru_rnn(torch.Generator().manual_seed(0), ccfg)\n"
        "cl = _leaves(cp)\n"
        "[t.requires_grad_(True) for t in cl]\n"
        "m = train_stage_cls.make_classifier_step(ccfg)(cp, torch.optim.Adam(cl), {\n"
        "    'feats': np.ones((2, 6, 54), np.float32), 'cls': np.zeros((2, 6), np.int32),\n"
        "    'mask': np.ones((2, 6), np.float32)})\n"
        "assert np.isfinite(float(m['loss']))\n"
        "enc, dec = train_stage_vq.make_vq_cfgs(exp)\n"
        "vp = train_stage_vq.init_vq(torch.Generator().manual_seed(0), enc, dec, 8,\n"
        "                            np.zeros(54), np.ones(54), 4, 'cpu')\n"
        "vl = train_stage_vq.vq_trainable(vp)\n"
        "[t.requires_grad_(True) for t in vl]\n"
        "b = {'feats': np.ones((2, 6, 54), np.float32), 'src_code': np.ones((2, 6, 2), np.float32),\n"
        "     'trg_code': np.ones((2, 6, 2), np.float32), 'cv_excit': np.ones((2, 6, 4), np.float32),\n"
        "     'mask': np.ones((2, 6), np.float32)}\n"
        "m = train_stage_vq.make_vq_step(enc, dec, 4, 8)(vp, torch.optim.Adam(vl), b)\n"
        "assert np.isfinite(float(m['loss']))\n"
        "g = init_gmm(torch.Generator().manual_seed(0), 2, 3, torch.randn(10, 3))\n"
        "assert np.isfinite(float(gmm_em_update(g, torch.randn(10, 3))[1]))\n"
        "print('imported', len([m for m in sys.modules if m.startswith('cyclevae_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_port_sources_name_no_jax_module():
    pkg = ROOT / "cyclevae_tpu_torch"
    files = [p for p in pkg.rglob("*.py") if "build" not in p.relative_to(pkg).parts]
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                root = mod.split(".")[0]
                assert root not in ("jax", "jaxlib", "optax", "cyclevae_tpu"), (path, line)
