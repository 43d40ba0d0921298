"""The port's posterior-inference stage (``pipeline/infer_stage.py``) against
the JAX package's on the CPU: the shapes and diagnostics of
``tests/test_infer_stage.py``, the posterior predictive decode, the whole
HMC posterior conversion with JAX's draws replayed, and the store file that
``run_infer_stage`` writes."""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.infer.hmc import HMCConfig as JaxHMCConfig
from cyclevae_tpu.pipeline import infer_stage as jis
from cyclevae_tpu.utils.hdf5 import read_hdf5, write_hdf5
from cyclevae_tpu.vi.train import CycleVAEConfig as JaxConfig
from cyclevae_tpu.vi.train import init_cyclevae as jax_init
from cyclevae_tpu_torch.infer import Draws, HMCConfig
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.pipeline import infer_stage as tis
from cyclevae_tpu_torch.utils.store import read_store, write_store
from cyclevae_tpu_torch.vi.train import CycleVAEConfig

from test_torch_infer import JaxHMCDraws

torch.set_num_threads(1)


def _setup():
    """``tests/test_infer_stage.py``'s model and utterance, in both packages."""
    jcfg = JaxConfig(hidden_units=16, lat_dim=4)
    jp = jax_init(jax.random.PRNGKey(0), jcfg, np.zeros(54, np.float32), np.ones(54, np.float32))
    feats = np.random.default_rng(0).normal(size=(12, 54)).astype(np.float32)
    return jcfg, jp, CycleVAEConfig(hidden_units=16, lat_dim=4), \
        params_from_jax(jp, device="cpu"), feats


def test_posterior_convert_hmc_shapes_and_diagnostics():
    _, _, cfg, params, feats = _setup()
    r = tis.posterior_convert_hmc(
        params, cfg, feats, 0, 1, Draws(torch.Generator().manual_seed(1)), n_chains=2,
        hmc=HMCConfig(step_size=0.05, n_leapfrog=4, n_warmup=5, n_samples=10), n_predictive=4)
    assert r["z_mean"].shape == (12, 4) and r["z_std"].shape == (12, 4)
    assert r["cv_mcep_mean"].shape == (12, 50)
    assert np.all(r["cv_mcep_std"] >= 0) and np.all(r["z_std"] >= 0)
    assert 0.0 <= r["accept_prob"] <= 1.0 and r["step_size"] > 0
    assert np.isfinite(r["cv_mcep_mean"]).all()


def test_posterior_marginal_smc_evidence():
    _, _, cfg, params, feats = _setup()
    m = tis.posterior_marginal_smc(params, cfg, feats, 0,
                                   Draws(torch.Generator().manual_seed(2)), n_particles=64)
    assert np.isfinite(m["log_marginal"])
    assert 0.0 < m["mean_ess"] <= 64.0 and 0.0 <= m["resample_rate"] <= 1.0


def test_decode_batch_matches_jax():
    """The posterior predictive decode (K1's plain version on the CPU)."""
    jcfg, jp, cfg, params, _ = _setup()
    z = np.random.default_rng(3).normal(size=(5, 12, 4)).astype(np.float32)
    code = np.zeros((12, 2), np.float32)
    code[:, 1] = 1
    want = np.asarray(jis._decode_batch(jp, jcfg, jnp.asarray(code), jnp.asarray(z)))
    got = tis._decode_batch(params, cfg, torch.as_tensor(code), torch.as_tensor(z))
    assert got.shape == (5, 12, 50)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_posterior_convert_hmc_replays_jax():
    """The whole posterior conversion with JAX's HMC draws replayed (its
    run key is split(key)[1]): the posterior and predictive statistics."""
    jcfg, jp, cfg, params, feats = _setup()
    kw = dict(n_chains=3, n_predictive=4, obs_scale=50.0)
    hcfg = (0.02, 4, 4, 5)
    key = jax.random.PRNGKey(4)
    want = jis.posterior_convert_hmc(jp, jcfg, feats, 0, 1, key, hmc=JaxHMCConfig(*hcfg), **kw)
    got = tis.posterior_convert_hmc(params, cfg, feats, 0, 1,
                                    JaxHMCDraws(jax.random.split(key)[1], 9),
                                    hmc=HMCConfig(*hcfg), **kw)
    for k in ("z_mean", "cv_mcep_mean"):
        assert got[k].shape == want[k].shape
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel < 1e-4, (k, rel)
    for k in ("z_std", "cv_mcep_std"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    for k in ("accept_prob", "step_size"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_run_infer_stage_writes_the_store(tmp_path):
    """Per utterance basename the four statistics, the same datasets as the
    JAX stage writes to its ``.h5``."""
    jcfg, jp, cfg, params, feats = _setup()
    kw = dict(n_chains=2, n_predictive=3, hmc=None)
    files = []
    for i, T in enumerate((12, 9)):
        f = feats[:T] + i
        write_store(str(tmp_path / f"e{i}.npz"), "/feat_org_lf0", f)
        write_hdf5(str(tmp_path / f"e{i}.h5"), "/feat_org_lf0", f)
        files.append(T)
    hcfg = (0.05, 2, 2, 3)
    kw["hmc"] = HMCConfig(*hcfg)
    res = tis.run_infer_stage(params, cfg, [str(tmp_path / f"e{i}.npz") for i in range(2)],
                              str(tmp_path / "posterior_ep1.npz"), **kw)
    kw["hmc"] = JaxHMCConfig(*hcfg)
    jres = jis.run_infer_stage(jp, jcfg, [str(tmp_path / f"e{i}.h5") for i in range(2)],
                               str(tmp_path / "posterior_ep1.h5"), **kw)
    assert sorted(res) == sorted(jres) == ["e0", "e1"]
    with np.load(tmp_path / "posterior_ep1.npz") as z:
        assert sorted(z.files) == sorted(f"e{i}/{k}" for i in range(2) for k in (
            "z_mean", "z_std", "cv_mcep_mean", "cv_mcep_std"))
    for i, T in enumerate(files):
        for k, dim in (("z_mean", 4), ("z_std", 4), ("cv_mcep_mean", 50), ("cv_mcep_std", 50)):
            got = read_store(str(tmp_path / "posterior_ep1.npz"), f"/e{i}/{k}")
            want = read_hdf5(str(tmp_path / "posterior_ep1.h5"), f"/e{i}/{k}")
            assert got.shape == want.shape == (T, dim) and got.dtype == want.dtype
            assert np.isfinite(got).all()
        assert 0.0 <= res[f"e{i}"]["accept_prob"] <= 1.0
    assert os.path.getsize(tmp_path / "posterior_ep1.npz") > 0
