"""The port's speaker-classifier trainer (``pipeline/train_stage_cls.py``)
against the JAX package's, on the CPU at a small size (hu16, n_spk 3): the
collated batch bitwise equal, one step at do_prob 0 with plain SGD (so the
update is the gradient itself) on both the kernel route and the plain path,
and ``run_train_cls`` end to end beside the JAX trainer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cyclevae_tpu.models.gru_vae import init_gru_rnn as jax_init_gru_rnn
from cyclevae_tpu.pipeline import dataset_mult as jdm
from cyclevae_tpu.pipeline import stats as jstats
from cyclevae_tpu.pipeline import train_stage_cls as jtc
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.config import ModelConfig as JaxModelConfig
from cyclevae_tpu.utils.config import TrainConfig as JaxTrainConfig
from cyclevae_tpu_torch.pipeline import dataset_mult as tdm
from cyclevae_tpu_torch.pipeline import stats as tstats
from cyclevae_tpu_torch.pipeline import train_stage_cls as ttc
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
from cyclevae_tpu_torch.utils.store import read_store
from cyclevae_tpu_torch.utils.tree import tree_map
from cyclevae_tpu_torch.vi.train import _leaves

from test_torch_mult import ALL, SRC, TRG, _train_files, mult_stores  # noqa: F401  (fixture)
from test_torch_train import _walk

torch.set_num_threads(1)

LR = 1e-3


def _batch(stores, side):
    mod, col = (tdm, ttc._collate_cls) if side == "port" else (jdm, jtc._collate_cls)
    ds = mod.MultSpkTrainClsDataset(_train_files(stores[side]), SRC, TRG, 1, seed=4)
    return col([ds[i] for i in (2, 6, 3, 8)], 10)


def test_collate_cls_identical(mult_stores):  # noqa: F811
    got, want = _batch(mult_stores, "port"), _batch(mult_stores, "jax")
    assert sorted(got) == sorted(want) == ["cls", "feats", "mask"]
    assert got["feats"].shape == (4, 30, 54)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(np.unique(got["cls"][got["mask"] > 0])) == {0, 1, 2}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_classifier_step_matches_jax(mult_stores, use_pallas):  # noqa: F811
    model = dict(hidden_units=16, do_prob=0.0)
    cfg_j = jtc.GRURNNConfig(in_dim=54, out_dim=3, hidden_units=16, do_prob=0.0,
                             scale_in=True, scale_out=False)
    cfg_t = ttc.classifier_config(ExperimentConfig(model=ModelConfig(**model)), 3)
    assert (cfg_t.out_dim, cfg_t.scale_in, cfg_t.scale_out) == (3, True, False)
    rng = np.random.default_rng(0)
    jp = jax_init_gru_rnn(jax.random.PRNGKey(0), cfg_j)
    jp["scale_in"] = {"mean": jnp.asarray(rng.normal(size=54) * 0.3, jnp.float32),
                      "scale": jnp.asarray(0.5 + rng.random(54), jnp.float32)}
    before = _walk(jp, np.asarray)
    opt_j = optax.sgd(LR)
    jp2, _, _, met_j = jtc.make_classifier_step(cfg_j, opt_j)(
        jp, opt_j.init(jp), jax.random.PRNGKey(1),
        {k: jnp.asarray(v) for k, v in _batch(mult_stores, "jax").items()})

    tp = tree_map(lambda a: torch.tensor(np.asarray(a)), jp)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    met_t = ttc.make_classifier_step(cfg_t, use_pallas)(
        tp, torch.optim.SGD(leaves, lr=LR), _batch(mult_stores, "port"))
    assert sorted(met_t) == sorted(met_j) == ["acc", "loss"]
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) <= 1e-5 * abs(float(met_j["loss"]))
    assert float(met_t["acc"]) == pytest.approx(float(met_j["acc"]), abs=1e-7)
    # every tensor updated, the input scaler too (the JAX trainer's adam over
    # all leaves): within 1e-5 of its scale, the update within 2e-4 of its own
    for a, b, p0 in zip(_walk(tp, lambda t: t.detach().numpy()), _walk(jp2, np.asarray), before):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(float(np.max(np.abs(b))), 1e-3))
        g_t, g_j = (p0 - a) / LR, (p0 - b) / LR
        np.testing.assert_allclose(g_t, g_j, atol=2e-4 * max(float(np.max(np.abs(g_j))), 1e-3))
    assert not np.array_equal(tp["scale_in"]["mean"].detach().numpy(), before[-2])


def test_run_train_cls_end_to_end(mult_stores, tmp_path):  # noqa: F811
    """Both trainers, 2 epochs each on the same corpus: the same history
    layout, finite losses, frame accuracies in [0, 1], the same number of
    eval frames, and the port's input scaler trained as the JAX one's."""
    model = dict(hidden_units=16, do_prob=0.5)
    tkw = dict(batch_size=10, batch_size_utt=4, epoch_count=2, lr=1e-3, seed=2)
    res = {}
    for side, mod, st, exp, dev in (
            ("jax", jtc, jstats, JaxExperiment(model=JaxModelConfig(**model),
                                               train=JaxTrainConfig(**tkw)), {}),
            ("port", ttc, tstats, ExperimentConfig(model=ModelConfig(**model),
                                                   train=TrainConfig(**tkw)), {"device": "cpu"})):
        p = mult_stores[side]
        stats = str(tmp_path / f"jnt_{side}.{'h5' if side == 'jax' else 'npz'}")
        st.calc_stats_joint(_train_files(p), [], stats)
        res[side] = mod.run_train_cls(exp, _train_files(p), [p.h5s(s, True) for s in SRC],
                                      [p.h5s(s, True) for s in TRG], SRC, TRG, stats,
                                      str(tmp_path / side), **dev)
    h_t, h_j = res["port"]["history"], res["jax"]["history"]
    assert [h["epoch"] for h in h_t] == [h["epoch"] for h in h_j] == [1, 2]
    for a, b in zip(h_t, h_j):
        assert sorted(a) == sorted(b) and sorted(a["train"]) == sorted(b["train"])
        assert np.isfinite(a["train"]["loss"]) and 0.0 <= a["eval_acc"] <= 1.0
        assert 0.0 <= a["train"]["acc"] <= 1.0
    assert (tmp_path / "port" / "history_cls.json").exists()
    mean = read_store(str(tmp_path / "jnt_port.npz"), "/mean_feat_org_lf0_jnt")
    for side in ("port", "jax"):
        got = np.asarray(res[side]["params"]["scale_in"]["mean"].detach()
                         if side == "port" else res[side]["params"]["scale_in"]["mean"])
        assert not np.allclose(got, mean.astype(np.float32), atol=1e-6, rtol=0), side
    assert res["port"]["cfg"].out_dim == len(ALL)
