"""A training run of the JAX package resumed in the port: the JAX
package's ``save_checkpoint`` (parameters, optax's Adam or AdamW state under
``multi_transform``, the JAX key, the numpy generator, the epoch) restored by
the port's ``restore_train_state``, then one more train step on each side on
the same replayed draws; and ``run_train(resume=<JAX checkpoint>)``
continuing the JAX run's epoch order.

The JAX step after the restore runs jitted on a one-segment batch, so its
draws are taken once, at trace time, in program order: the recorder of
``tests/test_torch_train.py`` records them there and the port replays them.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cyclevae_tpu.models.gru_vae as jgv
import cyclevae_tpu.vi.train as jtrain
from cyclevae_tpu.pipeline import train_stage as jts
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.config import ModelConfig as JaxModelConfig
from cyclevae_tpu.utils.config import TrainConfig as JaxTrainConfig
from cyclevae_tpu.vi.checkpoint import save_checkpoint as jax_save_checkpoint
from cyclevae_tpu_torch.pipeline import train_stage as tts
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
from cyclevae_tpu_torch.vi import train as ttrain
from cyclevae_tpu_torch.vi.checkpoint import (jax_key_seed, load_checkpoint, opt_state_from_jax,
                                              restore_np_rng, restore_train_state)

from test_torch_train import Recorder, Replay, _assert_grads_close, _setup, _walk
from test_torch_train_stage import _Stub, _train_kwargs, stores  # noqa: F401  (fixture)

torch.set_num_threads(1)

LR, SEG = 1e-3, 10


def _batch(seed, T=SEG):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[None, :, None]
    feats = (np.sin(t * 0.07 + np.arange(54)[None, None]) + 0.3 * rng.normal(size=(2, T, 54)))
    feats = feats.astype(np.float32)
    code = np.zeros((2, T, 2), np.float32)
    return {"feats": feats, "src_code": code + [1, 0], "trg_code": code + [0, 1],
            "cv_excit": feats[..., :4].copy(), "flens": np.array([T, T - 3], np.int32)}


def _jax_adam(opt_state):
    """optax's ScaleByAdamState under multi_transform (and adamw's chain)."""
    return opt_state.inner_states["train"].inner_state[0]


def _trainable(net):
    return {k: v for k, v in net.items() if k not in ("scale_in", "scale_out")}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch, weight_decay):
    jc, tc, jp = _setup(use_pallas=True, seed=3)
    opt_j = jtrain.make_optimizer(jc, lr=LR, weight_decay=weight_decay)
    ts_j = jtrain.TrainState(jp, opt_j.init(jp), jax.random.PRNGKey(5), jnp.zeros((), jnp.int32))
    # two JAX steps with its own draws, then its checkpoint
    step_j = jtrain.make_train_step(jc, opt_j, SEG, 1)
    for s in (1, 2):
        ts_j, _ = step_j(ts_j, {k: jnp.asarray(v) for k, v in _batch(s).items()})
    np_rng = np.random.default_rng(7)
    np_rng.permutation(5)
    path = jax_save_checkpoint(str(tmp_path), ts_j.params, ts_j.opt_state, ts_j.rng, np_rng, 2)

    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 2 and "jax_key" in ckpt
    opt_t = ttrain.make_optimizer(tc, lr=LR, weight_decay=weight_decay)
    ts_t = restore_train_state(ckpt, opt_t, device="cpu")
    assert isinstance(ts_t.opt_state, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    assert ts_t.opt_state.state_dict()["param_groups"][0]["lr"] == LR
    assert ts_t.opt_state.state_dict()["param_groups"][0]["weight_decay"] == \
        (weight_decay if weight_decay else 0)
    # the generator seeded from the key's two words; the shuffles restored exactly
    assert ts_t.rng.initial_seed() == jax_key_seed(np.asarray(ts_j.rng))
    assert restore_np_rng(ckpt["np_rng_state"]).permutation(9).tolist() == \
        np_rng.permutation(9).tolist()

    def moments(ts_t, ts_j):
        adam = _jax_adam(ts_j.opt_state)
        for net_t, mu_j, nu_j in zip(ts_t.params, adam.mu, adam.nu):
            leaves = _walk(_trainable(net_t), lambda t: t)
            st = [ts_t.opt_state.state[p] for p in leaves]
            yield ([s["exp_avg"].numpy() for s in st], _walk(_trainable(mu_j), np.asarray),
                   [s["exp_avg_sq"].numpy() for s in st], _walk(_trainable(nu_j), np.asarray),
                   [float(s["step"]) for s in st], int(adam.count))

    # the restore carries everything across: params exact, moments within 1e-6
    for net_t, net_j in zip(ts_t.params, ts_j.params):
        for a, b in zip(_walk(net_t, lambda t: t.detach().numpy()), _walk(net_j, np.asarray)):
            np.testing.assert_array_equal(a, b)
    for mu_t, mu_j, nu_t, nu_j, steps, count in moments(ts_t, ts_j):
        assert steps == [2.0] * len(steps) and count == 2
        for a, b in zip(mu_t + nu_t, mu_j + nu_j):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)

    # one more step on each side, on the same draws
    rec = Recorder(seed=11)
    monkeypatch.setattr(jgv, "_bernoulli_fast", rec.bernoulli)
    monkeypatch.setattr(jtrain, "sampling_vae_batch", rec.sampling)
    batch = _batch(3)
    ts_j, met_j = jtrain.make_train_step(jc, opt_j, SEG, 1)(
        ts_j, {k: jnp.asarray(v) for k, v in batch.items()})
    ts_t, met_t = ttrain.make_train_step(tc, opt_t, SEG, 1)(ts_t, batch, Replay(rec.seq))
    # the ELBO parity bound (tests/test_elbo_parity.py)
    loss_j, loss_t = float(met_j["loss"][0]), float(met_t["loss"][0])
    assert abs(loss_t - loss_j) / abs(loss_j) < 2e-4
    for mu_t, mu_j, nu_t, nu_j, steps, count in moments(ts_t, ts_j):
        assert steps == [3.0] * len(steps) and count == 3
        # 0.9 (or 0.999) x the restored moments plus the new gradient's share
        _assert_grads_close(mu_t, mu_j)
        _assert_grads_close(nu_t, nu_j)
    # params within 2e-4 of each leaf's scale
    _assert_grads_close(
        [a for net in ts_t.params for a in _walk(net, lambda t: t.detach().numpy())],
        [a for net in ts_j.params for a in _walk(net, np.asarray)])


def test_opt_state_from_jax_rejects_other_states():
    _, tc, _ = _setup(use_pallas=True, seed=4)
    params = ttrain.init_cyclevae(torch.Generator().manual_seed(0), tc, device="cpu")
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        opt_state_from_jax({"train": ()}, params, ttrain.make_optimizer(tc))


class _OrderStub(_Stub):
    """The deterministic stand-in step, recording each batch it is given."""

    def __init__(self, cfg, torch_side):
        super().__init__(cfg, torch_side)
        self.batches = []

    def make_train_step(self, cfg, opt, seg_len, n_segs):
        step = super().make_train_step(cfg, opt, seg_len, n_segs)

        def record(ts_, batch):
            self.batches.append(np.asarray(batch["feats"]).copy())
            return step(ts_, batch)
        return record


def test_run_train_resumes_a_jax_run(stores, tmp_path, monkeypatch):  # noqa: F811
    """The JAX run's epoch-2 checkpoint resumed by the port's ``run_train``:
    epoch 3 takes the batches in the JAX run's order, and history.json and
    the checkpoints continue it."""
    kw = dict(hidden_units=8, lat_dim=4, n_cyc=1, spk_src="SPKA", spk_trg="SPKB")
    tkw = dict(batch_size=20, batch_size_utt=3, batch_size_utt_eval=2, epoch_count=2, seed=3)
    cfg = ttrain.CycleVAEConfig(hidden_units=8, n_cyc=1)
    jexp = JaxExperiment(model=JaxModelConfig(**kw), train=JaxTrainConfig(**tkw))
    jstub = _OrderStub(cfg, False)
    monkeypatch.setattr(jts, "make_train_step", jstub.make_train_step)
    monkeypatch.setattr(jts, "make_eval_forward", jstub.make_eval_forward)
    jdir = str(tmp_path / "jax")
    jts.run_train(jexp, expdir=jdir, **_train_kwargs(stores["jax"]))
    ckpt = os.path.join(jdir, "checkpoint-2.pkl")
    pdir = str(tmp_path / "port")       # the port resumes beside the run's history
    os.makedirs(pdir)
    shutil.copy(os.path.join(jdir, "history.json"), pdir)
    # the JAX run continued to epoch 3, for reference
    jexp.train.epoch_count = 3
    jstub.batches = []
    jts.run_train(jexp, expdir=jdir, resume=ckpt, **_train_kwargs(stores["jax"]))

    with open(os.path.join(jdir, "history.json")) as f:
        jhist = json.load(f)
    pexp = ExperimentConfig(model=ModelConfig(**kw), train=TrainConfig(**{**tkw,
                                                                          "epoch_count": 3}))
    pstub = _OrderStub(cfg, True)
    pstub.eval_calls = 4          # the stand-in eval forward at epoch 3, as the JAX one
    monkeypatch.setattr(tts, "make_train_step", pstub.make_train_step)
    monkeypatch.setattr(tts, "make_eval_forward", pstub.make_eval_forward)
    res = tts.run_train(pexp, expdir=pdir, resume=ckpt, device="cpu",
                        **_train_kwargs(stores["port"]))
    assert len(pstub.batches) == len(jstub.batches) == 2
    for a, b in zip(pstub.batches, jstub.batches):
        np.testing.assert_array_equal(a, b)
    with open(os.path.join(pdir, "history.json")) as f:
        phist = json.load(f)
    assert [h["epoch"] for h in phist["history"]] == [1, 2, 3]
    assert phist["history"][2] == jhist["history"][2]
    assert res["best"] == jhist["best"]
    assert {"checkpoint-3.pkl", "checkpoint-final.pkl"} <= set(os.listdir(pdir))
    back = load_checkpoint(os.path.join(pdir, "checkpoint-3.pkl"))
    assert back["epoch"] == 3 and "rng_state" in back
