"""The port's training core against the JAX package's, on the CPU.

``torch.Generator`` and ``jax.random`` draw different numbers, so the dropout
masks and posterior noise are recorded where the JAX package draws them
(``monkeypatch`` of ``cyclevae_tpu.models.gru_vae._bernoulli_fast`` and
``cyclevae_tpu.vi.train.sampling_vae_batch``, made from a numpy seed) and
replayed into the port in the same order (a ``Draws`` that pops them).
The JAX train step's segment scan runs under ``jax.disable_jit()``, so its
body draws afresh for every segment.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cyclevae_tpu.models.gru_vae as jgv
import cyclevae_tpu.vi.train as jtrain
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.models.gru_vae import Draws
from cyclevae_tpu_torch.pipeline.dataset import Utterance, make_batch
from cyclevae_tpu_torch.pipeline.train_stage import _pad_batch_utts
from cyclevae_tpu_torch.vi import train as ttrain

torch.set_num_threads(1)

H, LAT, B, SEG = 16, 6, 2, 10
LR = 1e-3


class Recorder:
    """Stands in for the JAX package's draws: numpy draws, recorded."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.seq = []

    def bernoulli(self, key, p, shape):
        m = self.rng.random(shape) < p
        self.seq.append(("mask", m))
        return jnp.asarray(m)

    def sampling(self, key, param, lat_dim=None):
        lat_dim = param.shape[-1] // 2 if lat_dim is None else lat_dim
        mu, lv = param[..., :lat_dim], param[..., lat_dim:]
        eps = self.rng.normal(size=mu.shape).astype(np.float32)
        self.seq.append(("eps", eps))
        return mu + jnp.exp(lv / 2.0) * jnp.asarray(eps)


class Replay(Draws):
    """The port's draws, popped in order from a Recorder's sequence."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind, shape):
        got_kind, a = self.seq.pop(0)
        assert got_kind == kind and a.shape == tuple(shape), (got_kind, a.shape, kind, shape)
        return torch.tensor(a)

    def bernoulli(self, keep, shape):
        return self._pop("mask", shape)

    def normal(self, shape):
        return self._pop("eps", shape)

    def eps(self, shape, laplace):
        assert not laplace
        return self._pop("eps", shape)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder(seed=11)
    monkeypatch.setattr(jgv, "_bernoulli_fast", rec.bernoulli)
    monkeypatch.setattr(jtrain, "sampling_vae_batch", rec.sampling)
    return rec


def _setup(use_pallas, seed=0):
    kw = dict(hidden_units=H, lat_dim=LAT, n_cyc=2, do_prob=0.5, use_pallas=use_pallas)
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=54).astype(np.float32) * 0.1
    scale = rng.uniform(0.5, 2.0, size=54).astype(np.float32)
    jp = jtrain.init_cyclevae(jax.random.PRNGKey(seed), jtrain.CycleVAEConfig(**kw), mean, scale)
    return jtrain.CycleVAEConfig(**kw), ttrain.CycleVAEConfig(**kw), jp


def _utterances(rng, flens):
    utts = []
    for T in flens:
        t = np.arange(T)[:, None]
        feats = (np.sin(t * 0.07 + np.arange(54)[None]) + 0.3 * rng.normal(size=(T, 54)))
        feats = feats.astype(np.float32)
        code = np.zeros((T, 2), np.float32)
        utts.append(Utterance("", "", feats, feats[:, :4].copy(), np.arange(T),
                              code + [1, 0], code + [0, 1], feats, np.arange(T), True))
    return utts


def _walk(tree, leaf):
    """Leaves in sorted-key order, list order; None where ``leaf`` says so."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _walk(tree[k], leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _walk(v, leaf)]
    return [leaf(tree)]


def _assert_grads_close(got, want, factor=2e-4):
    # the JAX package's gradient tolerance (tests/test_gru_ar_vjp.py): float32
    # sums in another order, scaled by the largest gradient of each leaf
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(np.max(np.abs(w))), 1e-3)
        np.testing.assert_allclose(g, w, atol=factor * scale, rtol=factor)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_segment_loss_and_grads_match_jax(recorder, use_pallas):
    jc, tc, jp = _setup(use_pallas)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(B, SEG, 54)).astype(np.float32)
    seg = {"feats": feats,
           "src_code": np.tile([1.0, 0.0], (B, SEG, 1)).astype(np.float32),
           "trg_code": np.tile([0.0, 1.0], (B, SEG, 1)).astype(np.float32),
           "cv_excit": rng.normal(size=(B, SEG, 4)).astype(np.float32),
           "mask": np.stack([np.ones(SEG), np.arange(SEG) < 6]).astype(np.float32)}
    state_j = jtrain.init_cycle_state(jc, jp, B)
    (loss_j, (_, met_j)), g_j = jax.value_and_grad(jtrain.segment_loss, has_aux=True)(
        jp, jc, jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in seg.items()},
        state_j, True)

    tp = params_from_jax(jp, device="cpu")
    ttrain.make_optimizer(tc).init(tp)            # marks the trainable leaves
    state_t = ttrain.init_cycle_state(tc, tp, B)
    for k, v in state_j.items():
        np.testing.assert_array_equal(state_t[k].numpy(), np.asarray(v))
    loss_t, (_, met_t) = ttrain.segment_loss(
        tp, tc, Replay(recorder.seq), {k: torch.tensor(v) for k, v in seg.items()},
        state_t, do=True)
    loss_t.backward()

    # the ELBO parity bound of tests/test_elbo_parity.py
    assert abs(float(loss_t.detach()) - float(loss_j)) / abs(float(loss_j)) < 2e-4
    for k, v in met_j.items():
        assert abs(float(met_t[k].detach()) - float(v)) <= 2e-4 * max(abs(float(v)), 1.0), k
    trainable = lambda net: {k: v for k, v in net.items() if k not in ("scale_in", "scale_out")}
    for jnet, tnet in zip(g_j, tp):
        _assert_grads_close(_walk(trainable(tnet), lambda t: t.grad.numpy()),
                            _walk(trainable(jnet), np.asarray))
        for k in ("scale_in", "scale_out"):
            if k in tnet:
                assert all(t.grad is None for t in tnet[k].values())


def _jax_mu(opt_state):
    """optax's Adam first moments (the trainable leaves; MaskedNode elsewhere)."""
    inner = opt_state.inner_states["train"].inner_state
    return inner[0].mu


def test_train_step_matches_optax(recorder):
    jc, tc, jp = _setup(use_pallas=True, seed=2)
    rng = np.random.default_rng(2)
    batch, meta = make_batch(_utterances(rng, [20, 14]), SEG, quantum_segs=3)
    assert meta["n_segs"] == 3 and batch["feats"].shape[1] == 30  # last segment all padding
    n_segs = meta["n_segs"]
    tp = params_from_jax(jp, device="cpu")          # before JAX's step donates jp

    opt_j = jtrain.make_optimizer(jc, lr=LR)
    ts_j = jtrain.TrainState(jp, opt_j.init(jp), jax.random.PRNGKey(5), jnp.zeros((), jnp.int32))
    with jax.disable_jit():
        ts_j, met_j = jtrain.build_step_fn(jc, opt_j, SEG, n_segs)(
            ts_j, {k: jnp.asarray(v) for k, v in batch.items()})

    opt_t = ttrain.make_optimizer(tc, lr=LR)
    ts_t = ttrain.TrainState(tp, opt_t.init(tp), torch.Generator(), 0)
    scalers = [t.clone() for net in tp for k in ("scale_in", "scale_out") if k in net
               for t in net[k].values()]
    ts_t, met_t = ttrain.make_train_step(tc, opt_t, SEG, n_segs)(ts_t, batch, Replay(recorder.seq))
    assert ts_t.step == 1

    np.testing.assert_array_equal(met_t["seg_valid"].numpy(), [1.0, 1.0, 0.0])
    np.testing.assert_array_equal(np.asarray(met_j["seg_valid"]), [1.0, 1.0, 0.0])
    # segment 0 starts from the same params: the ELBO bound; segment 1 starts
    # from params one Adam step apart (below), which moves its loss by ~1e-3
    loss_j, loss_t = np.asarray(met_j["loss"]), met_t["loss"].numpy()
    assert abs(loss_t[0] - loss_j[0]) / abs(loss_j[0]) < 2e-4
    assert abs(loss_t[1] - loss_j[1]) / abs(loss_j[1]) < 2e-3
    assert loss_t[2] == 0.0 and loss_j[2] == 0.0

    # Adam's first moments, 0.9 * 0.1 g0 + 0.1 g1: g0 within the gradient
    # bound, g1 taken at params up to 2 lr apart (below)
    mu_t = [[ts_t.opt_state.state[p]["exp_avg"].numpy() for p in
             _walk({k: v for k, v in net.items() if k not in ("scale_in", "scale_out")},
                   lambda t: t)] for net in tp]
    mu_j = _jax_mu(ts_j.opt_state)
    for net_t, net_j in zip(mu_t, mu_j):
        _assert_grads_close(net_t, [np.asarray(a) for a in jax.tree_util.tree_leaves(net_j)],
                            factor=2e-3)

    # params: an Adam step moves each weight by about lr * sign(g), so where
    # a gradient is near 0 the two frameworks may step opposite ways: two
    # steps differ by less than 2 lr
    for net_t, net_j in zip(ts_t.params, ts_j.params):
        for a, b in zip(_walk(net_t, lambda t: t.detach().numpy()), _walk(net_j, np.asarray)):
            assert np.max(np.abs(a - b)) < 2 * LR
    # the frozen scalers never move
    after = [t for net in ts_t.params for k in ("scale_in", "scale_out") if k in net
             for t in net[k].values()]
    for a, b in zip(after, scalers):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_padding_segment_leaves_params_and_optimizer_unchanged():
    """A step over 3 segments whose last one is all padding ends where the
    same step over the first 2 segments ends, bit for bit."""
    _, tc, jp = _setup(use_pallas=True, seed=4)
    rng = np.random.default_rng(4)
    batch, _ = make_batch(_utterances(rng, [20, 14]), SEG, quantum_segs=3)
    results = []
    for n_segs in (3, 2):
        tp = params_from_jax(jp, device="cpu")
        opt = ttrain.make_optimizer(tc, lr=LR)
        ts = ttrain.TrainState(tp, opt.init(tp), torch.Generator().manual_seed(9), 0)
        ts, met = ttrain.make_train_step(tc, opt, SEG, n_segs)(ts, batch)
        results.append((ts, met))
    (ts3, met3), (ts2, met2) = results
    np.testing.assert_array_equal(met3["seg_valid"].numpy(), [1.0, 1.0, 0.0])
    torch.testing.assert_close(met3["loss"][:2], met2["loss"], atol=0, rtol=0)
    for a, b in zip(_walk(list(ts3.params), lambda t: t), _walk(list(ts2.params), lambda t: t)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    s3, s2 = ts3.opt_state.state_dict()["state"], ts2.opt_state.state_dict()["state"]
    assert s3.keys() == s2.keys()
    for i in s3:
        for k in s3[i]:
            torch.testing.assert_close(s3[i][k], s2[i][k], atol=0, rtol=0)


def test_pad_batch_utts_matches_jax():
    from cyclevae_tpu.pipeline.train_stage import _pad_batch_utts as jax_pad
    rng = np.random.default_rng(6)
    batch, _ = make_batch(_utterances(rng, [12, 25, 7]), SEG, quantum_segs=2)
    assert batch["feats"].shape[1] == 40
    got, want = _pad_batch_utts(batch, 5), jax_pad(batch, 5)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert _pad_batch_utts(got, 5) is got


def test_eval_forward_runs_without_grad():
    jc, tc, jp = _setup(use_pallas=True, seed=7)
    tp = params_from_jax(jp, device="cpu")
    ttrain.make_optimizer(tc).init(tp)
    rng = np.random.default_rng(7)
    batch, _ = make_batch(_utterances(rng, [17, 9]), SEG, quantum_segs=1)
    outs = ttrain.make_eval_forward(tc)(tp, Draws(torch.Generator().manual_seed(0)), batch)
    T = batch["feats"].shape[1]
    assert outs["lat"].shape == (2, 2, T, 2 * LAT) and outs["recon"].shape == (2, 2, T, 50)
    assert all(not v.requires_grad and bool(torch.isfinite(v).all()) for v in outs.values())
