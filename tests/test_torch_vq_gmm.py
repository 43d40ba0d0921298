"""The port's VQ helpers, its GMM and its VQ-CycleVAE trainer against the
JAX package's (``models/vq.py``, ``models/gmm.py``,
``pipeline/train_stage_vq.py``), on the same inputs and parameters (CPU,
small model: hu16, ld8).  One VQ step of each assignment runs on both sides
at do_prob 0 (no random draws) with plain SGD on the trainable tensors and
``set_to_zero`` on the scalers, so the parameter update is the gradient
itself."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cyclevae_tpu.models import gmm as jgmm
from cyclevae_tpu.models import vq as jvq
from cyclevae_tpu.models.gru_vae import init_gru_rnn as jax_init_gru_rnn
from cyclevae_tpu.pipeline import dataset as jds
from cyclevae_tpu.pipeline import train_stage_vq as jtvq
from cyclevae_tpu.utils import hdf5 as jh
from cyclevae_tpu.utils.config import ExperimentConfig as JaxExperiment
from cyclevae_tpu.utils.config import ModelConfig as JaxModelConfig
from cyclevae_tpu_torch.models import gmm as tgmm
from cyclevae_tpu_torch.models import vq as tvq
from cyclevae_tpu_torch.pipeline import dataset as tds
from cyclevae_tpu_torch.pipeline import train_stage_vq as ttvq
from cyclevae_tpu_torch.utils import store as ts
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
from cyclevae_tpu_torch.utils.tree import tree_map

from test_torch_train import _walk

torch.set_num_threads(1)

MODEL = dict(hidden_units=16, lat_dim=8, do_prob=0.0)
N_CTR, LR = 16, 1e-3


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


@pytest.fixture(scope="module")
def codes():
    rng = np.random.default_rng(0)
    return {"enc": rng.normal(size=(3, 11, 6)).astype(np.float32),
            "ctr": rng.normal(size=(9, 6)).astype(np.float32),
            "w": rng.normal(size=(3, 11, 6)).astype(np.float32),
            "mask": (np.arange(11)[None] < np.array([[11], [7], [4]])).astype(np.float32)}


def test_nn_search_ids_exact(codes):
    enc, ctr = codes["enc"], codes["ctr"]
    got = tvq.nn_search_batch(_t(enc), _t(ctr)).numpy()
    want = np.asarray(jvq.nn_search_batch(jnp.asarray(enc), jnp.asarray(ctr)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvq.nn_search(_t(enc[1]), _t(ctr)).numpy(),
                                  np.asarray(jvq.nn_search(jnp.asarray(enc[1]), jnp.asarray(ctr))))
    # ties go to the first centroid, as argmin does in both
    tie = np.zeros((2, 6), np.float32)
    assert tvq.nn_search(_t(tie), _t(np.zeros((3, 6)))).tolist() == [0, 0]


def test_weighted_ctr_values_and_grads(codes):
    enc, ctr = codes["enc"][0], codes["ctr"]

    def jloss(e, c):
        wc, wd = jvq.weighted_ctr(e, c)
        return jnp.sum(wc * codes["w"][0]) + wd, (wc, wd)

    (_, (wc_j, wd_j)), (ge_j, gc_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(enc), jnp.asarray(ctr))
    e, c = _t(enc, True), _t(ctr, True)
    wc, wd = tvq.weighted_ctr(e, c)
    (torch.sum(wc * _t(codes["w"][0])) + wd).backward()
    np.testing.assert_allclose(wc.detach().numpy(), wc_j, atol=1e-6)
    np.testing.assert_allclose(float(wd.detach()), float(wd_j), atol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), ge_j, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), gc_j, atol=1e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_straight_through_values_and_grads(codes, batched):
    enc, ctr, w = (codes["enc"], codes["ctr"], codes["w"]) if batched else \
        (codes["enc"][2], codes["ctr"], codes["w"][2])

    def jloss(e, c):
        if batched:
            st, hard, ids = jvq.vq_straight_through_batch(e, c)
            return jnp.sum(st * w) + jnp.sum((e - hard) ** 2), (st, ids)
        st, ids = jvq.vq_straight_through(e, c)
        return jnp.sum(st * w), (st, ids)

    (_, (st_j, ids_j)), (ge_j, gc_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(enc), jnp.asarray(ctr))
    e, c = _t(enc, True), _t(ctr, True)
    if batched:
        st, hard, ids = tvq.vq_straight_through_batch(e, c)
        (torch.sum(st * _t(w)) + torch.sum((e - hard) ** 2)).backward()
    else:
        st, ids = tvq.vq_straight_through(e, c)
        torch.sum(st * _t(w)).backward()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(st.detach().numpy(), st_j, atol=1e-6)
    np.testing.assert_allclose(st.detach().numpy(), ctr[ids.numpy()], atol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), ge_j, atol=1e-5)
    # without the codebook loss no gradient reaches the centroids: None here, zeros in JAX
    gc = np.zeros_like(ctr) if c.grad is None else c.grad.numpy()
    np.testing.assert_allclose(gc, gc_j, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_codebook_perplexity(codes, masked):
    ids = np.asarray(jvq.nn_search_batch(jnp.asarray(codes["enc"]), jnp.asarray(codes["ctr"])))
    mask = codes["mask"] if masked else None
    want = float(jvq.codebook_perplexity(jnp.asarray(ids), 9,
                                         None if mask is None else jnp.asarray(mask)))
    got = float(tvq.codebook_perplexity(torch.tensor(ids), 9,
                                        None if mask is None else _t(mask)))
    assert got == pytest.approx(want, rel=1e-6) and 1.0 <= got <= 9.0
    assert float(tvq.codebook_perplexity(torch.zeros((2, 5), dtype=torch.long), 8)) == 1.0


@pytest.fixture(scope="module")
def gmm_case():
    rng = np.random.default_rng(1)
    data = np.concatenate([rng.normal(size=(40, 5)) - 2, rng.normal(size=(60, 5)) + 1.5])
    params = {"weights": np.array([0.2, 0.3, 0.5]), "means": rng.normal(size=(3, 5)),
              "dcovs": 0.5 + rng.random((3, 5))}
    return data.astype(np.float32), {k: v.astype(np.float32) for k, v in params.items()}


def test_gmm_log_prob_and_forward(gmm_case):
    data, p = gmm_case
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    np.testing.assert_allclose(float(tgmm.gmm_log_prob(tp, _t(data))),
                               float(jgmm.gmm_log_prob(jp, jnp.asarray(data))), rtol=1e-5)
    ll_t, em_t = tgmm.gmm_forward(tp, _t(data))
    ll_j, em_j = jgmm.gmm_forward(jp, jnp.asarray(data))
    np.testing.assert_allclose(float(ll_t), float(ll_j), rtol=1e-5)
    np.testing.assert_allclose(em_t.numpy(), em_j, atol=1e-5)


def test_gmm_em_update(gmm_case):
    data, p = gmm_case
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    lls = []
    for _ in range(3):
        jp, ll_j = jgmm.gmm_em_update(jp, jnp.asarray(data))
        tp, ll_t = tgmm.gmm_em_update(tp, _t(data))
        np.testing.assert_allclose(float(ll_t), float(ll_j), rtol=1e-5)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], atol=1e-5, rtol=1e-5, err_msg=k)
        lls.append(float(ll_t))
    assert lls[0] <= lls[1] <= lls[2]        # EM never lowers the likelihood
    assert float(tp["weights"].sum()) == pytest.approx(1.0, abs=1e-6)


def test_init_gmm():
    data = torch.tensor(np.random.default_rng(2).normal(size=(30, 4)), dtype=torch.float32)
    p = tgmm.init_gmm(torch.Generator().manual_seed(0), 5, 4, data)
    rows = {tuple(r) for r in data.numpy().tolist()}
    assert all(tuple(m) in rows for m in p["means"].numpy().tolist())
    assert len({tuple(m) for m in p["means"].numpy().tolist()}) == 5   # without replacement
    torch.testing.assert_close(p["dcovs"], torch.var(data, dim=0, unbiased=False).expand(5, 4))
    torch.testing.assert_close(p["weights"], torch.full((5,), 0.2))
    q = tgmm.init_gmm(torch.Generator().manual_seed(0), 3, 4)
    assert q["means"].shape == (3, 4) and torch.equal(q["dcovs"], torch.ones(3, 4))
    assert np.isfinite(float(tgmm.gmm_log_prob(p, data)))


# ---------------------------------------------------------------------------
# the VQ-CycleVAE trainer
# ---------------------------------------------------------------------------

def _vq_case(seed=3):
    exp_j = JaxExperiment(model=JaxModelConfig(**MODEL))
    exp_t = ExperimentConfig(model=ModelConfig(**MODEL))
    enc_j, dec_j = jtvq.make_vq_cfgs(exp_j)
    enc_t, dec_t = ttvq.make_vq_cfgs(exp_t)
    rng = np.random.default_rng(seed)
    mean = (0.1 * rng.normal(size=54)).astype(np.float32)
    scale = (0.5 + rng.random(54)).astype(np.float32)
    k_enc, k_dec, k_ctr = jax.random.split(jax.random.PRNGKey(seed), 3)
    jp = {"encoder": jax_init_gru_rnn(k_enc, enc_j), "decoder": jax_init_gru_rnn(k_dec, dec_j),
          "centroids": 0.5 * jax.random.normal(k_ctr, (N_CTR, MODEL["lat_dim"]))}
    jp["encoder"]["scale_in"] = {"mean": jnp.asarray(mean), "scale": jnp.asarray(scale)}
    jp["decoder"]["scale_out"] = {"mean": jnp.asarray(mean[4:]), "scale": jnp.asarray(scale[4:])}
    flens = [30, 22]
    T = 30
    t = np.arange(T)[None, :, None]
    feats = (mean + scale * np.sin(t * 0.09 + np.arange(54)) + 0.3 * rng.normal(size=(2, T, 54)))
    code = np.zeros((2, T, 2), np.float32)
    batch = {"feats": feats.astype(np.float32), "src_code": code + [1, 0],
             "trg_code": code + [0, 1],
             "cv_excit": (feats[..., :4] + 0.1).astype(np.float32),
             "mask": (np.arange(T)[None] < np.array(flens)[:, None]).astype(np.float32)}
    return (enc_j, dec_j, jp), (enc_t, dec_t), batch


def _jax_frozen_sgd(lr):
    def label_fn(p):
        net = lambda n: {k: jax.tree_util.tree_map(
            lambda _: "frozen" if k in ("scale_in", "scale_out") else "train", v)
            for k, v in n.items()}
        return {"encoder": net(p["encoder"]), "decoder": net(p["decoder"]), "centroids": "train"}
    return optax.multi_transform({"train": optax.sgd(lr), "frozen": optax.set_to_zero()},
                                 label_fn)


@pytest.mark.parametrize("assignment,use_pallas",
                         [("st", True), ("st", False), ("soft", True)])
def test_vq_step_matches_jax(assignment, use_pallas):
    (enc_j, dec_j, jp), (enc_t, dec_t), batch = _vq_case()
    assert (enc_t.out_dim, dec_t.in_dim) == (enc_j.out_dim, dec_j.in_dim) == (8, 10)
    tp = tree_map(lambda a: torch.tensor(np.asarray(a)), jp)
    before = _walk(jp, np.asarray)

    opt_j = _jax_frozen_sgd(LR)
    step_j = jtvq.make_vq_step(enc_j, dec_j, opt_j, 4, N_CTR, 0.25, assignment)
    jp2, _, _, met_j = step_j(jp, opt_j.init(jp), jax.random.PRNGKey(0),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    trainable = ttvq.vq_trainable(tp)
    for t in trainable:
        t.requires_grad_(True)
    step_t = ttvq.make_vq_step(enc_t, dec_t, 4, N_CTR, 0.25, assignment, use_pallas=use_pallas)
    met_t = step_t(tp, torch.optim.SGD(trainable, lr=LR), batch)

    assert sorted(met_t) == sorted(met_j) == ["loss", "mcd_cyc", "mcd_rec", "perplexity", "vq"]
    for k in met_j:
        assert abs(float(met_t[k]) - float(met_j[k])) <= 1e-5 * abs(float(met_j[k])), k
    # the updated parameters within 1e-5 of their scale, and the update
    # (lr x the gradient) within 2e-4 of its largest value
    after_t, after_j = _walk(tp, lambda t: t.detach().numpy()), _walk(jp2, np.asarray)
    for a, b, p0 in zip(after_t, after_j, before):
        scale = max(float(np.max(np.abs(b))), 1e-3)
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0)
        g_t, g_j = (p0 - a) / LR, (p0 - b) / LR
        np.testing.assert_allclose(g_t, g_j, atol=2e-4 * max(float(np.max(np.abs(g_j))), 1e-3))
    # the scalers are frozen on both sides, the codebook moves
    for net, k in (("encoder", "scale_in"), ("decoder", "scale_out")):
        for v in ("mean", "scale"):
            np.testing.assert_array_equal(tp[net][k][v].detach().numpy(), jp[net][k][v])
    assert not np.array_equal(tp["centroids"].detach().numpy(), np.asarray(jp["centroids"]))


@pytest.fixture(scope="module")
def vq_stores(tmp_path_factory):
    """A tiny paired one-to-one corpus in both stores (the h5 contract of
    stages 1-3) and the joint stats."""
    root = tmp_path_factory.mktemp("vq")
    rng = np.random.default_rng(1)
    files = {"jax": {}, "port": {}}
    for k, spk in enumerate(("SPK_S", "SPK_T")):
        for side in files:
            files[side][spk] = []
        for i in range(3):
            T = 50 + 17 * i
            t = np.arange(T)[:, None]
            feats = np.sin(t * 0.07 + np.arange(54)[None]) + 1.2 * k + 0.1 * rng.normal(size=(T, 54))
            data = {"/feat_org_lf0": feats, "/cvuvlogf0fil_ap": feats[:, :4] + 0.1,
                    "/spcidx_range": np.arange(5, T - 5)[None]}
            for side, write, ext in (("jax", jh.write_hdf5, "h5"), ("port", ts.write_store, "npz")):
                path = str(root / side / spk / f"u{i}.{ext}")
                for key, v in data.items():
                    write(path, key, v)
                files[side][spk].append(path)
    for side, write, ext in (("jax", jh.write_hdf5, "h5"), ("port", ts.write_store, "npz")):
        path = str(root / side / f"stats_jnt.{ext}")
        write(path, "/mean_feat_org_lf0_jnt", np.full(54, 0.6))
        write(path, "/scale_feat_org_lf0_jnt", np.full(54, 1.1))
        files[side]["stats"] = path
    return files


def test_collate_vq_identical(vq_stores):
    s, t = vq_stores["port"], vq_stores["jax"]
    ds_t = tds.SingleVAEDataset(s["SPK_S"] + s["SPK_T"], s["SPK_T"] + s["SPK_S"], "SPK_S")
    ds_j = jds.SingleVAEDataset(t["SPK_S"] + t["SPK_T"], t["SPK_T"] + t["SPK_S"], "SPK_S")
    idx = [4, 0, 2]
    got = ttvq._collate_vq([ds_t[i] for i in idx], 20)
    want = jtvq._collate_vq([ds_j[i] for i in idx], 20)
    assert sorted(got) == sorted(want) and got["feats"].shape == (3, 100, 54)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("assignment", ["st", "soft"])
def test_run_train_vq_end_to_end(vq_stores, tmp_path, assignment):
    s = vq_stores["port"]
    exp = ExperimentConfig(model=ModelConfig(**MODEL),
                           train=TrainConfig(batch_size=20, batch_size_utt=4, epoch_count=2,
                                             lr=5e-3))
    assert exp.model.use_pallas          # the kernel route: its plain versions on the CPU
    res = ttvq.run_train_vq(exp, s["SPK_S"], s["SPK_T"], "SPK_S", s["stats"],
                            str(tmp_path / "vq"), n_centroids=N_CTR, assignment=assignment,
                            device="cpu")
    h = res["history"]
    assert [e["epoch"] for e in h] == [1, 2]
    assert sorted(h[0]["train"]) == ["loss", "mcd_cyc", "mcd_rec", "perplexity", "vq"]
    assert all(np.isfinite(v) for e in h for v in e["train"].values())
    assert 1.0 <= h[-1]["train"]["perplexity"] <= N_CTR
    assert (tmp_path / "vq" / "history_vq.json").exists()
    p = res["params"]
    np.testing.assert_array_equal(p["encoder"]["scale_in"]["mean"].numpy(), np.full(54, 0.6,
                                                                                   np.float32))
    assert p["centroids"].shape == (N_CTR, MODEL["lat_dim"])
    with pytest.raises(ValueError):
        ttvq.make_vq_step(res["enc_cfg"], res["dec_cfg"], 4, N_CTR, assignment="hard")
