"""Stage 4: cyclic-CycleVAE training driver.

PyTorch counterpart of ``cyclevae_tpu/pipeline/train_stage.py`` (reference
src/bin/train_gru_cyclevae_gauss_batch.py).  One epoch = shuffled utterance
batches -> TBPTT segment loop with per-segment Adam (one step function per
bucket size; K2 forward and K3 backward on CUDA) -> per-epoch checkpoint
with RNG state -> eval epoch (full-length cyclic forward, K1 on CUDA; DTW
MCD metrics vs the paired utterance on host C++) -> best-epoch selection by
the reference criterion (mcdpow+std+mcd+std of src→trg, train…py:1153-1201).

Randomness, mapped from the JAX package's: its ``PRNGKey(seed)`` is a
``torch.Generator`` on the device seeded with ``seed``, which draws the
initial parameters and then every train step's noise; the numpy
``default_rng(seed)`` that shuffles the batches stays numpy, so the batch
order is the JAX package's; the eval key ``seed + 10007 * (epoch + 1)`` is a
generator seeded with that number.  Checkpoints hold both generators'
states, and a resume restores them.
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..dsp import dtw as dtw_c
from ..models.gru_vae import Draws
from ..utils.config import ExperimentConfig, save_config
from ..utils.device import resolve_device
from ..utils.store import read_store
from ..vi.checkpoint import load_checkpoint, restore_np_rng, restore_train_state, save_checkpoint
from ..vi.train import (
    CycleVAEConfig,
    TrainState,
    init_cyclevae,
    make_eval_forward,
    make_optimizer,
    make_train_step,
)
from .dataset import SingleVAEDataset, Utterance, iter_batches, make_batch


def model_config(exp: ExperimentConfig) -> CycleVAEConfig:
    m = exp.model
    return CycleVAEConfig(
        in_dim=m.in_dim, out_dim=m.out_dim, lat_dim=m.lat_dim, n_spk=m.n_spk,
        hidden_units=m.hidden_units, hidden_layers=m.hidden_layers,
        kernel_size=m.kernel_size, dilation_size=m.dilation_size,
        n_cyc=m.n_cyc, do_prob=m.do_prob, stdim=m.stdim,
        posterior=m.posterior, use_pallas=m.use_pallas,
        compute_dtype=m.compute_dtype)


def _pad_batch_utts(batch: Dict, bsu: int) -> Dict:
    """Pad a partial utterance batch to bsu with zero-flen dummies, so every
    batch of a bucket has one shape (masks null their loss contribution)."""
    B = batch["feats"].shape[0]
    if B == bsu:
        return batch
    out = {}
    for k, v in batch.items():
        pad_shape = (bsu - B,) + v.shape[1:]
        out[k] = np.concatenate([v, np.zeros(pad_shape, v.dtype)])
    return out


def _utt_eval_metrics(cfg: CycleVAEConfig, utt: Utterance,
                      outs: Dict, j: int,
                      gv_mean_trg: Optional[np.ndarray] = None
                      ) -> Dict[str, float]:
    """Per-utterance eval metrics on cycle 0 (reference eval epoch
    train…py:817-1152 / decode metric definitions decode…py:363-404).
    ``outs``: the eval forward's outputs as numpy arrays."""
    stdim = cfg.stdim
    flen = utt.flen
    spc = utt.spcidx
    mcep_src = np.asarray(utt.feats[:, stdim:], dtype=np.float64)
    recon = np.asarray(outs["recon"][0, j, :flen], dtype=np.float64)
    cyc = np.asarray(outs["cyc_recon"][0, j, :flen], dtype=np.float64)
    conv = np.asarray(outs["conv"][0, j, :flen], dtype=np.float64)

    m: Dict[str, float] = {}
    if gv_mean_trg is not None:
        # GV log-RMSE of converted mcep vs target-speaker data GV
        # (reference train…py:722-727 / gru_vae.py:508)
        var_cv = np.var(conv[:, 1:], axis=0)
        m["gv_log_rmse_cv"] = float(np.mean(np.sqrt(
            (np.log(np.maximum(var_cv, 1e-12)) - np.log(gv_mean_trg)) ** 2)))
    # reconstruction / cyclic MCD over speech frames (power-incl and excl)
    m["mcdpow_rec"], _ = dtw_c.calc_mcd(recon[spc], mcep_src[spc])
    m["mcd_rec"], _ = dtw_c.calc_mcd(recon[spc][:, 1:], mcep_src[spc][:, 1:])
    m["mcdpow_cyc"], _ = dtw_c.calc_mcd(cyc[spc], mcep_src[spc])
    m["mcd_cyc"], _ = dtw_c.calc_mcd(cyc[spc][:, 1:], mcep_src[spc][:, 1:])
    # conversion MCD vs the PAIRED utterance with DTW alignment
    mcep_trg = np.asarray(utt.feats_pair[:, stdim:], dtype=np.float64)
    trg_spc = mcep_trg[utt.spcidx_pair]
    conv_spc = conv[spc]
    _, _, m["mcdpow_cv"], _ = dtw_c.dtw_org_to_trg(conv_spc, trg_spc)
    _, _, m["mcd_cv"], _ = dtw_c.dtw_org_to_trg(conv_spc[:, 1:], trg_spc[:, 1:])
    return m


def run_train(exp: ExperimentConfig, feats_src: List[str],
              feats_src_pair: List[str], feats_trg: List[str],
              feats_trg_pair: List[str], feats_eval_src: List[str],
              feats_eval_trg: List[str], stats_src: str, stats_trg: str,
              stats_jnt: str, expdir: str,
              resume: Optional[str] = None, device=None) -> Dict:
    """Train; returns summary dict incl. best epoch. Artifacts in expdir.
    Runs on ``device`` (CUDA unless ``device="cpu"``)."""
    device = resolve_device(device)
    os.makedirs(expdir, exist_ok=True)
    cfg = model_config(exp)
    tcfg = exp.train
    save_config(exp, os.path.join(expdir, "model.json"))

    mean_jnt = read_store(stats_jnt, "/mean_feat_org_lf0_jnt")
    scale_jnt = read_store(stats_jnt, "/scale_feat_org_lf0_jnt")
    gv_trg_mean = read_store(stats_trg, "/gv_range_mean")[1:]
    gv_src_mean = read_store(stats_src, "/gv_range_mean")[1:]

    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    np_rng = np.random.default_rng(tcfg.seed)
    opt = make_optimizer(cfg, tcfg.lr, tcfg.weight_decay)
    start_epoch = 0
    if resume:
        ckpt = load_checkpoint(resume)
        ts = restore_train_state(ckpt, opt, device)
        np_rng = restore_np_rng(ckpt["np_rng_state"])
        start_epoch = ckpt["epoch"]
        ts = ts._replace(step=start_epoch)
        logging.info("restored from %d-epoch checkpoint %s", start_epoch, resume)
    else:
        params = init_cyclevae(generator, cfg, mean_jnt.astype(np.float32),
                               scale_jnt.astype(np.float32), device=device)
        ts = TrainState(params, opt.init(params), generator, start_epoch)

    train_ds = SingleVAEDataset(
        list(feats_src) + list(feats_trg),
        list(feats_src_pair) + list(feats_trg_pair), exp.model.spk_src)
    eval_src_ds = SingleVAEDataset(feats_eval_src, feats_eval_trg, exp.model.spk_src)
    eval_trg_ds = SingleVAEDataset(feats_eval_trg, feats_eval_src, exp.model.spk_src)

    seg = tcfg.batch_size
    bsu = tcfg.batch_size_utt
    step_cache: Dict[int, object] = {}
    eval_fn = make_eval_forward(cfg)

    def get_step(n_segs: int):
        if n_segs not in step_cache:
            step_cache[n_segs] = make_train_step(cfg, opt, seg, n_segs)
        return step_cache[n_segs]

    history = []
    best = {"criterion": np.inf, "epoch": -1}
    if resume:
        # continue the experiment's history/best across the restart
        hist_path = os.path.join(expdir, "history.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                prev = json.load(f)
            history = [h for h in prev.get("history", [])
                       if h["epoch"] <= start_epoch]
            prev_best = prev.get("best", {})
            if prev_best.get("epoch", -1) <= start_epoch and \
                    np.isfinite(prev_best.get("criterion", np.inf)):
                best = prev_best

    for epoch in range(start_epoch, tcfg.epoch_count):
        t_ep = time.time()
        ep_metrics: List[Dict] = []
        for batch, meta in iter_batches(train_ds, bsu, seg, np_rng):
            batch = _pad_batch_utts(batch, bsu)
            ts, metrics = get_step(meta["n_segs"])(ts, batch)
            # average over VALID segments only: fully-padded trailing segments
            # carry all-zero metrics that would dilute the epoch means
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            w = metrics.pop("seg_valid")
            nw = max(float(w.sum()), 1.0)
            ep_metrics.append(
                {k: float(np.sum(v * w) / nw) for k, v in metrics.items()})
        mean_train = {k: float(np.mean([m[k] for m in ep_metrics]))
                      for k in ep_metrics[0]}
        logging.info("epoch %d train: %s (%.1fs)", epoch + 1,
                     {k: round(v, 3) for k, v in sorted(mean_train.items())},
                     time.time() - t_ep)

        # checkpoint with RNG state (reference :711); non-eval epochs only
        # refresh the rolling 'latest' to bound disk usage
        eval_interval = getattr(tcfg, "eval_interval", 1)
        is_eval_epoch = (epoch + 1) % max(eval_interval, 1) == 0
        if is_eval_epoch:
            save_checkpoint(expdir, ts.params, ts.opt_state, ts.rng, np_rng,
                            epoch + 1)
        save_checkpoint(expdir, ts.params, ts.opt_state, ts.rng, np_rng,
                        epoch + 1, name="checkpoint-latest.pkl")
        if not is_eval_epoch:
            history.append({"epoch": epoch + 1, "train": mean_train,
                            "eval": None})
            continue

        # ---- eval epoch (reference :817-1152) ----
        ev: List[Dict[str, float]] = []
        eval_seed = tcfg.seed + 10007 * (epoch + 1)
        for ds in (eval_src_ds, eval_trg_ds):
            for b_start in range(0, len(ds), tcfg.batch_size_utt_eval):
                utts = [ds[i] for i in
                        range(b_start, min(b_start + tcfg.batch_size_utt_eval,
                                           len(ds)))]
                batch, meta = make_batch(utts, seg)
                # every eval batch draws from the same seed, as the JAX
                # package passes one eval key to every batch
                draws = Draws(torch.Generator(device=device).manual_seed(eval_seed))
                outs = {k: v.cpu().numpy()
                        for k, v in eval_fn(ts.params, draws, batch).items()}

                # host DTW is the serial bottleneck of the eval epoch; the
                # C++ kernels release the GIL, so thread the per-utterance
                # metrics
                def one(j_utt):
                    j, utt = j_utt
                    gv_t = gv_trg_mean if utt.is_src_speaker else gv_src_mean
                    m = _utt_eval_metrics(cfg, utt, outs, j, gv_t)
                    m["is_src"] = float(utt.is_src_speaker)
                    return m
                with ThreadPoolExecutor(max_workers=8) as ex:
                    ev.extend(ex.map(one, list(enumerate(utts))))
        agg = {}
        for k in ev[0]:
            if k == "is_src":
                continue
            vals = np.array([m[k] for m in ev])
            agg[f"{k}_mean"] = float(vals.mean())
            agg[f"{k}_std"] = float(vals.std())
        # best-epoch criterion: the SRC→TRG direction only, as the reference
        # (train…py:1153 uses eval_*_src_trg, never the trg→src direction);
        # the pooled two-direction agg above is logged for observability
        src_cv_pow = np.array([m["mcdpow_cv"] for m in ev if m["is_src"] > 0])
        src_cv = np.array([m["mcd_cv"] for m in ev if m["is_src"] > 0])
        if src_cv_pow.size == 0:    # no src-speaker eval utterances
            src_cv_pow = np.array([m["mcdpow_cv"] for m in ev])
            src_cv = np.array([m["mcd_cv"] for m in ev])
        criterion = float(src_cv_pow.mean() + src_cv_pow.std()
                          + src_cv.mean() + src_cv.std())
        agg["criterion"] = criterion
        logging.info("epoch %d eval: %s", epoch + 1,
                     {k: round(v, 3) for k, v in sorted(agg.items())})
        history.append({"epoch": epoch + 1, "train": mean_train, "eval": agg})
        if criterion < best["criterion"]:
            best = {"criterion": criterion, "epoch": epoch + 1}
        with open(os.path.join(expdir, "history.json"), "w") as f:
            json.dump({"history": history, "best": best}, f, indent=2)

    save_checkpoint(expdir, ts.params, ts.opt_state, ts.rng, np_rng,
                    tcfg.epoch_count, name="checkpoint-final.pkl")
    return {"best": best, "history": history}
