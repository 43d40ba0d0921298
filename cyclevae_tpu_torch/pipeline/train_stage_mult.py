"""Stage 4m: the many-to-many CycleVAE training driver.

PyTorch counterpart of ``cyclevae_tpu/pipeline/train_stage_mult.py``.  The
reference defines the many-to-many data surface (dataset.py:101-492) but
ships no training binary (it lives in the successor repo); this driver
completes the capability: N-speaker one-hot codes, per-cycle random
conversion pairs with the partner speaker's converted excitation, and the
one-to-one train step (``vi.train.make_train_step``: K2 forward and K3
backward on CUDA), which takes the per-cycle code axis (n_cyc, B, T, N)
natively.  The eval epoch is the full-length cyclic forward (K1 on CUDA)
with the reconstruction and cyclic MCDs on the host.

Randomness, mapped from the JAX package's as in ``train_stage.run_train``:
a ``torch.Generator`` seeded with ``seed`` draws the initial parameters and
then every train step's noise; the numpy ``default_rng(seed)`` shuffles the
batches (so the batch order is the JAX package's), and the dataset's own
``default_rng(seed)`` draws the conversion pairs (the JAX package's pairs);
each eval epoch draws from a generator seeded with ``seed + 31 * epoch``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..dsp import dtw as dtw_c
from ..models.gru_vae import Draws
from ..utils.config import ExperimentConfig, save_config
from ..utils.device import resolve_device
from ..utils.store import read_store
from ..vi.checkpoint import save_checkpoint
from ..vi.train import (
    TrainState,
    init_cyclevae,
    make_eval_forward,
    make_optimizer,
    make_train_step,
)
from .dataset import bucket_len, padding
from .dataset_mult import MultSpkEvalDataset, MultSpkTrainDataset, MultUtterance
from .train_stage import model_config


def _collate(utts: List[MultUtterance], n_cyc: int, seg_len: int,
             quantum_segs: int = 7) -> Tuple[Dict, int]:
    """(batch, n_segs): feats, src_code (B, T, .), trg_code (n_cyc, B, T, N),
    cv_excit (n_cyc, B, T, 4) padded to the bucket length, and flens."""
    T = bucket_len(max(u.flen for u in utts), seg_len, quantum_segs)

    def pad2(x):
        return padding(x, T).astype(np.float32)

    batch = {
        "feats": np.stack([pad2(u.feats) for u in utts]),
        "src_code": np.stack([pad2(u.src_code) for u in utts]),
        "trg_code": np.stack([np.stack([pad2(u.trg_codes[i]) for u in utts])
                              for i in range(n_cyc)]),
        "cv_excit": np.stack([np.stack([pad2(u.cv_excits[i]) for u in utts])
                              for i in range(n_cyc)]),
        "flens": np.asarray([u.flen for u in utts], dtype=np.int32),
    }
    return batch, T // seg_len


def run_train_mult(exp: ExperimentConfig, feat_files: Sequence[str],
                   feat_files_eval: Sequence[str],
                   spk_src_list: Sequence[str], spk_trg_list: Sequence[str],
                   stats_jnt: str, expdir: str, device=None) -> Dict:
    """Train a many-to-many CycleVAE over N speakers on ``device`` (CUDA
    unless ``device="cpu"``); returns {"history": [...]}.  Writes
    ``model.json``, ``checkpoint-<epoch>.pkl`` and ``history.json`` (best
    epoch: the lowest eval ``mcdpow_rec_mean``) to ``expdir``."""
    device = resolve_device(device)
    os.makedirs(expdir, exist_ok=True)
    cfg = dataclasses.replace(model_config(exp), n_spk=len(spk_src_list) + len(spk_trg_list))
    tcfg = exp.train
    save_config(exp, os.path.join(expdir, "model.json"))

    mean_jnt = read_store(stats_jnt, "/mean_feat_org_lf0_jnt")
    scale_jnt = read_store(stats_jnt, "/scale_feat_org_lf0_jnt")
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    np_rng = np.random.default_rng(tcfg.seed)
    params = init_cyclevae(generator, cfg, mean_jnt.astype(np.float32),
                           scale_jnt.astype(np.float32), device=device)
    opt = make_optimizer(cfg, tcfg.lr, tcfg.weight_decay)
    ts = TrainState(params, opt.init(params), generator, 0)

    train_ds = MultSpkTrainDataset(feat_files, spk_src_list, spk_trg_list, cfg.eff_cyc,
                                   seed=tcfg.seed)
    eval_ds = MultSpkEvalDataset(feat_files_eval, spk_src_list, spk_trg_list, cfg.eff_cyc)

    seg = tcfg.batch_size
    bsu = tcfg.batch_size_utt
    step_cache: Dict[int, object] = {}
    eval_fn = make_eval_forward(cfg)

    def get_step(n_segs: int):
        if n_segs not in step_cache:
            step_cache[n_segs] = make_train_step(cfg, opt, seg, n_segs)
        return step_cache[n_segs]

    history = []
    for epoch in range(tcfg.epoch_count):
        t_ep = time.time()
        order = np.arange(len(train_ds))
        np_rng.shuffle(order)
        ep_metrics = []
        for s in range(0, len(order), bsu):
            n_real = len(order[s:s + bsu])
            utts = [train_ds[i] for i in order[s:s + bsu]]
            while len(utts) < bsu:  # dummy-pad partial batches (masked out)
                dummy = utts[0]
                utts.append(MultUtterance(dummy.featfile, np.zeros_like(dummy.feats),
                                          dummy.src_code, dummy.trg_codes, dummy.cv_excits,
                                          dummy.spcidx, dummy.pair_spks))
            batch, n_segs = _collate(utts, cfg.eff_cyc, seg)
            batch["flens"][n_real:] = 0
            ts, metrics = get_step(n_segs)(ts, batch)
            # average over VALID segments only, as train_stage.run_train
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            w = metrics.pop("seg_valid")
            nw = max(float(w.sum()), 1.0)
            ep_metrics.append({k: float(np.sum(v * w) / nw) for k, v in metrics.items()})
        mean_train = {k: float(np.mean([mm[k] for mm in ep_metrics])) for k in ep_metrics[0]}
        logging.info("m2m epoch %d train: %s (%.1fs)", epoch + 1,
                     {k: round(v, 3) for k, v in sorted(mean_train.items())},
                     time.time() - t_ep)
        save_checkpoint(expdir, ts.params, ts.opt_state, ts.rng, np_rng, epoch + 1)

        # eval: reconstruction / cyclic MCD over speech frames per utterance
        ev = []
        eval_seed = tcfg.seed + 31 * (epoch + 1)
        for s in range(0, len(eval_ds), tcfg.batch_size_utt_eval):
            utts = [eval_ds[i] for i in
                    range(s, min(s + tcfg.batch_size_utt_eval, len(eval_ds)))]
            batch, _ = _collate(utts, cfg.eff_cyc, seg)
            draws = Draws(torch.Generator(device=device).manual_seed(eval_seed))
            outs = {k: v.cpu().numpy() for k, v in eval_fn(ts.params, draws, batch).items()}
            for j, u in enumerate(utts):
                spc = u.spcidx
                mcep = np.asarray(u.feats[:, cfg.stdim:], np.float64)
                rec = np.asarray(outs["recon"][0, j, :u.flen], np.float64)
                cyc = np.asarray(outs["cyc_recon"][0, j, :u.flen], np.float64)
                m1, _ = dtw_c.calc_mcd(rec[spc], mcep[spc])
                m2, _ = dtw_c.calc_mcd(cyc[spc], mcep[spc])
                ev.append({"mcdpow_rec": m1, "mcdpow_cyc": m2})
        agg = {f"{k}_mean": float(np.mean([e[k] for e in ev])) for k in ev[0]}
        logging.info("m2m epoch %d eval: %s", epoch + 1, {k: round(v, 3) for k, v in agg.items()})
        history.append({"epoch": epoch + 1, "train": mean_train, "eval": agg})
        with open(os.path.join(expdir, "history.json"), "w") as f:
            json.dump({"history": history,
                       "best": {"epoch": int(np.argmin(
                           [h["eval"]["mcdpow_rec_mean"] for h in history]) + 1)}},
                      f, indent=2)
    return {"history": history}
