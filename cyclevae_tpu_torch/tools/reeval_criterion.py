"""Recompute the best-epoch criterion for the saved checkpoints of an
experiment.

Port of the JAX package's ``tools/reeval_criterion.py``.  A criterion can
pool both conversion directions or take the src->trg direction only, as the
reference selects its best epoch.  This replays the eval epoch of every
``checkpoint-N.pkl`` exactly as ``pipeline.train_stage.run_train`` ran it
(the eval forward on K1; every eval batch draws from a generator seeded
``seed + 10007 * N``, N = epoch + 1), computes BOTH criteria, writes
``criteria.json`` into the experiment directory, and with
``--patch-history`` sets ``history.json``'s ``best`` to the src-only winner
so a resumed run tracks best consistently.

    python -m cyclevae_tpu_torch.tools.reeval_criterion --work W --config exp.json \\
        --wav-root R [--patch-history] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ._common import add_device_arg, device_entry, kernel_launches, launches_since
from ._common import resolve_device, write_json


def criterion(sel) -> float:
    pw = np.array([m["mcdpow_cv"] for m in sel])
    mc = np.array([m["mcd_cv"] for m in sel])
    return float(pw.mean() + pw.std() + mc.mean() + mc.std())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--wav-root", required=True)
    p.add_argument("--n-train", type=int, default=40)
    p.add_argument("--patch-history", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..models.gru_vae import Draws
    from ..pipeline.dataset import SingleVAEDataset, make_batch
    from ..pipeline.recipe import RecipePaths
    from ..pipeline.train_stage import _utt_eval_metrics, model_config
    from ..utils.config import load_config
    from ..utils.store import read_store
    from ..vi.checkpoint import load_checkpoint
    from ..vi.train import CycleVAEParams, make_eval_forward, params_to

    exp = load_config(args.config)
    cfg = model_config(exp)
    tcfg = exp.train
    paths = RecipePaths(wav_root=args.wav_root, work=args.work, n_train=args.n_train)
    expdir = os.path.join(args.work, "exp", exp.name())
    spk_src, spk_trg = exp.model.spk_src, exp.model.spk_trg

    gv_trg_mean = read_store(paths.stats(spk_trg), "gv_range_mean")[1:]
    gv_src_mean = read_store(paths.stats(spk_src), "gv_range_mean")[1:]
    eval_src_ds = SingleVAEDataset(paths.h5s(spk_src, True), paths.h5s(spk_trg, True), spk_src)
    eval_trg_ds = SingleVAEDataset(paths.h5s(spk_trg, True), paths.h5s(spk_src, True), spk_src)
    eval_fn = make_eval_forward(cfg)

    ckpts = sorted(
        (int(m.group(1)), f) for f in glob.glob(os.path.join(expdir, "checkpoint-*.pkl"))
        if (m := re.match(r".*checkpoint-(\d+)\.pkl$", f)))
    before = kernel_launches()
    results = []
    for epoch, ck in ckpts:
        params = params_to(CycleVAEParams(*load_checkpoint(ck)["params"]), dev)
        # the eval epoch exactly as run_train ran it after this checkpoint
        eval_seed = tcfg.seed + 10007 * epoch
        ev = []
        for ds in (eval_src_ds, eval_trg_ds):
            for b0 in range(0, len(ds), tcfg.batch_size_utt_eval):
                utts = [ds[i] for i in range(b0, min(b0 + tcfg.batch_size_utt_eval, len(ds)))]
                batch, _ = make_batch(utts, tcfg.batch_size)
                draws = Draws(torch.Generator(device=dev).manual_seed(eval_seed))
                outs = {k: v.cpu().numpy() for k, v in eval_fn(params, draws, batch).items()}

                def one(j_utt):
                    j, utt = j_utt
                    gv_t = gv_trg_mean if utt.is_src_speaker else gv_src_mean
                    m = _utt_eval_metrics(cfg, utt, outs, j, gv_t)
                    m["is_src"] = float(utt.is_src_speaker)
                    return m
                with ThreadPoolExecutor(max_workers=8) as ex:
                    ev.extend(ex.map(one, list(enumerate(utts))))
        src_sel = [m for m in ev if m["is_src"] > 0]
        row = {"epoch": epoch, "criterion_src": criterion(src_sel),
               "criterion_pooled": criterion(ev)}
        results.append(row)
        print(json.dumps(row), flush=True)

    best = min(results, key=lambda r: r["criterion_src"])
    out = {"results": results, "best_src": best, "device": device_entry(dev),
           "launches": launches_since(before)}
    write_json(os.path.join(expdir, "criteria.json"), out, indent=2)
    print("best (src-only):", best, flush=True)

    if args.patch_history:
        hp = os.path.join(expdir, "history.json")
        with open(hp) as f:
            hist = json.load(f)
        hist["best"] = {"criterion": best["criterion_src"], "epoch": best["epoch"]}
        write_json(hp, hist, indent=2)
        print("patched", hp, flush=True)
    return out


if __name__ == "__main__":
    main()
