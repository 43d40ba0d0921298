"""The many-to-many recipe (stages 3m, 4m, 5m, 6m).

PyTorch counterpart of ``cyclevae_tpu/pipeline/recipe_mult.py``.  The
reference defines the many-to-many data surface but ships no recipe for it
(the training binary lives in the successor repo); this driver completes it
on top of the same per-speaker feature and statistics files as the
one-to-one recipe:

  stage 3m  per-partner converted excitation (/cvuvlogf0fil_ap_<spk>)
  stage 4m  N-speaker CycleVAE training (a random conversion pair per
            cycle; K2 and K3 in the train steps, K1 in the eval epochs)
  stage 5m  per-direction GV calibration (N directions per utterance in one
            batched decode; K1)
  stage 6m  eval decode over every ordered direction + interpolation demo
            (runs 5m inline first if the model is uncalibrated; K1)

Usage:
  python -m cyclevae_tpu_torch.pipeline.recipe_mult --work W --wav-root R \\
      --src-speakers VCC2SF1 --trg-speakers VCC2TF1 VCC2TF2 --stage 3456
(stages 1/2 are shared with the one-to-one recipe: run them per speaker
first with ``python -m cyclevae_tpu_torch --stage 12``.)  The device stages
run on the current CUDA device unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from ..utils.config import ExperimentConfig, load_config
from ..utils.device import resolve_device
from .recipe import RecipePaths


def run_mult_stages(stages: str, exp: ExperimentConfig, paths: RecipePaths,
                    spk_src_list: List[str], spk_trg_list: List[str],
                    conf_dir: Optional[str] = None, device=None):
    """Run the selected stages ("3", "4", "5", "6") over the speakers
    ``spk_src_list + spk_trg_list``.  Stages 5 and 6 load the best epoch of
    ``exp/<name>_m2m/history.json``: a checkpoint of the port's or of the
    JAX package's ``run_train_mult``."""
    device = resolve_device(device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S")
    all_spk = list(spk_src_list) + list(spk_trg_list)
    expdir = os.path.join(paths.work, "exp", exp.name() + "_m2m")

    if "3" in stages:
        from .stats import extract_cv_excitation_mult
        for spk in all_spk:
            partners = {s: paths.stats(s) for s in all_spk if s != spk}
            for eval_set in (False, True):
                files = paths.h5s(spk, eval_set)
                if files:
                    extract_cv_excitation_mult(files, paths.stats(spk), partners,
                                               exp.feature.fs, exp.feature.shiftms)
        logging.info("stage 3m done")

    if "4" in stages:
        from .stats import calc_stats_joint
        from .train_stage_mult import run_train_mult
        # joint stats across ALL speakers' train halves
        train_files, eval_files = [], []
        for spk in all_spk:
            train_files += paths.h5s(spk)[:paths.n_train]
            eval_files += paths.h5s(spk, True)
        stats_jnt = os.path.join(paths.work, "stats", "stats_jnt_mult.npz")
        calc_stats_joint(train_files, [], stats_jnt)
        summary = run_train_mult(exp, train_files, eval_files, spk_src_list, spk_trg_list,
                                 stats_jnt, expdir, device=device)
        logging.info("stage 4m done: %d epochs", len(summary["history"]))

    if "5" not in stages and "6" not in stages:
        return
    from ..interop import params_from_jax
    from ..vi.checkpoint import load_checkpoint
    from .decode import Codec
    from .decode_mult import calc_cvgv_mult, decode_to_speaker, eval_pair_mult, load_cvgv_mult
    from .train_stage import model_config

    with open(os.path.join(expdir, "history.json")) as f:
        epoch = json.load(f)["best"]["epoch"]
    ckpt = load_checkpoint(os.path.join(expdir, f"checkpoint-{epoch}.pkl"))
    cfg = dataclasses.replace(model_config(exp), n_spk=len(all_spk))
    codec = Codec(params_from_jax(ckpt["params"], device), cfg, device=device)
    model_id = f"{exp.name()}_m2m_ep{epoch}"

    def calibrate():
        calc_cvgv_mult(codec, paths, all_spk, model_id,
                       torch.Generator(device=device).manual_seed(5))

    if "5" in stages:
        # stage 5m: per-direction GV calibration over training data
        calibrate()
        logging.info("stage 5m done")

    if "6" in stages:
        # every ordered speaker direction over the parallel eval sets, DTW
        # MCD vs the target utterance (the one-to-one stage-6 metric
        # contract on the N-speaker path), then the interpolation demo
        if load_cvgv_mult(paths, all_spk[0], all_spk[-1], model_id) is None:
            # decode alone on an uncalibrated model: run stage 5m inline so
            # the GV postfilter uses the calibrated per-direction stats
            calibrate()
        outdir = os.path.join(expdir, f"wav_m2m_ep{epoch}")
        generator = torch.Generator(device=device).manual_seed(4242)
        per_dir: dict = {}
        for src_spk in all_spk:
            for trg_spk in all_spk:
                if trg_spk == src_spk:
                    continue
                pairs = list(zip(paths.wavs(src_spk, eval_set=True),
                                 paths.wavs(trg_spk, eval_set=True)))
                mets = [eval_pair_mult(codec, exp, paths, ws, wt, src_spk, trg_spk, all_spk,
                                       outdir=outdir if i < 3 else None, generator=generator,
                                       conf_dir=conf_dir, model_id=model_id)
                        for i, (ws, wt) in enumerate(pairs)]
                if not mets:  # no eval wavs for this direction
                    continue
                d = {k: float(np.mean([m[k] for m in mets])) for k in mets[0]}
                d.update({f"{k}_std": float(np.std([m[k] for m in mets])) for k in mets[0]})
                per_dir[f"{src_spk}-{trg_spk}"] = d

        # interpolation demo: the first eval utterance of the first speaker
        # swept through speaker space (BASELINE.json north-star config 5)
        demo_wav = paths.wavs(all_spk[0], eval_set=True)[0]
        for w0 in (0.75, 0.5, 0.25):
            decode_to_speaker(codec, exp, paths, demo_wav, all_spk[0], all_spk,
                              [w0, 1.0 - w0] + [0.0] * (len(all_spk) - 2), outdir,
                              conf_dir=conf_dir)

        if not per_dir:  # no ordered direction had eval wavs
            logging.warning("stage 6m: no eval pairs in any direction; "
                            "skipping decode_metrics aggregate")
            return
        overall = {k: float(np.mean([d[k] for d in per_dir.values()]))
                   for k in next(iter(per_dir.values())) if not k.endswith("_std")}
        agg = {"per_direction": per_dir, "overall": overall, "epoch": epoch}
        with open(os.path.join(expdir, f"decode_metrics_m2m_ep{epoch}.json"), "w") as f:
            json.dump(agg, f, indent=2)
        logging.info("stage 6m done: overall %s", {k: round(v, 3) for k, v in overall.items()})


def main(argv=None):
    p = argparse.ArgumentParser(prog="cyclevae_tpu_torch.pipeline.recipe_mult",
                                description="many-to-many CycleVAE recipe (PyTorch / CUDA)")
    p.add_argument("--stage", default="34", help="stages to run (e.g. 3456)")
    p.add_argument("--work", required=True, help="working directory of stages 1-2")
    p.add_argument("--src-speakers", nargs="+", required=True)
    p.add_argument("--trg-speakers", nargs="+", required=True)
    p.add_argument("--config", default=None, help="experiment config json")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n-train", type=int, default=40)
    p.add_argument("--wav-root", required=True,
                   help="wav corpus: <spk>/*.wav and eval/<spk>/*.wav (stage 6 reads eval wavs)")
    p.add_argument("--conf-dir", default=None, help="dir with <spk>.f0/<spk>.pow")
    p.add_argument("--device", default=None,
                   help="torch device of stages 4, 5 and 6 (default: the current CUDA "
                        "device; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)
    exp = load_config(args.config) if args.config else ExperimentConfig()
    if args.epochs is not None:
        exp.train.epoch_count = args.epochs
    exp.model.n_spk = len(args.src_speakers) + len(args.trg_speakers)
    paths = RecipePaths(wav_root=args.wav_root, work=args.work, n_train=args.n_train)
    run_mult_stages(args.stage, exp, paths, args.src_speakers, args.trg_speakers,
                    conf_dir=args.conf_dir, device=args.device)


if __name__ == "__main__":
    main()
