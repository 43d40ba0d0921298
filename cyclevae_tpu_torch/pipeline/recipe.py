"""Recipe orchestrator: the reference's egs/one-to-one/run.sh as a typed
Python driver (stages selected by substring, run.sh:209-638).

PyTorch counterpart of ``cyclevae_tpu/pipeline/recipe.py``, over the port's
feature store (``.npz`` files; :mod:`cyclevae_tpu_torch.utils.store`).  The
device stages (4, 5, 6, i, v) run on ``device``: CUDA unless the caller passes
``device="cpu"`` (``--device cpu``); without a CUDA device they raise.

Stages:
  1  feature extraction (train + eval, both speakers; host processes)
  a  speaker F0/power statistics (histograms + suggested bounds)
  2  per-speaker + joint statistics
  3  converted excitation
  4  CycleVAE training (K2 and K3 in the train steps, K1 in the eval epochs)
  5  GV calibration (cvgv; K1)
  6  decode eval utterances to waveforms (K1)
  i  posterior inference over eval latents (HMC: K2 and K3; the
     posterior predictive: K1)
  v  neural-vocoder training (a cuDNN GRU) + copy-synthesis eval (K4)
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.config import ExperimentConfig, load_config
from ..utils.device import resolve_device
from ..utils.prefetch import BackgroundGenerator
from ..utils.store import find_files, read_store


@dataclass
class SpeakerConf:
    """Per-speaker analysis bounds (reference conf/<spk>.f0 / conf/<spk>.pow)."""
    minf0: float
    maxf0: float
    pow_threshold: float


# bundled VCC2018 speaker settings (reference egs/one-to-one/conf/)
DEFAULT_SPEAKERS: Dict[str, SpeakerConf] = {
    "VCC2SF1": SpeakerConf(130.0, 427.0, -40.0),
    "VCC2SF2": SpeakerConf(121.0, 341.0, -35.5),
    "VCC2SF3": SpeakerConf(132.0, 318.0, -45.0),
    "VCC2SF4": SpeakerConf(125.0, 360.0, -36.0),
    "VCC2SM1": SpeakerConf(60.0, 199.0, -34.5),
    "VCC2SM2": SpeakerConf(86.0, 275.0, -35.0),
    "VCC2SM3": SpeakerConf(58.0, 210.0, -38.5),
    "VCC2SM4": SpeakerConf(57.0, 247.0, -34.5),
    "VCC2TF1": SpeakerConf(138.0, 343.0, -45.5),
    "VCC2TF2": SpeakerConf(127.0, 400.0, -35.0),
    "VCC2TM1": SpeakerConf(64.0, 220.0, -29.0),
    "VCC2TM2": SpeakerConf(85.0, 265.0, -35.5),
    "bdl": SpeakerConf(61.0, 257.0, -28.0),
    "slt": SpeakerConf(132.0, 325.0, -28.5),
}


@dataclass
class RecipePaths:
    wav_root: str                  # contains <spk>/ and eval/<spk>/
    work: str                      # output root (features/stats/exp)
    n_train: int = 40              # first N wavs per speaker = train set

    def wavs(self, spk: str, eval_set: bool = False) -> List[str]:
        d = os.path.join(self.wav_root, "eval", spk) if eval_set else \
            os.path.join(self.wav_root, spk)
        return sorted(find_files(d, "*.wav"))

    # the feature files keep the JAX recipe's method names (h5dir, h5s) so
    # the two recipes read line for line; here they are .npz files
    def h5dir(self, spk: str, eval_set: bool = False) -> str:
        # NOTE: the parent directory name IS the speaker identity (the
        # datasets' code-assignment contract, reference dataset.py:75-80):
        # eval sets therefore live under eval/<spk>/, never eval_<spk>/
        sub = os.path.join("eval", spk) if eval_set else spk
        return os.path.join(self.work, "hdf5", sub)

    def h5s(self, spk: str, eval_set: bool = False) -> List[str]:
        return sorted(find_files(self.h5dir(spk, eval_set), "*.npz"))

    def stats(self, spk: str) -> str:
        return os.path.join(self.work, "stats", f"stats_{spk}.npz")

    def stats_jnt(self) -> str:
        return os.path.join(self.work, "stats", "stats_jnt.npz")


def _read_spk_conf(conf_dir: Optional[str], spk: str) -> SpeakerConf:
    if conf_dir:
        f0p = os.path.join(conf_dir, f"{spk}.f0")
        powp = os.path.join(conf_dir, f"{spk}.pow")
        if os.path.exists(f0p) and os.path.exists(powp):
            with open(f0p) as f:
                mn, mx = f.read().split()
            with open(powp) as f:
                pw = float(f.read().strip())
            return SpeakerConf(float(mn), float(mx), pw)
    return DEFAULT_SPEAKERS.get(spk, SpeakerConf(40.0, 700.0, -20.0))


def run_stages(stages: str, exp: ExperimentConfig, paths: RecipePaths,
               conf_dir: Optional[str] = None, n_jobs: int = 8,
               decode_epoch: Optional[int] = None,
               vocoder_epochs: int = 300, vocoder_clip_frames: int = 96,
               vocoder_n_eval: int = 5, vocoder_hidden_units: int = 896,
               vocoder_resume: str = None,
               vocoder_temperature: float = 0.8,
               vocoder_multispk: bool = False,
               vocoder_lr_decay: bool = False, vocoder_dual: bool = False, device=None):
    device = resolve_device(device)
    spk_src = exp.model.spk_src
    spk_trg = exp.model.spk_trg
    speakers = [spk_src, spk_trg]
    expdir = os.path.join(paths.work, "exp", exp.name())
    os.makedirs(expdir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S")

    def split(files):
        return files[:paths.n_train], files[paths.n_train:]

    # Reference split semantics (run.sh:222-237): the SOURCE speaker trains on
    # the FIRST n_train utterances, the TARGET speaker on the REMAINING tail:
    # disjoint sentence sets, so training is truly non-parallel.  The opposite
    # half of each speaker provides the sentence-parallel counterpart used
    # ONLY for eval-time DTW alignment (train_src_trg / train_trg_src).
    def train_lists():
        src_head, src_tail = split(paths.h5s(spk_src))
        trg_head, trg_tail = split(paths.h5s(spk_trg))
        n_head = min(len(src_head), len(trg_head))
        n_tail = min(len(src_tail), len(trg_tail))
        return {
            "train_src": src_head[:n_head],
            "train_src_pair": trg_head[:n_head],   # same sentences, trg voice
            "train_trg": trg_tail[:n_tail],
            "train_trg_pair": src_tail[:n_tail],   # same sentences, src voice
        }

    if "1" in stages:
        from .features import extract_features
        for spk in speakers:
            sc = _read_spk_conf(conf_dir, spk)
            for eval_set in (False, True):
                wavs = paths.wavs(spk, eval_set)
                if not wavs:
                    continue
                wavdir = None if eval_set else os.path.join(
                    paths.work, "wav_anasyn", spk)
                n_files, n_frames = extract_features(
                    wavs, paths.h5dir(spk, eval_set), wavdir, exp.feature,
                    sc.minf0, sc.maxf0, sc.pow_threshold, n_jobs=n_jobs)
                if n_files != len(wavs):
                    raise RuntimeError(f"stage 1 extracted {n_files} of {len(wavs)} wavs")
                logging.info("stage 1 %s eval=%s: %d files %d frames",
                             spk, eval_set, n_files, n_frames)

    if "a" in stages:
        from .stats import spk_stat
        for spk in speakers:
            sugg = spk_stat(paths.h5s(spk), os.path.join(paths.work,
                                                         "init_spk_stat"), spk)
            logging.info("stage a %s suggested conf: %s", spk, sugg)

    if "2" in stages:
        from .stats import calc_stats, calc_stats_joint
        tl = train_lists()
        calc_stats(tl["train_src"], paths.stats(spk_src), spkr=spk_src)
        calc_stats(tl["train_trg"], paths.stats(spk_trg), spkr=spk_trg)
        calc_stats_joint(tl["train_src"], tl["train_trg"], paths.stats_jnt())
        logging.info("stage 2 done: %s", paths.stats_jnt())

    if "3" in stages:
        from .stats import extract_cv_excitation
        # every utterance of each speaker gets converted excitation toward the
        # partner (train + pair + eval sets; reference run.sh stage 3)
        for spk, other in ((spk_src, spk_trg), (spk_trg, spk_src)):
            for eval_set in (False, True):
                files = paths.h5s(spk, eval_set)
                if files:
                    extract_cv_excitation(files, paths.stats(spk),
                                          paths.stats(other), exp.feature.fs,
                                          exp.feature.shiftms)
        logging.info("stage 3 done")

    if "4" in stages:
        from .train_stage import run_train
        tl = train_lists()
        # CYCLEVAE_N_EVAL truncates the per-speaker eval lists (the
        # reference has no eval-subset knob; keeps per-epoch eval cheap over
        # long schedules; both recipes must see the SAME eval files)
        n_eval = int(os.environ.get("CYCLEVAE_N_EVAL", "0"))
        eval_src = paths.h5s(spk_src, True)
        eval_trg = paths.h5s(spk_trg, True)
        if n_eval > 0:
            eval_src, eval_trg = eval_src[:n_eval], eval_trg[:n_eval]
        summary = run_train(
            exp,
            feats_src=tl["train_src"], feats_src_pair=tl["train_src_pair"],
            feats_trg=tl["train_trg"], feats_trg_pair=tl["train_trg_pair"],
            feats_eval_src=eval_src,
            feats_eval_trg=eval_trg,
            stats_src=paths.stats(spk_src), stats_trg=paths.stats(spk_trg),
            stats_jnt=paths.stats_jnt(), expdir=expdir,
            resume=exp.train.resume, device=device)
        logging.info("stage 4 done: best=%s", summary["best"])

    if "5" in stages or "6" in stages or "i" in stages:
        from ..vi.checkpoint import load_checkpoint
        from .decode import Codec
        from .train_stage import model_config

        epoch = decode_epoch
        if epoch is None:
            with open(os.path.join(expdir, "history.json")) as f:
                epoch = json.load(f)["best"]["epoch"]
        ckpt = load_checkpoint(os.path.join(expdir, f"checkpoint-{epoch}.pkl"))
        codec = Codec(ckpt["params"], model_config(exp), device=device)
        model_id = f"{exp.name()}_ep{epoch}"

        if "5" in stages:
            from .decode import calc_cvgv
            tl = train_lists()
            out = calc_cvgv(codec, exp,
                            torch.Generator(device=device).manual_seed(decode_epoch or 0),
                            tl["train_src"], tl["train_trg"],
                            paths.stats(spk_src), model_id)
            logging.info("stage 5 done: %s",
                         {k: v.mean() for k, v in out.items()})

        if "6" in stages:
            from .decode import analyze_pair, decode_pair
            sc_src = _read_spk_conf(conf_dir, spk_src)
            sc_trg = _read_spk_conf(conf_dir, spk_trg)
            f0stats = {
                "lf0_mean_src": float(read_store(paths.stats(spk_src), "/lf0_range_mean")),
                "lf0_std_src": float(read_store(paths.stats(spk_src), "/lf0_range_std")),
                "lf0_mean_trg": float(read_store(paths.stats(spk_trg), "/lf0_range_mean")),
                "lf0_std_trg": float(read_store(paths.stats(spk_trg), "/lf0_range_std")),
            }
            gv = {
                "gv_mean_src": read_store(paths.stats(spk_src), "/gv_range_mean")[1:],
                "gv_mean_trg": read_store(paths.stats(spk_trg), "/gv_range_mean")[1:],
                "cvgv_mean": read_store(paths.stats(spk_src), f"/cvgv_mean_{model_id}"),
                "cvgvsrc_mean": read_store(paths.stats(spk_src), f"/cvgvsrc_mean_{model_id}"),
                "cvgvtrg_mean": read_store(paths.stats(spk_src), f"/cvgvtrg_mean_{model_id}"),
            }
            outdir = os.path.join(expdir, f"wav_cv_ep{epoch}")
            wavs_src = paths.wavs(spk_src, eval_set=True)
            wavs_trg = paths.wavs(spk_trg, eval_set=True)
            pairs = list(zip(wavs_src, wavs_trg))
            # one generator per pair, so a pair's draws do not depend on
            # which thread decodes it or when
            gens = [torch.Generator(device=device).manual_seed(4242 + i)
                    for i in range(len(pairs))]
            # producer/consumer pipeline (reference fans whole decodes over
            # n_gpus processes, decode…py:552-602; here one device is shared):
            # analysis prefetches on worker threads (C++ DSP releases the
            # GIL) ahead of the decode pool; decode_pair's device calls take
            # the codec's lock, one request at a time, while the host
            # DSP/metric tails of other pairs run concurrently: device decode
            # of pair i overlaps analysis of i+1.. and synthesis of i-1..
            n_workers = max(2, min(n_jobs, 8))
            lookahead = 4
            ana_pool = ThreadPoolExecutor(max_workers=max(1, n_workers // 2))

            def ana_gen():
                # bounded lookahead: at most `lookahead` analyses in flight
                pending = deque()
                for ws, wt in pairs:
                    pending.append(ana_pool.submit(
                        analyze_pair, exp, ws, wt, sc_src.minf0,
                        sc_src.maxf0, sc_trg.minf0, sc_trg.maxf0,
                        sc_src.pow_threshold, sc_trg.pow_threshold))
                    if len(pending) >= lookahead:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()

            if os.environ.get("CYCLEVAE_PREFETCH", "1") == "0":
                # sequential baseline (A/B knob for the overlap pipeline):
                # analyze -> decode -> synthesize one pair at a time
                ana_pool.shutdown(wait=False)
                all_metrics = [
                    decode_pair(codec, exp, gens[i], ws, wt, outdir,
                                f0stats, gv, sc_src.minf0, sc_src.maxf0,
                                sc_trg.minf0, sc_trg.maxf0,
                                sc_src.pow_threshold, sc_trg.pow_threshold,
                                analysis=analyze_pair(
                                    exp, ws, wt, sc_src.minf0, sc_src.maxf0,
                                    sc_trg.minf0, sc_trg.maxf0,
                                    sc_src.pow_threshold,
                                    sc_trg.pow_threshold))
                    for i, (ws, wt) in enumerate(pairs)]
            else:
                analyses = BackgroundGenerator(ana_gen(), max_prefetch=2)
                try:
                    with ThreadPoolExecutor(max_workers=n_workers) as syn_pool:
                        futs = []
                        for i, analysis in enumerate(analyses):
                            ws, wt = pairs[i]
                            futs.append(syn_pool.submit(
                                decode_pair, codec, exp, gens[i], ws, wt,
                                outdir, f0stats, gv, sc_src.minf0,
                                sc_src.maxf0, sc_trg.minf0, sc_trg.maxf0,
                                sc_src.pow_threshold, sc_trg.pow_threshold,
                                analysis=analysis))
                        all_metrics = [f.result() for f in futs]
                finally:
                    ana_pool.shutdown(wait=False, cancel_futures=True)
            agg = {k: float(np.mean([m[k] for m in all_metrics]))
                   for k in all_metrics[0]}
            agg_std = {f"{k}_std": float(np.std([m[k] for m in all_metrics]))
                       for k in all_metrics[0]}
            agg.update(agg_std)
            with open(os.path.join(expdir, f"decode_metrics_ep{epoch}.json"),
                      "w") as f:
                json.dump(agg, f, indent=2)
            logging.info("stage 6 done: %s", {k: round(v, 3)
                                              for k, v in agg.items()})

        if "i" in stages:
            # posterior-inference stage (no reference counterpart): HMC
            # posterior over eval utterance latents + posterior-predictive
            # conversion stats written to posterior_ep<epoch>.npz
            from .infer_stage import run_infer_stage
            out_path = os.path.join(expdir, f"posterior_ep{epoch}.npz")
            res = run_infer_stage(codec.params, codec.cfg, paths.h5s(spk_src, True)[:4],
                                  out_path)
            logging.info("stage i done: %s", res)

    if "v" in stages:
        # neural-vocoder stage (the reference defines the data surface,
        # FeatureDatasetNeuVoco dataset.py:495-563, but ships no trainer):
        # train the target speaker's WaveRNN on its train wav/feature pairs
        # (vocoder_multispk: one model of both speakers' full train+pair sets
        # under one-hot speaker-code conditioning), then score copy-synthesis
        # on held-out eval utterances
        from ..models.wavernn import WaveRNNConfig
        from .vocoder_stage import eval_copy_synthesis, run_train_vocoder
        spks = [spk_src, spk_trg] if vocoder_multispk else [spk_trg]
        vcfg = WaveRNNConfig(hidden_units=vocoder_hidden_units,
                             n_spk=len(spks) if vocoder_multispk else 0, dual=vocoder_dual)
        wavs, feats, spk_ids = [], [], []
        for si, spk in enumerate(spks):
            w, h = paths.wavs(spk), paths.h5s(spk)
            if not vocoder_multispk:
                w, h = w[:paths.n_train], h[:paths.n_train]
            if len(w) != len(h) or not w:
                raise RuntimeError(f"stage v: {len(w)} wavs and {len(h)} feature files of "
                                   f"{spk}: run stage 1 first")
            wavs += w
            feats += h
            spk_ids += [si] * len(w)
        name = "multispk" if vocoder_multispk else spk_trg
        vexpdir = os.path.join(paths.work, "exp", f"vocoder_{name}_hu{vcfg.hidden_units}"
                               + ("_dual" if vocoder_dual else ""))
        res = run_train_vocoder(vcfg, wavs, feats, vexpdir, epochs=vocoder_epochs,
                                clip_frames=vocoder_clip_frames, resume=vocoder_resume,
                                spk_ids=spk_ids if vocoder_multispk else None,
                                lr_decay=vocoder_lr_decay, device=device)
        aggs = {spk: eval_copy_synthesis(
            res["params"], vcfg, exp, paths.wavs(spk, eval_set=True)[:vocoder_n_eval],
            _read_spk_conf(conf_dir, spk),
            os.path.join(vexpdir, f"wav_vocoded_{spk}" if vocoder_multispk else "wav_vocoded"),
            temperature=vocoder_temperature, spk_id=si if vocoder_multispk else None,
            device=device) for si, spk in enumerate(spks) if vocoder_n_eval > 0}
        summary = {"epochs": vocoder_epochs, "final_nll": res["history"][-1]["nll"]}
        if vocoder_multispk:
            summary = {"speakers": spks, **summary, "copy_synthesis": aggs}
        else:
            summary = {"speaker": spk_trg, **summary, "copy_synthesis": aggs.get(spk_trg, {})}
        with open(os.path.join(vexpdir, "vocoder_eval.json"), "w") as f:
            json.dump(summary, f, indent=2)
        logging.info("stage v done: %s", {s: {k: round(v, 3) for k, v in a.items()}
                                          for s, a in aggs.items()})


def main(argv=None):
    p = argparse.ArgumentParser(prog="cyclevae_tpu_torch",
                                description="CycleVAE VC recipe (PyTorch / CUDA)")
    p.add_argument("--stage", default="123456", help="stages to run (e.g. 1a23456)")
    p.add_argument("--wav-root", required=True,
                   help="wav corpus: <spk>/*.wav and eval/<spk>/*.wav")
    p.add_argument("--work", required=True, help="output working directory")
    p.add_argument("--config", default=None, help="experiment config json")
    p.add_argument("--conf-dir", default=None, help="dir with <spk>.f0/<spk>.pow")
    p.add_argument("--n-jobs", type=int, default=8)
    p.add_argument("--n-train", type=int, default=40)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--decode-epoch", type=int, default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume stage-4 training from")
    p.add_argument("--vocoder-epochs", type=int, default=300)
    p.add_argument("--vocoder-clip-frames", type=int, default=96)
    p.add_argument("--vocoder-n-eval", type=int, default=5)
    p.add_argument("--vocoder-hidden-units", type=int, default=896)
    p.add_argument("--vocoder-resume", default=None)
    p.add_argument("--vocoder-temperature", type=float, default=0.8,
                   help="sampling temperature (0.8 = measured sweet spot)")
    p.add_argument("--vocoder-multispk", action="store_true",
                   help="pool both speakers' train+pair sets under one-hot "
                        "speaker-code conditioning (one shared model)")
    p.add_argument("--vocoder-lr-decay", action="store_true",
                   help="cosine lr decay to lr/10 over the run")
    p.add_argument("--vocoder-dual", action="store_true",
                   help="the published WaveRNN's output: 16-bit samples from a coarse and a "
                        "fine 8-bit softmax (default: one mu-law softmax)")
    p.add_argument("--device", default=None,
                   help="torch device of stages 4, 5, 6, i and v (default: the current CUDA "
                        "device; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

    exp = load_config(args.config) if args.config else ExperimentConfig()
    if args.epochs is not None:
        exp.train.epoch_count = args.epochs
    if args.resume is not None:
        exp.train.resume = args.resume
    paths = RecipePaths(wav_root=args.wav_root, work=args.work,
                        n_train=args.n_train)
    # the dual output is the port's alone: its keyword is passed only when
    # asked for, so a command line both recipes take gives the same keywords
    dual = {"vocoder_dual": True} if args.vocoder_dual else {}
    run_stages(args.stage, exp, paths, conf_dir=args.conf_dir,
               n_jobs=args.n_jobs, decode_epoch=args.decode_epoch,
               vocoder_epochs=args.vocoder_epochs,
               vocoder_clip_frames=args.vocoder_clip_frames,
               vocoder_n_eval=args.vocoder_n_eval,
               vocoder_hidden_units=args.vocoder_hidden_units,
               vocoder_resume=args.vocoder_resume,
               vocoder_temperature=args.vocoder_temperature,
               vocoder_multispk=args.vocoder_multispk,
               vocoder_lr_decay=args.vocoder_lr_decay,
               **dual,
               device=args.device)


if __name__ == "__main__":
    main()
