"""Train the WaveRNN vocoder on one speaker's natural wav/feature pairs, then
measure copy-synthesis quality on held-out eval utterances: re-analyse the
vocoded waveform and report DTW MCD against the original mel-cepstra plus
the voiced-F0 relative error.

Port of the JAX package's ``tools/train_eval_vocoder.py``: training by
``pipeline.vocoder_stage.run_train_vocoder`` (a cuDNN GRU on the card),
copy synthesis by ``eval_copy_synthesis`` (K4).  ``--wav-root`` (holding
``<spk>/*.wav`` and ``eval/<spk>/*.wav``) is required; stages 1-2 of the
recipe must have written the speaker's features under ``--work``.

    python -m cyclevae_tpu_torch.tools.train_eval_vocoder --work W --wav-root R \\
        --speaker SPK [--epochs 60 --n-train 40 --n-eval 5] [--device cpu]

Writes ``--out`` (default ``<work>/exp/vocoder_<spk>_hu<H>/vocoder_eval.json``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ._common import add_device_arg, device_entry, kernel_launches, launches_since
from ._common import resolve_device, write_json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", required=True)
    p.add_argument("--speaker", default="VCC2TF1")
    p.add_argument("--wav-root", required=True)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--n-train", type=int, default=40)
    p.add_argument("--n-eval", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--clip-frames", type=int, default=24)
    p.add_argument("--hidden-units", type=int, default=896)
    p.add_argument("--eval-only", action="store_true",
                   help="skip training; evaluate checkpoint-latest.pkl")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--lr-decay", action="store_true",
                   help="cosine-decay the lr to lr/10 over the run")
    p.add_argument("--resume", default=None, help="checkpoint to resume training from")
    p.add_argument("--out", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S")

    from ..interop import wavernn_params_from_jax
    from ..models.wavernn import WaveRNNConfig
    from ..pipeline.recipe import RecipePaths, _read_spk_conf
    from ..pipeline.vocoder_stage import eval_copy_synthesis, run_train_vocoder
    from ..utils.config import ExperimentConfig
    from ..vi.checkpoint import latest_checkpoint, load_checkpoint

    spk = args.speaker
    paths = RecipePaths(wav_root=args.wav_root, work=args.work, n_train=args.n_train)
    exp = ExperimentConfig()
    sc = _read_spk_conf(None, spk)

    wavs = paths.wavs(spk)[:args.n_train]
    feats = paths.h5s(spk)[:args.n_train]
    if not (len(wavs) == len(feats) and wavs):
        raise RuntimeError("run stages 1-2 first: no wav/feature pairs for " + spk)

    cfg = WaveRNNConfig(hidden_units=args.hidden_units)
    expdir = os.path.join(args.work, "exp", f"vocoder_{spk}_hu{cfg.hidden_units}")
    before = kernel_launches()
    if args.eval_only:
        # either package's checkpoint: the same nested dict, torch layout
        params = wavernn_params_from_jax(load_checkpoint(latest_checkpoint(expdir))["params"],
                                         device=dev)
        final_nll = float("nan")
    else:
        res = run_train_vocoder(cfg, wavs, feats, expdir, epochs=args.epochs,
                                batch_size=args.batch_size, clip_frames=args.clip_frames,
                                lr_decay=args.lr_decay, resume=args.resume, device=dev)
        params = res["params"]
        final_nll = res["history"][-1]["nll"]

    # --- copy-synthesis quality on held-out eval utterances ---------------
    eval_wavs = paths.wavs(spk, eval_set=True)[:args.n_eval]
    agg = eval_copy_synthesis(params, cfg, exp, eval_wavs, sc,
                              os.path.join(expdir, "wav_vocoded"),
                              temperature=args.temperature, device=dev)
    summary = {"speaker": spk, "epochs": args.epochs, "final_nll": final_nll,
               "n_eval": len(eval_wavs), "temperature": args.temperature,
               "copy_synthesis": agg, "device": device_entry(dev),
               "launches": launches_since(before)}
    out_path = args.out or os.path.join(expdir, "vocoder_eval.json")
    write_json(out_path, summary, indent=2)
    logging.info("vocoder eval: %s", json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
