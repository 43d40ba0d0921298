"""Neural-vocoder synthesis of CycleVAE-converted features.

Port of the JAX package's ``tools/vocode_converted.py``: takes stage 6's
converted features (posterior-mean encode and target-code decode through
``device_decode_pair``, K1 twice a pair; ``mod_pow``, the GV postfilter,
``mod_pow`` again; the log-Gaussian F0 transform), renders them with the
trained WaveRNN (``synthesize_vocoder``, K4 once a pair; or with
``--vocoder pwg`` a Parallel WaveGAN generator, its layer kernel 30 times a
pair) and with WORLD's ``_GV`` path, and re-analyses both renderings:

  mcd_cv_voc    DTW MCD of the re-analysed NEURAL-vocoded conversion vs the
                natural target utterance
  mcd_cv_world  the same metric for the WORLD-synthesized ``_GV`` rendering
  f0_rel_err    voiced median relative F0 error of the vocoded wav vs the
                converted-F0 target trajectory

The conditioning follows the vocoder's training layout
(``pipeline/decode._feat_from_wav``): [uv, log cont-F0-lpf, codeap, mcep]
with the converted F0 and the GV-postfiltered converted mceps in place of
the naturals.  Each pair's posterior draws come from a generator seeded
777 + its index (the JAX tool splits its key 777 per pair; the draws
cannot match JAX's).

    python -m cyclevae_tpu_torch.tools.vocode_converted --work W --wav-root R \\
        --config exp.json --vocoder-exp W/exp/vocoder_<spk>_hu896 [--device cpu]

With ``--vocoder pwg``, ``--vocoder-exp`` is a checkpoint of
kan-bayashi/ParallelWaveGAN (its ``["model"]["generator"]``, or a plain
generator state dict; a directory: its newest ``checkpoint-*.pkl``), weight
norm folded at load (``models.pwg.from_state_dict``); its hop (v1's 256)
must be the recipe's frame shift in samples (11.61 ms at 22.05 kHz), as PWG
upsamples by an integer factor only.

Writes ``--out`` (default ``<expdir>/vocode_converted_ep<N>.json``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from ._common import add_device_arg, device_entry, kernel_launches, launches_since
from ._common import resolve_device, write_json
from ..ops.cuda_pwg import cuda_pwg_layer
from ..pipeline.decode import device_decode_pair


def load_vocoder(args, fcfg, dev):
    """(params, config) of the vocoder ``args`` name: the WaveRNN from either
    package's checkpoint, or a Parallel WaveGAN generator (v1's widths) from
    a ParallelWaveGAN checkpoint, its hop checked against the frame shift."""
    from ..interop import wavernn_params_from_jax
    from ..models.pwg import PWGConfig, from_state_dict
    from ..models.wavernn import WaveRNNConfig
    from ..vi.checkpoint import latest_checkpoint, load_checkpoint

    if args.vocoder == "wavernn":
        vcfg = WaveRNNConfig(hidden_units=args.hidden_units, n_spk=args.n_spk, dual=args.dual)
        return wavernn_params_from_jax(
            load_checkpoint(latest_checkpoint(args.vocoder_exp))["params"], device=dev), vcfg
    vcfg = PWGConfig(fs=fcfg.fs)
    if abs(fcfg.fs * fcfg.shiftms / 1000.0 - vcfg.hop) > 1e-6:
        raise ValueError(f"the PWG generator's hop ({vcfg.hop} samples) is not the frame shift "
                         f"({fcfg.shiftms} ms at {fcfg.fs} Hz): PWG upsamples by an integer "
                         "factor only")
    path = args.vocoder_exp
    if os.path.isdir(path):
        found = sorted(f for f in os.listdir(path)
                       if f.startswith("checkpoint-") and f.endswith(".pkl"))
        if not found:
            raise FileNotFoundError(f"no checkpoint-*.pkl in {path}")
        path = os.path.join(path, max(found, key=lambda f: os.path.getmtime(
            os.path.join(path, f))))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", {}).get("generator", sd)
    return from_state_dict(sd, vcfg, device=dev), vcfg


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", required=True)
    p.add_argument("--config", required=True, help="CycleVAE experiment json (model.json)")
    p.add_argument("--vocoder-exp", required=True,
                   help="trained vocoder expdir (checkpoint-latest.pkl)")
    p.add_argument("--hidden-units", type=int, default=896)
    p.add_argument("--wav-root", required=True)
    p.add_argument("--n-train", type=int, default=40)
    p.add_argument("--n-eval", type=int, default=5)
    p.add_argument("--epoch", type=int, default=None, help="CycleVAE epoch (default: best)")
    p.add_argument("--temperature", type=float, default=0.8,
                   help="sampling temperature (0.8 is the copy-synthesis sweet spot)")
    p.add_argument("--n-spk", type=int, default=0,
                   help="vocoder speaker-code width (multispk model)")
    p.add_argument("--spk-id", type=int, default=1,
                   help="speaker code for rendering (multispk training order is "
                        "[spk_src, spk_trg]; conversion targets spk_trg = 1)")
    p.add_argument("--dual", action="store_true",
                   help="the vocoder has the dual coarse/fine 16-bit output")
    p.add_argument("--vocoder", choices=("wavernn", "pwg"), default="wavernn",
                   help="the neural vocoder: the WaveRNN, or a Parallel WaveGAN generator")
    p.add_argument("--out", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S")

    from ..dsp import dtw as dtw_c
    from ..dsp import sptk, world
    from ..pipeline.decode import Codec, _feat_from_wav, analyze_pair, gv_postfilter
    from ..pipeline.features import convert_f0, mod_pow
    from ..pipeline.recipe import RecipePaths, _read_spk_conf
    from ..pipeline.train_stage import model_config
    from ..pipeline.vocoder_stage import converted_conditioning, synthesize_vocoder
    from ..utils.config import load_config
    from ..utils.store import read_store
    from ..utils.wavio import write_wav
    from ..vi.checkpoint import load_checkpoint
    from ..vi.train import CycleVAEParams

    exp = load_config(args.config)
    paths = RecipePaths(wav_root=args.wav_root, work=args.work, n_train=args.n_train)
    spk_src, spk_trg = exp.model.spk_src, exp.model.spk_trg
    sc_src = _read_spk_conf(None, spk_src)
    sc_trg = _read_spk_conf(None, spk_trg)

    # --- frozen CycleVAE at its best epoch + stage-5 GV calibration -------
    expdir = os.path.join(paths.work, "exp", exp.name())
    epoch = args.epoch
    if epoch is None:
        with open(os.path.join(expdir, "history.json")) as f:
            epoch = json.load(f)["best"]["epoch"]
    ckpt = load_checkpoint(os.path.join(expdir, f"checkpoint-{epoch}.pkl"))
    codec = Codec(CycleVAEParams(*ckpt["params"]), model_config(exp), device=dev)
    model_id = f"{exp.name()}_ep{epoch}"
    f0stats = {
        "lf0_mean_src": float(read_store(paths.stats(spk_src), "lf0_range_mean")),
        "lf0_std_src": float(read_store(paths.stats(spk_src), "lf0_range_std")),
        "lf0_mean_trg": float(read_store(paths.stats(spk_trg), "lf0_range_mean")),
        "lf0_std_trg": float(read_store(paths.stats(spk_trg), "lf0_range_std")),
    }
    gv_mean_trg = read_store(paths.stats(spk_trg), "gv_range_mean")[1:]
    cvgv_mean = read_store(paths.stats(spk_src), f"cvgv_mean_{model_id}")

    # --- trained neural vocoder (either package's checkpoint) -------------
    fcfg = exp.feature
    vparams, vcfg = load_vocoder(args, fcfg, dev)
    temperature = 1.0 if args.vocoder == "pwg" else args.temperature
    outdir = os.path.join(expdir, f"wav_cv_vocoded_ep{epoch}")
    os.makedirs(outdir, exist_ok=True)

    pairs = list(zip(paths.wavs(spk_src, eval_set=True),
                     paths.wavs(spk_trg, eval_set=True)))[:args.n_eval]
    before = kernel_launches()
    before_pwg = cuda_pwg_layer.launches
    mets = []
    for i, (ws, wt) in enumerate(pairs):
        ana = analyze_pair(exp, ws, wt, sc_src.minf0, sc_src.maxf0,
                           sc_trg.minf0, sc_trg.maxf0,
                           sc_src.pow_threshold, sc_trg.pow_threshold)
        fs, src, trg = ana["fs"], ana["src"], ana["trg"]
        assert fs == fcfg.fs, (fs, fcfg.fs)
        gen = torch.Generator(device=dev).manual_seed(777 + i)
        _, _, cvmcep, _, _ = device_decode_pair(codec, gen, src["feat"], trg["feat"])
        # stage 6's post-processing chain for the `_GV` rendering
        cvmcep = mod_pow(cvmcep, src["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)
        cvmcep_gv = gv_postfilter(cvmcep, gv_mean_trg, cvgv_mean)
        cvmcep_gv = mod_pow(cvmcep_gv, src["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)
        cvf0 = convert_f0(src["f0"], f0stats["lf0_mean_src"], f0stats["lf0_std_src"],
                          f0stats["lf0_mean_trg"], f0stats["lf0_std_trg"])

        # converted conditioning in the training layout
        feat_cv = converted_conditioning(src["feat"], cvmcep_gv, cvf0, fcfg.shiftms)

        # vocoder samples are [-1, 1]; host IO/analysis are int16-scale
        y = synthesize_vocoder(vparams, vcfg, feat_cv, seed=i, temperature=temperature,
                               spk_id=args.spk_id if args.n_spk else None,
                               device=dev) * 32768.0
        base = os.path.splitext(os.path.basename(ws))[0]
        write_wav(os.path.join(outdir, f"{base}_GVvoc.wav"), fs, y.astype(np.float32))

        # --- re-analysis metrics: neural vs WORLD rendering ---------------
        m = {}
        mcep_trg_spc = trg["mcep"][trg["spcidx"]].astype(np.float64)
        re = _feat_from_wav(y.astype(np.float64), fs, sc_trg.minf0, sc_trg.maxf0,
                            sc_trg.pow_threshold, fcfg)
        re_spc = re["mcep"][re["spcidx"]].astype(np.float64)
        _, _, m["mcdpow_cv_voc"], _ = dtw_c.dtw_org_to_trg(re_spc, mcep_trg_spc)
        _, _, m["mcd_cv_voc"], _ = dtw_c.dtw_org_to_trg(re_spc[:, 1:], mcep_trg_spc[:, 1:])

        cvsp = sptk.mc2sp(cvmcep_gv, fcfg.mcep_alpha, fcfg.fftl)
        yw = world.synthesize(cvf0, cvsp, src["ap"], fs, frame_period=fcfg.shiftms)
        rew = _feat_from_wav(yw.astype(np.float64), fs, sc_trg.minf0, sc_trg.maxf0,
                             sc_trg.pow_threshold, fcfg)
        rew_spc = rew["mcep"][rew["spcidx"]].astype(np.float64)
        _, _, m["mcdpow_cv_world"], _ = dtw_c.dtw_org_to_trg(rew_spc, mcep_trg_spc)
        _, _, m["mcd_cv_world"], _ = dtw_c.dtw_org_to_trg(rew_spc[:, 1:], mcep_trg_spc[:, 1:])

        n = min(len(cvf0), len(re["f0"]))
        v = (cvf0[:n] > 0) & (re["f0"][:n] > 0)
        m["f0_rel_err_median"] = float(np.median(
            np.abs(re["f0"][:n][v] - cvf0[:n][v]) / cvf0[:n][v])) if v.any() else float("nan")
        m["uv_agree"] = float(np.mean((cvf0[:n] > 0) == (re["f0"][:n] > 0)))
        mets.append(m)
        logging.info("vocoded conversion %s: %s", base, {k: round(v, 3) for k, v in m.items()})

    agg = {k: float(np.mean([m[k] for m in mets])) for k in mets[0]}
    agg.update({f"{k}_std": float(np.std([m[k] for m in mets])) for k in mets[0]})
    launches = launches_since(before)
    if args.vocoder == "pwg":
        launches["PWG"] = cuda_pwg_layer.launches - before_pwg
    summary = {"model": model_id, "vocoder_exp": args.vocoder_exp,
               "temperature": temperature, "n_eval": len(mets), "metrics": agg,
               "device": device_entry(dev), "launches": launches}
    out_path = args.out or os.path.join(expdir, f"vocode_converted_ep{epoch}.json")
    write_json(out_path, summary, indent=2)
    logging.info("vocode_converted: %s", json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
