"""Stages 5m and 6m: many-to-many decode, to any target speaker or to an
interpolated point in speaker space.

PyTorch counterpart of ``cyclevae_tpu/pipeline/decode_mult.py`` (the
reference ships no many-to-many decode binary; successor-repo surface):

  wav -> on-the-fly analysis -> encoder posterior-mean latent -> decode with
  the target speaker's one-hot (or soft interpolation weights) -> GV
  postfilter toward the target speaker's data GV -> log-Gaussian F0
  transform (per-speaker stats) -> synthesis.

The device work is the port's ``Codec`` (K1 on CUDA): ``encode_mean`` for
the posterior mean, ``decode`` / ``decode_batch`` for the conversions.  A
``torch.Generator`` on the codec's device takes the place of each JAX key,
as in ``decode.device_decode_pair``: one generator's draws, in call order.

GV handling: ``calc_cvgv_mult`` (stage 5m) calibrates the model GV per
ordered direction over training data: all N directions of one utterance
ride a single ``decode_batch`` (one K1 launch at B = N).  Decodes without a
calibrated ``model_id`` (and soft interpolated codes, which have no fixed
direction) fall back to the utterance-level postfilter
``gv_postfilter_utt``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..dsp import dtw as dtw_c
from ..dsp import sptk, world
from ..utils.config import ExperimentConfig
from ..utils.store import check_store, read_store, write_store
from ..utils.wavio import read_wav, write_wav
from .decode import Codec, _feat_from_wav, _speaker_codes, analyze_pair, speaker_interp_code
from .decode import gv_postfilter as _gv_postfilter
from .features import convert_f0, mod_pow
from .recipe import RecipePaths, _read_spk_conf


def _generator(codec: Codec, generator: Optional[torch.Generator]) -> torch.Generator:
    return (torch.Generator(device=codec.device).manual_seed(0)
            if generator is None else generator)


def calc_cvgv_mult(codec: Codec, paths: RecipePaths, all_speakers: Sequence[str],
                   model_id: str, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """Stage 5m: per-direction GV calibration for the N-speaker model, the
    many-to-many analogue of the one-to-one stage 5 (reference
    calc_cvgv…py:131-362, generalized to N·N ordered directions incl. self-
    reconstruction).

    For every source speaker's TRAINING utterances: one encode +
    posterior-mean call, then ONE batched decode over all N target codes.
    Per-utterance converted-mcep variances are aggregated per direction and
    written into the SOURCE speaker's stats file as
    ``/cvgv_mean_<trg>_<model_id>`` / ``/cvgv_var_<trg>_<model_id>``.
    Each utterance's posterior-mean draws come from ``generator`` (default:
    seeded with 0), in speaker and file order."""
    generator = _generator(codec, generator)
    cfg = codec.cfg
    spk_list = list(all_speakers)
    n = len(spk_list)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for s in spk_list:
        cvlists: List[List[np.ndarray]] = [[] for _ in range(n)]
        for f in paths.h5s(s)[:paths.n_train]:
            feat = read_store(f, "/feat_org_lf0").astype(np.float32)
            with codec.lock:
                _, (z,) = codec.encode_mean(generator, [feat])
                T = len(z)
                outs = codec.decode_batch([(_speaker_codes(T, cfg.n_spk, t_idx), z)
                                           for t_idx in range(n)])
            for t_idx in range(n):
                cvlists[t_idx].append(np.var(outs[t_idx][:, 1:], axis=0))
        out[s] = {}
        for t_idx, t in enumerate(spk_list):
            arr = np.array(cvlists[t_idx])
            mean, var = arr.mean(axis=0), arr.var(axis=0)
            write_store(paths.stats(s), f"/cvgv_mean_{t}_{model_id}", mean)
            write_store(paths.stats(s), f"/cvgv_var_{t}_{model_id}", var)
            out[s][t] = mean
    logging.info("stage 5m: calibrated %d directions over %d speakers", n * n, n)
    return out


def load_cvgv_mult(paths: RecipePaths, src_spk: str, trg_spk: str,
                   model_id: str) -> Optional[np.ndarray]:
    """Per-direction calibrated model GV written by calc_cvgv_mult, or None
    if this (model, direction) has not been calibrated."""
    key = f"/cvgv_mean_{trg_spk}_{model_id}"
    if check_store(paths.stats(src_spk), key):
        return read_store(paths.stats(src_spk), key)
    return None


def gv_postfilter_utt(cvmcep: np.ndarray, gv_mean_trg: np.ndarray) -> np.ndarray:
    """Utterance-level GV postfilter: scale deviations so the converted
    utterance's own variance matches the target speaker's data GV."""
    datamean = np.mean(cvmcep[:, 1:], axis=0)
    cvgv_utt = np.var(cvmcep[:, 1:], axis=0)
    return np.c_[cvmcep[:, 0],
                 np.sqrt(gv_mean_trg / np.maximum(cvgv_utt, 1e-12))
                 * (cvmcep[:, 1:] - datamean) + datamean]


def _lf0_stats(paths: RecipePaths, spk: str):
    return (float(read_store(paths.stats(spk), "/lf0_range_mean")),
            float(read_store(paths.stats(spk), "/lf0_range_std")))


def decode_to_speaker(
    codec: Codec, exp: ExperimentConfig, paths: RecipePaths,
    wav_file: str, src_spk: str, all_speakers: Sequence[str],
    trg: Union[str, Sequence[float]], outdir: str,
    generator: Optional[torch.Generator] = None,
    conf_dir: Optional[str] = None, gv_postfilter: bool = True,
    model_id: Optional[str] = None,
) -> Dict[str, str]:
    """Convert one wav to a target speaker (name) or soft code (weights).
    Returns {variant: wav path}.  The posterior-mean draws come from
    ``generator`` (default: seeded with 0 on the codec's device)."""
    generator = _generator(codec, generator)
    fcfg = exp.feature
    cfg = codec.cfg
    sc_src = _read_spk_conf(conf_dir, src_spk)
    fs, x = read_wav(wav_file, cutoff=int(fcfg.highpass_cutoff))
    src = _feat_from_wav(x, fs, sc_src.minf0, sc_src.maxf0, sc_src.pow_threshold, fcfg)

    with codec.lock:
        _, (z,) = codec.encode_mean(generator, [src["feat"]])
    T = len(z)
    if isinstance(trg, str):
        weights = np.zeros(len(all_speakers), np.float32)
        weights[list(all_speakers).index(trg)] = 1.0
        trg_name = trg
    else:
        weights = np.asarray(trg, np.float32)
        trg_name = "mix-" + "-".join(f"{w:.2f}" for w in weights)
    with codec.lock:
        cvmcep = codec.decode(speaker_interp_code(T, cfg.n_spk, weights), z)
    cvmcep = mod_pow(cvmcep, src["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)

    # F0: interpolate target log-F0 stats over the soft code weights
    lm_t, ls_t = 0.0, 0.0
    for w, spk in zip(weights, all_speakers):
        if w > 0:
            lm, ls = _lf0_stats(paths, spk)
            lm_t += w * lm
            ls_t += w * ls
    lm_s, ls_s = _lf0_stats(paths, src_spk)
    cvf0 = convert_f0(src["f0"], lm_s, ls_s, lm_t, ls_t)

    os.makedirs(outdir, exist_ok=True)
    base = os.path.splitext(os.path.basename(wav_file))[0]
    out = {}

    def synth(mcep_mat, suffix):
        cvsp = sptk.mc2sp(mcep_mat, fcfg.mcep_alpha, fcfg.fftl)
        wav = world.synthesize(cvf0, cvsp, src["ap"], fs, frame_period=fcfg.shiftms)
        path = os.path.join(outdir, f"{base}_to_{trg_name}{suffix}.wav")
        write_wav(path, fs, wav)
        out[suffix or "noGV"] = path

    synth(cvmcep, "_noGV")
    if gv_postfilter:
        gv_t = np.zeros(cfg.out_dim - 1)
        for w, spk in zip(weights, all_speakers):
            if w > 0:
                gv_t += w * read_store(paths.stats(spk), "/gv_range_mean")[1:]
        cvgv_model = (load_cvgv_mult(paths, src_spk, trg, model_id)
                      if model_id and isinstance(trg, str) else None)
        if cvgv_model is not None:
            cv_gv = _gv_postfilter(cvmcep, gv_t, cvgv_model)
        else:
            cv_gv = gv_postfilter_utt(cvmcep, gv_t)
        cv_gv = mod_pow(cv_gv, src["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)
        synth(cv_gv, "_GV")
    logging.info("m2m decoded %s -> %s", wav_file, trg_name)
    return out


def eval_pair_mult(
    codec: Codec, exp: ExperimentConfig, paths: RecipePaths,
    wav_src: str, wav_trg: str, src_spk: str, trg_spk: str,
    all_speakers: Sequence[str], outdir: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    conf_dir: Optional[str] = None, model_id: Optional[str] = None,
) -> Dict[str, float]:
    """Metric pass for one m2m eval pair: convert the source utterance to
    ``trg_spk`` through the N-speaker model and report DTW MCD against the
    target speaker's parallel utterance (the one-to-one stage-6 metric
    contract, reference decode…py:604-644, on the m2m decode path); with
    ``outdir``, also write the ``_noGV`` and ``_GV`` conversions.

    Returns {"mcdpow_cv", "mcd_cv", "mcd_cvgv", "gv_log_rmse"}."""
    generator = _generator(codec, generator)
    fcfg = exp.feature
    cfg = codec.cfg
    sc_src = _read_spk_conf(conf_dir, src_spk)
    sc_trg = _read_spk_conf(conf_dir, trg_spk)
    ana = analyze_pair(exp, wav_src, wav_trg, sc_src.minf0, sc_src.maxf0,
                       sc_trg.minf0, sc_trg.maxf0, sc_src.pow_threshold,
                       sc_trg.pow_threshold)
    fs, src, trg = ana["fs"], ana["src"], ana["trg"]

    weights = np.zeros(len(all_speakers), np.float32)
    weights[list(all_speakers).index(trg_spk)] = 1.0
    with codec.lock:
        _, (z,) = codec.encode_mean(generator, [src["feat"]])
        cvmcep = codec.decode(speaker_interp_code(len(z), cfg.n_spk, weights), z)

    mcep_trg_spc = trg["mcep"][trg["spcidx"]].astype(np.float64)
    cv_spc = cvmcep[src["spcidx"]]
    metrics: Dict[str, float] = {}
    _, _, metrics["mcdpow_cv"], _ = dtw_c.dtw_org_to_trg(cv_spc, mcep_trg_spc)
    _, _, metrics["mcd_cv"], _ = dtw_c.dtw_org_to_trg(cv_spc[:, 1:], mcep_trg_spc[:, 1:])

    gv_t = read_store(paths.stats(trg_spk), "/gv_range_mean")[1:]
    cvgv_model = load_cvgv_mult(paths, src_spk, trg_spk, model_id) if model_id else None
    if cvgv_model is not None:
        # corpus-calibrated per-direction postfilter (stage 5m)
        cv_gv = _gv_postfilter(cvmcep, gv_t, cvgv_model)
    else:
        cv_gv = gv_postfilter_utt(cvmcep, gv_t)
    _, _, metrics["mcd_cvgv"], _ = dtw_c.dtw_org_to_trg(
        cv_gv[src["spcidx"]][:, 1:], mcep_trg_spc[:, 1:])
    metrics["gv_log_rmse"] = float(np.sqrt(np.mean(
        (np.log(np.maximum(np.var(cv_spc[:, 1:], axis=0), 1e-12))
         - np.log(np.maximum(gv_t, 1e-12))) ** 2)))

    if outdir is not None:
        cvmcep_p = mod_pow(cvmcep, src["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)
        lm_s, ls_s = _lf0_stats(paths, src_spk)
        lm_t, ls_t = _lf0_stats(paths, trg_spk)
        cvf0 = convert_f0(src["f0"], lm_s, ls_s, lm_t, ls_t)
        os.makedirs(outdir, exist_ok=True)
        base = os.path.splitext(os.path.basename(wav_src))[0]
        for mat, suffix in ((cvmcep_p, "_noGV"),
                            (mod_pow(cv_gv, src["mcep"], alpha=fcfg.mcep_alpha,
                                     irlen=fcfg.irlen), "_GV")):
            cvsp = sptk.mc2sp(mat, fcfg.mcep_alpha, fcfg.fftl)
            wav = world.synthesize(cvf0, cvsp, src["ap"], fs, frame_period=fcfg.shiftms)
            write_wav(os.path.join(outdir, f"{base}_to_{trg_spk}{suffix}.wav"), fs, wav)
    return metrics
