"""Stage 6: decode / conversion of (source wav, target wav) pairs.

PyTorch counterpart of ``cyclevae_tpu/pipeline/decode.py`` (reference
src/bin/decode_gru-cyclevae_gauss.py). Per pair, ``decode_pair``:
  on-the-fly WORLD/SPTK analysis of both wavs (``analyze_pair``, host)
  -> the device phase (``device_decode_pair``: one batched encode plus
  posterior-mean draw for both utterances, one batched 3-direction decode:
  trg-code conversion, src-code reconstruction, trg self-reconstruction;
  the ``Codec`` engine, K1 on CUDA)
  -> DTW latent distances + MCD metrics -> mod_pow power correction
  -> GV postfilter scaling deviations by sqrt(gv_data/gv_model)
  -> log-Gaussian F0 transform -> 8 synthesis variants
  (_noGV/_GV x cv/src/trg, _DiffGV, _DiffGVF0; decode…py:479-548).
The host DSP is the port's copy of the C++ library (:mod:`..dsp`).
``decode_pair`` takes its F0 and GV statistics as dicts, which the recipe
reads from the feature store; stage 5's GV calibration (``calc_cvgv``) writes
the model's GV statistics there.

Several threads may decode pairs at once (the recipe's stage 6): each
codec's device calls run one request at a time, under the codec's lock, on
the thread's current stream, and each ends in a copy to the host, so two
requests' cooperative kernels never run at once.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dsp import dtw as dtw_c
from ..dsp import sptk, world
from ..models.gru_vae import (gru_rnn_apply, sampling_vae_batch,
                              sampling_vae_laplace_batch)
from ..utils.config import ExperimentConfig
from ..utils.device import resolve_device
from ..utils.profiling import fetch, span
from ..utils.store import read_store, write_store
from ..utils.wavio import low_cut_filter, low_pass_filter, read_wav, write_wav
from ..vi.train import CycleVAEConfig, CycleVAEParams, params_to
from .features import analyze, convert_continuos_f0, convert_f0, extfrm, mod_pow, spc2npow


def _feat_from_wav(x, fs, minf0, maxf0, pow_threshold, cfg_feat):
    """On-the-fly analysis to the 54-d feature vector (decode…py:254-299)."""
    time_axis, f0, sp, ap = analyze(x, fs, minf0=minf0, maxf0=maxf0,
                                    fperiod=cfg_feat.shiftms, fftl=cfg_feat.fftl)
    mcep = sptk.sp2mc(sp, cfg_feat.mcep_dim, cfg_feat.mcep_alpha)
    codeap = world.code_aperiodicity(ap, fs)
    npow = spc2npow(sp)
    _, spcidx = extfrm(mcep, npow, power_threshold=pow_threshold)
    uv, contf0 = convert_continuos_f0(np.array(f0))
    cont_f0_lpf = low_pass_filter(contf0, int(1.0 / (cfg_feat.shiftms * 0.001)),
                                  cutoff=20)
    feat = np.c_[np.expand_dims(uv, -1),
                 np.expand_dims(np.log(cont_f0_lpf), -1), codeap, mcep]
    return {
        "time_axis": time_axis, "f0": f0, "sp": sp, "ap": ap, "mcep": mcep,
        "npow": npow, "spcidx": spcidx[0], "feat": feat.astype(np.float32),
    }


class Codec:
    """Frozen encoder/decoder applied to full utterances (host-facing API).

    Inputs are zero-padded to a multiple of ``bucket`` frames, as the JAX
    package pads them so that one compiled program serves every length;
    padding frames are trimmed from every output, and only the last
    rec_field/2 (= 4) real frames see a boundary difference (zero frames vs
    the window's zero pad).  Runs on ``device`` (CUDA by default).

    Randomness: the posterior mean is the mean of ``n_smpl_dec``
    reparameterized draws, whose noise comes from a ``torch.Generator`` on
    the codec's device, or is handed in as ``eps`` (over the real frames;
    it is zero-padded to the bucket)."""

    def __init__(self, params: CycleVAEParams, cfg: CycleVAEConfig,
                 n_smpl_dec: int = 300, bucket: int = 560, device=None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.n_smpl_dec = n_smpl_dec
        self.bucket = bucket
        # held by device_decode_pair and calc_cvgv: one request's device calls at a time
        self.lock = threading.Lock()
        # posterior family selects the clamp + reparameterized sampler
        laplace = cfg.posterior == "laplace"
        self._clamp_kw = ({"clamp_vae_laplace": True} if laplace
                          else {"clamp_vae": True})
        self._sample = (sampling_vae_laplace_batch if laplace
                        else sampling_vae_batch)

    # ---- device work: plain functions on tensors ----

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _encode_b(self, feats: torch.Tensor) -> torch.Tensor:
        # feats (B, Tp, in) -> posterior params (B, Tp, 2*lat)
        cfg = self.cfg
        lat, _, _ = gru_rnn_apply(
            self.params.encoder, cfg.enc_cfg, feats,
            torch.zeros((feats.shape[0], cfg.lat_dim * 2), device=self.device),
            lat_dim=cfg.lat_dim, use_pallas=cfg.use_pallas, **self._clamp_kw)
        return lat

    def _latent_mean(self, generator, lat: torch.Tensor,
                     eps: Optional[torch.Tensor]) -> torch.Tensor:
        # mean of n_smpl_dec reparameterized draws (MC estimate of mu;
        # reference decode…py:304-306)
        draws = self._sample(
            lat.expand((self.n_smpl_dec,) + tuple(lat.shape)), self.cfg.lat_dim,
            generator=generator, eps=eps)
        return draws.mean(dim=0)

    def _decode_b(self, code_z: torch.Tensor) -> torch.Tensor:
        # code_z (B, Tp, n_spk + lat) -> (B, Tp, out); decoder feedback
        # starts at the normalized zero mcep, (0 - mean) / scale
        s = self.params.decoder["scale_out"]
        y0 = ((0.0 - s["mean"]) / s["scale"]).expand(code_z.shape[0], self.cfg.out_dim)
        out, _, _ = gru_rnn_apply(self.params.decoder, self.cfg.dec_cfg, code_z,
                                  y0, use_pallas=self.cfg.use_pallas)
        return out

    def _eps(self, eps, lens: Sequence[int], Tp: int) -> Optional[torch.Tensor]:
        """Injected noise (n_smpl_dec, B, max(lens), lat) zero-padded to Tp."""
        if eps is None:
            return None
        eps = self._tensor(eps)
        want = (self.n_smpl_dec, len(lens), max(lens), self.cfg.lat_dim)
        if tuple(eps.shape) != want:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {want}")
        return torch.nn.functional.pad(eps, (0, 0, 0, Tp - eps.shape[2]))

    # ---- host-facing API (numpy in, numpy out) ----

    def _pad(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        T = x.shape[0]
        Tp = ((T + self.bucket - 1) // self.bucket) * self.bucket
        if Tp != T:
            x = np.concatenate([x, np.zeros((Tp - T,) + x.shape[1:], x.dtype)])
        return x, T

    def _pad_stack(self, mats: List[np.ndarray]) -> Tuple[np.ndarray, List[int]]:
        """Zero-pad a list of (T_i, D) to one common bucketed length and
        stack, so K utterances of different lengths ride ONE batched AR
        scan."""
        lens = [m.shape[0] for m in mats]
        Tp = ((max(lens) + self.bucket - 1) // self.bucket) * self.bucket
        out = np.zeros((len(mats), Tp, mats[0].shape[1]), np.float32)
        for i, m in enumerate(mats):
            out[i, :len(m)] = m
        return out, lens

    @torch.inference_mode()
    def encode(self, feat: np.ndarray) -> np.ndarray:
        feat, T = self._pad(np.asarray(feat, np.float32))
        return fetch(self._encode_b(self._tensor(feat)[None])[0, :T]).numpy()

    @torch.inference_mode()
    def latent_mean(self, generator: Optional[torch.Generator], lat: np.ndarray,
                    eps=None) -> np.ndarray:
        """Posterior mean of one utterance's (T, 2*lat) posterior params;
        ``eps`` (n_smpl_dec, T, lat) replaces the generator's draws."""
        lat, T = self._pad(np.asarray(lat, np.float32))
        if eps is not None:
            eps = self._eps(np.asarray(eps)[:, None], [T], lat.shape[0])[:, 0]
        return fetch(self._latent_mean(generator, self._tensor(lat), eps)[:T]).numpy()

    @torch.inference_mode()
    def decode(self, code: np.ndarray, z: np.ndarray) -> np.ndarray:
        cz, T = self._pad(np.concatenate([code, z], axis=-1, dtype=np.float32))
        out = self._decode_b(self._tensor(cz)[None])[0, :T]
        return fetch(out).numpy().astype(np.float64)

    @torch.inference_mode()
    def encode_mean(self, generator: Optional[torch.Generator],
                    feats: List[np.ndarray], eps=None
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Fused batched encode + n_smpl_dec posterior-mean draw for K
        utterances in ONE device call.  Returns ([lat_i], [z_i]) trimmed.
        ``eps`` (n_smpl_dec, K, max T_i, lat) replaces the generator's draws."""
        with span("codec.encode_mean"):
            with span("codec.pack"):
                stack, lens = self._pad_stack([np.asarray(f, np.float32) for f in feats])
                x = self._tensor(stack)
                eps = self._eps(eps, lens, stack.shape[1])
            with span("codec.encode"):
                lat = self._encode_b(x)
            with span("codec.latent_mean"):
                z = self._latent_mean(generator, lat, eps)
            lat, z = fetch(lat), fetch(z)
            with span("codec.unpack"):
                lat, z = lat.numpy(), z.numpy()
                return ([lat[i, :n] for i, n in enumerate(lens)],
                        [z[i, :n] for i, n in enumerate(lens)])

    @torch.inference_mode()
    def decode_batch(self, pairs: List[Tuple[np.ndarray, np.ndarray]]
                     ) -> List[np.ndarray]:
        """Batched decode of K (code, z) pairs in ONE device call (the
        3-direction stage-6 fan-out becomes a single batched AR scan)."""
        with span("codec.decode_batch"):
            with span("codec.pack"):
                stack, lens = self._pad_stack(
                    [np.concatenate([c, z], axis=-1, dtype=np.float32) for c, z in pairs])
                x = self._tensor(stack)
            with span("codec.decode"):
                out = self._decode_b(x)
            out = fetch(out)
            with span("codec.unpack"):
                out = out.numpy().astype(np.float64)
                return [out[i, :n] for i, n in enumerate(lens)]


def _speaker_codes(T: int, n_spk: int, idx: int) -> np.ndarray:
    code = np.zeros((T, n_spk), np.float32)
    code[:, idx] = 1
    return code


def speaker_interp_code(T: int, n_spk: int, weights) -> np.ndarray:
    """Speaker-space interpolation: a soft point in the n_spk-dim code space
    (e.g. 0.5/0.5 morphs between the two one-to-one speakers).  The decoder
    conditions linearly on the code, so intermediate codes synthesize
    intermediate voices."""
    w = np.asarray(weights, np.float32)
    if w.shape != (n_spk,):
        raise ValueError(f"weights must have shape ({n_spk},), got {w.shape}")
    return np.broadcast_to(w, (T, n_spk)).copy()


def decode_interpolated(codec: Codec, generator: Optional[torch.Generator],
                        feat: np.ndarray, weights) -> np.ndarray:
    """Convert an utterance's features to an interpolated speaker identity.
    Returns the converted mcep trajectory (T, out_dim)."""
    _, (z,) = codec.encode_mean(generator, [feat])  # fused encode+posterior-mean
    code = speaker_interp_code(len(z), codec.cfg.n_spk, weights)
    return codec.decode(code, z)


def gv_postfilter(cvmcep: np.ndarray, gv_mean_data: np.ndarray,
                  cvgv_mean_model: np.ndarray) -> np.ndarray:
    """Scale mcep deviations by sqrt(gv_data/gv_model), keep c0
    (decode…py:418-421)."""
    with span("vocoder.postfilter"):
        datamean = np.mean(cvmcep[:, 1:], axis=0)
        return np.c_[cvmcep[:, 0],
                     np.sqrt(gv_mean_data / cvgv_mean_model)
                     * (cvmcep[:, 1:] - datamean) + datamean]


def latent_dtw_metrics(lat_src: np.ndarray, lat_trg: np.ndarray,
                       spc_src: np.ndarray, spc_trg: np.ndarray,
                       lat_dim: int) -> Dict[str, float]:
    """DTW-aligned latent RMSE / cosine distance between paired utterances
    (decode…py:332-360)."""
    mu_s = lat_src[spc_src][:, :lat_dim].astype(np.float64)
    mu_t = lat_trg[spc_trg][:, :lat_dim].astype(np.float64)
    aligned, _, _, _ = dtw_c.dtw_org_to_trg(mu_s, mu_t)
    rmse = float(np.mean(np.sqrt(np.mean((aligned - mu_t) ** 2, axis=1))))
    num = np.sum(aligned * mu_t, axis=1)
    den = (np.linalg.norm(aligned, axis=1) * np.linalg.norm(mu_t, axis=1) + 1e-12)
    cos = float(np.mean(1.0 - num / den))
    return {"lat_rmse": rmse, "lat_cos": cos}


def analyze_pair(exp: ExperimentConfig, wav_file: str, wav_trg_file: str,
                 minf0: float, maxf0: float, minf0_trg: float,
                 maxf0_trg: float, pow_src: float, pow_trg: float):
    """Host-DSP analysis phase of one decode pair (WORLD/SPTK, no device).
    Split out so a caller can prefetch analyses on a producer thread while
    the device decodes the previous pair (decode…py:254-299)."""
    fcfg = exp.feature
    with span("stage6.analysis"):
        fs, x = read_wav(wav_file, cutoff=int(fcfg.highpass_cutoff))
        src = _feat_from_wav(x, fs, minf0, maxf0, pow_src, fcfg)
        _, x_trg = read_wav(wav_trg_file, cutoff=int(fcfg.highpass_cutoff))
        trg = _feat_from_wav(x_trg, fs, minf0_trg, maxf0_trg, pow_trg, fcfg)
        return {"fs": fs, "x": x, "src": src, "trg": trg}


def device_decode_pair(codec: Codec, generator: Optional[torch.Generator],
                       src_feat: np.ndarray, trg_feat: np.ndarray, eps=None):
    """Device phase of one conversion request: ONE fused batched
    encode+posterior-mean call for both utterances and ONE fused
    3-direction batched decode, under the codec's lock.  ``generator``
    defaults to one seeded with 0 on the codec's device; ``eps``
    (n_smpl_dec, 2, max(T_src, T_trg), lat) replaces its draws.  Returns
    (lat_src, lat_trg, cvmcep, cvmcep_src, cvmcep_trg)."""
    cfg = codec.cfg
    if generator is None and eps is None:
        generator = torch.Generator(device=codec.device).manual_seed(0)
    with span("decode.device_decode_pair"), codec.lock:
        (lat_src, lat_trg), (z_src, z_trg) = codec.encode_mean(
            generator, [src_feat, trg_feat], eps)
        T, Tt = len(z_src), len(z_trg)
        cvmcep, cvmcep_src, cvmcep_trg = codec.decode_batch([
            (_speaker_codes(T, cfg.n_spk, 1), z_src),
            (_speaker_codes(T, cfg.n_spk, 0), z_src),
            (_speaker_codes(Tt, cfg.n_spk, 1), z_trg),
        ])
    return lat_src, lat_trg, cvmcep, cvmcep_src, cvmcep_trg


def decode_pair(codec: Codec, exp: ExperimentConfig,
                generator: Optional[torch.Generator],
                wav_file: str, wav_trg_file: str, outdir: str,
                f0stats: Dict[str, float], gv: Dict[str, np.ndarray],
                minf0: float, maxf0: float, minf0_trg: float, maxf0_trg: float,
                pow_src: float, pow_trg: float,
                out_name: Optional[str] = None,
                analysis: Optional[dict] = None, eps=None) -> Dict[str, float]:
    """Full decode of one (source wav, target wav) pair; writes 8 wavs.
    Returns the metric dict for corpus aggregation (decode…py:604-644).
    ``analysis``: pre-computed analyze_pair output (prefetch path).
    ``generator`` / ``eps``: the posterior-mean draws, as
    ``device_decode_pair`` takes them.  Recorded under the span
    ``stage6.decode_pair``, its stages under ``stage6.analysis`` (when
    ``analysis`` is not given), ``stage6.device``, ``stage6.metrics`` (the
    metrics, mod_pow and the postfilter) and ``stage6.synthesis`` (the eight
    renderings and their files): see ``utils.profiling``."""
    fcfg = exp.feature
    cfg = codec.cfg
    with span("stage6.decode_pair"):
        if analysis is None:
            analysis = analyze_pair(exp, wav_file, wav_trg_file, minf0, maxf0,
                                    minf0_trg, maxf0_trg, pow_src, pow_trg)
        fs, x = analysis["fs"], analysis["x"]
        src, trg = analysis["src"], analysis["trg"]

        base = out_name or os.path.splitext(os.path.basename(wav_file))[0]
        os.makedirs(outdir, exist_ok=True)

        with span("stage6.device"):
            lat_src, lat_trg, cvmcep, cvmcep_src, cvmcep_trg = device_decode_pair(
                codec, generator, src["feat"], trg["feat"], eps=eps)

        with span("stage6.metrics"):
            metrics: Dict[str, float] = {}
            metrics.update(latent_dtw_metrics(lat_src, lat_trg, src["spcidx"],
                                              trg["spcidx"], cfg.lat_dim))

            # --- MCD of conversion vs target (DTW), recon vs source (framewise) ---
            mcep_src_spc = src["mcep"][src["spcidx"]].astype(np.float64)
            mcep_trg_spc = trg["mcep"][trg["spcidx"]].astype(np.float64)
            cv_spc = cvmcep[src["spcidx"]]
            _, _, metrics["mcdpow_cv"], _ = dtw_c.dtw_org_to_trg(cv_spc, mcep_trg_spc)
            _, _, metrics["mcd_cv"], _ = dtw_c.dtw_org_to_trg(cv_spc[:, 1:],
                                                              mcep_trg_spc[:, 1:])
            metrics["mcdpow_src"], _ = dtw_c.calc_mcd(cvmcep_src[src["spcidx"]],
                                                      mcep_src_spc)
            metrics["mcd_src"], _ = dtw_c.calc_mcd(cvmcep_src[src["spcidx"]][:, 1:],
                                                   mcep_src_spc[:, 1:])
            metrics["mcdpow_trg"], _ = dtw_c.calc_mcd(cvmcep_trg[trg["spcidx"]],
                                                      mcep_trg_spc)
            metrics["mcd_trg"], _ = dtw_c.calc_mcd(cvmcep_trg[trg["spcidx"]][:, 1:],
                                                   mcep_trg_spc[:, 1:])

            # --- power correction (decode…py:406-416) ---
            # mc2e of the (fixed) reference mceps is the stage-6 host hot path —
            # compute once per side and share across all 6 mod_pow calls
            src_e = sptk.mc2e(src["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)
            trg_e = sptk.mc2e(trg["mcep"], alpha=fcfg.mcep_alpha, irlen=fcfg.irlen)
            cvmcep = mod_pow(cvmcep, src["mcep"], alpha=fcfg.mcep_alpha,
                             irlen=fcfg.irlen, ref_e=src_e)
            cvmcep_src = mod_pow(cvmcep_src, src["mcep"], alpha=fcfg.mcep_alpha,
                                 irlen=fcfg.irlen, ref_e=src_e)
            cvmcep_trg = mod_pow(cvmcep_trg, trg["mcep"], alpha=fcfg.mcep_alpha,
                                 irlen=fcfg.irlen, ref_e=trg_e)

            # --- GV postfilter (decode…py:418-467) ---
            cvmcep_gv = gv_postfilter(cvmcep, gv["gv_mean_trg"], gv["cvgv_mean"])
            cvmcep_src_gv = gv_postfilter(cvmcep_src, gv["gv_mean_src"], gv["cvgvsrc_mean"])
            cvmcep_trg_gv = gv_postfilter(cvmcep_trg, gv["gv_mean_trg"], gv["cvgvtrg_mean"])
            _, _, metrics["mcd_cvgv"], _ = dtw_c.dtw_org_to_trg(
                cvmcep_gv[src["spcidx"]][:, 1:], mcep_trg_spc[:, 1:])
            cvmcep_gv = mod_pow(cvmcep_gv, src["mcep"], alpha=fcfg.mcep_alpha,
                                irlen=fcfg.irlen, ref_e=src_e)
            cvmcep_src_gv = mod_pow(cvmcep_src_gv, src["mcep"], alpha=fcfg.mcep_alpha,
                                    irlen=fcfg.irlen, ref_e=src_e)
            cvmcep_trg_gv = mod_pow(cvmcep_trg_gv, trg["mcep"], alpha=fcfg.mcep_alpha,
                                    irlen=fcfg.irlen, ref_e=trg_e)

            # --- differential mceps + converted F0 (decode…py:469-477) ---
            mc_cv_diff = cvmcep_gv - src["mcep"]
            cvf0 = convert_f0(src["f0"], f0stats["lf0_mean_src"], f0stats["lf0_std_src"],
                              f0stats["lf0_mean_trg"], f0stats["lf0_std_trg"])

        with span("stage6.synthesis"):
            # --- synthesis x8 (decode…py:479-548) ---
            def synth(mcep_mat, f0_use, ap_use, suffix):
                cvsp = sptk.mc2sp(mcep_mat, fcfg.mcep_alpha, fcfg.fftl)
                wav = world.synthesize(f0_use, cvsp, ap_use, fs,
                                       frame_period=fcfg.shiftms)
                write_wav(os.path.join(outdir, f"{base}{suffix}.wav"), fs, wav)

            synth(cvmcep, cvf0, src["ap"], "_noGV")
            synth(cvmcep_src, src["f0"], src["ap"], "_noGV_src")
            synth(cvmcep_trg, trg["f0"], trg["ap"], "_noGV_trg")
            synth(cvmcep_gv, cvf0, src["ap"], "_GV")
            synth(cvmcep_src_gv, src["f0"], src["ap"], "_GV_src")
            synth(cvmcep_trg_gv, trg["f0"], trg["ap"], "_GV_trg")

            # differential-spectrum MLSA filtering of the original waveform
            shiftl = int(fs / 1000 * fcfg.shiftms)
            b = sptk.mc2b(mc_cv_diff, fcfg.mcep_alpha)
            wav_diff = sptk.mlsadf(x, b, fcfg.mcep_alpha, hop=shiftl)
            write_wav(os.path.join(outdir, f"{base}_DiffGV.wav"), fs, wav_diff)

            # re-analysis of the filtered waveform + F0-swapped re-synthesis
            wav_hp = low_cut_filter(np.clip(wav_diff, -32768, 32767), fs, 70)
            sp_diff = world.cheaptrick(wav_hp, src["f0"], src["time_axis"], fs, fcfg.fftl)
            ap_diff = world.d4c(wav_hp, src["f0"], src["time_axis"], fs, fcfg.fftl)
            wav_f0 = world.synthesize(cvf0, sp_diff, ap_diff, fs,
                                      frame_period=fcfg.shiftms)
            write_wav(os.path.join(outdir, f"{base}_DiffGVF0.wav"), fs, wav_f0)

        logging.info("decoded %s -> %s: %s", wav_file, outdir,
                     {k: round(v, 3) for k, v in metrics.items()})
        return metrics


def calc_cvgv(codec: Codec, exp: ExperimentConfig,
              generator: Optional[torch.Generator],
              feat_files_src: List[str], feat_files_trg: List[str],
              stats_src: str, model_id: str) -> Dict[str, np.ndarray]:
    """Stage 5: run the frozen model over TRAINING features, collect
    per-utterance variances of converted mcep in 3 directions, and write
    cvgv stats keyed by the model id into the source stats file
    (reference calc_cvgv…py:131-362).  Each utterance's posterior-mean
    draws come from ``generator``, in file order."""
    cfg = codec.cfg
    cvlists = {"cv": [], "cvsrc": [], "cvtrg": []}
    for files, is_src in ((feat_files_src, True), (feat_files_trg, False)):
        for f in files:
            feat = read_store(f, "/feat_org_lf0").astype(np.float32)
            # fused: one encode+mean call, one 2-direction batched decode
            with codec.lock:
                (lat,), (z,) = codec.encode_mean(generator, [feat])
                T = len(z)
                # direction indices mirror training codes: src speaker=0, trg=1
                self_idx, other_idx = (0, 1) if is_src else (1, 0)
                cv, cv_self = codec.decode_batch([
                    (_speaker_codes(T, cfg.n_spk, other_idx), z),
                    (_speaker_codes(T, cfg.n_spk, self_idx), z)])
            if is_src:
                cvlists["cv"].append(np.var(cv[:, 1:], axis=0))
                cvlists["cvsrc"].append(np.var(cv_self[:, 1:], axis=0))
            else:
                cvlists["cvtrg"].append(np.var(cv_self[:, 1:], axis=0))
    out = {}
    for name, key in (("cv", "cvgv"), ("cvsrc", "cvgvsrc"), ("cvtrg", "cvgvtrg")):
        arr = np.array(cvlists[name])
        out[f"{key}_mean"] = arr.mean(axis=0)
        out[f"{key}_var"] = arr.var(axis=0)
        write_store(stats_src, f"/{key}_mean_{model_id}", out[f"{key}_mean"])
        write_store(stats_src, f"/{key}_var_{model_id}", out[f"{key}_var"])
    return out
