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
from ..models.gru_vae import (compose_conv, gru_rnn_apply, sampling_vae_batch,
                              sampling_vae_laplace_batch)
from ..ops import _build, cuda_gru
from ..utils.config import ExperimentConfig
from ..utils.device import resolve_device
from ..utils.profiling import count, fetch, span
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


def _thread_pool_set() -> None:
    """Give the calling thread the intra-op thread count of
    ``torch.set_num_threads`` before its first matrix product on the CPU.
    ATen sets it lazily, at the thread's first parallel loop; a BLAS product
    before that runs at OpenMP's default count and sums in another order,
    so a decode on a worker thread would differ from a serial one."""
    torch.get_num_threads()


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
        # the frozen conv stacks, composed once and not on every call
        with torch.inference_mode():
            self._enc_conv = compose_conv(self.params.encoder, cfg.enc_cfg)
            self._dec_conv = compose_conv(self.params.decoder, cfg.dec_cfg)
        # device_decode_pair's device phases, one a padded length (captured
        # as CUDA graphs on a CUDA codec)
        self._pair_phases: Dict[int, _PairPhase] = {}

    # ---- device work: plain functions on tensors ----

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _encode_b(self, feats: torch.Tensor) -> torch.Tensor:
        # feats (B, Tp, in) -> posterior params (B, Tp, 2*lat)
        cfg = self.cfg
        _thread_pool_set()
        lat, _, _ = gru_rnn_apply(
            self.params.encoder, cfg.enc_cfg, feats,
            torch.zeros((feats.shape[0], cfg.lat_dim * 2), device=self.device),
            lat_dim=cfg.lat_dim, use_pallas=cfg.use_pallas, conv=self._enc_conv,
            **self._clamp_kw)
        return lat

    def _latent_mean(self, generator, lat: torch.Tensor,
                     eps: Optional[torch.Tensor]) -> torch.Tensor:
        # mean of n_smpl_dec reparameterized draws (MC estimate of mu;
        # reference decode…py:304-306)
        draws = self._sample(
            lat.expand((self.n_smpl_dec,) + tuple(lat.shape)), self.cfg.lat_dim,
            generator=generator, eps=eps)
        return draws.mean(dim=0)

    def _draw(self, generator: torch.Generator, out: torch.Tensor) -> torch.Tensor:
        """The posterior sampler's noise into ``out``, the values
        ``_latent_mean`` draws from ``generator`` at that shape."""
        if self.cfg.posterior == "laplace":
            return torch.rand(out.shape, generator=generator, out=out).mul_(0.9999).sub_(0.4999)
        return torch.randn(out.shape, generator=generator, out=out)

    def _decode_b(self, code_z: torch.Tensor) -> torch.Tensor:
        # code_z (B, Tp, n_spk + lat) -> (B, Tp, out); decoder feedback
        # starts at the normalized zero mcep, (0 - mean) / scale
        s = self.params.decoder["scale_out"]
        _thread_pool_set()
        y0 = ((0.0 - s["mean"]) / s["scale"]).expand(code_z.shape[0], self.cfg.out_dim)
        out, _, _ = gru_rnn_apply(self.params.decoder, self.cfg.dec_cfg, code_z,
                                  y0, use_pallas=self.cfg.use_pallas, conv=self._dec_conv)
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
    def convert_pair(self, generator: Optional[torch.Generator], src_feat: np.ndarray,
                     trg_feat: np.ndarray, eps=None, on_device: bool = False) -> tuple:
        """``device_decode_pair``'s device phase: (lat_src, lat_trg, cvmcep,
        cvmcep_src, cvmcep_trg), the values of ``encode_mean`` then
        ``decode_batch``.  On a CUDA codec the phase of each padded length
        is captured as a CUDA graph at its first request, and the host then
        queues three copies, the draws and one replay, where the two calls
        queue ~250 operations and wait three times.

        ``on_device``: float32 tensors left on the device, with no wait on
        it.  Else the latents as float32 and the decodes as float64 arrays,
        brought to the host in one blocking copy of the graph's own outputs,
        which the next replay writes over: callers on several threads hold
        ``lock`` until the call returns."""
        cfg = self.cfg
        with span("codec.convert_pair"):
            with span("codec.pack"):
                stack, lens = self._pad_stack([np.asarray(f, np.float32)
                                               for f in (src_feat, trg_feat)])
                (T, Tt), Tp = lens, stack.shape[1]
                codes = np.zeros((3, Tp, cfg.n_spk), np.float32)
                for i, (n, idx) in enumerate(((T, 1), (T, 0), (Tt, 1))):
                    codes[i, :n] = _speaker_codes(n, cfg.n_spk, idx)
                eps = self._eps(eps, lens, Tp)
            phase = self._pair_phases.get(Tp)
            if phase is None:
                phase = self._pair_phases[Tp] = _PairPhase(self, Tp)
            flat = phase.run(self, generator, stack, codes, eps)
        if on_device:
            lat, out = phase.split(flat if phase.graph is None else flat.clone())
            return lat[0, :T], lat[1, :Tt], out[0, :T], out[1, :T], out[2, :Tt]
        lat, out = phase.split(fetch(flat).numpy())
        return (lat[0, :T], lat[1, :Tt],
                *(o.astype(np.float64) for o in (out[0, :T], out[1, :T], out[2, :Tt])))

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


class _PairPhase:
    """``Codec.convert_pair``'s device phase at one padded length Tp: the
    batched encode of the two utterances (K1), the posterior mean of the
    draws, the batched decode of the three directions (K1), from buffers
    that each request writes: the padded features, the draws and the
    speaker codes, zero past each direction's length, where the decode
    input's latents are zeroed too, as ``decode_batch`` pads them.  On a
    CUDA codec the phase is captured as one CUDA graph and replayed on the
    current stream, the buffers written there first and the outputs copied
    out after (the next replay writes over the graph's), its K1 launches
    counted at each replay (and the run off the capture's, which launched
    them too); on the CPU it runs directly.  Its output is one flat buffer
    of the latents then the decodes, so that the host path brings both to
    the host in one copy; each replay is counted under
    ``codec.pair_replays``, which a direct run leaves at 0."""

    def __init__(self, codec: "Codec", Tp: int):
        cfg, dev = codec.cfg, codec.device
        self.shapes = ((2, Tp, 2 * cfg.lat_dim), (3, Tp, cfg.out_dim))
        self.x = torch.zeros((2, Tp, cfg.in_dim), device=dev)
        self.eps = torch.zeros((codec.n_smpl_dec, 2, Tp, cfg.lat_dim), device=dev)
        self.code = torch.zeros((3, Tp, cfg.n_spk), device=dev)
        self.graph = None
        if dev.type != "cuda":
            return
        # one run off the capture first, as CUDA graphs ask (the libraries'
        # handles and workspaces, the kernels' plans); its launches ran
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(codec)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = cuda_gru.cuda_gru_ar.launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.flat = self._body(codec)
        self.launches = cuda_gru.cuda_gru_ar.launches - before
        cuda_gru.cuda_gru_ar.launches = before

    def _body(self, codec: "Codec") -> torch.Tensor:
        lat = codec._encode_b(self.x)
        z = codec._latent_mean(None, lat, self.eps)
        z = torch.where((self.code != 0).any(-1, keepdim=True),
                        torch.stack([z[0], z[0], z[1]]), 0.0)
        out = codec._decode_b(torch.cat([self.code, z], dim=-1))
        return torch.cat([lat.reshape(-1), out.reshape(-1)])

    def split(self, flat):
        """The latents (2, Tp, 2 lat) and the decodes (3, Tp, out) of the
        flat output ``flat``, a tensor or its host array, as views of it."""
        n = int(np.prod(self.shapes[0]))
        return flat[:n].reshape(self.shapes[0]), flat[n:].reshape(self.shapes[1])

    def run(self, codec: "Codec", generator: Optional[torch.Generator], stack: np.ndarray,
            codes: np.ndarray, eps: Optional[torch.Tensor]) -> torch.Tensor:
        """The phase on one request's inputs, queued without a wait (the
        host arrays' copies are staged before ``copy_`` returns): its flat
        output, on a CUDA codec the graph's own."""
        self.x.copy_(torch.from_numpy(stack), non_blocking=True)
        self.code.copy_(torch.from_numpy(codes), non_blocking=True)
        if eps is None:
            codec._draw(generator, self.eps)
        else:
            self.eps.copy_(eps)
        if self.graph is None:
            count("codec.pair_replays", 0)          # run directly: no replay
            return self._body(codec)
        self.graph.replay()
        count("codec.pair_replays")
        for _ in range(self.launches):
            _build.count_launch(cuda_gru.cuda_gru_ar)
        return self.flat


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
    (decode…py:418-421).  A tensor (``device_decode_pair(...,
    on_device=True)``'s) is filtered where it is, in float64, without a
    wait on its device."""
    with span("vocoder.postfilter"):
        if isinstance(cvmcep, torch.Tensor):
            cv = cvmcep.double()
            ratio = torch.from_numpy(np.sqrt(gv_mean_data / cvgv_mean_model)).to(
                cv.device, non_blocking=True)
            datamean = cv[:, 1:].mean(dim=0)
            return torch.cat([cv[:, :1], ratio * (cv[:, 1:] - datamean) + datamean], dim=1)
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
                       src_feat: np.ndarray, trg_feat: np.ndarray, eps=None,
                       on_device: bool = False):
    """Device phase of one conversion request, under the codec's lock:
    ONE batched encode+posterior-mean of both utterances and ONE batched
    3-direction decode (``Codec.convert_pair``: on a CUDA codec one CUDA
    graph replay), the values of ``Codec.encode_mean`` then
    ``Codec.decode_batch``.  ``generator`` defaults to one seeded with 0
    on the codec's device; ``eps`` (n_smpl_dec, 2, max(T_src, T_trg), lat)
    replaces its draws.  Returns (lat_src, lat_trg, cvmcep, cvmcep_src,
    cvmcep_trg): float32 latents and float64 decodes, brought to the host
    in one blocking copy.

    ``on_device``: the five are float32 tensors left on the codec's device,
    the same values, and the call never waits on the device, so the host
    can queue what follows (``gv_postfilter``, ``converted_conditioning``
    and a Parallel WaveGAN rendering take them there) while K1 runs.  The
    request then does not end in a copy to the host: callers on several
    threads order their streams themselves."""
    if generator is None and eps is None:
        generator = torch.Generator(device=codec.device).manual_seed(0)
    with span("decode.device_decode_pair"), codec.lock:
        return codec.convert_pair(generator, src_feat, trg_feat, eps, on_device)


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
