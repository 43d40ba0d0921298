"""Stage 6: the device side of conversion — the ``Codec`` engine.

PyTorch counterpart of the device part of ``cyclevae_tpu/pipeline/decode.py``.
Per (source, target) utterance pair the recipe makes two device calls
(``device_decode_pair``): one batched encode plus posterior-mean draw for both
utterances, and one batched 3-direction decode (trg-code conversion, src-code
reconstruction, trg self-reconstruction).  The host DSP around it (WORLD/SPTK
analysis and synthesis, DTW metrics, power correction) and the GV statistics
I/O are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gru_vae import (gru_rnn_apply, sampling_vae_batch,
                              sampling_vae_laplace_batch)
from ..utils.device import resolve_device
from ..vi.train import CycleVAEConfig, CycleVAEParams, params_to


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
        return self._encode_b(self._tensor(feat)[None])[0, :T].cpu().numpy()

    @torch.inference_mode()
    def latent_mean(self, generator: Optional[torch.Generator], lat: np.ndarray,
                    eps=None) -> np.ndarray:
        """Posterior mean of one utterance's (T, 2*lat) posterior params;
        ``eps`` (n_smpl_dec, T, lat) replaces the generator's draws."""
        lat, T = self._pad(np.asarray(lat, np.float32))
        if eps is not None:
            eps = self._eps(np.asarray(eps)[:, None], [T], lat.shape[0])[:, 0]
        return self._latent_mean(generator, self._tensor(lat), eps)[:T].cpu().numpy()

    @torch.inference_mode()
    def decode(self, code: np.ndarray, z: np.ndarray) -> np.ndarray:
        cz, T = self._pad(np.concatenate([code, z], axis=-1, dtype=np.float32))
        out = self._decode_b(self._tensor(cz)[None])[0, :T]
        return out.cpu().numpy().astype(np.float64)

    @torch.inference_mode()
    def encode_mean(self, generator: Optional[torch.Generator],
                    feats: List[np.ndarray], eps=None
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Fused batched encode + n_smpl_dec posterior-mean draw for K
        utterances in ONE device call.  Returns ([lat_i], [z_i]) trimmed.
        ``eps`` (n_smpl_dec, K, max T_i, lat) replaces the generator's draws."""
        stack, lens = self._pad_stack([np.asarray(f, np.float32) for f in feats])
        lat = self._encode_b(self._tensor(stack))
        z = self._latent_mean(generator, lat, self._eps(eps, lens, stack.shape[1]))
        lat, z = lat.cpu().numpy(), z.cpu().numpy()
        return ([lat[i, :n] for i, n in enumerate(lens)],
                [z[i, :n] for i, n in enumerate(lens)])

    @torch.inference_mode()
    def decode_batch(self, pairs: List[Tuple[np.ndarray, np.ndarray]]
                     ) -> List[np.ndarray]:
        """Batched decode of K (code, z) pairs in ONE device call (the
        3-direction stage-6 fan-out becomes a single batched AR scan)."""
        stack, lens = self._pad_stack(
            [np.concatenate([c, z], axis=-1, dtype=np.float32) for c, z in pairs])
        out = self._decode_b(self._tensor(stack)).cpu().numpy().astype(np.float64)
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
    datamean = np.mean(cvmcep[:, 1:], axis=0)
    return np.c_[cvmcep[:, 0],
                 np.sqrt(gv_mean_data / cvgv_mean_model)
                 * (cvmcep[:, 1:] - datamean) + datamean]


def device_decode_pair(codec: Codec, generator: Optional[torch.Generator],
                       src_feat: np.ndarray, trg_feat: np.ndarray, eps=None):
    """Device phase of one conversion request: ONE fused batched
    encode+posterior-mean call for both utterances and ONE fused
    3-direction batched decode.  ``generator`` defaults to one seeded with 0
    on the codec's device; ``eps`` (n_smpl_dec, 2, max(T_src, T_trg), lat)
    replaces its draws.  Returns (lat_src, lat_trg, cvmcep, cvmcep_src,
    cvmcep_trg)."""
    cfg = codec.cfg
    if generator is None and eps is None:
        generator = torch.Generator(device=codec.device).manual_seed(0)
    (lat_src, lat_trg), (z_src, z_trg) = codec.encode_mean(
        generator, [src_feat, trg_feat], eps)
    T, Tt = len(z_src), len(z_trg)
    cvmcep, cvmcep_src, cvmcep_trg = codec.decode_batch([
        (_speaker_codes(T, cfg.n_spk, 1), z_src),
        (_speaker_codes(T, cfg.n_spk, 0), z_src),
        (_speaker_codes(Tt, cfg.n_spk, 1), z_trg),
    ])
    return lat_src, lat_trg, cvmcep, cvmcep_src, cvmcep_trg
