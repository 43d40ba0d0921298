"""Posterior-inference stage: MCMC over utterance latents with the frozen
decoder + posterior-predictive conversion.

PyTorch counterpart of ``cyclevae_tpu/pipeline/infer_stage.py``: where stage
6 converts with the amortized encoder mean, this stage draws the latent
trajectory from its posterior p(z | x, decoder) by HMC (chains ride the
decoder's batch axis: K2 forward, K3 backward on the card) or SMC
(particles over frame latents), then decodes posterior samples (K1) —
yielding credible intervals over converted mcep beside the point
conversion.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..infer.draws import Draws
from ..infer.hmc import HMCConfig, hmc_sample_batch
from ..infer.logjoint import make_utterance_logjoint_batched
from ..infer.nuts import NUTSConfig, nuts_sample  # noqa: F401  (the JAX module's surface)
from ..infer.smc import SMCConfig, make_decoder_ssm, smc_filter
from ..models.gru_vae import gru_rnn_apply
from ..utils.profiling import fetch, span
from ..utils.store import read_store, write_store
from ..vi.train import CycleVAEConfig, CycleVAEParams


def _device(params: CycleVAEParams) -> torch.device:
    return params.decoder["out"]["w"].device


def _code(T: int, n_spk: int, idx: int, device) -> torch.Tensor:
    code = torch.zeros((T, n_spk), device=device)
    code[:, idx] = 1.0
    return code


@torch.no_grad()
def _decode_batch(params: CycleVAEParams, cfg: CycleVAEConfig,
                  code: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Decode a batch of latent trajectories: z (C, T, lat) -> (C, T, out);
    one K1 launch for all C on the card."""
    C = z.shape[0]
    s = params.decoder["scale_out"]
    y0 = ((0.0 - s["mean"]) / s["scale"]).expand(C, cfg.out_dim)
    code_b = code.expand((C,) + tuple(code.shape))
    out, _, _ = gru_rnn_apply(params.decoder, cfg.dec_cfg, torch.cat([code_b, z], dim=-1), y0,
                              use_pallas=cfg.use_pallas)
    return out


def posterior_convert_hmc(
    params: CycleVAEParams, cfg: CycleVAEConfig, feats: np.ndarray,
    enc_code_idx: int, dec_code_idx: int, draws: Draws,
    n_chains: int = 8, hmc: HMCConfig = HMCConfig(
        step_size=0.02, n_leapfrog=8, n_warmup=100, n_samples=100),
    obs_scale: float = 50.0, n_predictive: int = 16,
) -> Dict[str, np.ndarray]:
    """HMC posterior over the latent trajectory of one utterance + posterior-
    predictive converted mcep, on the parameters' device.

    enc_code_idx: speaker whose decoder defines the likelihood (usually the
    source: the latent must explain the observed features through the
    source-code decoder); dec_code_idx: conversion target code.
    Returns posterior mean/std of z, posterior-predictive mean/std of the
    converted mcep, and sampler diagnostics.
    """
    dev = _device(params)
    T = feats.shape[0]
    with span("infer.posterior_convert_hmc"):
        lj = make_utterance_logjoint_batched(
            params, cfg, torch.as_tensor(np.asarray(feats, np.float32), device=dev),
            _code(T, cfg.n_spk, enc_code_idx, dev), obs_scale=obs_scale)
        z0 = torch.zeros((n_chains, T, cfg.lat_dim), device=dev)
        samples, info = hmc_sample_batch(draws, lj, z0, hmc)
        with span("infer.predictive"):
            # samples: (n_samples, C, T, lat)
            flat = samples.reshape(-1, T, cfg.lat_dim)
            # posterior predictive: decode the last n_predictive draws
            # (round-robin over chains) through the target-speaker code
            pred = _decode_batch(params, cfg, _code(T, cfg.n_spk, dec_code_idx, dev),
                                 flat[-n_predictive:])
            as_np = lambda t: fetch(t).numpy()
            return {
                "z_mean": as_np(flat.mean(dim=0)),
                "z_std": as_np(flat.std(dim=0, correction=0)),
                "cv_mcep_mean": as_np(pred.mean(dim=0)),
                "cv_mcep_std": as_np(pred.std(dim=0, correction=0)),
                "accept_prob": float(fetch(info["accept_prob"])),
                "step_size": float(fetch(info["step_size"])),
            }


def posterior_marginal_smc(
    params: CycleVAEParams, cfg: CycleVAEConfig, feats: np.ndarray,
    code_idx: int, draws: Draws, n_particles: int = 256, obs_scale: float = 50.0,
) -> Dict[str, float]:
    """SMC estimate of log p(x | decoder, speaker code) over frame latents —
    a model-evidence score usable for speaker verification / model
    comparison."""
    dev = _device(params)
    T = feats.shape[0]
    init, prop, logw = make_decoder_ssm(
        params, cfg, torch.as_tensor(np.asarray(feats, np.float32), device=dev),
        _code(T, cfg.n_spk, code_idx, dev), obs_scale=obs_scale)
    with torch.no_grad():
        _, info = smc_filter(draws, T, init, prop, logw, SMCConfig(n_particles=n_particles))
    return {"log_marginal": float(info["log_marginal"]),
            "mean_ess": float(info["ess"].mean()),
            "resample_rate": float(info["resampled"].float().mean())}


def run_infer_stage(params: CycleVAEParams, cfg: CycleVAEConfig,
                    feat_files: Sequence[str], out_path: str,
                    generator: Optional[torch.Generator] = None,
                    enc_code_idx: int = 0, dec_code_idx: int = 1, **kwargs) -> Dict:
    """Run posterior conversion over a list of utterances (their
    ``/feat_org_lf0`` in the feature store); write the posterior statistics
    into the store file ``out_path`` as ``/<basename>/{z_mean, z_std,
    cv_mcep_mean, cv_mcep_std}``.  ``generator`` (on the parameters'
    device, seed 0 by default) draws every utterance's chains in turn."""
    if generator is None:
        generator = torch.Generator(device=_device(params)).manual_seed(0)
    draws = Draws(generator)
    results = {}
    for f in feat_files:
        feats = read_store(f, "/feat_org_lf0").astype(np.float32)
        r = posterior_convert_hmc(params, cfg, feats, enc_code_idx, dec_code_idx, draws,
                                  **kwargs)
        base = os.path.splitext(os.path.basename(f))[0]
        for k in ("z_mean", "z_std", "cv_mcep_mean", "cv_mcep_std"):
            write_store(out_path, f"/{base}/{k}", r[k])
        results[base] = {"accept_prob": r["accept_prob"]}
        logging.info("posterior inference %s: accept=%.2f", base, r["accept_prob"])
    return results
