"""Diagnose the amortized proposal's ESS collapse in the decoder SSM.

Port of the JAX package's ``tools/diag_smc_amortized.py``.  Per (proposal,
obs_scale) cell it reports the mean per-step incremental log-likelihood, the
mean per-step importance correction (for the amortized proposal a -KL
estimate), their net drift (what the log-marginal loses per frame), ESS,
the resample rate and the log-marginal; per obs_scale a verdict says which
proposal wins.  It also reports the mean KL(q_t || prior) of the encoder's
posterior itself.  Two hypotheses it separates: a tempered likelihood
(obs_scale >> 1) makes the prior proposal near-optimal, so the guided one
pays its KL with no likelihood gain; and the SSM's center-tap-only conv
differs from the decoder the guide was trained against.

    python -m cyclevae_tpu_torch.tools.diag_smc_amortized [--device cpu]

Writes ``--out`` (DIAG_TORCH_SMC_AMORTIZED.json).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ._common import (add_device_arg, device_entry, load_cyclevae, read_real, resolve_device,
                      synthetic_sin, write_json)
from .bench_smc_particles import encoder_latents

HIDDEN_UNITS = 1024


@torch.no_grad()
def raw_increments(draws, T: int, N: int, init, prop, logw, amortized: bool):
    """One unweighted pass (no resampling): the mean over particles and
    steps of the likelihood part of the weight and of the importance
    correction."""
    states = init(N)
    ll_t, iw_t = [], []
    for t in range(T):
        states = prop(draws, states, t)
        lw = logw(states, t)
        iw = states["log_iw"] if amortized else torch.zeros_like(lw)
        ll_t.append(torch.mean(lw - iw))
        iw_t.append(torch.mean(iw))
    return float(torch.stack(ll_t).mean()), float(torch.stack(iw_t).mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--obs-scales", type=float, nargs="+", default=[1.0, 2.0, 5.0, 10.0, 50.0])
    ap.add_argument("--real", default=None,
                    help="feature-store file of a REAL utterance (feat_org_lf0) in place of "
                         "the synthetic sinusoids: the encoder is only in-distribution on "
                         "real features")
    ap.add_argument("--spk-idx", type=int, default=0,
                    help="speaker one-hot index for --real (0=src)")
    ap.add_argument("--out", default="DIAG_TORCH_SMC_AMORTIZED.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..infer import Draws, SMCConfig, make_decoder_ssm, smc_filter
    from ..vi.train import CycleVAEConfig

    cfg = CycleVAEConfig(hidden_units=HIDDEN_UNITS, n_cyc=2)
    params, src = load_cyclevae(args.ckpt, cfg, dev)
    if src != "fresh-init":
        src = src.split("/")[0]

    T, N = args.frames, args.particles
    raw = read_real(args.real, T)
    if raw is not None:
        T = int(raw.shape[0])
        onehot = np.zeros(2, np.float32)
        onehot[args.spk_idx] = 1.0
        feats, code = raw, np.tile(onehot, (T, 1))
        data_src = os.path.basename(args.real)
    else:
        # same synthetic utterance family as bench_smc_particles
        feats = synthetic_sin(np.random.default_rng(0), T)
        code = np.tile([0.0, 1.0], (T, 1)).astype(np.float32)
        data_src = "synthetic-sin"
    feats = torch.as_tensor(feats, device=dev)
    code = torch.as_tensor(code, device=dev)

    enc_lat = encoder_latents(params, cfg, feats)
    mu = enc_lat[:, :cfg.lat_dim]
    lv = enc_lat[:, cfg.lat_dim:]
    kl_t = 0.5 * torch.sum(torch.exp(lv) + mu ** 2 - lv - 1.0, dim=-1)
    mean_kl = float(torch.mean(kl_t))
    print(f"params={src}  T={T} N={N}  mean KL(q_t || N(0,I)) = {mean_kl:.2f} nats/frame",
          flush=True)

    results = {"params": src, "data": data_src, "frames": T, "particles": N,
               "device": device_entry(dev),
               "mean_kl_q_prior_per_frame": round(mean_kl, 3), "cells": []}
    for obs_scale in args.obs_scales:
        row_pair = {}
        for proposal in ("prior", "amortized"):
            init, prop, logw = make_decoder_ssm(
                params, cfg, feats, code, obs_scale=obs_scale, proposal=proposal,
                enc_lat=enc_lat if proposal == "amortized" else None)
            with torch.no_grad():
                _, info = smc_filter(
                    Draws(torch.Generator(device=dev).manual_seed(int(obs_scale * 101))), T,
                    init, prop, logw, SMCConfig(n_particles=N))
            mean_ll, mean_iw = raw_increments(
                Draws(torch.Generator(device=dev).manual_seed(3)), T, N, init, prop, logw,
                proposal == "amortized")
            cell = {
                "log_marginal": round(float(info["log_marginal"]), 2),
                "mean_ess": round(float(torch.mean(info["ess"])), 1),
                "resample_rate": round(float(torch.mean(info["resampled"].float())), 3),
                "mean_loglik_per_step": round(mean_ll, 3),
                "mean_log_iw_per_step": round(mean_iw, 3),
            }
            row_pair[proposal] = cell
            print(f"obs_scale={obs_scale:5.1f} {proposal:9s} "
                  f"logZ={cell['log_marginal']:10.2f} "
                  f"ESS={cell['mean_ess']:7.1f} "
                  f"rr={cell['resample_rate']:.3f} "
                  f"E[loglik]={cell['mean_loglik_per_step']:9.3f} "
                  f"E[log_iw]={cell['mean_log_iw_per_step']:8.3f}", flush=True)
        dz = row_pair["amortized"]["log_marginal"] - row_pair["prior"]["log_marginal"]
        dess = row_pair["amortized"]["mean_ess"] - row_pair["prior"]["mean_ess"]
        # likelihood gain the guided proposal buys per step, vs the KL it pays
        gain = (row_pair["amortized"]["mean_loglik_per_step"]
                - row_pair["prior"]["mean_loglik_per_step"])
        pay = -row_pair["amortized"]["mean_log_iw_per_step"]
        results["cells"].append({
            "obs_scale": obs_scale, **{f"{k}_{p}": v for p, c in row_pair.items()
                                       for k, v in c.items()},
            "dlogZ_amortized_minus_prior": round(dz, 2),
            "dESS": round(dess, 1),
            "loglik_gain_per_step": round(gain, 3),
            "kl_paid_per_step": round(pay, 3),
            "amortized_wins": bool(dz > 0 and dess > 0)})
        print(f"  -> dlogZ={dz:+.2f}  dESS={dess:+.1f}  "
              f"lik-gain/step={gain:+.3f} vs KL-paid/step={pay:.3f}  "
              f"{'AMORTIZED WINS' if dz > 0 and dess > 0 else 'prior wins'}", flush=True)

    write_json(args.out, results)
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
