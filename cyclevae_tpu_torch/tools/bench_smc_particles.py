"""SMC particle-count sweep on the flagship decoder state-space model.

Port of the JAX package's ``tools/bench_smc_particles.py``: sweeps
n_particles on the (trained or fresh-init) hu=1024 decoder SSM
(``infer.make_decoder_ssm``: per particle, one decoder GRU step and a
Laplace observation weight per frame; the particles are the batch of each
product) and reports particle-steps/s = n_particles * T / filter wall time.
No kernel runs in the filter: the SSM steps the decoder one frame at a time
with batched products (``infer/smc.py``); the amortized guide is one K1
launch of the encoder over the utterance.

Proposals swept: "prior" (bootstrap), "amortized" (the raw encoder guide,
w=1) and "amortized_w0.5" (the tempered guide).  The importance correction
changes the weights, not the per-step work.  ESS and the resample rate come
along so the throughput number is quality-annotated.  ``--real`` takes a
feature-store file's ``feat_org_lf0`` (the encoder guide is only meaningful
in-distribution); absent or missing, the synthetic utterance.

    python -m cyclevae_tpu_torch.tools.bench_smc_particles [--device cpu]

Writes ``--out`` (BENCH_TORCH_SMC_PARTICLES.json).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ._common import (add_device_arg, device_entry, load_cyclevae, platform, read_real,
                      resolve_device, sync, synthetic_sin, write_json)

HIDDEN_UNITS = 1024


def encoder_latents(params, cfg, feats: torch.Tensor) -> torch.Tensor:
    """The encoder's posterior parameters (T, 2 * lat) over one utterance
    (the amortized proposal's guide)."""
    from ..models.gru_vae import gru_rnn_apply

    with torch.no_grad():
        enc_lat, _, _ = gru_rnn_apply(
            params.encoder, cfg.enc_cfg, feats[None],
            torch.zeros((1, cfg.lat_dim * 2), device=feats.device), lat_dim=cfg.lat_dim,
            clamp_vae=True, use_pallas=cfg.use_pallas)
    return enc_lat[0]


def utterance(args, T: int, dev: torch.device):
    """(feats, code, data source) as the JAX tool picks them."""
    raw = read_real(args.real, T)
    if raw is not None:
        assert raw.shape[0] >= T, (raw.shape, T)
        code = np.tile([1.0, 0.0], (T, 1)).astype(np.float32)
        src = os.path.basename(args.real)
    else:
        raw = synthetic_sin(np.random.default_rng(0), T)
        code = np.tile([0.0, 1.0], (T, 1)).astype(np.float32)
        src = "synthetic-sin"
    return torch.as_tensor(raw, device=dev), torch.as_tensor(code, device=dev), src


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--particles", type=int, nargs="+", default=[256, 512, 1024, 2048, 4096])
    ap.add_argument("--proposals", nargs="+", default=["prior", "amortized", "amortized_w0.5"])
    ap.add_argument("--obs-scale", type=float, default=1.0)
    ap.add_argument("--real", default=None,
                    help="feature-store file with feat_org_lf0 for in-distribution features; "
                         "absent/'none'/missing falls back to synthetic")
    ap.add_argument("--reps", type=int, default=3, help="timed filter repetitions (min taken)")
    ap.add_argument("--out", default="BENCH_TORCH_SMC_PARTICLES.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..infer import Draws, SMCConfig, make_decoder_ssm, smc_filter
    from ..vi.train import CycleVAEConfig

    cfg = CycleVAEConfig(hidden_units=HIDDEN_UNITS, n_cyc=2)
    params, src = load_cyclevae(args.ckpt, cfg, dev)
    T = args.frames
    feats, code, data_src = utterance(args, T, dev)
    enc_lat = encoder_latents(params, cfg, feats)

    sweeps = {}
    for proposal in args.proposals:
        guide_w = 1.0
        kind = proposal
        if proposal.startswith("amortized_w"):
            kind, guide_w = "amortized", float(proposal[len("amortized_w"):])
        init, prop, logw = make_decoder_ssm(
            params, cfg, feats, code, obs_scale=args.obs_scale, proposal=kind,
            enc_lat=enc_lat if kind == "amortized" else None, guide_weight=guide_w)
        rows = []
        for N in args.particles:
            scfg = SMCConfig(n_particles=N)

            @torch.no_grad()
            def run():
                _, info = smc_filter(Draws(torch.Generator(device=dev).manual_seed(N)), T,
                                     init, prop, logw, scfg)
                return (info["log_marginal"], torch.mean(info["ess"]),
                        torch.mean(info["resampled"].float()))

            lm, ess, rr = run()                 # warm-up
            sync(dev)
            best = np.inf
            for _ in range(args.reps):
                t0 = time.perf_counter()
                lm, ess, rr = run()
                sync(dev)
                best = min(best, time.perf_counter() - t0)
            psteps = N * T / best
            rows.append({
                "particles": N, "filter_ms": round(best * 1e3, 2),
                "particle_steps_per_sec_per_chip": round(psteps, 1),
                "log_marginal": round(float(lm), 2),
                "mean_ess": round(float(ess), 1),
                "resample_rate": round(float(rr), 3)})
            print(f"[{proposal}] N={N:5d}  {best*1e3:9.2f} ms/filter  "
                  f"{psteps:12.1f} particle-steps/s  ESS={float(ess):8.1f}  "
                  f"resample={float(rr):.3f}", flush=True)
        sweeps[proposal] = rows

    all_rows = [r for rows in sweeps.values() for r in rows]
    best = max(all_rows, key=lambda r: r["particle_steps_per_sec_per_chip"])
    best_prop = next(p for p, rows in sweeps.items() if best in rows)
    out = {"metric": "smc_particle_steps_per_sec_per_chip",
           "platform": platform(dev), "device": device_entry(dev), "params": src,
           "frames": T, "data": data_src, "obs_scale": args.obs_scale,
           "value": best["particle_steps_per_sec_per_chip"],
           "best_particles": best["particles"], "best_proposal": best_prop,
           "kernels": ("the filter none: the decoder SSM steps one frame at a time with "
                       "batched products (infer/smc.py make_decoder_ssm); the amortized "
                       "guide one K1 launch (the encoder over the utterance)"),
           "sweep": sweeps}
    write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("metric", "platform", "value", "best_particles")}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
