"""Chain-count sweep for batched-chain HMC on the flagship decoder log-joint.

Port of the JAX package's ``tools/bench_hmc_chains.py``: sweeps n_chains and
reports samples/s at each point on the card.

Workload: per-utterance latent posterior inference against the frozen
flagship (hu=1024) decoder, ``infer.make_utterance_logjoint_batched`` with
chains riding the decoder's batch axis, z of shape (C, T, 32), T=256.  Each
HMC iteration costs ``2*n_leapfrog`` log-joint gradients (K2 forward, K3
backward, through the decoder's AR recurrence) plus 2 log-joint values (K2);
every iteration (warm-up or sampling) costs the same, so samples/s = C /
per-iteration time.  A chain count past one kernel launch's rows runs in row
blocks (``ops/cuda_gru.py``): each row reports its K2 and K3 launches per
iteration, which shows where the blocks begin.

Modes: ``f32`` takes K2/K3 with float32 weights (the JAX tool's ``f32`` is
its XLA scan; the port's configurations default to the kernel route),
``fast`` takes them in bf16.  The JAX tool's skip of f32 past 256 chains
(a TPU fault) has no counterpart.  Each point is timed once after a warm-up
log-joint gradient at its chain count (nothing is compiled in the port).

    python -m cyclevae_tpu_torch.tools.bench_hmc_chains [--device cpu]

Writes ``--out`` (BENCH_TORCH_HMC_CHAINS.json).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ._common import (add_device_arg, device_entry, kernel_launches, launches_since,
                      load_cyclevae, platform, resolve_device, sync, synthetic_sin, timed,
                      write_json)

HIDDEN_UNITS = 1024


def ess_fraction(trace: np.ndarray) -> float:
    """Mean ESS/S over chains via the initial-positive-sequence
    autocorrelation estimator (Geyer 1992) on a (S, C) scalar trace."""
    S, C = trace.shape
    fracs = []
    for c in range(C):
        x = trace[:, c] - trace[:, c].mean()
        v = float(np.dot(x, x)) / S
        if v <= 0:
            fracs.append(1.0)
            continue
        acf = np.correlate(x, x, mode="full")[S - 1:] / (S * v)
        s, k = 0.0, 1
        while k + 1 < S:
            pair = acf[k] + acf[k + 1]
            if pair <= 0:
                break
            s += pair
            k += 2
        fracs.append(1.0 / max(1.0, 1.0 + 2.0 * s))
    return float(np.mean(fracs))


def kinetic_ms(z: torch.Tensor, dev: torch.device) -> float:
    """ms of the sampler's per-chain kinetic energy (``infer/hmc.py``
    ``kinetic``: one sum per chain, C small launches), twice per iteration."""
    C = z.shape[0]
    p = torch.randn_like(z)
    inv_mass = torch.ones_like(z[0])

    def kinetic():
        e = 0.5 * inv_mass * p ** 2
        return torch.stack([torch.sum(e[c]) for c in range(C)])
    return 2.0 * timed(kinetic, dev, reps=5) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="CycleVAE checkpoint; absent or 'none': a fresh init")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--chains", type=int, nargs="+", default=[32, 64, 128, 256, 512])
    ap.add_argument("--n-leapfrog", type=int, default=8)
    ap.add_argument("--iters", type=int, default=48,
                    help="timed HMC sampling iterations per chain count")
    ap.add_argument("--warmup", type=int, default=48,
                    help="dual-averaging warm-up iterations (adapts the step size to "
                         "--target-accept so acceptance is comparable across chain counts)")
    ap.add_argument("--target-accept", type=float, default=0.9)
    ap.add_argument("--mode", choices=["f32", "fast", "both"], default="both",
                    help="decoder path: K2/K3 in float32, in bf16, or sweep both")
    ap.add_argument("--adapt-mass", choices=["on", "off", "both"], default="both",
                    help="A/B the windowed diagonal mass adaptation against identity mass; "
                         "ESS/s is the honest currency")
    ap.add_argument("--out", default="BENCH_TORCH_HMC_CHAINS.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from dataclasses import replace as dc_replace

    from ..infer import Draws, HMCConfig, hmc_sample_batch, make_utterance_logjoint_batched
    from ..infer.logjoint import value_and_grad
    from ..vi.train import CycleVAEConfig

    cfg = CycleVAEConfig(hidden_units=HIDDEN_UNITS, n_cyc=2)
    params, src = load_cyclevae(args.ckpt, cfg, dev)

    T, ld = args.frames, cfg.lat_dim
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(synthetic_sin(rng, T), device=dev)
    code = torch.as_tensor(np.tile([0.0, 1.0], (T, 1)).astype(np.float32), device=dev)

    mass_settings = {"on": [True], "off": [False], "both": [True, False]}[args.adapt_mass]
    total_iters = args.warmup + args.iters
    modes = {"f32": cfg, "fast": dc_replace(cfg, compute_dtype="bfloat16")}
    if args.mode != "both":
        modes = {args.mode: modes[args.mode]}

    sweeps = {}
    for mode, cfg_m in modes.items():
        rows = []
        lj = make_utterance_logjoint_batched(params, cfg_m, feats, code)
        for adapt_mass in mass_settings:
            hmc_cfg = HMCConfig(step_size=0.02, n_leapfrog=args.n_leapfrog,
                                n_warmup=args.warmup, n_samples=args.iters,
                                target_accept=args.target_accept, adapt_mass=adapt_mass)
            for C in args.chains:
                z0 = torch.as_tensor(rng.normal(size=(C, T, ld)).astype(np.float32) * 0.1,
                                     device=dev)
                value_and_grad(lj, z0)       # warm-up: kernel builds and row-block plans
                sync(dev)
                before = kernel_launches()
                t0 = time.perf_counter()
                samples, info = hmc_sample_batch(Draws(torch.Generator(device=dev).manual_seed(C)),
                                                 lj, z0, hmc_cfg)
                trace = samples.mean(dim=(2, 3)).cpu().numpy()      # (S, C)
                sync(dev)
                dt = time.perf_counter() - t0
                n = launches_since(before)
                acc, ss = float(info["accept_prob"]), float(info["step_size"])
                per_iter = dt / total_iters
                sps = C / per_iter
                ef = ess_fraction(trace)
                grad_evals = C * 2 * args.n_leapfrog / per_iter
                rows.append({"chains": C, "adapt_mass": adapt_mass,
                             "iter_ms": per_iter * 1e3,
                             "samples_per_sec_per_chip": round(sps, 1),
                             "accept": round(acc, 3),
                             "da_step_size": round(ss, 5),
                             "ess_fraction": round(ef, 3),
                             "ess_per_sec_per_chip": round(sps * ef, 1),
                             "grad_evals_per_sec": round(grad_evals, 1),
                             "k2_launches_per_iter": n["K2"] / total_iters,
                             "k3_launches_per_iter": n["K3"] / total_iters,
                             "kinetic_ms_per_iter": kinetic_ms(z0, dev),
                             "finite": bool(np.isfinite(trace).all())})
                print(f"[{mode}] mass={'Y' if adapt_mass else 'n'} "
                      f"C={C:4d}  {per_iter*1e3:8.2f} ms/iter  "
                      f"{sps:10.1f} samples/s/chip  accept={acc:.3f}  "
                      f"eps={ss:.4f}  ESS/s={sps*ef:.1f}", flush=True)
        sweeps[mode] = rows

    all_rows = [r for rows in sweeps.values() for r in rows]
    best = max(all_rows, key=lambda r: r["samples_per_sec_per_chip"])
    best_mode = next(m for m, rows in sweeps.items() if best in rows)
    best_ess = max(all_rows, key=lambda r: r["ess_per_sec_per_chip"])
    out = {"metric": "hmc_samples_per_sec_per_chip",
           "platform": platform(dev), "device": device_entry(dev), "params": src,
           "frames": T, "lat_dim": ld, "n_leapfrog": args.n_leapfrog,
           "n_warmup_da": args.warmup, "target_accept": args.target_accept,
           "value": best["samples_per_sec_per_chip"],
           "best_chains": best["chains"], "best_mode": best_mode,
           "best_ess_per_sec_per_chip": best_ess["ess_per_sec_per_chip"],
           "best_ess_row": {k: best_ess[k] for k in ("chains", "adapt_mass", "accept")},
           "sweep": sweeps}
    write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("metric", "platform", "value", "best_chains")}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
