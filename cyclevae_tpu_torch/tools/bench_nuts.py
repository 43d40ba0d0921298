"""Batched-chain NUTS throughput on the flagship decoder log-joint.

Port of the JAX package's ``tools/bench_nuts.py``.  NUTS transition cost is
data-dependent (tree depth varies per transition), so the primary metric is
grad-evals/s: each live leapfrog is one gradient of the log-joint through
the decoder's AR recurrence (K2 forward, K3 backward), counted exactly by
the sampler (``info["mean_leapfrog"]``), with samples/s and the sampling
statistics alongside.  Each row also reports its K2 and K3 launches per
iteration (a chain count past one launch's rows runs in row blocks,
``ops/cuda_gru.py``).

Workload as ``bench_hmc_chains``: per-utterance latent posterior z (C, T,
32) against the frozen hu=1024 decoder, ``infer.make_utterance_logjoint_
batched``, chains riding the decoder's batch axis in lockstep
(``infer/nuts_batch.py``).  ``--real`` takes a feature-store file's
``feat_org_lf0``; absent or missing, the synthetic utterance.

    python -m cyclevae_tpu_torch.tools.bench_nuts [--device cpu]

Writes ``--out`` (BENCH_TORCH_NUTS.json).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ._common import (add_device_arg, device_entry, kernel_launches, launches_since,
                      load_cyclevae, platform, read_real, resolve_device, sync, synthetic_sin,
                      write_json)

HIDDEN_UNITS = 1024


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--chains", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--max-depths", type=int, nargs="+", default=[6, 8, 10],
                    help="sweep depth and report saturation")
    ap.add_argument("--real", default=None,
                    help="feature-store file with feat_org_lf0; absent/'none'/missing -> "
                         "synthetic")
    ap.add_argument("--warmup", type=int, default=24)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--target-accepts", type=float, nargs="+", default=[0.8],
                    help="dual-averaging targets")
    ap.add_argument("--mode", choices=["f32", "fast", "both"], default="fast")
    ap.add_argument("--out", default="BENCH_TORCH_NUTS.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from dataclasses import replace as dc_replace

    from ..infer import Draws, NUTSConfig, make_utterance_logjoint_batched, nuts_sample_batch
    from ..infer.logjoint import value_and_grad
    from ..vi.train import CycleVAEConfig

    cfg = CycleVAEConfig(hidden_units=HIDDEN_UNITS, n_cyc=2)
    params, src = load_cyclevae(args.ckpt, cfg, dev)

    T, ld = args.frames, cfg.lat_dim
    rng = np.random.default_rng(0)
    raw = read_real(args.real, T)
    if raw is not None:
        feats, code = raw, np.tile([1.0, 0.0], (T, 1)).astype(np.float32)
        data_src = os.path.basename(args.real)
    else:
        feats, code = synthetic_sin(rng, T), np.tile([0.0, 1.0], (T, 1)).astype(np.float32)
        data_src = "synthetic-sin"
    feats_d, code_d = torch.as_tensor(feats, device=dev), torch.as_tensor(code, device=dev)
    total_iters = args.warmup + args.iters

    modes = {"f32": cfg, "fast": dc_replace(cfg, compute_dtype="bfloat16")}
    if args.mode != "both":
        modes = {args.mode: modes[args.mode]}

    sweeps = {}
    for mode, cfg_m in modes.items():
        rows = []
        lj = make_utterance_logjoint_batched(params, cfg_m, feats_d, code_d)
        for depth in args.max_depths:
            for target in args.target_accepts:
                ncfg = NUTSConfig(step_size=0.02, max_depth=depth, n_warmup=args.warmup,
                                  n_samples=args.iters, target_accept=target)
                for C in args.chains:
                    z0 = torch.as_tensor(rng.normal(size=(C, T, ld)).astype(np.float32) * 0.1,
                                         device=dev)
                    value_and_grad(lj, z0)      # warm-up: builds and row-block plans
                    sync(dev)
                    before = kernel_launches()
                    t0 = time.perf_counter()
                    samples, info = nuts_sample_batch(
                        Draws(torch.Generator(device=dev).manual_seed(C)), lj, z0, ncfg)
                    mean = float(samples.mean())
                    sync(dev)
                    dt = time.perf_counter() - t0
                    n = launches_since(before)
                    acc, div, ss, mlf, sat = (float(info[k]) for k in (
                        "accept_stat", "divergence_rate", "step_size", "mean_leapfrog",
                        "saturation_rate"))
                    per_iter = dt / total_iters
                    sps = C / per_iter
                    # each live leapfrog = one fresh log-joint gradient
                    grad_evals = C * mlf / per_iter
                    rows.append({
                        "chains": C, "max_depth": depth,
                        "target_accept": target,
                        "iter_ms": round(per_iter * 1e3, 2),
                        "samples_per_sec_per_chip": round(sps, 1),
                        "grad_evals_per_sec_per_chip": round(grad_evals, 1),
                        "mean_leapfrog_per_iter": round(mlf, 1),
                        "leapfrog_cap": (1 << depth) - 1,
                        "saturation_rate": round(sat, 3),
                        "accept_stat": round(acc, 3),
                        "divergence_rate": round(div, 4),
                        "da_step_size": round(ss, 5),
                        "k2_launches_per_iter": n["K2"] / total_iters,
                        "k3_launches_per_iter": n["K3"] / total_iters,
                        "finite": bool(np.isfinite(mean))})
                    print(f"[{mode}] d={depth:2d} ta={target:.2f} C={C:4d} "
                          f"{per_iter*1e3:9.2f} ms/iter  {sps:8.1f} samples/s  "
                          f"{grad_evals:10.1f} grad-evals/s  lf/iter={mlf:6.1f}"
                          f"/{(1 << depth) - 1}  sat={sat:.3f}  accept={acc:.3f}", flush=True)
        sweeps[mode] = rows

    all_rows = [r for rows in sweeps.values() for r in rows]
    # headline = fastest NON-SATURATED operating point (genuine NUTS); fall
    # back to the overall best if every row saturates
    genuine = [r for r in all_rows if r["saturation_rate"] < 0.5]
    pool = genuine or all_rows
    best = max(pool, key=lambda r: r["grad_evals_per_sec_per_chip"])
    best_mode = next(m for m, rows in sweeps.items() if best in rows)
    out = {"metric": "nuts_grad_evals_per_sec_per_chip",
           "platform": platform(dev), "device": device_entry(dev), "params": src,
           "data": data_src, "frames": T, "lat_dim": ld, "max_depths": args.max_depths,
           "target_accepts": args.target_accepts,
           "value": best["grad_evals_per_sec_per_chip"],
           "best_chains": best["chains"], "best_mode": best_mode,
           "best_max_depth": best["max_depth"],
           "best_saturation_rate": best["saturation_rate"],
           "headline_is_nonsaturated": bool(genuine),
           "sweep": sweeps}
    write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("metric", "platform", "value", "best_chains")}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
