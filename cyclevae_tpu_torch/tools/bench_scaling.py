"""Scaling report: sharded-chain HMC on the DECODER LOG-JOINT over ranks.

Port of the JAX package's ``bench_scaling.py`` (and of
``tools/bench_scaling_multihost.py``, which compares in-process collectives
with cross-process ones: here every rank is a process already).  The
workload is per-utterance latent posterior inference against the frozen
flagship decoder (hu=1024): chains of ``infer.make_utterance_logjoint``,
every leapfrog differentiating through the decoder's AR recurrence (K2, K3),
sharded over a group of processes by ``infer.hmc_sample_sharded``; the
ranks are spawned by ``parallel.spawn.spawn_ranks`` for each point of a
curve, over gloo.

Ranks sit on the card by default; on one card the N ranks share it (its
time is divided among them, so the weak curve there measures the sharing,
not added hardware).  With ``--device cpu`` they are CPU processes, which
share the host's cores as the JAX tool's virtual CPU devices do.  Two
curves:

  * ``fixed_work``: the same total chain set on 1 rank vs sharded over N;
    total work is constant, so efficiency isolates the sharded path's
    overhead (per step a gather of the adaptation statistics);
  * ``weak``: chains per rank fixed, ranks 1..N.

    python -m cyclevae_tpu_torch.tools.bench_scaling [--ranks 1 2] [--device cpu]

Writes ``--out`` (BENCH_TORCH_SCALING.json).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ._common import add_device_arg, device_entry, platform, resolve_device, write_json

HIDDEN_UNITS = 1024
HMC = dict(step_size=0.05, n_leapfrog=4, n_warmup=4, n_samples=8)


def rank_run(rank: int, world: int, spec: dict) -> dict:
    """One rank of a point: the sharded sampler twice (the first warms the
    builds and plans), the second timed; its seconds and sample sums."""
    from ..infer import Draws, HMCConfig, hmc_sample_sharded, make_utterance_logjoint
    from ..parallel.mesh import make_mesh
    from ..vi.train import CycleVAEConfig
    from ._common import kernel_launches, launches_since, load_cyclevae, sync

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = CycleVAEConfig(hidden_units=spec["hidden_units"])
    params, _ = load_cyclevae(spec["ckpt"], cfg, dev)
    lj = make_utterance_logjoint(params, cfg, torch.as_tensor(spec["feats"], device=dev),
                                 torch.as_tensor(spec["code"], device=dev))
    mesh = make_mesh(world, device=dev)
    hcfg = HMCConfig(**spec["hmc"])
    z0 = torch.zeros((spec["chains"], spec["feats"].shape[0], cfg.lat_dim), device=dev)
    before = kernel_launches()
    s, _ = hmc_sample_sharded(mesh, Draws(torch.Generator(device=dev).manual_seed(spec["key"])),
                              lj, z0, hcfg)
    sync(dev)
    t0 = time.perf_counter()
    s, _ = hmc_sample_sharded(
        mesh, Draws(torch.Generator(device=dev).manual_seed(spec["key"] + 1)), lj, z0, hcfg)
    sync(dev)
    return {"seconds": time.perf_counter() - t0, "finite": bool(torch.isfinite(s).all()),
            "launches": launches_since(before)}


def run_point(n_ranks: int, C: int, key: int, base: dict, iters_per_chain: int,
              launches: dict) -> float:
    """Samples (iterations x chains) per second of C chains sharded over
    ``n_ranks`` ranks: the slowest rank's timed run.  Adds the ranks' kernel
    launches to ``launches``."""
    from ..parallel.spawn import spawn_ranks

    outs = spawn_ranks(rank_run, n_ranks, (dict(base, chains=C, key=key),),
                       backend="gloo", timeout_s=1800,
                       threads=1 if base["device"] == "cpu" else 2)
    if not all(o["finite"] for o in outs):
        raise FloatingPointError(f"non-finite samples at {n_ranks} ranks, {C} chains")
    for o in outs:
        for k, n in o["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return C * iters_per_chain / max(o["seconds"] for o in outs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="CycleVAE checkpoint; absent or 'none': a fresh init")
    ap.add_argument("--frames", type=int, default=40,
                    help="utterance length (frames) for the target")
    ap.add_argument("--chains-per-device", type=int, default=1)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="rank counts of each curve")
    ap.add_argument("--full-mesh-only", action="store_true",
                    help="measure only the largest rank count")
    ap.add_argument("--out", default="BENCH_TORCH_SCALING.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    T = args.frames
    rng = np.random.default_rng(0)
    t = np.arange(T)[:, None]
    feats = (np.sin(t * 0.05 + np.arange(54)[None, :])
             + 0.1 * rng.normal(size=(T, 54))).astype(np.float32)
    code = np.tile([0.0, 1.0], (T, 1)).astype(np.float32)
    base = {"device": str(dev), "hidden_units": HIDDEN_UNITS, "ckpt": args.ckpt,
            "feats": feats, "code": code, "hmc": dict(HMC)}
    iters_per_chain = HMC["n_warmup"] + HMC["n_samples"]

    n_dev_all = sorted(args.ranks)
    if args.full_mesh_only:
        n_dev_all = n_dev_all[-1:]
    n_max = n_dev_all[-1]

    # --- fixed total work: C_total chains on 1 rank vs sharded over N ---
    fixed, launches = {}, {}
    C_total = args.chains_per_device * n_max
    ref = None
    for n_dev in n_dev_all:
        rate = run_point(n_dev, C_total, 10 + n_dev, base, iters_per_chain, launches)
        ref = ref or rate
        fixed[str(n_dev)] = {"samples_per_sec": round(rate, 2), "vs_1dev": round(rate / ref, 3)}
        print(f"fixed-work C={C_total} ranks={n_dev}: {rate:.2f} it/s "
              f"({rate / ref:.2%} of 1-rank)", flush=True)

    # --- weak scaling: chains per rank fixed ---
    weak = {}
    ref = None
    for n_dev in n_dev_all:
        C = args.chains_per_device * n_dev
        rate = run_point(n_dev, C, 20 + n_dev, base, iters_per_chain, launches)
        ref = ref or rate
        eff = rate / (ref * n_dev)
        weak[str(n_dev)] = {"samples_per_sec": round(rate, 2), "efficiency": round(eff, 3)}
        print(f"weak C/rank={args.chains_per_device} ranks={n_dev}: "
              f"{rate:.2f} it/s, efficiency={eff:.2%}", flush=True)

    out = {
        "metric": "decoder_logjoint_hmc_iters_per_sec",
        "workload": {
            "target": f"make_utterance_logjoint (flagship decoder hu={HIDDEN_UNITS})",
            "params": os.path.basename(args.ckpt) if args.ckpt and args.ckpt != "none"
            else "fresh-init", "frames": T, "lat_dim": 32, "hmc": dict(HMC),
        },
        "platform": platform(dev),
        "device": device_entry(dev),
        "processes": n_max,
        "ranks_share_one_device": dev.type == "cpu" or torch.cuda.device_count() == 1,
        "host_cores": os.cpu_count(),
        "fixed_work": fixed,
        "weak_scaling": weak,
        "launches": launches,
        "note": ("ranks are processes over gloo; on one card (or the host's cores) the ranks "
                 "share it, so the weak curve measures sharing; fixed_work isolates the "
                 "sharded path's overhead (per step a gather of O(1) scalars per chain)"),
    }
    write_json(args.out, out, indent=2)
    print("wrote", args.out, flush=True)
    return out


if __name__ == "__main__":
    main()
