"""Trajectory-length sweep for batched-chain HMC on the flagship decoder.

Port of the JAX package's ``tools/bench_hmc_trajlen.py``: sweeps
(n_leapfrog, target_accept, adapt_mass) operating points with one call of
the port's ``bench_hmc_chains.main`` per point (in this process) and merges
one artifact.

Fault tolerance: a point that raises is recorded as ``{"fault": true,
"error": "<type: message>"}`` and the sweep goes on, as the JAX tool records
a faulting point.

ESS-estimator cap: with --iters S samples the per-chain initial-positive-
sequence estimate cannot exceed ess_fraction 1.0, so rows whose
ess_fraction ~= 1.0 are lower bounds on the true ESS/s.

    python -m cyclevae_tpu_torch.tools.bench_hmc_trajlen [--device cpu]

Writes ``--out`` (BENCH_TORCH_HMC_TRAJLEN.json).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from . import bench_hmc_chains
from ._common import add_device_arg, device_entry, resolve_device, write_json

# L,target_accept,adapt_mass: the JAX tool's grid around L=8, ta=0.9, mass on
DEFAULT_POINTS = [
    "8,0.9,on", "16,0.8,on", "32,0.9,on", "32,0.7,on", "32,0.7,off",
    "64,0.7,on",
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--points", nargs="+", default=DEFAULT_POINTS,
                    help="comma triples n_leapfrog,target_accept,adapt_mass")
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--warmup", type=int, default=48)
    ap.add_argument("--mode", default="fast", help="fast = K2/K3 in bf16")
    ap.add_argument("--out", default="BENCH_TORCH_HMC_TRAJLEN.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    with tempfile.TemporaryDirectory(prefix="hmc_trajlen_") as tmp:
        for spec in args.points:
            l_s, ta_s, mass = spec.split(",")
            L, ta = int(l_s), float(ta_s)
            part = os.path.join(tmp, f"hmc_trajlen_{spec.replace(',', '_')}.json")
            cmd = ["--chains", str(args.chains), "--n-leapfrog", str(L),
                   "--iters", str(args.iters), "--warmup", str(args.warmup),
                   "--target-accept", str(ta), "--mode", args.mode, "--adapt-mass", mass,
                   "--out", part, "--device", str(dev)]
            if args.ckpt:
                cmd += ["--ckpt", args.ckpt]
            print("+ bench_hmc_chains", " ".join(cmd), flush=True)
            try:
                d = bench_hmc_chains.main(cmd)
            except Exception as e:  # noqa: BLE001 -- record the fault, keep sweeping
                rows.append({"n_leapfrog": L, "target_accept": ta, "adapt_mass": mass == "on",
                             "fault": True, "error": f"{type(e).__name__}: {e}"})
                print(f"point {spec}: FAULT {type(e).__name__}: {e} (recorded, continuing)",
                      flush=True)
                continue
            row = dict(d["sweep"][args.mode][0])
            row["n_leapfrog"] = L
            row["target_accept"] = ta
            row["ckpt"] = d.get("params", "?")
            rows.append(row)
            print(f"point {spec}: ESS/s={row.get('ess_per_sec_per_chip')} "
                  f"ess_fraction={row.get('ess_fraction')} "
                  f"eps={row.get('da_step_size')} "
                  f"samples/s={row.get('samples_per_sec_per_chip')}", flush=True)

    ok = [r for r in rows if not r.get("fault")]
    best = max(ok, key=lambda r: r.get("ess_per_sec_per_chip", 0.0)) if ok else {}
    out = {
        "metric": "hmc_ess_per_sec_per_chip_vs_trajectory_length",
        "device": device_entry(dev),
        "value": best.get("ess_per_sec_per_chip"),
        "unit": "ESS/s/chip",
        "best_point": {k: best.get(k) for k in
                       ("n_leapfrog", "target_accept", "adapt_mass",
                        "ess_per_sec_per_chip", "ess_fraction",
                        "da_step_size", "accept")},
        "chains": args.chains,
        "iters": args.iters,
        "mode": args.mode,
        "n_faulting_points": sum(1 for r in rows if r.get("fault")),
        "ess_estimator_note": ("initial-positive-sequence on a "
                               f"{args.iters}-sample global-mean trace; "
                               "ess_fraction ~= 1.0 rows are lower bounds"),
        "rows": rows,
    }
    write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("metric", "value", "unit", "best_point")}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
