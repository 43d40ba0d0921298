"""Readings for the correctness limits: one process runs a cell's check on
several seeds with the program as configured, then on several with the
control (the program's own lower-precision path, compute dtype bfloat16),
each with a short window at the cell's own load, and prints one JSON line
per run with the numbers compared.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 3] [--fault <name>]

A limit lies above the largest program reading and below the smallest
control reading (``PERF.md`` gives both for every limit).  With ``--fault``
one of ``faults.py``'s faults is planted in the program first, for every
run of the process, to read what the check makes of it at the cell's size.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults  # noqa: E402
from benchmark.harness import core  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = core.Cell(args.workload)
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "bfloat16") for s in args.control_seeds.split(",") if s]
    for seed, dtype in runs:
        t0 = time.perf_counter()
        r = core.run_cell(cell, seed, args.seconds, False, dev, dtype=dtype)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "dtype": dtype or cell.config["model"]["compute_dtype"],
                          "correct": r["correct"], "attempted": r["attempted"],
                          "metrics": r["metrics"], "compared": r["compared"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
