"""Where one step of the WaveRNN sampling kernel (K4) spends its time, on the card.

    python -m cyclevae_tpu_torch.ops.wavernn_phases [--B 1] [--T 4000] [--temperature 0.8]

Builds ``csrc/wavernn.cu`` a second time with ``-DWAVERNN_PROFILE`` (thread 0
of block 0 sums the SM cycles of each phase of every step), runs it on random
weights at the flagship width (``WaveRNNConfig`` defaults: H=896, 256
classes, fc 128), and prints each phase's cycles per step and its share,
beside the per-sample time of the normal build from CUDA events, the plan
(grid, units per block, cluster size, f-stage rows, shared bytes) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import _build
from .cuda_wavernn import cuda_wavernn_generate, launch, plan
from ..models.wavernn import WaveRNNConfig, init_wavernn

PHASES = ("wait for the cluster's candidates", "merge, gates and h_t", "fc1 partial, pushed",
          "wait for the cluster's partials", "cluster sum stored with its tag, step count",
          "noise, wait for the step count", "poll h and the cluster partials", "sum f", "logits",
          "rank argmax", "candidates pushed", "Whh dot products")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--T", type=int, default=4000)
    ap.add_argument("--temperature", type=float, default=0.8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = WaveRNNConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_wavernn(gen, cfg)
    cond = torch.tanh(torch.randn((args.B, args.T, cfg.cond_dim), generator=gen, device=dev))
    call = (params, cfg, cond, 0, args.temperature)

    for _ in range(2):
        cuda_wavernn_generate(*call)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        cuda_wavernn_generate(*call)
    end.record()
    torch.cuda.synchronize()
    us_sample = start.elapsed_time(end) / 3 * 1e3 / args.T

    prof = _build.load("wavernn", ("WAVERNN_PROFILE",))
    prof.wavernn_profile_read.argtypes = [ctypes.c_void_p]
    prof.wavernn_profile_read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * len(PHASES))()
    launch(prof, *call)
    torch.cuda.synchronize()
    _build.check(prof, prof.wavernn_profile_read(counts), "profile reset")
    launch(prof, *call)
    torch.cuda.synchronize()
    _build.check(prof, prof.wavernn_profile_read(counts), "profile read")
    per_step = [c / args.T for c in counts]
    total = sum(per_step)
    print(json.dumps({
        "shape": dict(B=args.B, T=args.T, H=cfg.hidden_units, K=cfg.n_classes, fc=cfg.fc_dim),
        "temperature": args.temperature,
        "plan": dict(zip(("grid", "units", "cluster", "stage_rows", "smem"),
                         plan(prof, args.B, cfg.hidden_units, cfg.n_classes, cfg.fc_dim))),
        "us_per_sample": us_sample,
        "cycles_per_step": total,
        "phases": {p: {"cycles": c, "share": c / total} for p, c in zip(PHASES, per_step)},
        "card": torch.cuda.get_device_name(0),
        "card_line": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()}))


if __name__ == "__main__":
    main()
