"""Where one frame of the AR-GRU kernel spends its time, on the card.

    python -m cyclevae_tpu_torch.ops.gru_ar_phases [--B 3] [--T 1120] [--H 1024] [--out 50]

Builds ``csrc/gru_ar.cu`` a second time with ``-DGRU_AR_PROFILE`` (thread 0 of
block 0 sums the SM cycles of each phase of every frame), runs it on random
weights at the given shape in float32 and bf16, and prints each phase's
cycles per frame and its share, beside the per-frame time of the normal build
from CUDA events and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import _build
from .cuda_gru import cuda_gru_ar, launch
from .gru_scan import precompute_input_gates
from ..models.layers import init_dense, init_gru_stack

PHASES = ("copy h and y partials, sum y", "gate-row dot products", "warp sums",
          "gates and h_t", "wait for the block", "y partial", "grid barrier")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=3)
    ap.add_argument("--T", type=int, default=1120)
    ap.add_argument("--H", type=int, default=1024)
    ap.add_argument("--out", type=int, default=50)
    ap.add_argument("--conv-dim", type=int, default=306)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = init_gru_stack(gen, args.conv_dim + args.out, args.H, 1)[0]
    proj = init_dense(gen, args.H, args.out)
    gx = precompute_input_gates(
        layer, torch.randn((args.B, args.T, args.conv_dim), generator=gen, device=dev))
    y0 = torch.zeros((args.B, args.out), device=dev)
    h0 = torch.zeros((args.B, args.H), device=dev)

    prof = _build.load("gru_ar", ("GRU_AR_PROFILE",))
    prof.gru_ar_profile_read.argtypes = [ctypes.c_void_p]
    prof.gru_ar_profile_read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * len(PHASES))()
    for wdt in (torch.float32, torch.bfloat16):
        call = (layer, proj, gx, y0, h0, wdt)
        for _ in range(2):
            cuda_gru_ar(*call)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            cuda_gru_ar(*call)
        end.record()
        torch.cuda.synchronize()
        us_frame = start.elapsed_time(end) / 5 * 1e3 / args.T

        launch(prof, *call)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_profile_read(counts), "profile reset")
        launch(prof, *call)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_profile_read(counts), "profile read")
        per_frame = [c / args.T for c in counts]
        total = sum(per_frame)
        print(json.dumps({
            "shape": dict(B=args.B, T=args.T, H=args.H, out=args.out),
            "weight_dtype": str(wdt).split(".")[-1],
            "us_per_frame": us_frame,
            "cycles_per_frame": total,
            "phases": {p: {"cycles": c, "share": c / total}
                       for p, c in zip(PHASES, per_frame)},
            "card": torch.cuda.get_device_name(0),
            "card_line": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()}))


if __name__ == "__main__":
    main()
