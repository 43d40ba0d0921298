"""Where one frame of the AR-GRU forward kernel (K1; K2 with --train) spends its time, on the card.

    python -m cyclevae_tpu_torch.ops.gru_ar_phases [--B 3] [--T 1120] [--H 1024] [--out 50]
                                                   [--train]

Builds ``csrc/gru_ar.cu`` a second time with ``-DGRU_AR_PROFILE`` (thread 0 of
block 0 sums the SM cycles of each phase of every frame), runs it on random
weights at the given shape in float32 and bf16 (``--train``: the training
forward, K2, with a 0.5-keep inverted-dropout mask), and prints one JSON line
per dtype: the plan, the normal build's us per frame from CUDA events, each
phase's cycles per frame and its share, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import _build
from .cuda_gru import PHASES, PLAN_KEYS, cuda_gru_ar, cuda_gru_ar_train, launch, plan
from .gru_scan import precompute_input_gates
from ..models.layers import init_dense, init_gru_stack


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=3)
    ap.add_argument("--T", type=int, default=1120)
    ap.add_argument("--H", type=int, default=1024)
    ap.add_argument("--out", type=int, default=50)
    ap.add_argument("--conv-dim", type=int, default=306)
    ap.add_argument("--train", action="store_true",
                    help="profile the training forward (K2) with a dropout mask")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = init_gru_stack(gen, args.conv_dim + args.out, args.H, 1)[0]
    proj = init_dense(gen, args.H, args.out)
    gx = precompute_input_gates(
        layer, torch.randn((args.B, args.T, args.conv_dim), generator=gen, device=dev))
    y0 = torch.zeros((args.B, args.out), device=dev)
    h0 = torch.zeros((args.B, args.H), device=dev)
    mask = (torch.rand((args.B, args.T, args.H), generator=gen, device=dev) < 0.5).float() * 2.0

    prof = _build.load("gru_ar", ("GRU_AR_PROFILE",))
    prof.gru_ar_profile_read.argtypes = [ctypes.c_void_p]
    prof.gru_ar_profile_read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * len(PHASES))()
    for wdt in (torch.float32, torch.bfloat16):
        if args.train:
            fn, call, extra = cuda_gru_ar_train, (layer, proj, gx, y0, h0, mask, wdt), (mask,)
        else:
            fn, call, extra = cuda_gru_ar, (layer, proj, gx, y0, h0, wdt), ()
        for _ in range(2):
            fn(*call)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn(*call)
        end.record()
        torch.cuda.synchronize()
        us_frame = start.elapsed_time(end) / 10 * 1e3 / args.T

        pcall = (prof, layer, proj, gx, y0, h0, wdt) + extra
        launch(*pcall)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_profile_read(counts), "profile reset")
        launch(*pcall)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_profile_read(counts), "profile read")
        per_frame = [c / args.T for c in counts]
        total = sum(per_frame)
        print(json.dumps({
            "kernel": "K2 gru_ar_train" if args.train else "K1 gru_ar",
            "shape": dict(B=args.B, T=args.T, H=args.H, out=args.out),
            "weight_dtype": str(wdt).split(".")[-1],
            "plan": dict(zip(PLAN_KEYS, plan(prof, args.B, args.H, args.out, wdt, args.train))),
            "us_per_frame": us_frame,
            "cycles_per_frame": total,
            "phases": {p: {"cycles": c, "share": c / total} for p, c in zip(PHASES, per_frame)},
            "card": torch.cuda.get_device_name(0),
            "card_line": card_line}), flush=True)


if __name__ == "__main__":
    main()
