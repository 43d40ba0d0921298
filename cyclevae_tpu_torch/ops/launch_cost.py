"""Host time per launch of the AR-GRU kernels' wrappers, on the card.

    python -m cyclevae_tpu_torch.ops.launch_cost [--launches 200] [--rounds 7] [--B 10] [--T 80]
                                                 [--out 50]

Times loops of back-to-back calls of ``cuda_gru_ar`` (K1),
``cuda_gru_ar_train`` (K2) and ``cuda_gru_ar_bwd`` (K3) at one shape (the
train step's fused 2B decoder call by default, H=1024) with the host clock,
without synchronising inside a loop: what the host spends per launch
(checks, casts, allocations, the plan and the ctypes call), the device
running behind.  Each kernel's loop runs --rounds times, the kernels in
turns; prints one JSON line per weight dtype with the median and the least
round and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from .cuda_gru import cuda_gru_ar, cuda_gru_ar_bwd, cuda_gru_ar_train
from .gru_scan import precompute_input_gates
from ..models.layers import init_dense, init_gru_stack


def host_us(fn, n: int) -> float:
    """Host microseconds per call over n back-to-back calls; the device is
    drained before and after, not inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--B", type=int, default=10)
    ap.add_argument("--T", type=int, default=80)
    ap.add_argument("--H", type=int, default=1024)
    ap.add_argument("--out", type=int, default=50)
    ap.add_argument("--conv-dim", type=int, default=306)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    B, T, H, out = args.B, args.T, args.H, args.out
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = init_gru_stack(gen, args.conv_dim + out, H, 1)[0]
    proj = init_dense(gen, H, out)
    conv = torch.randn((B, T, args.conv_dim), generator=gen, device=dev)
    gx = precompute_input_gates(layer, conv)
    y0 = torch.zeros((B, out), device=dev)
    h0 = torch.zeros((B, H), device=dev)
    mask = (torch.rand((B, T, H), generator=gen, device=dev) < 0.5).float() * 2.0
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    for wdt in (torch.float32, torch.bfloat16):
        bwd = (proj["w"].to(wdt), layer["w_hh"].to(wdt), layer["w_ih"][:, -out:].to(wdt),
               layer["b_hh"], r(B, T, out), gx, 0.5 * r(B, T, out), torch.tanh(r(B, T, H)),
               mask, r(B, H), r(B, out))
        calls = {"K1 gru_ar": lambda: cuda_gru_ar(layer, proj, gx, y0, h0, wdt),
                 "K2 gru_ar_train": lambda: cuda_gru_ar_train(layer, proj, gx, y0, h0, mask, wdt),
                 "K3 gru_ar_bwd": lambda: cuda_gru_ar_bwd(*bwd)}
        for fn in calls.values():  # warm-up: builds, plans, allocator
            fn()
            fn()
        rounds = {name: [] for name in calls}
        for _ in range(args.rounds):
            for name, fn in calls.items():
                rounds[name].append(host_us(fn, args.launches))
        print(json.dumps({
            "shape": dict(B=B, T=T, H=H, out=out), "weight_dtype": str(wdt).split(".")[-1],
            "launches": args.launches, "rounds": args.rounds,
            "host_us_per_launch_median": {n: statistics.median(r) for n, r in rounds.items()},
            "host_us_per_launch_least": {n: min(r) for n, r in rounds.items()},
            "card": torch.cuda.get_device_name(0), "card_line": card_line}), flush=True)


if __name__ == "__main__":
    main()
