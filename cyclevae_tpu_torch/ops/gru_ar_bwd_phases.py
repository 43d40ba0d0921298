"""Where one reversed step of the AR-GRU backward kernel (K3) spends its time, on the card.

    python -m cyclevae_tpu_torch.ops.gru_ar_bwd_phases [--B 10] [--T 80] [--H 1024] [--out 50]

Builds ``csrc/gru_ar_bwd.cu`` a second time with ``-DGRU_AR_BWD_PROFILE``
(thread 0 of block 0 sums the SM cycles of each phase of every reversed
step), runs it on random inputs at the given shape in float32 and bf16, and
prints one JSON line per dtype: the plan, the normal build's us per step
from CUDA events, each phase's cycles per step and its share, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import _build
from .cuda_gru import BWD_PHASES, BWD_PLAN_KEYS, cuda_gru_ar_bwd, launch_bwd, plan_bwd


def random_bwd_args(dev: torch.device, B: int, T: int, H: int, out: int,
                    wdt: torch.dtype, seed: int = 0):
    """K3's eleven inputs at one shape, random from ``seed``: weights at
    ``wdt``, residuals in the ranges the forward gives them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    scale = H ** -0.5
    return ((scale * r(out, H)).to(wdt), (scale * r(3 * H, H)).to(wdt),
            (scale * r(3 * H, out)).to(wdt), 0.1 * r(3 * H), r(B, T, out), r(B, T, 3 * H),
            0.5 * r(B, T, out), torch.tanh(r(B, T, H)),
            (torch.rand((B, T, H), generator=gen, device=dev) < 0.5).float() * 2.0,
            r(B, H), r(B, out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=10)
    ap.add_argument("--T", type=int, default=80)
    ap.add_argument("--H", type=int, default=1024)
    ap.add_argument("--out", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    prof = _build.load("gru_ar_bwd", ("GRU_AR_BWD_PROFILE",))
    prof.gru_ar_bwd_profile_read.argtypes = [ctypes.c_void_p]
    prof.gru_ar_bwd_profile_read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * len(BWD_PHASES))()
    for wdt in (torch.float32, torch.bfloat16):
        call = random_bwd_args(dev, args.B, args.T, args.H, args.out, wdt)
        for _ in range(2):
            cuda_gru_ar_bwd(*call)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            cuda_gru_ar_bwd(*call)
        end.record()
        torch.cuda.synchronize()
        us_step = start.elapsed_time(end) / 10 * 1e3 / args.T

        launch_bwd(prof, *call)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_bwd_profile_read(counts), "profile reset")
        launch_bwd(prof, *call)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_bwd_profile_read(counts), "profile read")
        per_step = [c / args.T for c in counts]
        total = sum(per_step)
        print(json.dumps({
            "shape": dict(B=args.B, T=args.T, H=args.H, out=args.out),
            "weight_dtype": str(wdt).split(".")[-1],
            "plan": dict(zip(BWD_PLAN_KEYS, plan_bwd(prof, args.B, args.H, args.out, wdt))),
            "us_per_step": us_step,
            "cycles_per_step": total,
            "phases": {p: {"cycles": c, "share": c / total} for p, c in zip(BWD_PHASES, per_step)},
            "card": torch.cuda.get_device_name(0),
            "card_line": card_line}), flush=True)


if __name__ == "__main__":
    main()
