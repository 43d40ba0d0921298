"""Where one reversed step of the AR-GRU backward kernel (K3) spends its time, on the card.

    python -m cyclevae_tpu_torch.ops.gru_ar_bwd_phases [--B 10] [--T 80] [--H 1024] [--out 50]

Builds ``csrc/gru_ar_bwd.cu`` a second time with ``-DGRU_AR_BWD_PROFILE``
(thread 0 of block 0 sums the SM cycles of each phase of every reversed
step), runs it at the given shape in float32 and bf16 on two paths, and
prints one JSON line per dtype and path: the plan, the normal build's us per
step from CUDA events, each phase's cycles per step and its share, and the
card's name and power limit.  The paths: ``recomputed``, K3 alone on random
inputs, recomputing its gates before the loop (phase 7); ``saved``, K2
(``cuda_gru_ar_train_gates``) on the same weights, then K3 on its residuals
and gates, where phase 7 is only the first step's copy.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import _build
from .cuda_gru import (BWD_PHASES, BWD_PLAN_KEYS, cuda_gru_ar_bwd, cuda_gru_ar_train_gates,
                       launch_bwd, plan_bwd)


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


def saved_bwd_args(call):
    """K3's inputs and the gates as the training path has them: K2 run on
    the weights, gates_x and mask of ``call`` (random_bwd_args) from y0 = 0
    and h0 = 0, its residuals in place of the random y_prev and h_prev."""
    wout, whh, wy, bhh, d_trj, gx, _, _, mask, d_hT, d_yT = call
    B, out, dev, wdt = d_trj.shape[0], wout.shape[0], d_trj.device, whh.dtype
    y0 = torch.zeros((B, out), device=dev)
    h0 = torch.zeros((B, whh.shape[1]), device=dev)
    trj, _, _, h_seq, gates = cuda_gru_ar_train_gates(
        {"w_ih": wy, "w_hh": whh, "b_hh": bhh}, {"w": wout, "b": torch.zeros(out, device=dev)},
        gx, y0, h0, mask, wdt)
    y_prev = torch.cat([y0[:, None], trj[:, :-1]], dim=1).to(wdt)
    h_prev = torch.cat([h0[:, None].to(wdt), h_seq[:, :-1]], dim=1)
    return (wout, whh, wy, bhh, d_trj, gx, y_prev, h_prev, mask, d_hT, d_yT), gates


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
    for wdt, path in ((w, p) for w in (torch.float32, torch.bfloat16)
                      for p in ("recomputed", "saved")):
        call = random_bwd_args(dev, args.B, args.T, args.H, args.out, wdt)
        gates = None
        if path == "saved":
            call, gates = saved_bwd_args(call)
        for _ in range(2):
            cuda_gru_ar_bwd(*call, gates=gates)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            cuda_gru_ar_bwd(*call, gates=gates)
        end.record()
        torch.cuda.synchronize()
        us_step = start.elapsed_time(end) / 10 * 1e3 / args.T

        launch_bwd(prof, *call, gates)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_bwd_profile_read(counts), "profile reset")
        launch_bwd(prof, *call, gates)
        torch.cuda.synchronize()
        _build.check(prof, prof.gru_ar_bwd_profile_read(counts), "profile read")
        per_step = [c / args.T for c in counts]
        total = sum(per_step)
        print(json.dumps({
            "shape": dict(B=args.B, T=args.T, H=args.H, out=args.out),
            "weight_dtype": str(wdt).split(".")[-1],
            "gates": path,
            "plan": dict(zip(BWD_PLAN_KEYS, plan_bwd(prof, args.B, args.H, args.out, wdt))),
            "us_per_step": us_step,
            "cycles_per_step": total,
            "phases": {p: {"cycles": c, "share": c / total} for p, c in zip(BWD_PHASES, per_step)},
            "card": torch.cuda.get_device_name(0),
            "card_line": card_line}), flush=True)


if __name__ == "__main__":
    main()
