"""Where one step of the WaveRNN sampling kernel (K4) spends its time, on the card.

    python -m cyclevae_tpu_torch.ops.wavernn_phases [--B 1] [--T 4000] [--temperature 0.8] [--dual]

Builds ``csrc/wavernn.cu`` a second time with ``-DWAVERNN_PROFILE`` (thread 0
of block 0 sums the SM cycles of each phase of every step), runs it on random
weights at the flagship width (``WaveRNNConfig`` defaults: H=896, 256
classes, fc 128), and prints each phase's cycles per step and its share,
beside the per-sample time of the normal build from CUDA events, the plan
(grid, units per block, cluster size, f-stage rows, shared bytes) and the
card's name and power limit.

With ``--dual``, the same for the dual instantiation at the published width
(H = 896 in halves of 448, two 256-way heads): each stage's cycles per step
in the coarse and the fine phase, as thread 0 of the first block of each
half sees them, and per phase and half the poll passes of a step that found
a word not yet stored (summed over the block's threads).
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
# the stages of one phase of the dual's step (csrc/wavernn.cu DUAL_MARK)
DUAL_STAGES = ("wait for the cluster's candidates, merge", "the half's gates and h_t, stored",
               "first-layer partial pushed", "wait for the cluster's partials",
               "cluster sum stored with its tag", "noise",
               "poll the rank's values and the half's h_t", "sum the rank's values",
               "partial logits pushed to the class owners",
               "wait for the partial logits, scores, argmax, candidates pushed",
               "the half's Whh sums (fine: gh)")
HALVES = ("coarse block", "fine block")


def _card() -> dict:
    return {"card": torch.cuda.get_device_name(0),
            "card_line": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()}


def _us_per_sample(call, T: int) -> float:
    """The normal build's microseconds a sample, CUDA events over 3 calls."""
    for _ in range(2):
        cuda_wavernn_generate(*call)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        cuda_wavernn_generate(*call)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3 * 1e3 / T


def _profiled(prof, read: str, n: int, run) -> list:
    """The counts of a second profiled launch (the first warms up and is reset)."""
    fn = getattr(prof, read)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * n)()
    for what in ("profile reset", "profile read"):
        run()
        torch.cuda.synchronize()
        _build.check(prof, fn(counts), what)
    return list(counts)


def dual(args, dev, gen) -> dict:
    """The dual instantiation's stages per phase, per step."""
    cfg = WaveRNNConfig(dual=True)
    params = init_wavernn(gen, cfg)
    cond = torch.tanh(torch.randn((args.B, args.T, cfg.cond_dim), generator=gen, device=dev))
    call = (params, cfg, cond, 0, args.temperature)
    us_sample = _us_per_sample(call, args.T)
    prof = _build.load("wavernn", ("WAVERNN_PROFILE",))
    m = len(DUAL_STAGES)
    counts = _profiled(prof, "wavernn_profile_read_dual", 4 * m + 4, lambda: launch(prof, *call))
    phases = {}
    for p, phase in enumerate(("coarse", "fine")):
        per_half = [[counts[(h * 2 + p) * m + i] / args.T for i in range(m)] for h in (0, 1)]
        phases[phase] = {
            "stages": {st: dict(zip(HALVES, (per_half[0][i], per_half[1][i])))
                       for i, st in enumerate(DUAL_STAGES)},
            "cycles": dict(zip(HALVES, (sum(per_half[0]), sum(per_half[1])))),
            "stale_poll_passes": dict(zip(HALVES, (counts[4 * m + 2 * h + p] / args.T
                                                  for h in (0, 1))))}
    return {
        "shape": dict(B=args.B, T=args.T, H=cfg.hidden_units, K=cfg.n_classes, dual=True),
        "temperature": args.temperature,
        "plan": dict(zip(("grid", "units", "cluster", "stage_rows", "smem"),
                         plan(prof, args.B, cfg.hidden_units, cfg.n_classes, 0, dual=True))),
        "us_per_sample": us_sample,
        "cycles_per_step": {h: sum(phases[ph]["cycles"][h] for ph in phases) for h in HALVES},
        "phases": phases, **_card()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--T", type=int, default=4000)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--dual", action="store_true",
                    help="profile the dual instantiation (coarse and fine phases)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.dual:
        print(json.dumps(dual(args, dev, gen)))
        return
    cfg = WaveRNNConfig()
    params = init_wavernn(gen, cfg)
    cond = torch.tanh(torch.randn((args.B, args.T, cfg.cond_dim), generator=gen, device=dev))
    call = (params, cfg, cond, 0, args.temperature)
    us_sample = _us_per_sample(call, args.T)

    prof = _build.load("wavernn", ("WAVERNN_PROFILE",))
    counts = _profiled(prof, "wavernn_profile_read", len(PHASES), lambda: launch(prof, *call))
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
        **_card()}))


if __name__ == "__main__":
    main()
