"""Where one train step's time goes, on the card.

    python -m cyclevae_tpu_torch.vi.step_profile [--dtype float32]

Builds the flagship train step (``use_pallas``, bsu 5 utterances of 560, 300,
417, 489 and 351 frames: one 560-frame bucket of 7 segments of 80 frames;
random weights and synthetic features from a seed), runs it once to warm up,
then once timed and once under ``torch.profiler``, and prints one JSON line:
the step's wall time (host clock, ending in a host copy of the metrics; the
unprofiled one), the device's busy time in the profiled step (the sum of its
kernels' and copies' times: one stream, so they do not overlap), the idle
share of the unprofiled wall time, the AR-GRU kernels' time (K3, the backward
scan, and K2, the training forward, apart), and the kernels taking the most
device time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .train import CycleVAEConfig, TrainState, init_cyclevae, make_optimizer, make_train_step

FLENS = [560, 300, 417, 489, 351]
SEG_LEN = 80
TOP = 15


def _batch(rng: np.random.Generator):
    T = max(FLENS)
    feats = np.cumsum(rng.normal(size=(len(FLENS), T, 54)), axis=1) * 0.05
    feats += rng.normal(size=feats.shape) * 0.1
    for b, n in enumerate(FLENS):
        feats[b, n:] = 0.0
    code = np.zeros((len(FLENS), T, 2), np.float32)
    return {"feats": feats.astype(np.float32), "src_code": code + [1, 0],
            "trg_code": code + [0, 1], "cv_excit": feats[..., :4].astype(np.float32),
            "flens": np.asarray(FLENS, np.int32)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    batch = _batch(np.random.default_rng(0))
    real = batch["feats"][np.arange(max(FLENS))[None] < np.asarray(FLENS)[:, None]]
    cfg = CycleVAEConfig(use_pallas=True, compute_dtype=args.dtype)
    params = init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg,
                           real.mean(axis=0), real.std(axis=0) + 1e-3, device=dev)
    opt = make_optimizer(cfg, lr=1e-4)
    ts = TrainState(params, opt.init(params), torch.Generator(device=dev).manual_seed(1), 0)
    step = make_train_step(cfg, opt, SEG_LEN, max(FLENS) // SEG_LEN)

    def timed_step(ts):
        t0 = time.perf_counter()
        ts, m = step(ts, batch)
        {k: v.cpu() for k, v in m.items()}   # the step ends in a host copy of its metrics
        return ts, (time.perf_counter() - t0) * 1e6

    ts, _ = timed_step(ts)                   # warm-up
    ts, wall_us = timed_step(ts)             # unprofiled: the wall time the idle share is of
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ts, profiled_us = timed_step(ts)

    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    gru_us = sum(us for name, (_, us) in by_name.items() if "gru_ar" in name)
    k3_us = sum(us for name, (_, us) in by_name.items() if "gru_ar_bwd" in name)
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "dtype": args.dtype, "hidden": cfg.hidden_units,
        "real_frames": int(sum(FLENS)), "step_ms": wall_us / 1e3,
        "profiled_step_ms": profiled_us / 1e3,
        "real_frames_per_s": sum(FLENS) / (wall_us / 1e6),
        "device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / wall_us,
        "ar_gru_kernels_ms": gru_us / 1e3, "k3_ms": k3_us / 1e3, "k2_ms": (gru_us - k3_us) / 1e3,
        "rest_ms": (busy_us - gru_us) / 1e3,
        "top_kernels": [{"name": name[:90], "calls": calls, "ms": us / 1e3}
                        for name, (calls, us) in top]}))


if __name__ == "__main__":
    main()
