"""Where one conversion request's time goes, on the card.

    python -m cyclevae_tpu_torch.pipeline.decode_profile [--dtype float32] [--src 900] [--trg 845]

Builds the flagship ``Codec`` (``use_pallas``, random weights and smooth
synthetic features from a seed), warms it up on two requests (both 560-frame
bucket counts: each captures its length's CUDA graph), then runs one
request through ``device_decode_pair`` once timed and once under
``torch.profiler``, and prints one JSON line: the request's wall time
(host clock; it ends in host copies of its outputs), the device's busy
time in the profiled request (the sum of its kernels' and copies' times:
one stream, so they do not overlap), the idle share of the unprofiled wall
time, K1's time and launches apart from the rest, and the kernels taking
the most device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..vi.train import CycleVAEConfig, init_cyclevae
from .decode import Codec, device_decode_pair

TOP = 12


def _features(rng: np.random.Generator, T: int, dim: int = 54) -> np.ndarray:
    """Smooth trajectories laid out as the recipe's 54-d vector: [U/V, log
    F0, 2 coded aperiodicities, 50 mel-cepstra]."""
    feat = np.cumsum(rng.normal(size=(T, dim)), axis=0) * 0.05
    feat -= feat.mean(axis=0)
    feat += rng.normal(size=(T, dim)) * 0.1
    feat[:, 0] = (np.sin(np.arange(T) / 37.0) > -0.3).astype(np.float64)
    feat[:, 1] += 5.3
    return feat.astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--src", type=int, default=900, help="source frames")
    ap.add_argument("--trg", type=int, default=845, help="target frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    src, trg = _features(rng, args.src), _features(rng, args.trg)
    warm = [(_features(rng, 350), _features(rng, 450)), (_features(rng, 650), _features(rng, 900))]
    allf = np.concatenate([src, trg])
    cfg = CycleVAEConfig(use_pallas=True, compute_dtype=args.dtype)
    params = init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg, allf.mean(axis=0),
                           allf.std(axis=0) + 1e-3, device=dev)
    codec = Codec(params, cfg, device=dev)

    def request():
        t0 = time.perf_counter()
        device_decode_pair(codec, torch.Generator(device=dev).manual_seed(100), src, trg)
        return (time.perf_counter() - t0) * 1e6

    for s, t in warm:
        device_decode_pair(codec, None, s, t)
    wall_us = request()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_us = request()

    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    k1 = [(calls, us) for name, (calls, us) in by_name.items() if "gru_ar" in name]
    k1_us = sum(us for _, us in k1)
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card_line": card_line, "dtype": args.dtype,
        "frames": dict(src=args.src, trg=args.trg), "request_ms": wall_us / 1e3,
        "profiled_request_ms": profiled_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us, "k1_ms": k1_us / 1e3,
        "k1_launches": sum(calls for calls, _ in k1), "rest_ms": (busy_us - k1_us) / 1e3,
        "top_kernels": [{"name": name[:90], "calls": calls, "ms": us / 1e3}
                        for name, (calls, us) in top]}), flush=True)


if __name__ == "__main__":
    main()
