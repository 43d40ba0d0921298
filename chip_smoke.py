#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cyclevae_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one line or more each; any failure exits non-zero:
  1. build    every CUDA kernel of the port from ``cyclevae_tpu_torch/csrc``
              (one nvcc per source, all started together);
  2. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes of the conversion path (flagship H=1024, T=1120:
              encoder B=2 out=64, decoder B=3 out=50), float32 and bf16,
              with kernel, per-frame and plain times from CUDA events;
  3. main     the stage-6 conversion path of the flagship hu1024 CycleVAE
              (random weights from a seed, stats baked in): 4 requests
              through ``Codec`` + ``device_decode_pair`` per dtype, with the
              kernel launch counts read around them, then the same requests
              through the plain path to check the outputs;
then the card's name and power limit, one JSON line of the kernels, and as
the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
H = 1024
T_KERNEL = 1120                     # two 560-frame buckets: a 900-frame request
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; float32 outside
# the tensor cores and dense bf16 operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# tolerances of kernel vs plain version on the card:
#   float32: the two sum in different orders; after 1120 AR frames the max
#   abs difference of the normalized outputs was 4.8e-7 on an H100, and this
#   leaves room for other orders of summation
F32_ATOL = 1e-4
#   bf16: operands round to 8 bits of mantissa at every product, the JAX
#   package's own bound for its bf16 kernel path
BF16_REL_L2 = 3e-2
BF16_COS = 0.999
# requests: (source frames, target frames), 1.5-4.5 s of speech at 5 ms
REQUESTS = [(300, 420), (512, 688), (760, 604), (900, 845)]
WARMUP = [(350, 450), (650, 900)]   # both 560-frame bucket counts


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))


def gru_ar_bound_ms(B: int, T: int, out: int, wdt: torch.dtype):
    """Least time for one call: its operations over the peak rate of the
    input type, or its bytes (each input read once, each output written
    once) over HBM bandwidth, whichever is larger."""
    wb = torch.empty((), dtype=wdt).element_size()
    ops = 2 * T * B * (3 * H * H + 3 * H * out + H * out)
    nbytes = ((3 * H * H + 3 * H * out + out * H) * wb + (3 * H + out) * 4
              + B * T * 3 * H * wb + (B * out + B * H) * 4
              + B * T * out * 4 + (B * out + B * H) * 4)
    t_ops, t_bytes = ops / PEAK_OPS[wdt] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from cyclevae_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build(["gru_ar"])
    log(f"[build] {len(paths)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(dev):
    """K1 against its plain version at the conversion path's shapes."""
    from cyclevae_tpu_torch.models.layers import init_dense, init_gru_stack
    from cyclevae_tpu_torch.ops import _build
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar, gru_ar_reference, plan
    from cyclevae_tpu_torch.ops.gru_scan import precompute_input_gates

    results = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for call, B, out, conv_dim in (("encoder", 2, 64, 486), ("decoder", 3, 50, 306)):
        layer = init_gru_stack(gen, conv_dim + out, H, 1)[0]
        layer["b_ih"].uniform_(-0.1, 0.1, generator=gen)
        layer["b_hh"].uniform_(-0.1, 0.1, generator=gen)
        proj = init_dense(gen, H, out)
        conv = torch.randn((B, T_KERNEL, conv_dim), generator=gen, device=dev)
        gx = precompute_input_gates(layer, conv)
        y0 = 0.5 * torch.randn((B, out), generator=gen, device=dev)
        h0 = torch.zeros((B, H), device=dev)
        for wdt in (torch.float32, torch.bfloat16):
            args = (layer, proj, gx, y0, h0, wdt)
            got = cuda_gru_ar(*args)
            want = gru_ar_reference(*args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rl2, cos = rel_l2(got[0], want[0]), cosine(got[0], want[0])
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ok = finite and (err <= F32_ATOL if wdt == torch.float32
                             else rl2 < BF16_REL_L2 and cos > BF16_COS)
            ms = cuda_ms(lambda: cuda_gru_ar(*args), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: gru_ar_reference(*args), iters=2)
            bound_ms, bound_by = gru_ar_bound_ms(B, T_KERNEL, out, wdt)
            grid, units, stage_rows, smem = plan(_build.load("gru_ar"), B, H, out, wdt)
            key = f"{call}/{str(wdt).split('.')[-1]}"
            results[key] = dict(B=B, T=T_KERNEL, out=out, max_abs_err=err,
                                rel_l2=rl2, cosine=cos, ms=ms,
                                us_per_frame=ms * 1e3 / T_KERNEL, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, ok=ok)
            log(f"[kernels] gru_ar {key} B={B} T={T_KERNEL} H={H} out={out} "
                f"grid={grid}x{units} stage={stage_rows} smem={smem} max_abs={err:.3e} "
                f"rel_l2={rl2:.3e} cos={cos:.6f} kernel={ms:.3f} ms "
                f"({ms * 1e3 / T_KERNEL:.2f} us/frame) plain={plain_ms:.1f} ms "
                f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}")
    return results


def synth_features(rng: np.random.Generator, T: int, in_dim: int = 54) -> np.ndarray:
    """Smooth feature trajectories laid out as the recipe's 54-d vector:
    [U/V, log F0, 2 coded aperiodicities, 50 mel-cepstra]."""
    walk = np.cumsum(rng.normal(size=(T, in_dim)), axis=0) * 0.05
    walk -= walk.mean(axis=0)
    feat = walk + rng.normal(size=(T, in_dim)) * 0.1
    feat[:, 0] = (np.sin(np.arange(T) / 37.0) > -0.3).astype(np.float64)
    feat[:, 1] += 5.3
    feat[:, 4] += -3.0
    return feat.astype(np.float32)


def phase_main(dev):
    """The conversion path: Codec + device_decode_pair, as the recipe drives it."""
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

    rng = np.random.default_rng(SEED)
    pairs = [(synth_features(rng, s), synth_features(rng, t)) for s, t in REQUESTS]
    warm = [(synth_features(rng, s), synth_features(rng, t)) for s, t in WARMUP]
    allf = np.concatenate([f for p in pairs for f in p])
    mean, scale = allf.mean(axis=0), allf.std(axis=0) + 1e-3

    codecs = {}
    for dt in ("float32", "bfloat16"):
        cfg = CycleVAEConfig(use_pallas=True, compute_dtype=dt)
        params = init_cyclevae(torch.Generator(device=dev).manual_seed(SEED), cfg,
                               mean, scale, device=dev)
        n = sum(p.numel() for net in params for p in _leaves(net))
        log(f"[main] {dt}: flagship hl{cfg.hidden_layers} hu{cfg.hidden_units} "
            f"ld{cfg.lat_dim} ks{cfg.kernel_size} ds{cfg.dilation_size} "
            f"n_spk{cfg.n_spk}: {n} params")
        codecs[dt] = (Codec(params, cfg, device=dev),
                      Codec(params, dataclasses.replace(cfg, use_pallas=False), device=dev))
        for src, trg in warm:   # warm-up, not counted
            device_decode_pair(codecs[dt][0], None, src, trg)

    # ---- the main path: counts set to 0 just before, read just after ----
    outs, lat_ms, launches = {}, {}, {}
    cuda_gru_ar.launches = 0
    for dt, (codec, _) in codecs.items():
        before = cuda_gru_ar.launches
        outs[dt], lat_ms[dt] = [], []
        for i, (src, trg) in enumerate(pairs):
            t0 = time.perf_counter()
            outs[dt].append(device_decode_pair(
                codec, torch.Generator(device=dev).manual_seed(100 + i), src, trg))
            lat_ms[dt].append((time.perf_counter() - t0) * 1e3)
        launches[dt] = cuda_gru_ar.launches - before
    total_launches = cuda_gru_ar.launches

    ok = True
    for dt, (_, plain) in codecs.items():
        want_launches = 2 * len(pairs)
        ok &= launches[dt] == want_launches
        worst_rl2, worst_abs = 0.0, 0.0
        for i, ((src, trg), got) in enumerate(zip(pairs, outs[dt])):
            ref = device_decode_pair(
                plain, torch.Generator(device=dev).manual_seed(100 + i), src, trg)
            shapes = [(len(src), 64), (len(trg), 64), (len(src), 50),
                      (len(src), 50), (len(trg), 50)]
            ok &= all(g.shape == s and np.isfinite(g).all() for g, s in zip(got, shapes))
            for g, r in zip(got[2:], ref[2:]):
                worst_rl2 = max(worst_rl2, float(np.linalg.norm(g - r) / np.linalg.norm(r)))
                worst_abs = max(worst_abs, float(np.abs(g - r).max()))
        tol = 1e-4 if dt == "float32" else BF16_REL_L2
        ok &= worst_rl2 < tol and (dt != "float32" or worst_abs <= F32_ATOL)
        frames = [s + t for s, t in REQUESTS]
        log(f"[main] {dt}: {len(pairs)} requests, K1 launches {launches[dt]} "
            f"(want {want_launches}); latency ms "
            + ", ".join(f"{m:.1f}" for m in lat_ms[dt])
            + "; frames/s " + ", ".join(f"{f / m * 1e3:.0f}" for f, m in zip(frames, lat_ms[dt]))
            + f"; vs plain path: rel_l2 {worst_rl2:.3e} (< {tol}), max_abs {worst_abs:.3e}")
    log(f"[main] {'ok' if ok else 'FAIL'}")
    return ok, total_launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import cyclevae_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    kern = phase_kernels(dev)
    main_ok, launches = phase_main(dev)
    ok = main_ok and all(r["ok"] for r in kern.values())

    dec = kern["decoder/float32"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gru_ar", "route": "cuda",
        "source": "cyclevae_tpu_torch/csrc/gru_ar.cu",
        "replaces": "cyclevae_tpu/ops/pallas_gru.py:365",
        "launches": launches, "max_abs_err": dec["max_abs_err"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None}]}), flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
