"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name:
  * ``BENCHMARK.json`` (beside this folder) names the cell's configuration,
    traffic mix and metrics;
  * ``configs/<config>.json`` the model and its sizes;
  * ``traffic/<traffic>.json`` the mix's parameters, and the driver that
    serves it, ``drivers/<driver>.py``;
  * ``cells/<cell>.json`` the limits of the numbers its check compares;
  * ``metrics/<metric>.py`` the reader of each metric;
  * ``kernels/<K>.py`` each kernel's name pattern, launch counter and work.

A driver has ``setup()``, ``unit()`` (one unit of the mix, ended when its
outputs are on the host; returns its counts), ``release()`` (frees the
program's state) and ``check()`` (the compared numbers, by name).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent.parent          # the benchmark's folder
ROOT = HERE.parent                                      # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "cyclevae_tpu")
KERNELS = ("K1", "K2", "K3", "K4")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A cell's entry in BENCHMARK.json with its files."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        wl = {w["name"]: w for w in bench["workloads"]}
        if name not in wl:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name, self.entry = name, wl[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT / cfg["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        limits = HERE / "cells" / f"{name}.json"
        # no limits file: every compared number lacks its limit, and fails
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        moved = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        names = {m["name"] for m in moved}
        self.end_to_end = moved
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]


class Window:
    """What the readers read: the units of the window with their counts and
    times, set-up time, the trace, the program's launch counts."""

    def __init__(self, config: Dict, traffic: Dict):
        self.config, self.traffic = config, traffic
        self.units: List[Dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace = None
        self.launches: Dict[str, int] = {}

    def total(self, key: str) -> float:
        return float(sum(u.get(key, 0.0) for u in self.units))

    def values(self, key: str) -> List[float]:
        return [u[key] for u in self.units if key in u]


def kernel_modules() -> Dict:
    return {k: load_module(HERE / "kernels" / f"{k}.py", f"bench_kernel_{k}") for k in KERNELS}


def launch_counts(kmods) -> Dict[str, int]:
    return {k: m.launches() for k, m in kmods.items()}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             dtype: Optional[str] = None, overrides: Optional[Dict] = None) -> Dict:
    """One run.  ``dtype`` replaces the configuration's compute dtype (the
    control); ``overrides`` {"config": {...}, "traffic": {...}} shrink a run
    for the CPU tests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = json.loads(json.dumps(cell.config))
    traffic = dict(cell.traffic)
    if overrides:
        for k, v in overrides.get("config", {}).items():
            if isinstance(v, dict):
                if k in config:
                    config[k] = {**config[k], **v}
            else:
                config[k] = v
        traffic.update(overrides.get("traffic", {}))
    dtype = dtype or config["model"]["compute_dtype"]
    kmods = kernel_modules()
    driver_mod = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                             f"bench_driver_{traffic['driver']}")
    drv = driver_mod.Driver(config, traffic, seed, device, dtype)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    before_setup = process_age_s()
    drv.setup()
    sync()
    win = Window(config, traffic)
    win.setup_s = process_age_s()
    print(f"benchmark: set-up {win.setup_s:.2f} s, {before_setup:.2f} s of it before the "
          "driver (interpreter, imports, CUDA)", file=sys.stderr)
    before = launch_counts(kmods)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    with prof if prof is not None else nullcontext():
        with torch.profiler.record_function("bench.window") if trace else nullcontext():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                u0 = time.perf_counter()
                counts = drv.unit()
                u1 = time.perf_counter()
                win.units.append({**counts, "t0": u0 - t0, "t1": u1 - t0})
                if u1 >= deadline:
                    break
            win.window_s = u1 - t0
    durs = np.asarray([u["t1"] - u["t0"] for u in win.units])
    q = np.percentile(durs, [25, 50, 75])
    print(f"benchmark: {len(durs)} units in {win.window_s:.3f} s; unit s quartiles "
          f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, max {durs.max():.4f}; first units "
          + " ".join(f"{d:.3f}" for d in durs[:40]), file=sys.stderr)
    after = launch_counts(kmods)
    win.launches = {k: after[k] - before[k] for k in kmods}
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    device_entry = {"platform": "gpu" if cuda else device.type,
                    "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                    "count": 1, "memory_peak_bytes": memory_peak}
    breakdown = None
    if trace:
        from .trace import reduce
        win.trace = reduce(prof, {k: m.PATTERN for k, m in kmods.items()})
        del prof
        device_entry.update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
        if cuda:
            device_entry["card"] = card_line()
        breakdown = win.trace.breakdown()

    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    compared = drv.check()
    correct, checks = True, {}
    for name, value in compared.items():
        limit = cell.limits.get(name)
        # a number without a limit of its own fails: nothing says it is right
        ok = (value is not None and limit is not None and math.isfinite(value)
              and value <= limit)
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    if not compared:
        correct = False

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
        v = reader.read(win)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(win.units),
              "failed": int(sum(u.get("failed", 0) for u in win.units)),
              "metrics": metrics, "device": device_entry}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = checks
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program and its libraries inside the checkout, at
    # fixed paths (the nvcc-built kernels live in the port's own build/)
    cache = HERE / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    cell = Cell(args.workload)
    import torch

    need = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # one process, few threads: the host's other cores stay free of the
    # intra-op pool's spinning, which only the program's small CPU tensors use
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules that must not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
