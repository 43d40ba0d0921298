"""What more than one port tool needs: the device and its JSON entry,
parameters from a checkpoint or a fresh init, the synthetic utterance of the
samplers' sweeps, a real utterance's features from the store, timing and the
JSON writer."""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.store import read_store

# the repository's root: where ``python -m cyclevae_tpu_torch...`` finds the package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA card (raises without "
                         "one), 'cpu' only when asked")


def device_entry(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else dev.type


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable[[], object], dev: torch.device, reps: int = 10,
          warmup: int = 1) -> float:
    """Seconds per call of ``fn``: ``warmup`` calls, then ``reps`` calls
    between two CUDA events on the card (``perf_counter`` on the host), one
    sync at the end."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def load_cyclevae(ckpt: Optional[str], cfg, dev: torch.device) -> Tuple[object, str]:
    """(params, source): the checkpoint's parameters (either package's
    ``checkpoint-*.pkl``), or with no checkpoint (absent or ``none``) a
    fresh init from seed 0 with zero-mean unit-scale statistics, as the JAX
    tools fall back when their checkpoint is missing."""
    from ..vi.checkpoint import load_checkpoint
    from ..vi.train import CycleVAEParams, init_cyclevae, params_to

    if ckpt and ckpt != "none":
        params = params_to(CycleVAEParams(*load_checkpoint(ckpt)["params"]), dev)
        return params, os.path.basename(os.path.dirname(ckpt)) + "/" + os.path.basename(ckpt)
    params = init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg,
                           np.zeros(54, np.float32), np.ones(54, np.float32), device=dev)
    return params, "fresh-init"


def synthetic_sin(rng: np.random.Generator, T: int) -> np.ndarray:
    """The JAX sweeps' synthetic utterance (``tools/bench_hmc_chains.py``):
    sinusoids plus 0.1 of ``rng``'s normals, (T, 54) float32; the draws are
    the numpy ones, so the features are the JAX tools' bit for bit."""
    t = np.arange(T)[:, None]
    return (np.sin(t * 0.05 + np.arange(54)[None, :])
            + 0.1 * rng.normal(size=(T, 54))).astype(np.float32)


def read_real(path: Optional[str], T: int) -> Optional[np.ndarray]:
    """The first ``T`` frames of ``feat_org_lf0`` of a feature-store file,
    or None when ``path`` is absent, ``none`` or missing."""
    if not path or path == "none" or not os.path.exists(path):
        return None
    return np.asarray(read_store(path, "feat_org_lf0"), np.float32)[:T]


def write_json(path: str, obj, indent: int = 1) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def decode_epoch(expdir: str, epoch: Optional[int] = None) -> int:
    """``epoch``, or when it is None the best epoch of ``expdir``'s
    ``history.json``, as stages 5 and 6 take it."""
    if epoch is not None:
        return epoch
    with open(os.path.join(expdir, "history.json")) as f:
        return int(json.load(f)["best"]["epoch"])


def kernel_launches() -> dict:
    """The launch counts of K1, K2, K3 and K4 so far."""
    from ..ops.cuda_gru import cuda_gru_ar, cuda_gru_ar_bwd, cuda_gru_ar_train
    from ..ops.cuda_wavernn import cuda_wavernn_generate
    return {"K1": cuda_gru_ar.launches, "K2": cuda_gru_ar_train.launches,
            "K3": cuda_gru_ar_bwd.launches, "K4": cuda_wavernn_generate.launches}


def launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


__all__ = ["REPO", "add_device_arg", "device_entry", "platform", "sync", "timed",
           "load_cyclevae", "synthetic_sin", "read_real", "write_json", "decode_epoch",
           "kernel_launches", "launches_since", "resolve_device"]
