"""Drive the data-parallel layer once: the sharded train step, HMC and SMC.

The counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``:

    python -m cyclevae_tpu_torch.parallel.dryrun 2 [--device cpu]

spawns ``n`` ranks (``parallel.spawn``); each takes one sharded train step
at hu32 and then at the flagship hu1024, one sharded HMC run and one sharded
SMC filter at hu1024 on a 16-frame utterance, and rank 0 prints the JAX
dry run's lines.  ``dryrun_rank`` is the rank function, driven by a ``spec``
of work items, so a caller can run the same ranks at other sizes and hold
what they return against a single-process run (``chip_smoke.py``'s phase 10
does).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .spawn import spawn_ranks


def synthetic_batch(B: int, T: int, in_dim: int = 54, stdim: int = 4, seed: int = 0) -> Dict:
    """The JAX dry run's batch: smooth features plus noise, a one-to-one
    speaker pair, every utterance T frames long (host numpy arrays)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[None, :, None]
    feats = (np.sin(t * 0.05 + np.arange(in_dim)[None, None, :])
             + 0.1 * rng.normal(size=(B, T, in_dim))).astype(np.float32)
    return {"feats": feats,
            "src_code": np.tile([1.0, 0.0], (B, T, 1)).astype(np.float32),
            "trg_code": np.tile([0.0, 1.0], (B, T, 1)).astype(np.float32),
            "cv_excit": feats[..., :stdim],
            "flens": np.asarray([T] * B, dtype=np.int32)}


def dryrun_spec(n: int) -> Dict:
    """The JAX dry run's work at ``n`` ranks: B = 2n utterances of 2
    segments of 8 frames at hu32 and at hu1024, 2n HMC chains (2 leapfrogs,
    2 + 2 steps) and 8n SMC particles over 16 frames at hu1024."""
    batch = synthetic_batch(2 * n, 16)
    feats = synthetic_batch(1, 16)["feats"][0]
    code = np.tile([1.0, 0.0], (16, 1)).astype(np.float32)
    model = dict(mean=np.zeros(54, np.float32), scale=np.ones(54, np.float32), seed=0)
    return {
        "train": [dict(tag="tiny hu=32", hidden_units=32, seg_len=8, n_segs=2, batch=batch,
                       rng_seed=7, **model),
                  dict(tag="flagship hu=1024", hidden_units=1024, seg_len=8, n_segs=2,
                       batch=batch, rng_seed=7, **model)],
        "hmc": dict(hidden_units=1024, feats=feats, code=code, chains=2 * n,
                    hmc=(0.05, 2, 2, 2), draws_seed=3, obs_scale=1.0, **model),
        "smc": dict(hidden_units=1024, feats=feats, code=code, particles=8 * n, draws_seed=4,
                    obs_scale=1.0, **model),
    }


def _counts() -> Dict[str, int]:
    from ..ops.cuda_gru import cuda_gru_ar, cuda_gru_ar_bwd, cuda_gru_ar_train
    return {"K1": cuda_gru_ar.launches, "K2": cuda_gru_ar_train.launches,
            "K3": cuda_gru_ar_bwd.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def model_of(item: Dict, device: torch.device):
    """(config, params) of a work item: ``hidden_units`` (the flagship's
    other widths), ``compute_dtype``, stats ``mean`` / ``scale``, weights
    from ``seed`` on ``device``."""
    from ..vi.train import CycleVAEConfig, init_cyclevae
    cfg = CycleVAEConfig(hidden_units=item["hidden_units"],
                         compute_dtype=item.get("compute_dtype", "float32"))
    params = init_cyclevae(torch.Generator(device=device).manual_seed(item["seed"]), cfg,
                           item["mean"], item["scale"], device=device)
    return cfg, params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_item(mesh, item: Dict) -> Dict:
    """One sharded step of ``item`` (model, global batch, segments) on this
    rank's ``mesh``: its per-segment metrics, launches and seconds,
    optionally the first update's all-reduced gradients (``grads``), each
    of ``timed_steps`` more steps' seconds (``measure_steps``) with the
    seconds of one segment's gradient all-reduce alone, and the launches of
    the whole item (``launches_all``)."""
    from ..utils.profiling import measure_steps
    from ..vi.train import TrainState, make_optimizer, trainable_leaves
    from .mesh import make_sharded_train_step, replicate

    dev = mesh.device
    cfg, params = model_of(item, dev)
    params = replicate(mesh, params)
    opt = make_optimizer(cfg, lr=item.get("lr", 1e-4))
    ts = TrainState(params, opt.init(params),
                    replicate(mesh, torch.Generator(device=dev).manual_seed(item["rng_seed"])), 0)
    grads: List[torch.Tensor] = []
    hook = None
    if item.get("grads"):
        def first_update(optimizer, args, kwargs):
            if not grads:
                grads.extend(p.grad.detach().cpu().clone() for p in trainable_leaves(ts.params))
        hook = ts.opt_state.register_step_pre_hook(first_update)
    step = make_sharded_train_step(cfg, opt, item["seg_len"], item["n_segs"], mesh)
    _sync(dev)
    before, t0 = _counts(), time.perf_counter()
    ts, metrics = step(ts, item["batch"])
    metrics = {k: v.cpu() for k, v in metrics.items()}
    seconds = time.perf_counter() - t0
    launches = _since(before)
    if hook is not None:
        hook.remove()
    out = {"tag": item.get("tag", ""), "metrics": metrics, "launches": launches,
           "seconds": seconds, "grads": grads or None}
    if item.get("timed_steps"):
        m = measure_steps(step, ts, item["batch"], n_steps=item["timed_steps"], warmup=0)
        out.update(median_seconds=m["median_seconds"], step_seconds=m["step_seconds"])
        # one segment's gradient all-reduce alone: the flat buffer of every
        # trainable gradient, host to host under gloo
        flat = torch.zeros(sum(p.numel() for p in trainable_leaves(ts.params)), device=dev)
        mesh.all_reduce(flat)
        _sync(dev)
        t1 = time.perf_counter()
        for _ in range(3):
            mesh.all_reduce(flat)
        _sync(dev)
        out.update(all_reduce_seconds=(time.perf_counter() - t1) / 3, all_reduce_bytes=4 * flat.numel())
    out["launches_all"] = _since(before)
    return out


def hmc_item(mesh, item: Dict) -> Dict:
    """One sharded HMC run of ``item``'s chains on its utterance's
    log-joint: this rank's samples and the info, launches and seconds."""
    from ..infer import Draws, HMCConfig, hmc_sample_sharded, make_utterance_logjoint

    dev = mesh.device
    cfg, params = model_of(item, dev)
    feats = torch.as_tensor(item["feats"], device=dev)
    lj = make_utterance_logjoint(params, cfg, feats, torch.as_tensor(item["code"], device=dev),
                                 obs_scale=item["obs_scale"])
    z0 = torch.zeros((item["chains"], feats.shape[0], cfg.lat_dim), device=dev)
    draws = Draws(torch.Generator(device=dev).manual_seed(item["draws_seed"]))
    _sync(dev)
    before, t0 = _counts(), time.perf_counter()
    samples, info = hmc_sample_sharded(mesh, draws, lj, z0, HMCConfig(*item["hmc"]))
    _sync(dev)
    return {"samples": samples.cpu(), "info": {k: v.cpu() for k, v in info.items()},
            "launches": _since(before), "seconds": time.perf_counter() - t0}


def smc_item(mesh, item: Dict) -> Dict:
    """One sharded SMC filter of ``item``'s particles over the decoder SSM
    of its utterance: the log-marginal, mean ESS, launches and seconds."""
    from ..infer import Draws, SMCConfig, make_decoder_ssm, smc_filter_sharded

    dev = mesh.device
    cfg, params = model_of(item, dev)
    feats = torch.as_tensor(item["feats"], device=dev)
    init, prop, logw = make_decoder_ssm(params, cfg, feats,
                                        torch.as_tensor(item["code"], device=dev),
                                        obs_scale=item["obs_scale"])
    draws = Draws(torch.Generator(device=dev).manual_seed(item["draws_seed"]))
    _sync(dev)
    before, t0 = _counts(), time.perf_counter()
    _, info = smc_filter_sharded(mesh, draws, feats.shape[0], init, prop, logw,
                                 SMCConfig(n_particles=item["particles"]))
    _sync(dev)
    return {"log_marginal": float(info["log_marginal"]), "mean_ess": float(info["ess"].mean()),
            "launches": _since(before), "seconds": time.perf_counter() - t0}


def dryrun_rank(rank: int, world: int, device: str, spec: Dict) -> Dict:
    """The rank function: ``spec``'s train items, then its HMC and SMC item
    (each optional), on this rank's ``device`` over the default group (its
    backend is the group's); rank 0 prints a line per item.  Returns
    {"train": [...], "hmc": ..., "smc": ...}."""
    from .mesh import make_mesh

    mesh = make_mesh(device=device)
    say = (lambda msg: print(f"dryrun_multichip({world}) {msg}", flush=True)) if rank == 0 else \
        (lambda msg: None)
    out: Dict = {"train": []}
    for item in spec.get("train", ()):
        r = train_item(mesh, item)
        loss = float(r["metrics"]["loss"].sum())
        if not np.isfinite(loss):
            raise FloatingPointError(f"[{r['tag']}] loss {loss}")
        say(f"[{r['tag']}]: loss={loss:.2f} OK")
        out["train"].append(r)
    if "hmc" in spec:
        r = out["hmc"] = hmc_item(mesh, spec["hmc"])
        acc = float(r["info"]["accept_prob"].mean())
        n_s = spec["hmc"]["hmc"][3]
        if not (np.isfinite(acc) and r["samples"].shape[1] == n_s):
            raise FloatingPointError(f"sharded HMC: accept {acc}, {tuple(r['samples'].shape)}")
        say(f"[sharded HMC hu={spec['hmc']['hidden_units']}]: accept={acc:.2f} OK")
    if "smc" in spec:
        r = out["smc"] = smc_item(mesh, spec["smc"])
        if not np.isfinite(r["log_marginal"]):
            raise FloatingPointError(f"sharded SMC: log marginal {r['log_marginal']}")
        say(f"[sharded SMC hu={spec['smc']['hidden_units']}]: logZ={r['log_marginal']:.2f} OK")
    return out


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout_s: float = 900.0) -> List[Dict]:
    """Spawn ``n_devices`` ranks and run the JAX dry run's work in them
    (``dryrun_spec``).  ``device`` "cpu" runs gloo ranks on the CPU;
    otherwise rank r runs on CUDA card r over NCCL, which needs one card per
    rank.  Returns each rank's results."""
    if device == "cpu":
        backend, devices = "gloo", ["cpu"] * n_devices
    else:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        if n_devices > count:
            raise ValueError(f"NCCL needs one card per rank: {n_devices} ranks, {count} cards")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n_devices)]
    return spawn_ranks(rank_on_device, n_devices, (devices, dryrun_spec(n_devices)),
                       backend=backend, timeout_s=timeout_s,
                       threads=1 if device == "cpu" else None)


def rank_on_device(rank: int, world: int, devices: List[str], spec: Dict) -> Dict:
    """``dryrun_rank`` on ``devices[rank]`` (for ``parallel.spawn``)."""
    if devices[rank].startswith("cuda"):
        torch.cuda.set_device(torch.device(devices[rank]))
    return dryrun_rank(rank, world, devices[rank], spec)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None, help="cpu, or the CUDA cards by default")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
