"""The data-parallel group and its sharding rules, on ``torch.distributed``.

PyTorch counterpart of ``cyclevae_tpu/parallel/mesh.py``.  The JAX package
runs one SPMD program over a ``jax.sharding.Mesh`` whose ``dp`` axis shards
the batch-like dimension (utterances in training, chains for HMC and NUTS,
particles for SMC), with the parameters replicated; here each process of a
``torch.distributed`` group is one slot of that axis:

  * every rank holds the same parameters, optimizer state and
    ``torch.Generator`` state (``replicate`` broadcasts them from rank 0);
  * every rank keeps its own rows of the batch (``shard_batch``);
  * every draw is made at its global shape and each rank keeps its rows
    (``parallel.draws.ShardedDraws``), so the generators never drift apart
    and a sharded run gives the single-process run's numbers up to the
    order of the sums;
  * the reductions XLA inserts for the JAX package (the loss's sum over
    utterances, the metrics' means, the samplers' adaptation statistics and
    resampling weights) are explicit collectives of ``Mesh``.

The group is the default one, which ``parallel.launch`` (or
``parallel.spawn``) initialized.  Its backend is NCCL on CUDA tensors, or
gloo; gloo has no CUDA ``all_gather``, so under gloo every collective stages
its tensor through a host copy, explicitly, and NCCL runs on the device.
``CYCLEVAE_VERIFY_GLOBAL=1`` checks, on every ``replicate`` and
``shard_batch``, that every rank passed byte-identical host values (a CRC32
all-gather), as the JAX package's ``_put_global`` does.
"""

from __future__ import annotations

import datetime
import os
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def init_group(backend: str, init_method: str, world_size: int, rank: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Initialize the default process group (``init_method``: ``tcp://host:port``
    or ``file:///path``), with a finite timeout on every collective."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


@dataclass(frozen=True)
class Mesh:
    """One data-parallel axis over the processes of a group: this process's
    ``rank`` of ``size``, its ``device`` and the group's ``backend``.
    ``group`` None is one process without a group (every collective is the
    identity)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]

    def _run(self, t: torch.Tensor, collective) -> torch.Tensor:
        """Run ``collective(x)`` on a fresh copy ``x`` of ``t`` where the
        backend takes it (host memory under gloo, the device under NCCL);
        returns ``x`` moved back to ``t``'s device."""
        where = torch.device("cpu") if self.backend == "gloo" else self.device
        x = t.detach().to(where, copy=True).contiguous()
        out = collective(x)
        return (x if out is None else out).to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum", "max", "min") of every rank's ``t``."""
        if self.group is None:
            return t
        return self._run(t, lambda x: dist.all_reduce(x, op=_OPS[op], group=self.group))

    def all_gather(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (all of one shape), in rank order, concatenated
        along ``axis``."""
        if self.group is None:
            return t

        def gather(x):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts, dim=axis)
        return self._run(t, gather)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank."""
        if self.group is None:
            return t
        return self._run(t, lambda x: dist.broadcast(x, src=0, group=self.group))

    def all(self, flag) -> bool:
        """True where ``flag`` (a bool tensor or bool) holds everywhere on
        every rank: one small all-reduce."""
        local = bool(torch.as_tensor(flag).all())
        return bool(self.all_reduce(torch.tensor([int(local)]), "min")[0])

    def any(self, flag) -> bool:
        """True where ``flag`` holds anywhere on any rank."""
        local = bool(torch.as_tensor(flag).any())
        return bool(self.all_reduce(torch.tensor([int(local)]), "max")[0])


def make_mesh(n_dp: Optional[int] = None, backend: Optional[str] = None,
              device=None) -> Mesh:
    """The data-parallel mesh over every process of the default group.

    ``device``: this rank's device, CUDA unless the caller passes "cpu"
    (``utils.device.resolve_device``).  ``backend``: the group's backend,
    checked against it ("nccl" needs CUDA tensors; "gloo" takes either).
    Without an initialized group the mesh is this one process.  ``n_dp``,
    where given, must be the group's size: the axis spans the whole group.
    """
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        got = dist.get_backend()
        if backend is not None and backend != got:
            raise ValueError(f"the process group's backend is {got}, not {backend}")
        backend = got
    else:
        group, rank, size = None, 0, 1
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves CUDA tensors: pass a CUDA device, or use gloo")
    if n_dp is not None and n_dp != size:
        raise ValueError(f"n_dp={n_dp}, but the process group has {size} processes: "
                         "launch one process per data-parallel slot")
    return Mesh(group, rank, size, device, backend)


# ---------------------------------------------------------------------------
# Same-host-value check
# ---------------------------------------------------------------------------

def _host_bytes(leaf) -> bytes:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().tobytes()
    if isinstance(leaf, np.ndarray):
        return np.ascontiguousarray(leaf).tobytes()
    return repr(leaf).encode()


def _verify_same_across_processes(mesh: Mesh, tree) -> None:
    """Raise ``AssertionError`` unless every rank holds byte-identical host
    values in ``tree`` (one CRC32 over its leaves, all-gathered)."""
    crc = 0
    for leaf in _tree_leaves(tree):
        crc = zlib.crc32(_host_bytes(leaf), crc)
    crcs = mesh.all_gather(torch.tensor([crc], dtype=torch.int64)).tolist()
    if any(c != crcs[0] for c in crcs):
        raise AssertionError(
            "global-array invariant violated: host value differs across processes "
            f"(crc32 per process: {crcs}): the loader produced divergent data; check "
            "per-process RNG seeding and file ordering")


def _verify_enabled() -> bool:
    return os.environ.get("CYCLEVAE_VERIFY_GLOBAL") == "1"


def _tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    if isinstance(tree, torch.optim.Optimizer):
        return [v for p in _opt_params(tree) for _, v in sorted(tree.state[p].items())]
    return [tree]


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"] if p in opt.state]


# ---------------------------------------------------------------------------
# Replication and sharding
# ---------------------------------------------------------------------------

def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank: tensors (in place), a
    ``torch.Generator``'s state (in place), a ``torch.optim`` optimizer's
    state tensors (in place), numpy arrays and scalars (new values), inside
    dicts, lists, tuples and named tuples (e.g. a ``TrainState``).  Returns
    the tree."""
    if _verify_enabled():
        _verify_same_across_processes(mesh, tree)
    return _replicate(mesh, tree)


def _replicate(mesh: Mesh, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _replicate(mesh, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replicate(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicate(mesh, v) for v in tree)
    if torch.is_tensor(tree):
        with torch.no_grad():
            tree.copy_(mesh.broadcast(tree))
        return tree
    if isinstance(tree, torch.Generator):
        tree.set_state(mesh.broadcast(tree.get_state()).cpu())
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        for p in _opt_params(tree):
            for v in tree.state[p].values():
                if torch.is_tensor(v):
                    _replicate(mesh, v)
        return tree
    if isinstance(tree, np.ndarray):
        return mesh.broadcast(torch.from_numpy(np.ascontiguousarray(tree))).numpy()
    if isinstance(tree, (bool, int, float, np.number)):
        return type(tree)(mesh.broadcast(torch.tensor(tree, dtype=torch.float64)).item())
    if tree is None:
        return None
    raise TypeError(f"replicate: no rule for {type(tree).__name__}")


def batch_spec(ndim: int) -> int:
    """The sharded axis of a batch array: the utterance / chain / particle
    axis, axis 0 of a 1-3-D array but axis 1 of the 4-D many-to-many
    per-cycle arrays (n_cyc, B, T, D): n_cyc (typically 2) is not the data
    axis and rarely divides the group."""
    return 1 if ndim == 4 else 0


def shard_rows(mesh: Mesh, value, axis: int = 0):
    """This rank's block of ``value`` (numpy or tensor) along ``axis``;
    raises when that axis does not divide by the group's size."""
    n = value.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of length {n} does not shard over {mesh.size} "
                         "processes")
    b = n // mesh.size
    index = [slice(None)] * np.ndim(value)
    index[axis] = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return value[tuple(index)]


class ShardedBatch(dict):
    """A batch holding this rank's rows (``shard_batch``), with the flens of
    every rank's utterances (``global_flens``): which segments have a real
    frame is decided over the whole batch."""

    global_flens: Optional[np.ndarray] = None


def shard_batch(mesh: Mesh, batch: Dict) -> ShardedBatch:
    """This rank's rows of every array of ``batch`` (the same global batch
    on every rank) along its ``batch_spec`` axis; values stay numpy arrays
    or tensors where they were."""
    if isinstance(batch, ShardedBatch):
        return batch
    if _verify_enabled():
        _verify_same_across_processes(mesh, batch)
    out = ShardedBatch((k, shard_rows(mesh, v, batch_spec(np.ndim(v))))
                       for k, v in batch.items())
    if "flens" in batch:
        f = batch["flens"]
        out.global_flens = np.asarray(f.cpu() if torch.is_tensor(f) else f)
    return out


# ---------------------------------------------------------------------------
# The data-parallel train step
# ---------------------------------------------------------------------------

def all_reduce_grads(mesh: Mesh, leaves: List[torch.Tensor]) -> None:
    """Sum every rank's gradients of ``leaves`` in place: one collective on
    one flat buffer.  The loss is a sum over utterances, so the sum (not
    DDP's mean) is the gradient of the whole batch's loss."""
    grads = [p.grad for p in leaves if p.grad is not None]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_sharded_train_step(cfg, optimizer, seg_len: int, n_segs: int, mesh: Mesh):
    """The data-parallel ``vi.train.make_train_step``.

    ``step(ts, batch, draws=None)`` takes the GLOBAL host batch (the same on
    every rank) and keeps this rank's rows itself (a batch that
    ``shard_batch`` already cut is taken as it is), the counterpart of the
    JAX step's in-graph sharding constraint: a caller cannot run it
    replicated by mistake.  ``ts`` is replicated (``replicate``).  Per
    segment: which segments run is decided from every rank's flens (a rank
    whose utterances all ended still joins the forward and the all-reduce);
    the forward runs on this rank's rows with the global draws' rows; the
    gradients are summed over the ranks (``all_reduce_grads``) between the
    backward and Adam's update, so every rank takes the same update.  The
    metrics are global: the loss summed, each mean over valid utterances
    made from the summed sums and counts.  Returns (ts, metrics) as the
    single-device step does, on every rank.
    """
    from ..models.gru_vae import Draws
    from ..vi.train import metric_names, run_segments, stack_metrics, TrainState
    from .draws import ShardedDraws

    def sharded_step(ts: TrainState, batch: Dict, draws=None):
        local = shard_batch(mesh, batch)
        flens = local.global_flens
        seg_valid = [bool(np.any(flens > s * seg_len)) for s in range(n_segs)]
        b = int(np.asarray(local["flens"]).shape[0])
        draws = ShardedDraws(Draws(ts.rng) if draws is None else draws, mesh.rank, mesh.size, b)
        per_seg = run_segments(cfg, seg_len, n_segs, ts, local, draws, seg_valid,
                               reduce_grads=lambda leaves: all_reduce_grads(mesh, leaves))
        dev = ts.params.decoder["out"]["w"].device
        names = [k for k in metric_names(cfg) if k != "loss"]
        valid = [s for s in range(n_segs) if seg_valid[s]]
        if valid:
            # per valid segment: the loss, each metric's sum over this rank's
            # valid utterances, and their count; one all-reduce for the step
            lf = np.asarray(local["flens"])
            counts = torch.tensor([float(np.sum(lf > s * seg_len)) for s in valid], device=dev)
            sums = torch.stack([torch.stack([per_seg[s][k] for k in names]) for s in valid])
            packed = torch.cat([torch.stack([per_seg[s]["loss"] for s in valid])[:, None],
                                sums * torch.clamp(counts, min=1.0)[:, None], counts[:, None]],
                               dim=1)
            packed = mesh.all_reduce(packed)
            n_all = torch.clamp(packed[:, -1], min=1.0)
            for i, s in enumerate(valid):
                per_seg[s] = {"loss": packed[i, 0],
                              **{k: packed[i, 1 + j] / n_all[i] for j, k in enumerate(names)}}
        return (TrainState(ts.params, ts.opt_state, ts.rng, ts.step + 1),
                stack_metrics(cfg, per_seg, seg_valid, dev))

    return sharded_step
