"""Run one function in each of ``world`` spawned processes of a group.

``spawn_ranks(fn, world, args)`` starts ``world`` processes (the ``spawn``
start method: each imports only what ``fn``'s module imports), initializes
the default group in each over a ``file://`` store in a fresh directory,
with a finite timeout on every collective, calls ``fn(rank, world, *args)``
and hands back each rank's return value.  The ranks are joined with a time
limit: a rank that hangs or fails ends all of them and raises here, so a
fault in a collective cannot hang the caller.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from .mesh import DEFAULT_TIMEOUT_S, init_group


def _rank_main(fn, rank: int, world: int, backend: str, store: str, timeout_s: float,
               threads: Optional[int], args_path: str, out: str) -> None:
    import torch.distributed as dist

    try:
        if threads is not None:
            torch.set_num_threads(threads)
        args = torch.load(args_path, weights_only=False)
        init_group(backend, "file://" + store, world, rank, timeout_s)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
                timeout_s: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None,
                workdir: Optional[str] = None) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own spawned process of one group of ``backend``.

    ``fn`` is pickled by its import path (a module-level function); ``args``
    and the results pass by value through ``torch.save`` files, so every
    rank gets its own copy of each tensor (``multiprocessing`` would hand
    the ranks one shared-memory tensor, which each would then update).
    ``timeout_s`` bounds each collective and the whole run; ``threads`` sets
    each rank's ``torch.set_num_threads``; ``workdir`` holds the store and
    the results (a temporary directory by default).  Raises
    ``TimeoutError`` when a rank is still running at the limit and
    ``RuntimeError`` (with the rank's traceback) when one failed.
    """
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cyclevae_ranks_", dir=workdir)
    try:
        store, args_path = os.path.join(tmp, "store"), os.path.join(tmp, "args.pt")
        torch.save(tuple(args), args_path)
        outs = [os.path.join(tmp, f"rank{r}") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, store, timeout_s,
                                                      threads, args_path, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            # until every rank ended, the limit passed, or one rank failed
            # (its partners would wait on it in a collective)
            while time.monotonic() < deadline:
                alive = [p for p in procs if p.is_alive()]
                if not alive or any(p.exitcode not in (None, 0) for p in procs):
                    break
                ready = multiprocessing.connection.wait([p.sentinel for p in alive],
                                                        deadline - time.monotonic())
                for p in alive:         # ending: reap it rather than poll
                    if p.sentinel in ready:
                        p.join(max(deadline - time.monotonic(), 0.0))
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            hung = [] if failed else [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        errors = []
        for r, o in enumerate(outs):
            if os.path.exists(o + ".err"):
                with open(o + ".err") as f:
                    errors.append(f"rank {r}:\n" + f.read())
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {timeout_s} s"
                               + ("\n" + "\n".join(errors) if errors else ""))
        if failed:
            raise RuntimeError(f"ranks {failed} failed (exit codes "
                               f"{[procs[r].exitcode for r in failed]})\n" + "\n".join(errors))
        return [torch.load(o + ".pt", weights_only=False) for o in outs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
