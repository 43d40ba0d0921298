"""Start a module or script in one process of a ``torch.distributed`` group.

The counterpart of ``tools/launch_multihost.py``: one process per slot of
the data-parallel axis, its group initialized from cluster environment
variables, then the recipe run in it:

    CYCLEVAE_NUM_PROCESSES=2 CYCLEVAE_PROCESS_ID=0 \\
        python -m cyclevae_tpu_torch.parallel.launch -m <module> [args...]
    srun --ntasks-per-node=1 python -m cyclevae_tpu_torch.parallel.launch \\
        -m cyclevae_tpu_torch.parallel.smoke_worker

Conventions, as the JAX launcher reads them:

  * explicit: ``CYCLEVAE_NUM_PROCESSES``, ``CYCLEVAE_PROCESS_ID`` (0..n-1),
    ``CYCLEVAE_COORDINATOR`` (default 127.0.0.1), ``CYCLEVAE_PORT`` (default
    8476);
  * Slurm: ``SLURM_JOB_NUM_NODES`` processes (one per node), rank
    ``SLURM_PROCID``, the coordinator the first host of
    ``SLURM_JOB_NODELIST`` (or ``CYCLEVAE_COORDINATOR``);
  * neither: one process.

``CYCLEVAE_PLATFORM=cpu`` makes the group gloo on the CPU; otherwise it is
NCCL, each process on CUDA device ``CYCLEVAE_LOCAL_RANK`` (default
``SLURM_LOCALID``, else the rank modulo the card count).  The group's
collectives time out after ``parallel.mesh.DEFAULT_TIMEOUT_S`` seconds.
"""

from __future__ import annotations

import os
import runpy
import sys
from typing import Dict, Tuple

from .mesh import init_group

DEFAULT_PORT = "8476"


def group_from_env(env: Dict[str, str]) -> Tuple[int, int, str]:
    """(world size, rank, ``tcp://`` address) from the environment; raises
    ``SystemExit`` with the convention's own message when it is
    incomplete."""
    port = env.get("CYCLEVAE_PORT", DEFAULT_PORT)
    if "CYCLEVAE_NUM_PROCESSES" in env:
        n = int(env["CYCLEVAE_NUM_PROCESSES"])
        if n > 1:
            if "CYCLEVAE_PROCESS_ID" not in env:
                raise SystemExit(
                    "CYCLEVAE_NUM_PROCESSES=%d requires CYCLEVAE_PROCESS_ID (0..%d) to be set "
                    "for each process; optional: CYCLEVAE_COORDINATOR (default 127.0.0.1), "
                    "CYCLEVAE_PORT (default %s)" % (n, n - 1, DEFAULT_PORT))
            pid = int(env["CYCLEVAE_PROCESS_ID"])
            if not 0 <= pid < n:
                raise SystemExit("CYCLEVAE_PROCESS_ID=%d out of range for "
                                 "CYCLEVAE_NUM_PROCESSES=%d" % (pid, n))
            coord = env.get("CYCLEVAE_COORDINATOR", "127.0.0.1")
            return n, pid, f"tcp://{coord}:{port}"
    elif "SLURM_JOB_NUM_NODES" in env and "SLURM_PROCID" in env:
        n = int(env["SLURM_JOB_NUM_NODES"])
        if n > 1:
            nodelist = env.get("SLURM_JOB_NODELIST", "")
            coord = env.get("CYCLEVAE_COORDINATOR", nodelist.split(",")[0].split("[")[0])
            return n, int(env["SLURM_PROCID"]), f"tcp://{coord}:{port}"
    return 1, 0, f"tcp://127.0.0.1:{port}"


def platform_device(env: Dict[str, str], rank: int):
    """(backend, device) of this process: gloo on the CPU under
    ``CYCLEVAE_PLATFORM=cpu``, else NCCL on this process's card."""
    import torch

    if env.get("CYCLEVAE_PLATFORM") == "cpu":
        return "gloo", torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: set CYCLEVAE_PLATFORM=cpu to run on the CPU")
    local = int(env.get("CYCLEVAE_LOCAL_RANK",
                        env.get("SLURM_LOCALID", rank % torch.cuda.device_count())))
    torch.cuda.set_device(local)
    return "nccl", torch.device("cuda", local)


def main() -> None:
    argv = sys.argv[1:]
    if not argv or (argv[0] == "-m" and len(argv) < 2):
        print("usage: python -m cyclevae_tpu_torch.parallel.launch "
              "-m <module> [args...] | <script> [args...]")
        sys.exit(2)
    env = dict(os.environ)
    n, rank, address = group_from_env(env)
    backend, device = platform_device(env, rank)
    init_group(backend, address, n, rank)
    print(f"[launch] process {rank}/{n} backend {backend} device {device}", flush=True)
    try:
        if argv[0] == "-m":
            sys.argv = [argv[1]] + argv[2:]
            runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
        else:
            sys.argv = argv
            runpy.run_path(argv[0], run_name="__main__")
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
