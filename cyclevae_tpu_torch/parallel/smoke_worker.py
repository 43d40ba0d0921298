"""One data-parallel train step in each process of a launched group.

The counterpart of ``tools/multihost_smoke_worker.py``, run by the launcher
(which initialized the group):

    CYCLEVAE_PLATFORM=cpu CYCLEVAE_NUM_PROCESSES=2 CYCLEVAE_PROCESS_ID=<r> \\
        python -m cyclevae_tpu_torch.parallel.launch -m cyclevae_tpu_torch.parallel.smoke_worker

Every process builds the same model and batch from seeds, takes one sharded
step (hu32, 2 cycles, 2 segments of 16 frames, 2 utterances per process)
and prints ``SMOKE_OK proc=<r>/<n> devices=<n> loss=<summed loss>``; the
processes of one run print the same loss.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def main() -> None:
    from . import make_mesh, make_sharded_train_step, replicate
    from .dryrun import synthetic_batch
    from ..vi.train import CycleVAEConfig, TrainState, init_cyclevae, make_optimizer

    device = "cpu" if os.environ.get("CYCLEVAE_PLATFORM") == "cpu" else None
    mesh = make_mesh(device=device)
    if mesh.size < 2:
        raise SystemExit("expected a launch of 2 or more processes")
    cfg = CycleVAEConfig(hidden_units=32, n_cyc=2)
    B, seg, n_segs = 2 * mesh.size, 16, 2
    T = seg * n_segs
    batch = synthetic_batch(B, T)
    dev = mesh.device
    params = replicate(mesh, init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg,
                                           np.zeros(54, np.float32), np.ones(54, np.float32),
                                           device=dev))
    opt = make_optimizer(cfg, lr=1e-4)
    ts = TrainState(params, opt.init(params),
                    replicate(mesh, torch.Generator(device=dev).manual_seed(7)), 0)
    step = make_sharded_train_step(cfg, opt, seg, n_segs, mesh)
    ts, metrics = step(ts, batch)
    loss = float(metrics["loss"].sum())
    print(f"SMOKE_OK proc={mesh.rank}/{mesh.size} devices={mesh.size} loss={loss:.6f}",
          flush=True)


if __name__ == "__main__":
    main()
