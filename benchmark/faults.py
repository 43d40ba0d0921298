"""Faults planted in the program under test, each a way its timed path could
break: the check's CPU tests plant them at a tiny size, and
``calibrate.py --fault <name>`` on the card at a cell's own size.  A plant
replaces one name of the program through ``setattr(obj, name, value)``:
pytest's ``monkeypatch.setattr`` in a test, the builtin in ``calibrate.py``'s
own process."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

Setter = Callable[[object, str, object], None]


def train_state_unchanged(setattr: Setter) -> None:
    """Every optimizer step keeps Adam's moments but puts the parameters
    back as they were."""
    import cyclevae_tpu_torch.vi.train as train

    class Stuck(torch.optim.Adam):
        def step(self, closure=None):
            keep = [p.detach().clone() for g in self.param_groups for p in g["params"]]
            super().step(closure)
            with torch.no_grad():
                for p, k in zip((p for g in self.param_groups for p in g["params"]), keep):
                    p.copy_(k)

    def init(self, params):
        leaves = train.trainable_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return Stuck(leaves, lr=self.lr)

    setattr(train.Optimizer, "init", init)


def train_half_batch(setattr: Setter) -> None:
    """The step leaves out the second half of the batch's utterances (their
    lengths read 0, so every frame of theirs is masked), its losses the mean
    over the rest."""
    import cyclevae_tpu_torch.vi.train as train
    make = train.make_train_step

    def broken(cfg, opt, seg_len, n_segs):
        step = make(cfg, opt, seg_len, n_segs)

        def run(ts, batch, draws=None):
            flens = np.array(batch["flens"])
            flens[(len(flens) + 1) // 2:] = 0
            return step(ts, {**batch, "flens": flens}, draws=draws)
        return run

    setattr(train, "make_train_step", broken)


def hmc_state_unchanged(setattr: Setter) -> None:
    """The leapfrog returns its start point and momentum."""
    import cyclevae_tpu_torch.infer.hmc as hmc
    setattr(hmc, "_leapfrog", lambda grad_fn, z, p, *a: (z, p))


def hmc_always_accept(setattr: Setter) -> None:
    """The accept test is skipped: every transition takes its proposal,
    while the accept probabilities, and so the adaptation, stay as they
    were."""
    import cyclevae_tpu_torch.infer.hmc as hmc

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def where(cond, a, b):
            # the step's choice between the proposal and its start point
            # (the other ``where`` of the step is over one value a chain)
            if torch.is_tensor(a) and a.ndim > 1:
                return a
            return torch.where(cond, a, b)

    setattr(hmc, "torch", Torch())


def hmc_sample_altered(setattr: Setter) -> None:
    """Every chain's sample altered at one frame where it is produced."""
    import cyclevae_tpu_torch.pipeline.infer_stage as stage
    real = stage.hmc_sample_batch

    def broken(*a, **k):
        samples, info = real(*a, **k)
        samples = samples.clone()
        samples[:, :, 3, 5] += 0.5
        return samples, info

    setattr(stage, "hmc_sample_batch", broken)


FAULTS: Dict[str, Callable[[Setter], None]] = {
    f.__name__: f for f in (train_state_unchanged, train_half_batch, hmc_state_unchanged,
                            hmc_always_accept, hmc_sample_altered)}
