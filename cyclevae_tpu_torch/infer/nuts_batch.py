"""Batched-chain NUTS: all chains ride the target's batch axis in lockstep.

PyTorch counterpart of ``cyclevae_tpu/infer/nuts_batch.py``: every outer
doubling iteration j, all still-active chains build a 2^j-leaf subtree
simultaneously, one batched value-and-gradient evaluation per leaf (the
decoder's batch axis: one K2 and one K3 launch for every chain), with
per-chain direction draws, U-turn flags, divergence flags and progressive
sampling decisions applied by masking.  The tree mechanics are
``nuts._transition``'s.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .draws import Draws
from .logjoint import value_and_grad
from .nuts import NUTSConfig, _info, _sample, _transition


def nuts_kernel_batch(draws: Draws, logjoint_batch: Callable[[torch.Tensor], torch.Tensor],
                      z: torch.Tensor, step_size, inv_mass: torch.Tensor, cfg: NUTSConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One batched NUTS transition: z (C, ...) -> (C, ...), stats per chain."""
    return _transition(draws, lambda zb: value_and_grad(logjoint_batch, zb), z,
                       torch.as_tensor(step_size), inv_mass, cfg)


def nuts_sample_batch(draws: Draws, logjoint_batch: Callable[[torch.Tensor], torch.Tensor],
                      z0_chains: torch.Tensor, cfg: NUTSConfig = NUTSConfig()
                      ) -> Tuple[torch.Tensor, dict]:
    """Batched-chain NUTS with shared dual-averaging + pooled mass adaptation
    (the windowed warmup).  Returns (samples (n_samples, C, ...), info)."""
    samples, warm, per, step, inv_mass = _sample(
        draws, lambda zb: value_and_grad(logjoint_batch, zb), z0_chains, cfg, windowed=True)
    return samples, _info(warm, per, step, inv_mass)
