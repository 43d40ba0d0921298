"""Nesterov dual-averaging step-size adaptation (Hoffman & Gelman 2014 §3.2).

PyTorch counterpart of ``cyclevae_tpu/infer/dual_averaging.py``, as plain
tensor functions: used during HMC/NUTS warmup to drive the average
acceptance probability to a target (0.8 by default).  Every field is a
tensor on the chains' device, a scalar for a shared step size or one value
per chain, so the warmup never waits for the host."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor       # current log step size
    log_step_avg: torch.Tensor   # averaged iterate
    h_bar: torch.Tensor          # running accept-error average
    mu: torch.Tensor             # shrinkage target
    t: torch.Tensor              # iteration counter


def da_init(step_size, device=None) -> DualAveragingState:
    log_eps = torch.log(torch.as_tensor(step_size, dtype=torch.float32, device=device))
    zero = torch.zeros_like(log_eps)
    return DualAveragingState(log_step=log_eps, log_step_avg=zero, h_bar=zero,
                              mu=math.log(10.0) + log_eps, t=zero)


def da_update(state: DualAveragingState, accept_prob: torch.Tensor,
              target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_step = state.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, state.mu, t)


def da_final(state: DualAveragingState) -> torch.Tensor:
    """Adapted step size to use after warmup."""
    return torch.exp(state.log_step_avg)
