"""Hamiltonian Monte Carlo with leapfrog integration + dual-averaging warmup.

PyTorch counterpart of ``cyclevae_tpu/infer/hmc.py``.  Chains are a batch
axis: ``hmc_sample_batch`` hands all chains to one batched log-joint (the
decoder's batch axis, one K2 / K3 launch for every chain), and
``hmc_sample`` / ``hmc_sample_chains`` run one chain, or chains of a
single-chain log-joint, through the same loop; ``hmc_sample_sharded``
runs the chains over a ``parallel.Mesh`` of processes.  Everything per step
stays on the device: the accept test is a per-chain ``torch.where``, the
adaptation statistics are tensors, so a step never waits for the host (but,
sharded, for the gather of the adaptation statistics).

A step with ``n_leapfrog`` = L makes JAX's count of evaluations: 2L
gradients (each a forward and a backward) and 2 energies (forwards).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..utils.profiling import span
from .draws import Draws
from .dual_averaging import da_final, da_init, da_update
from .logjoint import value_and_grad


class HMCConfig(NamedTuple):
    step_size: float = 0.1
    n_leapfrog: int = 16
    n_warmup: int = 200
    n_samples: int = 500
    target_accept: float = 0.8
    adapt_mass: bool = True


def _leapfrog(grad_fn, z, p, step_size, n_steps, inv_mass):
    """``n_steps`` leapfrog steps, two gradient evaluations each (as the JAX
    package's scan body)."""
    for _ in range(n_steps):
        p_half = p + 0.5 * step_size * grad_fn(z)
        z_new = z + step_size * inv_mass * p_half
        p = p_half + 0.5 * step_size * grad_fn(z_new)
        z = z_new
    return z, p


def _run(draws: Draws, logjoint_batch: Callable[[torch.Tensor], torch.Tensor],
         z0: torch.Tensor, cfg: HMCConfig, windowed: bool, shared: bool = True,
         mesh=None) -> Tuple[torch.Tensor, Dict]:
    """HMC over chains z0 (C, ...) of a batched log-joint (C, ...) -> (C,).

    ``shared``: one step size and one inverse mass for all chains (the
    statistics averaged over chains, and with a ``mesh`` over every rank's
    chains, gathered once per adaptation step), else one per chain.
    ``windowed``:
    the batched sampler's two-phase warmup (the step size re-adapted under
    the new metric), else the single-chain sampler's one phase.  Returns
    (samples (n_samples, C, ...), per-step accept probabilities of the
    warmup (n_warmup, C) and of the samples (n_samples, C), step size,
    inverse mass)."""
    C = z0.shape[0]
    axes = tuple(range(1, z0.ndim))
    bshape = (C,) + (1,) * len(axes)
    grad_fn = lambda z: value_and_grad(logjoint_batch, z)[1]

    def energy(z):
        with torch.no_grad():
            return logjoint_batch(z)

    def kinetic(p, inv_mass):
        # one sum per chain: on the card a sum over (C, ...) along the chain
        # dims adds in an order that depends on C, so a rank's C / size
        # chains (hmc_sample_sharded) would part from the single process's
        e = 0.5 * inv_mass * p ** 2
        return torch.stack([torch.sum(e[c]) for c in range(C)])

    def per_chain(x):       # a step size of shape () or (C,) over the chain dims
        return x.reshape(bshape) if x.ndim == 1 else x

    def chain_mean(x):      # the mean over the chains (every rank's, gathered:
        # the single-process mean of the same values, bit for bit)
        return (x if mesh is None else mesh.all_gather(x)).mean(dim=0)

    def one_step(z, step_size, inv_mass):
        p = draws.momentum(z.shape) / torch.sqrt(inv_mass)
        h0 = -energy(z) + kinetic(p, inv_mass)
        z_new, p_new = _leapfrog(grad_fn, z, p, per_chain(step_size), cfg.n_leapfrog,
                                 inv_mass)
        h1 = -energy(z_new) + kinetic(p_new, inv_mass)
        log_accept = torch.clamp(h0 - h1, max=0.0)                   # (C,)
        accept_prob = torch.exp(torch.where(torch.isfinite(log_accept), log_accept,
                                            torch.full_like(log_accept, -torch.inf)))
        accept = draws.accept((C,)) < accept_prob
        return torch.where(accept.reshape(bshape), z_new, z), accept_prob

    def warmup(z, step_size, inv_mass, n):
        with span("hmc.warmup"):
            da = da_init(step_size, device=z.device)
            w_sum, w2_sum, accs = torch.zeros_like(z), torch.zeros_like(z), []
            for _ in range(n):
                z, acc = one_step(z, torch.exp(da.log_step), inv_mass)
                da = da_update(da, chain_mean(acc) if shared else acc, target=cfg.target_accept)
                w_sum, w2_sum = w_sum + z, w2_sum + z ** 2
                accs.append(acc)
            var = w2_sum / n - (w_sum / n) ** 2 if n else torch.zeros_like(z)
            return z, da, (chain_mean(var) if shared else var), accs

    init_step = torch.full((C,) if not shared else (), cfg.step_size, device=z0.device)
    inv_mass0 = torch.ones_like(z0[0] if shared else z0)
    if cfg.adapt_mass and windowed:
        # Windowed warmup (Stan-style): phase 1 dual-averages the step size
        # under the identity metric while collecting posterior moments; the
        # diagonal inverse mass is set from the pooled cross-chain variance;
        # phase 2 then re-adapts the step size under the new metric
        n1 = cfg.n_warmup // 2
        z, da, var, acc1 = warmup(z0, init_step, inv_mass0, n1)
        inv_mass = torch.clamp(var, min=1e-3)
        z, da, _, acc2 = warmup(z, da_final(da), inv_mass, cfg.n_warmup - n1)
        warm_acc = acc1 + acc2
    else:
        z, da, var, warm_acc = warmup(z0, init_step, inv_mass0, cfg.n_warmup)
        # inv mass = posterior variance
        inv_mass = torch.clamp(var, min=1e-3) if cfg.adapt_mass else inv_mass0
    step_size = da_final(da)

    samples, accs = [], []
    with span("hmc.sample"):
        for _ in range(cfg.n_samples):
            z, acc = one_step(z, step_size, inv_mass)
            samples.append(z)
            accs.append(acc)
    stack = lambda xs: torch.stack(xs) if xs else torch.zeros((0, C), device=z0.device)
    return torch.stack(samples), stack(warm_acc), stack(accs), step_size, inv_mass


def hmc_sample(draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
               z0: torch.Tensor, cfg: HMCConfig = HMCConfig()
               ) -> Tuple[torch.Tensor, dict]:
    """Single-chain HMC.  Returns (samples (n_samples, *z.shape), info dict
    with accept_prob, warmup_accept_prob, adapted step_size, inv_mass)."""
    samples, warm, acc, step, inv_mass = _run(
        draws, lambda z: logjoint(z[0])[None], z0[None], cfg, windowed=False)
    return samples[:, 0], {"accept_prob": acc.mean(), "warmup_accept_prob": warm.mean(),
                           "step_size": step, "inv_mass": inv_mass}


def hmc_sample_batch(draws: Draws, logjoint_batch: Callable[[torch.Tensor], torch.Tensor],
                     z0_chains: torch.Tensor, cfg: HMCConfig = HMCConfig()
                     ) -> Tuple[torch.Tensor, dict]:
    """Multi-chain HMC where chains ride the target's BATCH axis.

    ``logjoint_batch(z (C, ...)) -> (C,)``: one fused evaluation for all
    chains (e.g. ``make_utterance_logjoint_batched``).  Acceptance is
    per-chain; dual averaging and mass adaptation share statistics across
    chains, with the windowed warmup.  Returns (samples (n_samples, C, ...),
    info)."""
    samples, warm, acc, step, inv_mass = _run(draws, logjoint_batch, z0_chains, cfg,
                                              windowed=True)
    return samples, {"accept_prob": acc.mean(), "warmup_accept_prob": warm.mean(),
                     "step_size": step, "inv_mass": inv_mass}


def hmc_sample_chains(draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
                      z0_chains: torch.Tensor, cfg: HMCConfig = HMCConfig(),
                      shared_adaptation: bool = True) -> Tuple[torch.Tensor, dict]:
    """Chains of a single-chain log-joint, z0_chains (C, *shape), stepped
    together (the JAX package vmaps ``hmc_sample``); the log-joint runs once
    per chain.  With ``shared_adaptation`` the dual-averaging and mass
    statistics are averaged over all chains, so they share one schedule.
    Returns (samples (C, n_samples, *shape), the chains first as the vmap
    lays them out, and info with one value per chain)."""
    return _chains(draws, logjoint, z0_chains, cfg, shared_adaptation, None)


def _chains(draws, logjoint, z0, cfg, shared, mesh):
    C = z0.shape[0]
    samples, warm, acc, step, inv_mass = _run(
        draws, lambda z: torch.stack([logjoint(z[c]) for c in range(C)]), z0, cfg,
        windowed=False, shared=shared, mesh=mesh)
    return samples.transpose(0, 1), {
        "accept_prob": acc.mean(dim=0), "warmup_accept_prob": warm.mean(dim=0),
        "step_size": step.expand(C), "inv_mass": inv_mass.expand_as(z0)}


def hmc_sample_sharded(mesh, draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
                       z0_chains: torch.Tensor, cfg: HMCConfig = HMCConfig()
                       ) -> Tuple[torch.Tensor, dict]:
    """``hmc_sample_chains`` with the chains sharded over a
    ``parallel.Mesh``: ``z0_chains`` (C, *shape) is the global start (the
    same on every rank), this rank runs its C / size chains, and the draws
    are the global ones' rows (``parallel.draws.ShardedDraws``), so the
    chains are the single-process sampler's.  The dual-averaging accept
    mean and the pooled within-chain variance are taken over every chain of
    every rank (all-gathered, then averaged as the single process averages
    them, so the schedule is the single-process one bit for bit): one
    adapted schedule for the fleet.  Returns (this rank's samples (C / size,
    n_samples, *shape), info averaged over the ranks, as the JAX package's
    ``pmean`` over ``dp``)."""
    from ..parallel.draws import ShardedDraws
    from ..parallel.mesh import shard_rows

    z0 = shard_rows(mesh, z0_chains)
    samples, info = _chains(ShardedDraws(draws, mesh.rank, mesh.size, z0.shape[0]), logjoint,
                            z0, cfg, True, mesh)
    return samples, {k: mesh.all_reduce(v) / mesh.size for k, v in info.items()}
