"""No-U-Turn Sampler (multinomial, iterative) with dual-averaging warmup.

PyTorch counterpart of ``cyclevae_tpu/infer/nuts.py`` (progressive-sampling
NUTS, Hoffman & Gelman 2014; multinomial weighting + biased progressive
sampling per Betancourt 2017), with the JAX package's tree-building
algorithm: trajectory doubling is a loop over subtree leaves, one leapfrog
(one value-and-gradient evaluation) per leaf; within-subtree U-turn checks
use the trailing-zero-bit stack (even leaf j stored at slot tz(j), tz(0) :=
max_depth; completing leaf j checks every level k with (j+1) % 2^k == 0
against the stored first leaf of that sub-subtree).  Given the same draws,
the tree is the JAX package's tree.

One transition (``_transition``) runs chains in lockstep on a batch axis,
as ``infer/nuts_batch.py`` of the JAX package does: a chain whose
trajectory ended freezes while the others go on.  A single chain is the
case C = 1, and chains of a single-chain log-joint (``nuts_sample_chains``)
evaluate it once per chain; either way each chain's tree is the one it
would build alone.  ``nuts_sample_sharded`` runs the chains over a
``parallel.Mesh`` of processes.  The loops end on data (U-turns, divergences), so each
leaf reads one flag back to the host.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from .draws import Draws
from .dual_averaging import da_final, da_init, da_update
from .logjoint import value_and_grad


class NUTSConfig(NamedTuple):
    step_size: float = 0.1
    max_depth: int = 8
    n_warmup: int = 200
    n_samples: int = 500
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0


def _tz(n: int, cap: int) -> int:
    """Trailing zeros of n, capped; tz(0) -> cap."""
    if n <= 0:
        return cap
    count = 0
    while n & 1 == 0 and count < cap:
        n >>= 1
        count += 1
    return count


def _uturn(z_plus, p_plus, z_minus, p_minus) -> torch.Tensor:
    d = (z_plus - z_minus).reshape(-1)
    return torch.logical_or(torch.dot(d, p_minus.reshape(-1)) < 0,
                            torch.dot(d, p_plus.reshape(-1)) < 0)


def _transition(draws: Draws, value_and_grad_batch, z: torch.Tensor,
                step_size: torch.Tensor, inv_mass: torch.Tensor, cfg: NUTSConfig,
                mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One NUTS transition of chains z (C, ...): ``value_and_grad_batch(z)
    -> (log-joint (C,), gradient (C, ...))``; ``step_size`` of shape () or
    (C,).  With a ``mesh`` the two loop conditions (every chain done, some
    chain live) are taken over every rank's chains, one small all-reduce
    each, so all ranks make the same count of draws.  Returns (z_new, stats
    per chain)."""
    every = (lambda t: bool(t.all())) if mesh is None else mesh.all
    some = (lambda t: bool(t.any())) if mesh is None else mesh.any
    C = z.shape[0]
    max_depth = cfg.max_depth
    bshape = (C,) + (1,) * (z.ndim - 1)
    step = step_size.reshape(bshape) if step_size.ndim == 1 else step_size

    def bwhere(mask, x, y):
        return torch.where(mask.reshape(bshape), x, y)

    def bdot(a, b):
        return torch.sum((a * b).reshape(C, -1), dim=-1)

    def kinetic(p):
        return 0.5 * torch.sum((inv_mass * p ** 2).reshape(C, -1), dim=-1)

    def leapfrog(z, p, g, direction):
        eps = step * direction.reshape(bshape)
        p_half = p + 0.5 * eps * g
        z_new = z + eps * inv_mass * p_half
        logp_new, g_new = value_and_grad_batch(z_new)
        return z_new, p_half + 0.5 * eps * g_new, g_new, logp_new

    p0 = draws.momentum(z.shape) / torch.sqrt(inv_mass)
    logp0, g0 = value_and_grad_batch(z)
    h0 = -logp0 + kinetic(p0)

    false = torch.zeros((C,), dtype=torch.bool, device=z.device)
    zeros = torch.zeros((C,), device=z.device)
    # the trajectory's ends in physical-time order, the proposal and the
    # total multinomial weight, and the acceptance statistics
    z_minus, p_minus, g_minus = z, p0, g0
    z_plus, p_plus, g_plus = z, p0, g0
    z_prop, log_w_total = z, zeros
    done, diverged, sum_alpha, n_alpha, depths = false, false, zeros, zeros, zeros
    depth = 0
    while depth < max_depth and not every(done):
        active = ~done
        direction = torch.where(draws.direction((C,)), 1.0, -1.0).to(z.dtype)
        fwd = direction > 0
        # the subtree: 2^depth leapfrogs from the end it grows from
        sz, sp, sg = bwhere(fwd, z_plus, z_minus), bwhere(fwd, p_plus, p_minus), \
            bwhere(fwd, g_plus, g_minus)
        s_prop, log_w = sz, torch.full((C,), -torch.inf, device=z.device)
        turning, s_div, s_alpha, s_n = false, false, zeros, zeros
        stack_z = torch.zeros((max_depth + 1,) + tuple(z.shape), device=z.device)
        stack_p = torch.zeros_like(stack_z)
        j = 0
        while j < (1 << depth):
            live = active & ~(turning | s_div)
            if not some(live):
                break
            z_new, p_new, g_new, logp_new = leapfrog(sz, sp, sg, direction)
            # frozen chains keep their old state
            z_new, p_new, g_new = bwhere(live, z_new, sz), bwhere(live, p_new, sp), \
                bwhere(live, g_new, sg)
            log_w_leaf = torch.where(live, h0 - (-logp_new + kinetic(p_new)),
                                     torch.full_like(h0, -torch.inf))
            div_new = live & (~torch.isfinite(log_w_leaf)
                              | (log_w_leaf < -cfg.divergence_threshold))
            alpha = torch.where(live, torch.clamp(torch.exp(log_w_leaf), max=1.0), zeros)
            # progressive multinomial within the subtree
            log_w_new = torch.logaddexp(log_w, log_w_leaf)
            take = live & (draws.leaf((C,)) < torch.exp(log_w_leaf - log_w_new))
            s_prop = bwhere(take, z_new, s_prop)
            # store even leaves at slot tz(j); check odd-completing levels
            if j & 1 == 0:
                slot = _tz(j, max_depth)
                stack_z[slot], stack_p[slot] = z_new, p_new
            for k in range(1, depth + 1):
                if (j + 1) % (1 << k) == 0:
                    f = _tz(j + 1 - (1 << k), max_depth)
                    d = z_new - stack_z[f]
                    turn_k = ((direction * bdot(d, stack_p[f]) < 0)
                              | (direction * bdot(d, p_new) < 0))
                    turning = torch.where(live, turning | turn_k, turning)
            sz, sp, sg = z_new, p_new, g_new
            log_w = torch.where(live, log_w_new, log_w)
            s_div = s_div | div_new
            s_alpha, s_n = s_alpha + alpha, s_n + live.to(z.dtype)
            j += 1

        ok = active & ~(turning | s_div)
        # biased progressive sampling toward the new subtree
        accept_prob = torch.clamp(torch.exp(log_w - log_w_total), max=1.0)
        take = ok & (draws.swap((C,)) < accept_prob)
        z_prop = bwhere(take, s_prop, z_prop)
        log_w_total = torch.where(ok, torch.logaddexp(log_w_total, log_w), log_w_total)
        # extend the trajectory ends (only when the subtree was not rejected);
        # a negative-eps leapfrog traces the exact flow backward, so sp IS
        # the physical momentum at the left end
        ext_r, ext_l = ok & fwd, ok & ~fwd
        z_plus, p_plus, g_plus = bwhere(ext_r, sz, z_plus), bwhere(ext_r, sp, p_plus), \
            bwhere(ext_r, sg, g_plus)
        z_minus, p_minus, g_minus = bwhere(ext_l, sz, z_minus), bwhere(ext_l, sp, p_minus), \
            bwhere(ext_l, sg, g_minus)
        d = z_plus - z_minus
        turning_top = (bdot(d, p_minus) < 0) | (bdot(d, p_plus) < 0)
        depths = depths + active.to(z.dtype)
        done = done | turning | s_div | turning_top
        diverged = diverged | s_div
        sum_alpha, n_alpha = sum_alpha + s_alpha, n_alpha + s_n
        depth += 1
    stats = {
        "accept_stat": sum_alpha / torch.clamp(n_alpha, min=1.0),
        "depth": depths,
        "diverged": diverged,
        "n_leapfrog": n_alpha,
        # the chain hit max_depth without a U-turn/divergence ending its
        # trajectory: the transition was fixed-length HMC
        "saturated": ~done,
    }
    return z_prop, stats


def nuts_kernel(draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
                z: torch.Tensor, step_size, inv_mass: torch.Tensor, cfg: NUTSConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One NUTS transition of one chain. Returns (z_new, stats dict)."""
    vg = lambda zb: value_and_grad(lambda x: logjoint(x[0])[None], zb)
    z_new, stats = _transition(draws, vg, z[None], torch.as_tensor(step_size), inv_mass, cfg)
    return z_new[0], {k: v[0] for k, v in stats.items()}


def _sample(draws: Draws, value_and_grad_batch, z0: torch.Tensor, cfg: NUTSConfig,
            windowed: bool, shared: bool = True, mesh=None):
    """NUTS over chains z0 (C, ...) with dual-averaging step size + diagonal
    mass warmup (``windowed``: the batched sampler's two phases); with a
    ``mesh`` the shared statistics and the loop conditions span every
    rank's chains.  Returns
    (samples (n_samples, C, ...), warmup accept stats (n_warmup, C), stats
    of the samples (dict of (n_samples, C)), step size, inverse mass)."""
    C = z0.shape[0]

    def chain_mean(x):      # the mean over the chains (every rank's, gathered:
        # the single-process mean of the same values, bit for bit)
        return (x if mesh is None else mesh.all_gather(x)).mean(dim=0)

    def warmup(z, step_size, inv_mass, n):
        da = da_init(step_size, device=z.device)
        w_sum, w2_sum, accs = torch.zeros_like(z), torch.zeros_like(z), []
        for _ in range(n):
            z, stats = _transition(draws, value_and_grad_batch, z, torch.exp(da.log_step),
                                   inv_mass, cfg, mesh)
            acc = stats["accept_stat"]
            da = da_update(da, chain_mean(acc) if shared else acc, target=cfg.target_accept)
            w_sum, w2_sum = w_sum + z, w2_sum + z ** 2
            accs.append(acc)
        var = w2_sum / n - (w_sum / n) ** 2 if n else torch.zeros_like(z)
        return z, da, (chain_mean(var) if shared else var), accs

    init_step = torch.full((C,) if not shared else (), cfg.step_size, device=z0.device)
    inv_mass0 = torch.ones_like(z0[0] if shared else z0)
    if windowed:
        # phase 1 adapts the step size under the identity metric and
        # collects moments, the pooled cross-chain variance becomes the
        # diagonal inverse mass, phase 2 re-adapts the step size under it
        n1 = cfg.n_warmup // 2
        z, da, var, acc1 = warmup(z0, init_step, inv_mass0, n1)
        inv_mass = torch.clamp(var, min=1e-3)
        z, da, _, acc2 = warmup(z, da_final(da), inv_mass, cfg.n_warmup - n1)
        warm_acc = acc1 + acc2
    else:
        z, da, var, warm_acc = warmup(z0, init_step, inv_mass0, cfg.n_warmup)
        inv_mass = torch.clamp(var, min=1e-3)
    step_size = da_final(da)

    samples, stats = [], []
    for _ in range(cfg.n_samples):
        z, st = _transition(draws, value_and_grad_batch, z, step_size, inv_mass, cfg, mesh)
        samples.append(z)
        stats.append(st)
    stack = lambda xs: torch.stack(xs) if xs else torch.zeros((0, C), device=z0.device)
    per = {k: stack([s[k] for s in stats]) for k in (stats[0] if stats else ())}
    return torch.stack(samples), stack(warm_acc), per, step_size, inv_mass


def _info(warm, per, step_size, inv_mass, dim=None) -> Dict[str, torch.Tensor]:
    mean = (lambda x: x.float().mean()) if dim is None else (lambda x: x.float().mean(dim=dim))
    return {
        "accept_stat": mean(per["accept_stat"]),
        "warmup_accept_stat": mean(warm),
        "mean_depth": mean(per["depth"]),
        "divergence_rate": mean(per["diverged"]),
        "step_size": step_size,
        "inv_mass": inv_mass,
        # mean live leapfrogs per chain per transition (tree depth is
        # data-dependent; gradient evaluations per second read this)
        "mean_leapfrog": mean(per["n_leapfrog"]),
        # fraction of transitions that hit max_depth without a U-turn
        "saturation_rate": mean(per["saturated"]),
    }


def nuts_sample(draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
                z0: torch.Tensor, cfg: NUTSConfig = NUTSConfig()
                ) -> Tuple[torch.Tensor, dict]:
    """Single-chain NUTS with dual-averaging step size + diagonal mass
    warmup.  Returns (samples (n_samples, *z.shape), info)."""
    vg = lambda zb: value_and_grad(lambda x: logjoint(x[0])[None], zb)
    samples, warm, per, step, inv_mass = _sample(draws, vg, z0[None], cfg, windowed=False)
    return samples[:, 0], _info(warm, per, step, inv_mass)


def nuts_sample_chains(draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
                       z0_chains: torch.Tensor, cfg: NUTSConfig = NUTSConfig(),
                       shared_adaptation: bool = True) -> Tuple[torch.Tensor, dict]:
    """Chains of a single-chain log-joint (the JAX package vmaps
    ``nuts_sample``), each its own tree, the log-joint run once per chain.
    Returns (samples (C, n_samples, ...), the chains first as the vmap lays
    them out, and info with one value per chain)."""
    return _chains(draws, logjoint, z0_chains, cfg, shared_adaptation, None)


def _chains(draws, logjoint, z0, cfg, shared, mesh):
    C = z0.shape[0]
    vg = lambda zb: value_and_grad(
        lambda x: torch.stack([logjoint(x[c]) for c in range(C)]), zb)
    samples, warm, per, step, inv_mass = _sample(draws, vg, z0, cfg, windowed=False,
                                                 shared=shared, mesh=mesh)
    return samples.transpose(0, 1), _info(warm, per, step.expand(C), inv_mass.expand_as(z0),
                                          dim=0)


def nuts_sample_sharded(mesh, draws: Draws, logjoint: Callable[[torch.Tensor], torch.Tensor],
                        z0_chains: torch.Tensor, cfg: NUTSConfig = NUTSConfig()
                        ) -> Tuple[torch.Tensor, dict]:
    """``nuts_sample_chains`` with the chains sharded over a
    ``parallel.Mesh``, with ``infer.hmc.hmc_sample_sharded``'s scheme: the
    global start ``z0_chains``, this rank's chains on the global draws'
    rows, the adaptation statistics and both loop conditions over every
    rank's chains.  Returns (this rank's samples (C / size, n_samples,
    ...), info averaged over the ranks)."""
    from ..parallel.draws import ShardedDraws
    from ..parallel.mesh import shard_rows

    z0 = shard_rows(mesh, z0_chains)
    samples, info = _chains(ShardedDraws(draws, mesh.rank, mesh.size, z0.shape[0]), logjoint,
                            z0, cfg, True, mesh)
    return samples, {k: mesh.all_reduce(v) / mesh.size for k, v in info.items()}
