"""Sequential Monte Carlo over frame-sequence latents (bootstrap filter).

PyTorch counterpart of ``cyclevae_tpu/infer/smc.py``: ``smc_filter`` on one
device, ``smc_filter_sharded`` over a ``parallel.Mesh`` of processes.  The
frame-sequence latent z_{1:T} of the CycleVAE decoder is a state-space model: prior z_t ~ N(0, I), observation
x_t ~ Laplace(dec(z)_t, b) with an autoregressive decoder, so each particle
carries the decoder's recurrent state (GRU hidden h, AR feedback y).  The
particles are a batch axis: ``init``, ``propagate`` and ``log_weight`` act
on all of them at once, and the filter is a loop over time.  No kernel is on
this path: the decoder SSM steps one frame at a time with batched products
over the particles (the JAX package's ``_gru_cell`` under ``vmap``).

On one device resampling is decided on the device: every step draws its
uniform and gathers the particles through either the systematic ancestors
or the identity, so a step never waits for the host.  Both filters run one
loop (``_filter``).

Generic: ``smc_filter`` takes (init, propagate, log_weight) callables, so the
same engine runs the decoder SSM and test targets (linear-Gaussian vs Kalman).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.layers import dilconv_effective
from ..ops.gru_scan import _gru_cell
from ..utils.tree import tree_map
from ..vi.elbo import mcd_constant
from .draws import Draws

_SQRT2 = 1.4142135623730950488016887242097


class SMCConfig(NamedTuple):
    n_particles: int = 256
    ess_threshold: float = 0.5   # resample when ESS/N drops below this
    resample: str = "systematic"


def systematic_resample_indices(draws: Draws, log_w: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: N ancestors from normalized weights."""
    n = log_w.shape[0]
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    u0 = draws.uniform(()).to(log_w.device) * (1.0 / n)
    pts = u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device) / n
    # a last cumulative weight a rounding below 1 must not index past the end
    return torch.clamp(torch.searchsorted(cum, pts), max=n - 1)


def _stack(values):
    """A list over time of tensors (or dicts of tensors) -> (T, ...)."""
    if isinstance(values[0], dict):
        return {k: torch.stack([v[k] for v in values]) for k in values[0]}
    return torch.stack(values)


def smc_filter(
    draws: Draws,
    T: int,
    init: Callable[[int], Any],
    propagate: Callable[[Draws, Any, int], Any],
    log_weight: Callable[[Any, int], torch.Tensor],
    cfg: SMCConfig = SMCConfig(),
    store: Optional[Callable[[Any], Any]] = None,
) -> Tuple[Any, dict]:
    """Bootstrap particle filter over ``cfg.n_particles`` particles.

    init(n) -> particle states (a dict of tensors with leading axis n)
    propagate(draws, states, t) -> new states (one step)
    log_weight(states, t) -> (n,) incremental log-likelihood of observation t
    store(states) -> per-step values to record for SMOOTHING (e.g. the latent
    z_t); when given, info carries the genealogy: ``stored`` (T, n, ...)
    pre-resample values and ``ancestors`` (T, n) resampling indices, which
    ``trace_ancestry`` / ``smc_smoothed_trajectories`` turn into full-
    trajectory posterior draws aligned with the final weights.

    Returns (final particle states, info with log_marginal (SMC estimate of
    log p(x_{1:T})), ess (T,), resampled (T,), log_w (n,)).
    """
    return _filter(None, draws, T, init, propagate, log_weight, cfg, store)


def smc_filter_sharded(
    mesh,
    draws: Draws,
    T: int,
    init: Callable[[int], Any],
    propagate: Callable[[Draws, Any, int], Any],
    log_weight: Callable[[Any, int], torch.Tensor],
    cfg: SMCConfig = SMCConfig(),
    store: Optional[Callable[[Any], Any]] = None,
) -> Tuple[Any, dict]:
    """``smc_filter`` with the particles sharded over a ``parallel.Mesh``:
    this rank holds particles [rank*n/size, (rank+1)*n/size) and draws its
    rows of the global draws (``parallel.draws.ShardedDraws``), so the
    particles are the single-process filter's.

    Per step the log-normaliser is a ``max`` all-reduce followed by a
    ``sum`` all-reduce, the ESS a ``sum`` all-reduce, and the resampling
    decision follows from them on every rank alike.  Resampling all-gathers
    the weights and the particle states; every rank draws the one shared
    uniform, makes the global systematic ancestors and keeps its slice.  A
    step that does not resample draws its uniform all the same, as the
    single-process filter does.

    Returns (this rank's final particle states, info with log_marginal, ess
    (T,), resampled (T,) and the global log_w (n,); with ``store`` also the
    global ``stored`` (T, n, ...) and ``ancestors`` (T, n) in global
    indices, all-gathered at the end, so ``trace_ancestry`` and
    ``smc_smoothed_trajectories`` apply unchanged on every rank).
    """
    return _filter(mesh, draws, T, init, propagate, log_weight, cfg, store)


def _filter(mesh, draws, T, init, propagate, log_weight, cfg, store):
    """The filter's loop, on one device (``mesh`` None) or over a mesh.

    One device decides each step's resampling on the device (the ancestors
    are either the systematic ones or the identity, through
    ``torch.where``), so a step never waits for the host.  Over a mesh the
    decision is read on the host, so the gathers of the weights and states
    run only on a step that resamples; the uniform is drawn either way."""
    n = cfg.n_particles
    if mesh is None:
        nl, lo = n, 0
        log_normaliser = lambda lw: torch.logsumexp(lw, dim=0)
        total = torch.sum
        gather = lambda x, axis=0: x
    else:
        from ..parallel.draws import ShardedDraws

        if n % mesh.size:
            raise ValueError(f"{n} particles do not shard over {mesh.size} processes")
        nl = n // mesh.size
        lo = mesh.rank * nl
        draws = ShardedDraws(draws, mesh.rank, mesh.size, nl)
        total = lambda x: mesh.all_reduce(torch.sum(x))
        gather = mesh.all_gather

        def log_normaliser(lw):
            gmax = mesh.all_reduce(torch.max(lw), "max")
            return gmax + torch.log(total(torch.exp(lw - gmax)))

    states = init(nl)
    log_w = None
    ess_t, res_t, stored_t, anc_t = [], [], [], []
    for t in range(T):
        states = propagate(draws, states, t)
        log_inc = log_weight(states, t)
        if log_w is None:
            log_w = torch.full_like(log_inc, -math.log(n))
            ident = torch.arange(lo, lo + nl, device=log_inc.device)
        log_w = log_w + log_inc
        if store is not None:
            stored_t.append(store(states))
        # marginal-likelihood increment + ESS
        log_sum = log_normaliser(log_w)
        ess = 1.0 / total(torch.exp(log_w - log_sum) ** 2)
        resampled = ess < cfg.ess_threshold * n
        # after resampling: uniform weights carrying the average weight
        if mesh is None:
            anc = torch.where(resampled, systematic_resample_indices(draws, log_w), ident)
            states = tree_map(lambda x: x[anc], states)
            log_w = torch.where(resampled, (log_sum - math.log(n)).expand(n), log_w)
        elif bool(resampled):
            anc = systematic_resample_indices(draws, gather(log_w))[lo:lo + nl]
            states = tree_map(lambda x: gather(x)[anc], states)
            log_w = (log_sum - math.log(n)).expand(nl)
        else:
            draws.uniform(())
            anc = ident
        ess_t.append(ess)
        res_t.append(resampled)
        anc_t.append(anc)
    info = {"log_marginal": log_normaliser(log_w), "ess": torch.stack(ess_t),
            "resampled": torch.stack(res_t), "log_w": gather(log_w)}
    if store is not None:
        info["stored"] = tree_map(lambda x: gather(x, axis=1), _stack(stored_t))
        info["ancestors"] = gather(torch.stack(anc_t), axis=1)
    return states, info


def trace_ancestry(stored, ancestors: torch.Tensor):
    """Turn filter genealogy into full-trajectory draws (ancestor tracing).

    ``stored``: a tensor (or dict of tensors) with leading (T, n, ...), the
    PRE-resample per-step values; ``ancestors``: (T, n) where
    ancestors[t][j] is the pre-resample index at time t of post-resample
    particle j (identity when step t did not resample).  Returns the same
    structure (T, n, ...) where lane j is the complete time trajectory of
    FINAL particle j: weight it with softmax(final log_w).

    This is the O(T·n) genealogy smoother: exact draws from the SMC
    approximation of p(z_{1:T} | x_{1:T}) (deep ancestry collapses onto few
    lineages for T >> the resampling interval)."""
    T, n = ancestors.shape
    pick = (lambda t, idx: stored[t][idx]) if torch.is_tensor(stored) else \
        (lambda t, idx: {k: v[t][idx] for k, v in stored.items()})
    idx = torch.arange(n, device=ancestors.device)
    traj = [None] * T
    for t in range(T - 1, -1, -1):
        idx = ancestors[t][idx]
        traj[t] = pick(t, idx)
    return _stack(traj)


def smc_smoothed_trajectories(info: dict):
    """(trajectories (T, n, ...), normalized final weights (n,)) from a
    ``store=``-enabled ``smc_filter`` info dict.  The smoothed posterior mean
    at t is ``einsum('n,tn...->t...', w, traj)``."""
    return trace_ancestry(info["stored"], info["ancestors"]), torch.softmax(info["log_w"], dim=0)


# ---------------------------------------------------------------------------
# CycleVAE decoder SSM wiring
# ---------------------------------------------------------------------------

def make_decoder_ssm(params, cfg, feats: torch.Tensor, spk_code: torch.Tensor,
                     obs_scale: float = 1.0, proposal: str = "prior",
                     enc_lat: Optional[torch.Tensor] = None,
                     guide_weight: float = 1.0):
    """(init, propagate, log_weight) for SMC over the decoder's frame latents.

    Each particle's state: {z_t, gru hidden h (L, H), AR feedback y, out_t}
    (batched: a leading particle axis on each).

    proposal="prior": bootstrap filter, z_t ~ N(0, I).
    proposal="amortized": GUIDED filter, z_t drawn from a tempered version
    of the amortized encoder posterior q(z_t | x) = N(mu_t, sigma_t^2) (pass
    ``enc_lat`` = encoder output (T, 2*lat)); the weight carries the
    importance correction log N(z; 0, I) - log proposal(z).
    ``guide_weight`` w in (0, 1] tempers the guide toward the prior:
    proposal = N(w*mu_t, w*sigma_t^2 + (1-w)).  The JAX package measured the
    prior proposal as the better default over long filters (its
    ``make_decoder_ssm`` docstring); the tempered guide only for short
    fixed-lag windows.

    Conv context: the per-frame center tap of the composed conv operator
    only (a kernel context over the sampled z trajectory would make the
    state non-Markov).
    """
    dec_cfg = cfg.dec_cfg
    decoder = tree_map(lambda t: t.detach(), params.decoder)
    mcep = feats[..., cfg.stdim:]
    beta = mcd_constant() * _SQRT2 / obs_scale
    s_out = decoder["scale_out"]
    y0 = (0.0 - s_out["mean"]) / s_out["scale"]
    gru = decoder["gru"]
    out_p = decoder["out"]
    hidden = gru[0]["w_hh"].shape[1]
    n_layers = len(gru)
    lat_dim = cfg.lat_dim

    w_eff, b_eff = dilconv_effective(decoder["conv"], dec_cfg.kernel_size)
    c_in = dec_cfg.in_dim
    center = (dec_cfg.rec_field // 2) * c_in
    w_center = w_eff[center:center + c_in, :]  # (in_dim, conv_dim)

    if proposal == "amortized":
        if enc_lat is None:
            raise ValueError("the amortized proposal needs enc_lat")
        w = guide_weight
        q_mu = w * enc_lat[..., :lat_dim]
        # tempered variance: w*sigma^2 + (1-w), in log space for the draw
        q_logvar = torch.log(w * torch.exp(enc_lat[..., lat_dim:]) + (1.0 - w))
    dev = y0.device

    def init(n: int) -> Dict[str, torch.Tensor]:
        state = {
            "h": torch.zeros((n, n_layers, hidden), device=dev),
            "y": y0.expand(n, -1),
            "out": torch.zeros((n, cfg.out_dim), device=dev),
            "z": torch.zeros((n, lat_dim), device=dev),
        }
        if proposal == "amortized":
            state["log_iw"] = torch.zeros((n,), device=dev)  # correction of step t
        return state

    def propagate(draws: Draws, state: Dict[str, torch.Tensor], t: int):
        n = state["y"].shape[0]
        eps = draws.normal((n, lat_dim)).to(dev)
        new_state = {}
        if proposal == "amortized":
            z = q_mu[t] + torch.exp(0.5 * q_logvar[t]) * eps
            # log N(z; 0, I) - log q(z | x): prior / proposal correction
            log_p = -0.5 * torch.sum(z ** 2, dim=-1)
            log_q = -0.5 * torch.sum(q_logvar[t] + eps ** 2, dim=-1)
            new_state["log_iw"] = log_p - log_q
        else:
            z = eps
        x_t = torch.cat([spk_code[t].expand(n, -1), z], dim=-1)       # (n, in_dim)
        conv_t = x_t @ w_center + b_eff                               # (n, conv_dim)
        inp_gates = torch.cat([conv_t, state["y"]], dim=-1) @ gru[0]["w_ih"].T + gru[0]["b_ih"]
        new_h = []
        for l in range(n_layers):
            if l > 0:
                inp_gates = new_h[l - 1] @ gru[l]["w_ih"].T + gru[l]["b_ih"]
            new_h.append(_gru_cell(inp_gates, state["h"][:, l], gru[l]["w_hh"],
                                   gru[l]["b_hh"], hidden))
        y = new_h[-1] @ out_p["w"].T + out_p["b"]
        new_state.update(h=torch.stack(new_h, dim=1), y=y,
                         out=y * s_out["scale"] + s_out["mean"], z=z)
        return new_state

    def log_weight(state: Dict[str, torch.Tensor], t: int) -> torch.Tensor:
        lw = -beta * torch.sum(torch.abs(state["out"] - mcep[t]), dim=-1)
        if proposal == "amortized":
            lw = lw + state["log_iw"]
        return lw

    return init, propagate, log_weight
