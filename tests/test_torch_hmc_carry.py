"""The HMC sampler's carry (``infer/hmc.py``): each chain's log-joint value
and gradient are carried from the evaluation that reached its point, so a
transition makes L evaluations, a run one more.  Held bitwise on the CPU
against the sampler that recomputes them (2L + 2 evaluations a
transition), kept here as the oracle, from the same draws: the samples,
the accept probabilities of every transition, the adapted step size and
inverse mass, for each sampler built on ``_run`` and on a target that is
not finite past a bound.

The test imports no JAX (``tests/test_torch_cuda_hmc.py`` runs the same
oracle on the card)."""

from typing import Callable, Dict, Tuple

import pytest
import torch

from cyclevae_tpu_torch.infer import Draws, HMCConfig, hmc, logjoint
from cyclevae_tpu_torch.infer.dual_averaging import da_final, da_init, da_update
from cyclevae_tpu_torch.infer.logjoint import value_and_grad
from cyclevae_tpu_torch.utils.profiling import span

torch.set_num_threads(1)

MEAN = torch.tensor([1.0, -2.0, 0.5, 3.0])
COV = torch.tensor([0.5, 2.0, 1.0, 0.25])


# ---- the oracle: the sampler before the carry, verbatim but for its names ----

def _leapfrog_2l2(grad_fn, z, p, step_size, n_steps, inv_mass):
    """``n_steps`` leapfrog steps, two gradient evaluations each (as the JAX
    package's scan body)."""
    for _ in range(n_steps):
        p_half = p + 0.5 * step_size * grad_fn(z)
        z_new = z + step_size * inv_mass * p_half
        p = p_half + 0.5 * step_size * grad_fn(z_new)
        z = z_new
    return z, p


def _run_2l2(draws: Draws, logjoint_batch: Callable[[torch.Tensor], torch.Tensor],
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
        z_new, p_new = _leapfrog_2l2(grad_fn, z, p, per_chain(step_size), cfg.n_leapfrog,
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


# ---- the comparison ----

OUTPUTS = ("samples", "warm-up accept probabilities", "accept probabilities", "step size",
           "inverse mass")


def counted(fn):
    """``fn`` with a count of its calls in ``.calls``."""
    def call(z):
        call.calls += 1
        return fn(z)
    call.calls = 0
    return call


def carry_and_oracle(monkeypatch, sampler, seed, target, *args, device="cpu", meter=None,
                     **kwargs):
    """``sampler(Draws(seed), target, *args, **kwargs)`` run by the sampler
    and by the oracle from the same draws (on ``device``): each run's
    ``_run`` output, and the calls it made to ``target`` (or, given a
    ``meter`` that reads counters as a dict, how far each counter moved)."""
    runs = []
    for run in (hmc._run, _run_2l2):
        def kept(*a, run=run, **k):
            runs.append(run(*a, **k))
            return runs[-1]
        monkeypatch.setattr(hmc, "_run", kept)
        lj = counted(target)
        before = meter() if meter else None
        sampler(Draws(torch.Generator(device=device).manual_seed(seed)), lj, *args, **kwargs)
        moved = {k: v - before[k] for k, v in meter().items()} if meter else lj.calls
        runs[-1] = (runs[-1], moved)
    return runs


def assert_bitwise(carry, oracle):
    for name, got, want in zip(OUTPUTS, carry, oracle):
        assert got.shape == want.shape and torch.equal(got, want), name


def assert_counts(carry_calls, oracle_calls, cfg, per_eval=1):
    """L evaluations a transition and one a run, against the oracle's
    2L + 2 a transition; ``per_eval`` calls of the target an evaluation."""
    n = cfg.n_warmup + cfg.n_samples
    assert carry_calls == per_eval * (1 + cfg.n_leapfrog * n)
    assert oracle_calls == per_eval * (2 * cfg.n_leapfrog + 2) * n


def accepts_and_rejects(samples):
    """Per transition and chain (the first transition left out), whether the
    chain moved."""
    return torch.diff(samples, dim=0).flatten(2).ne(0).any(dim=2)


def tiny_decoder(T=10, seed=0):
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae
    cfg = CycleVAEConfig(hidden_units=16, lat_dim=4)
    params = init_cyclevae(torch.Generator().manual_seed(seed), cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    feats = torch.randn((T, 54), generator=g)
    code = torch.tensor([0.0, 1.0]).expand(T, 2)
    return cfg, params, feats, code


def test_hmc_sample_on_a_gaussian(monkeypatch):
    cfg = HMCConfig(step_size=0.7, n_leapfrog=5, n_warmup=12, n_samples=20)
    (carry, n_carry), (oracle, n_oracle) = carry_and_oracle(
        monkeypatch, hmc.hmc_sample, 3, logjoint.make_gaussian_logjoint(MEAN, COV),
        torch.zeros(4), cfg)
    assert_bitwise(carry, oracle)
    assert_counts(n_carry, n_oracle, cfg)


def test_hmc_sample_batch_on_the_decoder_log_joint(monkeypatch):
    """Windowed warm-up on the tiny decoder's batched log-joint (the kernel
    route's plain versions on the CPU), accepts and rejects both met."""
    tcfg, params, feats, code = tiny_decoder()
    lj = logjoint.make_utterance_logjoint_batched(params, tcfg, feats, code, obs_scale=50.0)
    cfg = HMCConfig(step_size=0.05, n_leapfrog=4, n_warmup=10, n_samples=12)
    z0 = 0.5 * torch.randn((3, 10, 4), generator=torch.Generator().manual_seed(2))
    (carry, n_carry), (oracle, n_oracle) = carry_and_oracle(
        monkeypatch, hmc.hmc_sample_batch, 5, lj, z0, cfg)
    assert_bitwise(carry, oracle)
    assert_counts(n_carry, n_oracle, cfg)
    moved = accepts_and_rejects(carry[0])
    assert moved.any() and not moved.all()


def test_hmc_sample_chains_with_adaptation_per_chain(monkeypatch):
    """Chains of the decoder's single-chain log-joint, one step size and
    one inverse mass a chain."""
    tcfg, params, feats, code = tiny_decoder(T=8, seed=4)
    lj = logjoint.make_utterance_logjoint(params, tcfg, feats, code, obs_scale=50.0)
    cfg = HMCConfig(step_size=0.08, n_leapfrog=3, n_warmup=8, n_samples=10)
    z0 = torch.zeros((3, 8, 4))
    (carry, n_carry), (oracle, n_oracle) = carry_and_oracle(
        monkeypatch, hmc.hmc_sample_chains, 6, lj, z0, cfg, shared_adaptation=False)
    assert_bitwise(carry, oracle)
    assert_counts(n_carry, n_oracle, cfg, per_eval=3)
    assert carry[3].shape == (3,) and carry[4].shape == z0.shape


@pytest.mark.parametrize("sampler", ["hmc_sample_batch", "hmc_sample"])
def test_a_rejected_proposal_that_is_not_finite(monkeypatch, sampler):
    """A Gaussian whose log-joint is -inf past a box: proposals that leave
    it are rejected (accept probability 0), and the chain keeps its point's
    finite value and gradient."""
    batched = sampler == "hmc_sample_batch"
    bound = 1.5

    def target(z):
        inside = z.abs().flatten(int(batched)).amax(dim=-1) < bound
        value = -0.5 * torch.sum((z - 0.5) ** 2 / 0.8, dim=-1)
        return torch.where(inside, value, torch.full_like(value, -torch.inf))

    seen = []

    def watched(z):
        v = target(z)
        seen.append(bool(torch.isinf(v).any()))
        return v

    cfg = HMCConfig(step_size=1.2, n_leapfrog=4, n_warmup=6, n_samples=24)
    z0 = torch.zeros((4, 3)) if batched else torch.zeros(3)
    (carry, _), (oracle, _) = carry_and_oracle(
        monkeypatch, getattr(hmc, sampler), 9, watched, z0, cfg)
    assert_bitwise(carry, oracle)
    assert any(seen)
    probs = torch.cat([carry[1], carry[2]])
    assert (probs == 0).any() and (probs > 0).any()
    assert torch.isfinite(carry[0]).all() and (carry[0].abs() < bound).all()
