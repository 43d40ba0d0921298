"""Plain reference of one Hamiltonian Monte Carlo transition over a
CycleVAE utterance's latent trajectory (the recipe's posterior inference).

Target: log p(x, z) = -beta * sum_t,d |mcep_td - dec(z)_td| - 0.5 sum z^2,
beta = (10 / ln 10) sqrt(2) / obs_scale (the training L1-MCD as a Laplace
likelihood), dec the frozen decoder with the source speaker's code, chains
on the batch axis.  A transition with step size eps, diagonal inverse mass
M^-1 and L leapfrog steps: p = p0 / sqrt(M^-1); L steps of p += eps/2 grad,
z += eps M^-1 p, p += eps/2 grad (each gradient used twice, as the
integrator defines it); H = -log p(x, z) + 1/2 sum M^-1 p^2 per chain;
accept the end point where u < exp(min(H0 - H1, 0))."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .cyclevae import MCD_L1, Model, dec_y0, net_apply


class LogJoint:
    """Value and gradient of the log-joint of one utterance, per chain."""

    def __init__(self, p: Dict, m: Model, feats: torch.Tensor, code: torch.Tensor,
                 obs_scale: float):
        self.p, self.m = p, m
        self.mcep = feats[:, m.stdim:]
        self.code = code
        self.beta = MCD_L1 / obs_scale

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dec, m = self.p["decoder"], self.m
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            C, T, _ = z.shape
            x = torch.cat([self.code.expand(C, T, -1), z], -1)
            out, _, _ = net_apply(dec, m, x, dec_y0(dec, C),
                                  torch.zeros((C, m.hidden_units), device=z.device), False)
            v = (-self.beta * torch.sum(torch.abs(out - self.mcep), dim=(1, 2))
                 - 0.5 * torch.sum(z ** 2, dim=(1, 2)))
            (g,) = torch.autograd.grad(v.sum(), z)
        return v.detach(), g


def transition(vg: LogJoint, z: torch.Tensor, p0: torch.Tensor, eps: float,
               inv_mass: torch.Tensor, L: int):
    """One transition's proposal: (end point, H0, H1 per chain)."""
    p = p0 / torch.sqrt(inv_mass)
    kinetic = lambda q: 0.5 * torch.sum(inv_mass * q ** 2, dim=(1, 2))
    v0, g = vg(z)
    h0 = -v0 + kinetic(p)
    zc = z
    for _ in range(L):
        p = p + 0.5 * eps * g
        zc = zc + eps * inv_mass * p
        v, g = vg(zc)
        p = p + 0.5 * eps * g
    h1 = -v + kinetic(p)
    return zc, h0, h1

