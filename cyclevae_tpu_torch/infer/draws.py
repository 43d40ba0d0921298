"""The random numbers of the samplers.

``Draws`` draws from one ``torch.Generator`` on its device.  The samplers
call it by purpose (a momentum, an accept uniform, a tree direction, a leaf
or subtree swap uniform; SMC's propagation noise and resampling uniform are
``normal`` and ``uniform``), so a test can replay the JAX package's key
splits into them by overriding these methods (as ``models.gru_vae.Draws``
does for the training forward).
"""

from __future__ import annotations

import torch


class Draws:

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape) -> torch.Tensor:
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device)

    def uniform(self, shape) -> torch.Tensor:
        """Uniform on [0, 1)."""
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device)

    def momentum(self, shape) -> torch.Tensor:
        """HMC / NUTS: the standard-normal momentum of one transition."""
        return self.normal(shape)

    def accept(self, shape) -> torch.Tensor:
        """HMC: the uniform of each chain's accept test."""
        return self.uniform(shape)

    def direction(self, shape) -> torch.Tensor:
        """NUTS: True where a chain's next subtree grows forward (p = 0.5)."""
        return self.uniform(shape) < 0.5

    def leaf(self, shape) -> torch.Tensor:
        """NUTS: the uniform of the progressive sample at each new leaf."""
        return self.uniform(shape)

    def swap(self, shape) -> torch.Tensor:
        """NUTS: the uniform of the biased swap to a finished subtree."""
        return self.uniform(shape)
