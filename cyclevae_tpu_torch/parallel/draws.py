"""Draws at their global shape, this rank's rows kept.

Every draw of the port has the batch, chain or particle axis first (the
training forward's input noise, dropout masks and posterior noise; the
samplers' momenta, uniforms and propagation noise), and every rank holds the
same generator state.  ``ShardedDraws`` wraps either ``Draws`` class
(``models.gru_vae.Draws``, ``infer.draws.Draws``): where a caller on this
rank asks for ``(k*b, ...)`` with ``b`` its rows, it asks the wrapped draws
for ``(k*b*size, ...)``, views that as ``(k, b*size, ...)`` and keeps block
``rank`` of the second axis.  So the fused decoder's ``[src rows; trg rows]``
(k = 2) keeps this rank's source rows and its target rows, every rank draws
the same count of numbers, and the sharded run sees the single-process
run's numbers.  A scalar draw (SMC's resampling uniform) is kept whole.
"""

from __future__ import annotations

from typing import Tuple


class ShardedDraws:
    """``draws`` (a ``Draws``, or a subclass that replays recorded numbers)
    seen from ``rank`` of ``size`` ranks holding ``rows`` rows each."""

    def __init__(self, draws, rank: int, size: int, rows: int):
        self.draws, self.rank, self.size, self.rows = draws, rank, size, rows
        self.generator = getattr(draws, "generator", None)

    def _draw(self, name: str, shape, *args, shape_at: int = 0):
        shape = tuple(shape)
        if not shape:
            return self._call(name, shape, args, shape_at)
        k, rem = divmod(shape[0], self.rows)
        if rem or not k:
            raise ValueError(f"a draw of {shape} on a rank of {self.rows} rows: its first "
                             "axis must be a multiple of the rows")
        full = self._call(name, (k * self.rows * self.size,) + shape[1:], args, shape_at)
        b = self.rows
        blocks = full.reshape((k, b * self.size) + shape[1:])
        return blocks[:, self.rank * b:(self.rank + 1) * b].reshape(shape)

    def _call(self, name: str, shape: Tuple, args, shape_at: int):
        args = list(args)
        args.insert(shape_at, shape)
        return getattr(self.draws, name)(*args)

    # models.gru_vae.Draws
    def bernoulli(self, keep: float, shape):
        return self._draw("bernoulli", shape, keep, shape_at=1)

    def eps(self, shape, laplace: bool):
        return self._draw("eps", shape, laplace)

    # both
    def normal(self, shape):
        return self._draw("normal", shape)

    # infer.draws.Draws
    def uniform(self, shape):
        return self._draw("uniform", shape)

    def momentum(self, shape):
        return self._draw("momentum", shape)

    def accept(self, shape):
        return self._draw("accept", shape)

    def direction(self, shape):
        return self._draw("direction", shape)

    def leaf(self, shape):
        return self._draw("leaf", shape)

    def swap(self, shape):
        return self._draw("swap", shape)
