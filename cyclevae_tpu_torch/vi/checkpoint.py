"""Reading the JAX package's checkpoints without JAX.

``cyclevae_tpu/vi/checkpoint.py`` pickles ``{"params", "opt_state",
"jax_key", "np_rng_state", "epoch"}`` to ``checkpoint-<epoch>.pkl``, with
numpy leaves.  The pickle names ``cyclevae_tpu.vi.train.CycleVAEParams`` and
optax's state NamedTuples, so a plain ``pickle.load`` would import JAX.  The
unpickler here maps ``CycleVAEParams`` to the port's own class and every other
``jax`` / ``jaxlib`` / ``optax`` / ``cyclevae_tpu`` class to an inert
stand-in; only ``params`` is used by the port so far.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Any, Dict

from .train import CycleVAEParams

_FOREIGN = ("jax", "jaxlib", "optax", "cyclevae_tpu")


class Opaque(tuple):
    """Inert stand-in for a class of the JAX stack: keeps the positional
    fields a NamedTuple was pickled with, and any pickled state."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["pickled_state"] = state


@functools.lru_cache(maxsize=None)
def _opaque(module: str, name: str) -> type:
    return type(name, (Opaque,), {"__module__": module})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "cyclevae_tpu" and name == "CycleVAEParams":
            return CycleVAEParams
        if root in _FOREIGN:
            return _opaque(module, name)
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint written by the JAX package.  ``params`` comes back
    as the port's ``CycleVAEParams`` of numpy arrays (``interop`` turns it
    into tensors); ``opt_state`` holds inert stand-ins.  Unpickle only files
    this project wrote: unpickling can run code."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def latest_checkpoint(checkpoint_dir: str) -> str:
    """Path of the newest checkpoint: ``checkpoint-latest.pkl`` if the
    trainer maintains one, else the highest-numbered ``checkpoint-<N>.pkl``."""
    rolling = os.path.join(checkpoint_dir, "checkpoint-latest.pkl")
    if os.path.exists(rolling):
        return rolling
    epochs = [int(f[len("checkpoint-"):-len(".pkl")])
              for f in os.listdir(checkpoint_dir)
              if f.startswith("checkpoint-") and f.endswith(".pkl")
              and f[len("checkpoint-"):-len(".pkl")].isdigit()]
    if not epochs:
        raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    return os.path.join(checkpoint_dir, f"checkpoint-{max(epochs)}.pkl")
