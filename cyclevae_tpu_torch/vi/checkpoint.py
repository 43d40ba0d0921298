"""Checkpoints: the port's own, and reading the JAX package's without JAX.

The port pickles ``{"params", "opt_state", "rng_state", "np_rng_state",
"epoch"}`` to ``checkpoint-<epoch>.pkl`` (``save_checkpoint``), all numpy:
the parameters, the optimizer's ``state_dict``, the ``torch.Generator``'s
state and the numpy Generator's, as ``cyclevae_tpu/vi/checkpoint.py`` does
with the JAX key in place of the generator (reference train…py:152-167:
resume reproduces the training trajectory).  ``restore_train_state`` turns
one back into a ``TrainState``.

The JAX package's pickles name ``cyclevae_tpu.vi.train.CycleVAEParams`` and
optax's state NamedTuples, so a plain ``pickle.load`` would import JAX.  The
unpickler here maps ``CycleVAEParams`` to the port's own class and every other
``jax`` / ``jaxlib`` / ``optax`` / ``cyclevae_tpu`` class to an inert
stand-in; of those, only ``params`` is used by the port so far.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .train import CycleVAEParams, Optimizer, TrainState, params_to

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


def _to_numpy(tree):
    if isinstance(tree, CycleVAEParams):
        return CycleVAEParams(*(_to_numpy(net) for net in tree))
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def to_torch(tree):
    """numpy leaves -> CPU tensors (copies), structure kept."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def save_checkpoint(checkpoint_dir: str, params: Union[CycleVAEParams, Dict],
                    opt_state: torch.optim.Optimizer, generator: torch.Generator,
                    np_rng: np.random.Generator, epoch: int,
                    name: Optional[str] = None) -> str:
    """Pickle a training state with numpy leaves to
    ``checkpoint_dir/checkpoint-<epoch>.pkl`` (or ``name``), atomically.
    ``params`` is a CycleVAE's ``CycleVAEParams`` or a WaveRNN's nested dict
    (``pipeline.vocoder_stage.run_train_vocoder``); either comes back with
    its structure and numpy leaves.  A
    rolling ``checkpoint-latest.pkl`` is overwritten in place every epoch,
    and a crash mid-write must not corrupt the resume point."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    ckpt = {
        "params": _to_numpy(params),
        "opt_state": _to_numpy(opt_state.state_dict()),
        "rng_state": generator.get_state().numpy(),
        "np_rng_state": np_rng.bit_generator.state,
        "epoch": epoch,
    }
    path = os.path.join(checkpoint_dir, name or f"checkpoint-{epoch}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ckpt, f)
    os.replace(tmp, path)
    return path


def restore_train_state(ckpt: Dict[str, Any], optimizer: Optimizer,
                        device=None) -> TrainState:
    """A ``TrainState`` from one of the port's checkpoints: the parameters on
    ``device`` (CUDA unless ``device="cpu"``), a fresh optimizer of ``optimizer`` loaded with the saved
    state, and a generator on ``device`` with the saved state."""
    device = resolve_device(device)
    params = params_to(CycleVAEParams(*(to_torch(net) for net in ckpt["params"])), device)
    opt = optimizer.init(params)
    opt.load_state_dict(to_torch(ckpt["opt_state"]))
    generator = torch.Generator(device=device)
    generator.set_state(torch.from_numpy(np.asarray(ckpt["rng_state"], dtype=np.uint8)))
    return TrainState(params, opt, generator, 0)


def restore_np_rng(state) -> np.random.Generator:
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng
