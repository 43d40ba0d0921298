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
stand-in that keeps its class name and fields.  ``restore_train_state``
takes either package's checkpoint: from a JAX one, ``opt_state_from_jax``
turns optax's Adam state into a ``torch.optim`` state dict, and the
generator is seeded from the JAX key (see there).
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .train import _FROZEN, CycleVAEParams, Optimizer, TrainState, params_to

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


def _find_adam(state, found: List) -> List:
    """Every optax ``ScaleByAdamState`` stand-in under ``state``: under
    ``multi_transform``'s ``PartitionState`` (optax >= 0.2.4; its older name
    ``MultiTransformState``), a ``MaskedState`` and the chain's tuple, where
    adamw's chain holds more states beside it."""
    if type(state).__name__ == "ScaleByAdamState":
        found.append(state)
    elif isinstance(state, dict):
        for v in state.values():
            _find_adam(v, found)
    elif isinstance(state, (list, tuple)):
        for v in state:
            _find_adam(v, found)
    return found


def _trainable_paths(params) -> List[tuple]:
    """(net index, key path) of each trainable leaf, in the order of
    ``vi.train.trainable_leaves``."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in walk(v, path + (k,))]
        if isinstance(tree, (list, tuple)):
            return [p for i, v in enumerate(tree) for p in walk(v, path + (i,))]
        return [path]
    return [(n,) + p for n, net in enumerate(params) for k, v in net.items()
            if k not in _FROZEN for p in walk(v, (k,))]


def opt_state_from_jax(opt_state, params: CycleVAEParams, optimizer: Optimizer) -> Dict:
    """optax's Adam state from a JAX checkpoint (``vi/train.py``'s
    ``multi_transform`` of ``adam`` or ``adamw`` on the trainable leaves and
    ``set_to_zero`` on the scalers) as the ``state_dict`` of ``optimizer``
    over ``trainable_leaves(params)``: per leaf ``exp_avg`` = ``mu``,
    ``exp_avg_sq`` = ``nu``, ``step`` = ``count`` as a float32 tensor, taken
    by key path (JAX flattens dicts in sorted key order, the port in
    insertion order); the param groups are ``optimizer``'s own."""
    found = _find_adam(opt_state, [])
    if len(found) != 1:
        raise ValueError(f"expected one optax ScaleByAdamState in the checkpoint, found {len(found)}")
    count, mu, nu = found[0]
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return torch.from_numpy(np.array(tree, dtype=np.float32))

    state = {i: {"step": step.clone(), "exp_avg": at(mu, path), "exp_avg_sq": at(nu, path)}
             for i, path in enumerate(_trainable_paths(params))}
    groups = optimizer.init(params).state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}


def jax_key_seed(key) -> int:
    """A ``torch.Generator`` seed from a raw JAX PRNG key's two uint32 words
    (high word first)."""
    hi, lo = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(-1)[-2:])
    return (hi << 32) | lo


def restore_train_state(ckpt: Dict[str, Any], optimizer: Optimizer,
                        device=None) -> TrainState:
    """A ``TrainState`` from a checkpoint of either package: the parameters
    on ``device`` (CUDA unless ``device="cpu"``), a fresh optimizer of
    ``optimizer`` loaded with the saved Adam state, and a generator on
    ``device``.  The port's checkpoint restores the generator's state; a
    JAX one (``jax_key`` in place of ``rng_state``) cannot, since no JAX key
    becomes a ``torch.Generator`` stream: the generator is seeded from the
    key's two words (``jax_key_seed``), deterministically, so a resumed run
    repeats itself but draws other numbers than the JAX run would.  The
    numpy generator (``np_rng_state``: the epoch shuffles) restores exactly
    from either, through ``restore_np_rng``."""
    device = resolve_device(device)
    params = params_to(CycleVAEParams(*(to_torch(net) for net in ckpt["params"])), device)
    opt = optimizer.init(params)
    generator = torch.Generator(device=device)
    if "jax_key" in ckpt:
        opt.load_state_dict(opt_state_from_jax(ckpt["opt_state"], params, optimizer))
        generator.manual_seed(jax_key_seed(ckpt["jax_key"]))
    else:
        opt.load_state_dict(to_torch(ckpt["opt_state"]))
        generator.set_state(torch.from_numpy(np.asarray(ckpt["rng_state"], dtype=np.uint8)))
    return TrainState(params, opt, generator, 0)


def restore_np_rng(state) -> np.random.Generator:
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng
