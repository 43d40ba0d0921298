"""Parameters between the JAX package and the port.

The JAX package keeps each net's parameters as nested dicts and lists of
arrays already in torch layout (``cyclevae_tpu/models/layers.py``; the
WaveRNN vocoder's in ``cyclevae_tpu/models/wavernn.py``): GRU
``w_ih``/``w_hh`` (3H, in) with gate rows [r, z, n], dense ``w`` (out, in),
conv ``w`` (out, in, k).  So conversion is a leaf-by-leaf copy with no
transposes, and the structure (key names, list order) is the same on both
sides.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.tree import tree_map
from .vi.train import CycleVAEParams, params_to


def params_from_jax(params: Any, device=None) -> CycleVAEParams:
    """JAX ``CycleVAEParams`` (or any (encoder, decoder) pair) of numpy or
    JAX arrays -> the port's ``CycleVAEParams`` of float32 tensors on
    ``device`` (CUDA by default)."""
    encoder, decoder = params
    as_np = lambda a: np.array(a, dtype=np.float32)
    return params_to(CycleVAEParams(tree_map(as_np, encoder),
                                    tree_map(as_np, decoder)),
                     resolve_device(device))


def params_to_jax(params: CycleVAEParams) -> Tuple[dict, dict]:
    """The port's parameters -> an (encoder, decoder) pair of nested dicts
    and lists of float32 numpy arrays; ``cyclevae_tpu.vi.train.
    CycleVAEParams(*pair)`` makes the JAX container."""
    to_np = lambda t: t.detach().to("cpu").numpy().astype(np.float32)
    return tree_map(to_np, params.encoder), tree_map(to_np, params.decoder)


def wavernn_params_from_jax(params: Any, device=None) -> Dict:
    """The JAX WaveRNN's nested dict of numpy or JAX arrays -> the same dict
    of float32 tensors on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device),
                    params)


def wavernn_params_to_jax(params: Dict) -> Dict:
    """The port's WaveRNN parameters -> a nested dict of float32 numpy
    arrays, as ``cyclevae_tpu.models.wavernn`` holds them."""
    return tree_map(lambda t: t.detach().to("cpu").numpy().astype(np.float32), params)
