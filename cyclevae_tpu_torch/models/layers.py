"""Building blocks: two-sided dilated conv (as one window matmul) and GRU params.

PyTorch counterpart of ``cyclevae_tpu/models/layers.py``. The reference stacks
non-causal dilated Conv1d layers with no nonlinearity in between, so the stack
is one linear map from a ``kernel**layers``-frame window to the output
channels: the composed weight is built once and the context embedding is one
matmul (B*T, rec*C_in) @ (rec*C_in, C_out).

Parameters are plain dicts of tensors in torch layout: GRU ``w_ih``/``w_hh``
(3H, in) with gate rows [r, z, n], dense ``w`` (out, in), conv ``w``
(out, in, k) — the same arrays the JAX package holds.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def xavier_uniform(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ semantics: U(-a, a), a = sqrt(6/(fan_in+fan_out)).

    For 2-D (out, in): fan_in = in, fan_out = out.  For conv (out, in, k):
    fan_in = in*k, fan_out = out*k.  Drawn on ``generator``'s device.
    """
    if len(shape) == 2:
        fan_in, fan_out = shape[1], shape[0]
    elif len(shape) == 3:
        receptive = shape[2]
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    else:
        raise ValueError(f"unsupported shape {shape}")
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=dtype, device=generator.device)
    return w.uniform_(-a, a, generator=generator)


# ---------------------------------------------------------------------------
# Two-sided dilated convolution stack
# ---------------------------------------------------------------------------

def init_dilconv(generator: torch.Generator, in_dim: int, kernel_size: int = 3,
                 layers: int = 2) -> Dict:
    """Init the dilated conv stack: layer i maps in_dim*k^i -> in_dim*k^(i+1),
    dilation k^i; zero bias."""
    params = {"w": [], "b": []}
    for i in range(layers):
        c_in = in_dim * (kernel_size ** i)
        c_out = in_dim * (kernel_size ** (i + 1))
        params["w"].append(xavier_uniform(generator, (c_out, c_in, kernel_size)))
        params["b"].append(torch.zeros((c_out,), device=generator.device))
    return params


def dilconv_effective(params: Dict, kernel_size: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose the linear conv stack into one (rec*C_in, C_out) weight + bias.

    Layer l has taps at offsets ``o * kernel_size**l`` for o in [0, k).  The
    composed operator has taps covering a window of ``rec = k**L`` frames.
    ``window.reshape(rec*C_in) @ w_eff + b_eff`` equals the stacked
    convolution output at that frame.  The taps compose in the params' dtype;
    ``w_eff`` is float32 (as the JAX version's ``jnp.zeros`` is), the bias keeps
    the params' dtype.
    """
    layers = len(params["w"])
    w0 = params["w"][0]
    taps = {o: w0[:, :, o] for o in range(w0.shape[2])}
    bias = params["b"][0]
    for l in range(1, layers):
        wl, bl = params["w"][l], params["b"][l]
        dil = kernel_size ** l
        new_taps: Dict[int, torch.Tensor] = {}
        for o_l in range(wl.shape[2]):
            w_piece = wl[:, :, o_l]
            for off, mat in taps.items():
                key_off = off + o_l * dil
                contrib = w_piece @ mat
                new_taps[key_off] = (new_taps[key_off] + contrib
                                     if key_off in new_taps else contrib)
        # each output tap position sees the (constant) bias of the previous
        # layer through every kernel tap, plus its own bias
        bias = sum(wl[:, :, o] @ bias for o in range(wl.shape[2])) + bl
        taps = new_taps
    rec = kernel_size ** layers
    c_in = params["w"][0].shape[1]
    c_out = params["w"][-1].shape[0]
    w_eff = torch.zeros((rec, c_in, c_out), device=w0.device)
    for off, mat in taps.items():
        w_eff[off] = mat.T
    return w_eff.reshape(rec * c_in, c_out), bias


def window_gather(x: torch.Tensor, rec: int) -> torch.Tensor:
    """(B, T, C) -> (B, T, rec*C): concat frames [t-pad, t+pad] with zero padding.

    ``rec`` must be odd (even receptive fields change the output length in the
    reference's padding scheme and are not supported).
    """
    if rec % 2 != 1:
        raise ValueError("receptive field must be odd (use an odd kernel size)")
    pad = (rec - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    T = x.shape[1]
    cols = [xp[:, o: o + T, :] for o in range(rec)]
    return torch.cat(cols, dim=-1)


def dilconv_apply(params: Dict, x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Apply the composed conv stack: one window-gather + one matmul.

    x: (B, T, C_in) -> (B, T, C_out) with C_out = C_in * k**layers.
    """
    w_eff, b_eff = dilconv_effective(params, kernel_size)
    rec = kernel_size ** len(params["w"])
    return window_gather(x, rec) @ w_eff + b_eff


# ---------------------------------------------------------------------------
# GRU stack + dense
# ---------------------------------------------------------------------------

def init_gru_stack(generator: torch.Generator, input_dim: int, hidden_units: int,
                   n_layers: int = 1) -> List[Dict]:
    """torch-layout GRU params per layer: w_ih (3H, in), w_hh (3H, H), b_ih, b_hh.

    Gate row order [r, z, n]. Weights xavier-uniform over the full stacked
    matrix, biases zero.
    """
    dev = generator.device
    layers = []
    for l in range(n_layers):
        in_l = input_dim if l == 0 else hidden_units
        layers.append({
            "w_ih": xavier_uniform(generator, (3 * hidden_units, in_l)),
            "w_hh": xavier_uniform(generator, (3 * hidden_units, hidden_units)),
            "b_ih": torch.zeros((3 * hidden_units,), device=dev),
            "b_hh": torch.zeros((3 * hidden_units,), device=dev),
        })
    return layers


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int) -> Dict:
    """1x1-conv projection as a dense layer (reference out_1)."""
    return {"w": xavier_uniform(generator, (out_dim, in_dim)),
            "b": torch.zeros((out_dim,), device=generator.device)}
