"""Parallel WaveGAN's gated residual layer: CUDA kernel + plain version.

``cuda_pwg_layer(x, c, skip, w1, b1, w2, b2, dilation) -> (x', skip')`` runs
one layer of the generator (``models/pwg.py``) on the residual stream x
(B, R, n), the upsampled conditioning c (B, A, n) and the skip sum (B, S, n),
None before the first layer, with the layer's two products packed by
``models.pwg.pack_layers``: one launch of the hand-written kernel
``csrc/pwg.cu`` (design notes there) for CUDA tensors, its plain version
``pwg_layer_reference`` for CPU tensors.  A CUDA tensor never falls back:
the kernel launches or the call raises.  The kernel replaces no TPU kernel
(the JAX package has no PWG); it takes the published widths, R = S = 64 and
G = 128, kernel 3.

The layer, in the packed layout: X (B, Kp, n) stacks the taps x[t - d],
x[t], x[t + d] (zero outside [0, n)), then c, then zeros up to Kp;
  a  = w1^T X + b1                        (G channels)
  g  = tanh(a[:G/2]) * sigmoid(a[G/2:])
  o  = w2^T g + b2                        (R + S channels)
  x' = (x + o[:R]) * sqrt(1/2),  skip' = skip + o[R:]  (o[R:] at the first)
The kernel keeps this order: each sum over k in order, its bias added last.

The wrapper's ``launches`` counts the kernel's launches; each also counts
``pwg.layer_launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .cuda_gru import _entry, _ptr, _stream
from ..utils.profiling import count

_F32 = torch.float32
K_CHUNK = 16          # w1's rows are padded to a multiple of the kernel's K chunk
WIDTHS = (64, 128, 64)   # R, G, S the kernel is built for
TAPS = 3


def _taps(x: torch.Tensor, dilation: int) -> torch.Tensor:
    """x (B, R, n) -> (B, 3R, n): x[t - d], x[t], x[t + d], zero outside."""
    n = x.shape[2]
    xp = torch.nn.functional.pad(x, (dilation, dilation))
    return torch.cat([xp[:, :, j * dilation:j * dilation + n] for j in range(TAPS)], dim=1)


def pwg_layer_reference(x: torch.Tensor, c: torch.Tensor, skip: Optional[torch.Tensor],
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the layer kernel (float32 products)."""
    R, Kp = x.shape[1], w1.shape[0]
    X = torch.cat([_taps(x, dilation), c], dim=1)
    X = torch.nn.functional.pad(X, (0, 0, 0, Kp - X.shape[1]))
    a = torch.matmul(w1.t(), X) + b1[:, None]
    half = a.shape[1] // 2
    g = torch.tanh(a[:, :half]) * torch.sigmoid(a[:, half:])
    o = torch.matmul(w2.t(), g) + b2[:, None]
    x_new = (x + o[:, :R]) * math.sqrt(0.5)
    return x_new, (o[:, R:] if skip is None else skip + o[:, R:])


def cuda_pwg_layer(x: torch.Tensor, c: torch.Tensor, skip: Optional[torch.Tensor],
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gated residual layer: the kernel for CUDA tensors (one launch;
    ``skip`` is updated in place and returned), the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return pwg_layer_reference(x, c, skip, w1, b1, w2, b2, dilation)
    return launch(_build.load("pwg"), x, c, skip, w1, b1, w2, b2, dilation)


cuda_pwg_layer.launches = 0


def launch(lib: ctypes.CDLL, x: torch.Tensor, c: torch.Tensor, skip: Optional[torch.Tensor],
           w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs, allocate x' (and skip' at the first layer), and
    launch the kernel of ``lib`` (a build of ``csrc/pwg.cu``) once on the
    current stream."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the pwg layer kernel runs on CUDA tensors, got {dev}")
    R, G, S = WIDTHS
    if x.dim() != 3 or x.shape[1] != R or x.shape[2] < 1:
        raise ValueError(f"x {tuple(x.shape)} is not (B, {R}, n >= 1)")
    B, _, n = x.shape
    A = c.shape[1]
    Kp = w1.shape[0]
    want = {"c": (c, (B, A, n)), "w1": (w1, (Kp, G)), "b1": (b1, (G,)),
            "w2": (w2, (G // 2, R + S)), "b2": (b2, (R + S,))}
    if skip is not None:
        want["skip"] = (skip, (B, S, n))
    if Kp % K_CHUNK or not TAPS * R + A <= Kp:
        raise ValueError(f"w1 has {Kp} rows: not a multiple of {K_CHUNK} holding "
                         f"{TAPS} x {R} taps and {A} conditioning channels")
    for name, (t, shape) in {"x": (x, (B, R, n)), **want}.items():
        if tuple(t.shape) != shape or t.dtype != _F32 or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} is not a contiguous "
                             f"float32 {shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dilation < 1:
        raise ValueError(f"dilation {dilation} < 1")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("w1 and w2 must start on 16 bytes: the kernel reads them as float4")

    with torch.cuda.device(dev):
        x_new = torch.empty_like(x)
        first = skip is None
        if first:
            skip = torch.empty((B, S, n), dtype=_F32, device=dev)
        ptrs = (x, x_new, skip, c, w1, b1, w2, b2)
        ints = (B, n, A, Kp, dilation, int(first))
        fn = _entry(lib, "pwg_layer_f32", [ctypes.c_void_p] * len(ptrs)
                    + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        err = fn(*(_ptr(t) for t in ptrs), *ints, _stream(dev))
        _build.check(lib, err, "pwg layer launch")
    _build.count_launch(cuda_pwg_layer)
    count("pwg.layer_launches")
    return x_new, skip
