"""Fused autoregressive GRU forward (inference): CUDA kernel + plain version.

PyTorch counterpart of ``cyclevae_tpu/ops/pallas_gru.py:pallas_gru_ar``, with
the same contract: ``(gru_layer, out_proj, gates_x (B,T,3H), y0 (B,out),
h0 (B,H), weight_dtype) -> (trj (B,T,out), y_T, h_T)``, all float32.

``cuda_gru_ar`` runs the whole time loop in ONE launch of the hand-written
kernel ``csrc/gru_ar.cu`` (design notes there) for CUDA tensors, and the plain
version ``gru_ar_reference`` for CPU tensors.  A CUDA tensor never falls back:
the kernel launches or the call raises.  ``cuda_gru_ar.launches`` counts the
kernel launches (``launch`` adds one after each launch that succeeded).

Numerics follow the TPU kernel: ``h``, ``y`` and the new ``h`` are rounded to
the weight dtype before each product, products accumulate in float32, both
biases stay float32, the gates stream at the weight dtype, and the carried
state stays float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

_F32 = torch.float32
_WEIGHT_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _weights(gru_layer: Dict, out_proj: Dict, weight_dtype: torch.dtype):
    """(wy (3H,out), whh (3H,H), bhh, wout (out,H), bout) in torch layout:
    the matrices in ``weight_dtype``, the biases in float32."""
    out_dim = out_proj["w"].shape[0]
    conv_dim = gru_layer["w_ih"].shape[1] - out_dim
    return (gru_layer["w_ih"][:, conv_dim:].to(weight_dtype),
            gru_layer["w_hh"].to(weight_dtype),
            gru_layer["b_hh"].to(_F32),
            out_proj["w"].to(weight_dtype),
            out_proj["b"].to(_F32))


def gru_ar_reference(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor,
                     y0: torch.Tensor, h0: torch.Tensor,
                     weight_dtype: torch.dtype = _F32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, frame by frame.  Rounding an
    operand to ``weight_dtype`` and multiplying in float32 gives the kernel's
    products exactly (bf16 x bf16 is exact in float32)."""
    hidden = gru_layer["w_hh"].shape[1]
    wy, whh, bhh, wout, bout = _weights(gru_layer, out_proj, weight_dtype)
    wy, whh, wout = wy.to(_F32).T, whh.to(_F32).T, wout.to(_F32).T

    def q(a):  # an operand as the kernel feeds it to a product
        return a.to(weight_dtype).to(_F32)

    gx_all = q(gates_x)
    h, y = h0.to(_F32), y0.to(_F32)
    trj = []
    for t in range(gates_x.shape[1]):
        gx = gx_all[:, t] + q(y) @ wy
        gh = q(h) @ whh + bhh
        r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gx[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        n = torch.tanh(gx[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
        y = q(h) @ wout + bout
        trj.append(y)
    return torch.stack(trj, dim=1), y, h


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def plan(lib: ctypes.CDLL, batch: int, hidden: int, out_dim: int,
         weight_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(blocks, hidden units per block, y rows summed per pass, dynamic
    shared bytes) of one launch on the current CUDA device; raises when the
    shapes cannot run there."""
    vals = [ctypes.c_int() for _ in range(4)]
    fn = getattr(lib, f"gru_ar_plan_{_WEIGHT_DTYPES[weight_dtype]}")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    err = fn(batch, hidden, out_dim, *(ctypes.byref(v) for v in vals))
    _build.check(lib, err, f"gru_ar plan for B={batch} H={hidden} out={out_dim}")
    return tuple(v.value for v in vals)


def cuda_gru_ar(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor,
                y0: torch.Tensor, h0: torch.Tensor,
                weight_dtype: torch.dtype = _F32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused AR-GRU over a segment. Returns (trj (B,T,out), y_T, h_T), float32.

    ``weight_dtype=torch.bfloat16`` halves the weight and gate bytes at
    ~1e-2 relative output tolerance.
    """
    if gates_x.device.type == "cpu":
        return gru_ar_reference(gru_layer, out_proj, gates_x, y0, h0,
                                weight_dtype)
    return launch(_build.load("gru_ar"), gru_layer, out_proj, gates_x, y0, h0,
                  weight_dtype)


cuda_gru_ar.launches = 0


def launch(lib: ctypes.CDLL, gru_layer: Dict, out_proj: Dict,
           gates_x: torch.Tensor, y0: torch.Tensor, h0: torch.Tensor,
           weight_dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the inputs, allocate outputs and scratch, and launch the kernel
    of ``lib`` (a build of ``csrc/gru_ar.cu``) on the current stream."""
    if weight_dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be float32 or bfloat16, got {weight_dtype}")
    dev = gates_x.device
    if dev.type != "cuda":
        raise ValueError(f"the gru_ar kernel runs on CUDA tensors, got {dev}")
    B, T, threeH = gates_x.shape
    hidden = gru_layer["w_hh"].shape[1]
    out_dim = out_proj["w"].shape[0]
    if T < 1 or threeH != 3 * hidden:
        raise ValueError(f"gates_x {tuple(gates_x.shape)} does not fit H={hidden}")
    if tuple(y0.shape) != (B, out_dim) or tuple(h0.shape) != (B, hidden):
        raise ValueError(f"y0 {tuple(y0.shape)} / h0 {tuple(h0.shape)} do not "
                         f"fit B={B}, out={out_dim}, H={hidden}")
    tensors = [gates_x, y0, h0, *gru_layer.values(), *out_proj.values()]
    if any(t.device != dev for t in tensors):
        raise ValueError("the gru_ar kernel needs all tensors on one device")

    with torch.cuda.device(dev):
        wy, whh, bhh, wout, bout = (
            t.contiguous() for t in _weights(gru_layer, out_proj, weight_dtype))
        gx = gates_x.to(weight_dtype).contiguous()
        y0c = y0.to(_F32).contiguous()
        h0c = h0.to(_F32).contiguous()
        grid, units, stage_rows, smem = plan(lib, B, hidden, out_dim, weight_dtype)
        trj = torch.empty((B, T, out_dim), dtype=_F32, device=dev)
        y_last = torch.empty((B, out_dim), dtype=_F32, device=dev)
        h_last = torch.empty((B, hidden), dtype=_F32, device=dev)
        # scratch rows padded to 16 bytes for the kernel's cp.async copies
        hbuf = torch.empty((2, B, _up4(hidden)), dtype=_F32, device=dev)
        ypart = torch.empty((2, grid, _up4(B * out_dim)), dtype=_F32, device=dev)

        fn = getattr(lib, f"gru_ar_{_WEIGHT_DTYPES[weight_dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(_ptr(gx), _ptr(wy), _ptr(whh), _ptr(bhh), _ptr(wout), _ptr(bout),
                 _ptr(y0c), _ptr(h0c), _ptr(trj), _ptr(y_last), _ptr(h_last),
                 _ptr(hbuf), _ptr(ypart), B, T, hidden, out_dim, grid, units,
                 stage_rows, smem,
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _build.check(lib, err, "gru_ar launch")
    cuda_gru_ar.launches += 1
    return trj, y_last, h_last
