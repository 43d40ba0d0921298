"""Fused autoregressive GRU, forward and backward: CUDA kernels + plain versions.

PyTorch counterparts of ``cyclevae_tpu/ops/pallas_gru.py``, with the same
contracts:

* ``cuda_gru_ar`` (K1, ``pallas_gru_ar``): ``(gru_layer, out_proj, gates_x
  (B,T,3H), y0 (B,out), h0 (B,H), weight_dtype) -> (trj (B,T,out), y_T,
  h_T)``, all float32;
* ``cuda_gru_ar_train`` (K2, ``pallas_gru_ar_train``): K1 plus an
  inverted-dropout ``out_mask`` (B,T,H) on the GRU output before the output
  projection, and ``h_seq`` (B,T,H) at the weight dtype, the backward's
  residual;
* ``cuda_gru_ar_bwd`` (K3, ``pallas_gru_ar_bwd``): the reverse-time
  cotangent scan, recomputing each step's gates from the streamed residuals.

Each runs a hand-written kernel (``csrc/gru_ar.cu`` for K1 and K2,
``csrc/gru_ar_bwd.cu`` for K3; design notes there) for CUDA tensors, and its
plain version (``gru_ar_reference``, ``gru_ar_train_reference``,
``gru_ar_bwd_reference``) for CPU tensors.  A CUDA tensor never falls back:
the kernel launches or the call raises.

Every block of a kernel holds all B rows of h in shared memory, so a plan
exists up to a largest B (``max_batch``: at H = 1024 on an H100, K1 and K2
46 rows in float32 and 82 in bf16, K3 51 and 148).  A larger batch runs in
row blocks: the rows of a GRU batch are independent, so the wrapper slices
every per-row input into consecutive blocks of at most ``max_batch`` rows,
launches the same kernel once per block and concatenates the outputs along
B.  A batch within the limit is one launch.  Each wrapper's ``launches``
counts kernel launches, not calls: one per row block (added to after each
launch that succeeded, under a lock: ``_build.count_launch``).

Numerics follow the TPU kernels: every operand of a product is rounded to
the weight dtype where the TPU kernel casts it, products accumulate in
float32, biases stay float32, the streams (gates, mask, residuals, gate
cotangents) ride at the weight dtype, and the carried states stay float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

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


def _q(a: torch.Tensor, weight_dtype: torch.dtype) -> torch.Tensor:
    """An operand as the kernels feed it to a product: rounded to the weight
    dtype, as float32.  Multiplying two such values in float32 gives the
    kernels' products exactly (bf16 x bf16 is exact in float32)."""
    return a.to(weight_dtype).to(_F32)


def _forward_reference(gru_layer, out_proj, gates_x, y0, h0, out_mask, weight_dtype):
    hidden = gru_layer["w_hh"].shape[1]
    wy, whh, bhh, wout, bout = _weights(gru_layer, out_proj, weight_dtype)
    wy, whh, wout = wy.to(_F32).T, whh.to(_F32).T, wout.to(_F32).T
    q = lambda a: _q(a, weight_dtype)

    gx_all = q(gates_x)
    mask = None if out_mask is None else q(out_mask)
    h, y = h0.to(_F32), y0.to(_F32)
    trj, h_seq = [], []
    for t in range(gates_x.shape[1]):
        gx = gx_all[:, t] + q(y) @ wy
        gh = q(h) @ whh + bhh
        r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gx[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        n = torch.tanh(gx[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
        y = q(h if mask is None else h * mask[:, t]) @ wout + bout
        trj.append(y)
        h_seq.append(h.to(weight_dtype))
    return torch.stack(trj, dim=1), y, h, torch.stack(h_seq, dim=1)


def gru_ar_reference(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor,
                     y0: torch.Tensor, h0: torch.Tensor,
                     weight_dtype: torch.dtype = _F32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, frame by frame; rounds where the kernel
    does (``_q``)."""
    return _forward_reference(gru_layer, out_proj, gates_x, y0, h0, None,
                              weight_dtype)[:3]


def gru_ar_train_reference(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor,
                           y0: torch.Tensor, h0: torch.Tensor, out_mask: torch.Tensor,
                           weight_dtype: torch.dtype = _F32
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (``pallas_gru.py:_kernel_train``): the mask
    streams at the weight dtype, ``o = h' * mask`` rounds to it before Wout,
    ``h_seq`` is stored at it; the carried ``h`` stays unmasked float32."""
    return _forward_reference(gru_layer, out_proj, gates_x, y0, h0, out_mask,
                              weight_dtype)


def gru_ar_bwd_reference(wout: torch.Tensor, whh: torch.Tensor, wy: torch.Tensor,
                         bhh: torch.Tensor, d_trj: torch.Tensor, gates_x: torch.Tensor,
                         y_prev: torch.Tensor, h_prev: torch.Tensor, out_mask: torch.Tensor,
                         d_hT: torch.Tensor, d_yT: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K3 (``pallas_gru.py:_kernel_bwd``), step by
    step in reverse time: recompute the gates from the residuals, then the
    cotangent algebra.  The weight dtype is ``whh.dtype``; returns (dgx, dgh
    (B,T,3H) at it, dy_tot (B,T,out), dh0 (B,H), dy0 (B,out) float32)."""
    wdt = whh.dtype
    hidden = whh.shape[1]
    q = lambda a: _q(a, wdt)
    wy_f, whh_f, wout_f = q(wy), q(whh), q(wout)
    bhh_f = bhh.to(_F32)
    gx_all, yp, hp, mask = q(gates_x), q(y_prev), q(h_prev), q(out_mask)
    dh, dy = d_hT.to(_F32), d_yT.to(_F32)
    dgx_seq, dgh_seq, dy_seq = [], [], []
    for t in reversed(range(gates_x.shape[1])):
        gx = gx_all[:, t] + yp[:, t] @ wy_f.T
        gh = hp[:, t] @ whh_f.T + bhh_f
        r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gx[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        ghn = gh[:, 2 * hidden:]
        n = torch.tanh(gx[:, 2 * hidden:] + r * ghn)
        dy_tot = d_trj[:, t].to(_F32) + dy
        dh_tot = dh + (q(dy_tot) @ wout_f) * mask[:, t]
        dz = dh_tot * (hp[:, t] - n)
        dn = dh_tot * (1.0 - z)
        dgn = dn * (1.0 - n * n)
        dr = dgn * ghn
        dghn = dgn * r
        dgr = dr * r * (1.0 - r)
        dgz = dz * z * (1.0 - z)
        dgx_t = torch.cat([dgr, dgz, dgn], dim=-1)
        dgh_t = torch.cat([dgr, dgz, dghn], dim=-1)
        dh = dh_tot * z + q(dgh_t) @ whh_f
        dy = q(dgx_t) @ wy_f
        dgx_seq.append(dgx_t.to(wdt))
        dgh_seq.append(dgh_t.to(wdt))
        dy_seq.append(dy_tot)
    rev = lambda seq: torch.stack(seq[::-1], dim=1)
    return rev(dgx_seq), rev(dgh_seq), rev(dy_seq), dh, dy


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _entry(lib: ctypes.CDLL, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``lib``, its argument types set once."""
    key = (id(lib), name)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


_ENTRIES: Dict[Tuple[int, str], ctypes._CFuncPtr] = {}


class RowsDoNotFit(RuntimeError):
    """A plan's answer that B rows of h do not fit in one block's shared
    memory (``cudaErrorInvalidConfiguration``, ``csrc/gru_ar.cu`` and
    ``csrc/gru_ar_bwd.cu`` at the end of their plans)."""


_ROWS_DO_NOT_FIT = 9    # cudaErrorInvalidConfiguration


def _plan(lib: ctypes.CDLL, entry: str, n_out: int, batch: int, hidden: int,
          out_dim: int, weight_dtype: torch.dtype) -> Tuple[int, ...]:
    vals = [ctypes.c_int() for _ in range(n_out)]
    fn = _entry(lib, f"{entry}_{_WEIGHT_DTYPES[weight_dtype]}",
                [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * n_out)
    err = fn(batch, hidden, out_dim, *(ctypes.byref(v) for v in vals))
    what = f"{entry} for B={batch} H={hidden} out={out_dim}"
    if err == _ROWS_DO_NOT_FIT:
        raise RowsDoNotFit(f"{what}: the rows do not fit in one block's shared memory")
    _build.check(lib, err, what)
    return tuple(v.value for v in vals)


# plans already made, per (library, entry, device index, B, H, out, weight
# dtype): a plan queries the device and the occupancy of each candidate grid
_PLANS: Dict[Tuple, Tuple[int, ...]] = {}


def _cached_plan(lib: ctypes.CDLL, entry: str, n_out: int, batch: int, hidden: int,
                 out_dim: int, weight_dtype: torch.dtype, device: Optional[int]) -> Tuple[int, ...]:
    if device is None:
        device = torch.cuda.current_device()
    key = (id(lib), entry, device, batch, hidden, out_dim, weight_dtype)
    got = _PLANS.get(key)
    if got is None:
        got = _PLANS[key] = _plan(lib, entry, n_out, batch, hidden, out_dim, weight_dtype)
    return got


# what plan returns, and the phases of one frame that a -DGRU_AR_PROFILE build
# of csrc/gru_ar.cu times (ops/gru_ar_phases.py)
PLAN_KEYS = ("grid", "units", "slice", "lanes", "smem")
PHASES = ("wait for the frame count (hop 1)", "y slice summed and stored with its tag; h copied",
          "Whh product", "wait for the tagged y (hop 2)", "Wy product and gates",
          "y partial, written", "arrival")


def plan(lib: ctypes.CDLL, batch: int, hidden: int, out_dim: int,
         weight_dtype: torch.dtype, train: bool = False,
         device: Optional[int] = None) -> Tuple[int, int, int, int, int]:
    """(blocks, hidden units per block, y values each block sums, lanes per
    (row, unit) in the gate phase, dynamic shared bytes) of one K1 (or,
    ``train``, K2) launch on CUDA device ``device`` (the current one by
    default); raises when the shapes cannot run there (``RowsDoNotFit``
    where B rows do not fit; the wrappers then split B, ``max_batch``).
    Made once per shape and device."""
    entry = "gru_ar_train_plan" if train else "gru_ar_plan"
    return _cached_plan(lib, entry, 5, batch, hidden, out_dim, weight_dtype, device)


# what plan_bwd returns, and the phases of one reversed step that a
# -DGRU_AR_BWD_PROFILE build of csrc/gru_ar_bwd.cu times (ops/gru_ar_bwd_phases.py)
BWD_PLAN_KEYS = ("grid", "units", "stage_kk", "smem")
BWD_PHASES = ("wait for the partials (hop 1)", "dy slice summed and stored with its tag",
              "dh partials copied and summed", "wait for the tagged dy (hop 2)",
              "dy_tot . Wout and the cotangent algebra", "dh partial product, written",
              "dy partial product, written; arrival",
              "gate recompute of all steps before the loop (per step)")


def plan_bwd(lib: ctypes.CDLL, batch: int, hidden: int, out_dim: int,
             weight_dtype: torch.dtype, device: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(blocks, hidden units per block, dh partials copied per pass, dynamic
    shared bytes) of one K3 launch; raises when the shapes cannot run on CUDA
    device ``device`` (the current one by default; ``RowsDoNotFit`` where B
    rows do not fit).  Made once per shape and device."""
    return _cached_plan(lib, "gru_ar_bwd_plan", 4, batch, hidden, out_dim, weight_dtype, device)


# the largest B each kernel plans, per (kind, H, out, weight dtype, device
# index): found once by doubling and bisection over the plans
_MAX_BATCH: Dict[Tuple, int] = {}
_KINDS = ("k1", "k2", "k3")


def _largest(fits, limit: int = 4096) -> int:
    """The largest B <= ``limit`` with ``fits(B)``, by doubling and then
    bisection (``fits`` holds for every B up to it and for none past it);
    0 when not even one row fits."""
    if not fits(1):
        return 0
    lo = 1
    while lo < limit and fits(min(2 * lo, limit)):
        lo = min(2 * lo, limit)
    if lo == limit:
        return lo
    hi = min(2 * lo, limit)          # lo fits, hi does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def max_batch(kind: str, hidden: int, out_dim: int, weight_dtype: torch.dtype,
              device: Optional[int] = None) -> int:
    """The largest B one launch of K1 (``kind`` "k1"), K2 ("k2") or K3
    ("k3") takes at (H, out, weight dtype) on CUDA device ``device`` (the
    current one by default): the plan's limit on rows, found once and
    cached.  Only the plan's "rows do not fit" answer (``RowsDoNotFit``)
    counts as not fitting; any other error of a plan propagates."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if device is None:
        device = torch.cuda.current_device()
    key = (kind, hidden, out_dim, weight_dtype, device)
    got = _MAX_BATCH.get(key)
    if got is None:
        if kind == "k3":
            lib = _build.load("gru_ar_bwd")
            make = lambda b: plan_bwd(lib, b, hidden, out_dim, weight_dtype, device)
        else:
            lib = _build.load("gru_ar")
            make = lambda b: plan(lib, b, hidden, out_dim, weight_dtype, kind == "k2", device)

        def fits(b: int) -> bool:
            try:
                make(b)
                return True
            except RowsDoNotFit:
                return False

        got = _MAX_BATCH[key] = _largest(fits)
    return got


def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t``: a CUDA tensor does,
    a CPU tensor takes the plain version."""
    return t.device.type != "cpu"


def _row_blocks(wrapper, kind: str, B: int, hidden: int, out_dim: int,
                weight_dtype: torch.dtype, dev: torch.device, run_rows):
    """``run_rows(rows)`` for consecutive row blocks of at most
    ``max_batch`` rows (one block, all rows, when B is within it), one
    counted launch each; the outputs concatenated along B."""
    limit = max_batch(kind, hidden, out_dim, weight_dtype, dev.index)
    if limit < 1:
        raise RowsDoNotFit(f"not one row fits a {kind} launch at H={hidden} out={out_dim} "
                           f"{weight_dtype}")
    outs = []
    for b0 in range(0, B, limit):
        outs.append(run_rows(slice(b0, min(b0 + limit, B))))
        _build.count_launch(wrapper)
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def cuda_gru_ar(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor,
                y0: torch.Tensor, h0: torch.Tensor,
                weight_dtype: torch.dtype = _F32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused AR-GRU over a segment (K1). Returns (trj (B,T,out), y_T, h_T),
    float32.  ``launches`` counts kernel launches: one per row block.

    ``weight_dtype=torch.bfloat16`` halves the weight and gate bytes at
    ~1e-2 relative output tolerance.
    """
    if not _on_card(gates_x):
        return gru_ar_reference(gru_layer, out_proj, gates_x, y0, h0,
                                weight_dtype)
    return _forward_blocks(cuda_gru_ar, gru_layer, out_proj, gates_x, y0, h0, weight_dtype)


cuda_gru_ar.launches = 0


def cuda_gru_ar_train(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor,
                      y0: torch.Tensor, h0: torch.Tensor, out_mask: torch.Tensor,
                      weight_dtype: torch.dtype = _F32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused AR-GRU over a segment for the training path (K2). Returns
    (trj (B,T,out), y_T, h_T float32, h_seq (B,T,H) at ``weight_dtype``).
    ``launches`` counts kernel launches: one per row block."""
    if not _on_card(gates_x):
        return gru_ar_train_reference(gru_layer, out_proj, gates_x, y0, h0,
                                      out_mask, weight_dtype)
    return _forward_blocks(cuda_gru_ar_train, gru_layer, out_proj, gates_x, y0, h0,
                           weight_dtype, out_mask)


cuda_gru_ar_train.launches = 0


def _check_common(what: str, dev: torch.device, weight_dtype: torch.dtype, tensors) -> None:
    if weight_dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be float32 or bfloat16, got {weight_dtype}")
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"the {what} kernel needs all tensors on one device")


def _check_forward(gru_layer: Dict, out_proj: Dict, gates_x: torch.Tensor, y0: torch.Tensor,
                   h0: torch.Tensor, weight_dtype: torch.dtype,
                   out_mask: Optional[torch.Tensor]) -> Tuple[int, int, int, int]:
    """(B, T, H, out) of a K1 / K2 call; raises on shapes that do not fit."""
    if weight_dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be float32 or bfloat16, got {weight_dtype}")
    B, T, threeH = gates_x.shape
    hidden = gru_layer["w_hh"].shape[1]
    out_dim = out_proj["w"].shape[0]
    if T < 1 or threeH != 3 * hidden:
        raise ValueError(f"gates_x {tuple(gates_x.shape)} does not fit H={hidden}")
    if tuple(y0.shape) != (B, out_dim) or tuple(h0.shape) != (B, hidden):
        raise ValueError(f"y0 {tuple(y0.shape)} / h0 {tuple(h0.shape)} do not "
                         f"fit B={B}, out={out_dim}, H={hidden}")
    if out_mask is not None and tuple(out_mask.shape) != (B, T, hidden):
        raise ValueError(f"out_mask {tuple(out_mask.shape)} is not (B, T, H) = "
                         f"{(B, T, hidden)}")
    return B, T, hidden, out_dim


def _forward_blocks(wrapper, gru_layer, out_proj, gates_x, y0, h0, weight_dtype,
                    out_mask=None):
    """K1 (K2 with ``out_mask``) over the batch's row blocks; the weights
    cast to the weight dtype once for all blocks."""
    B, _, hidden, out_dim = _check_forward(gru_layer, out_proj, gates_x, y0, h0,
                                           weight_dtype, out_mask)
    lib = _build.load("gru_ar")
    weights = tuple(t.contiguous() for t in _weights(gru_layer, out_proj, weight_dtype))
    train = out_mask is not None
    return _row_blocks(
        wrapper, "k2" if train else "k1", B, hidden, out_dim, weight_dtype, gates_x.device,
        lambda r: launch_rows(lib, weights, gates_x[r], y0[r], h0[r], weight_dtype,
                              out_mask[r] if train else None))


def launch(lib: ctypes.CDLL, gru_layer: Dict, out_proj: Dict,
           gates_x: torch.Tensor, y0: torch.Tensor, h0: torch.Tensor,
           weight_dtype: torch.dtype, out_mask: Optional[torch.Tensor] = None):
    """One launch of the kernel of ``lib`` (a build of ``csrc/gru_ar.cu``)
    over all B rows, uncounted: K1, or K2 when ``out_mask`` is given (which
    also returns ``h_seq``).  Raises where B rows do not fit one launch."""
    _check_forward(gru_layer, out_proj, gates_x, y0, h0, weight_dtype, out_mask)
    weights = tuple(t.contiguous() for t in _weights(gru_layer, out_proj, weight_dtype))
    return launch_rows(lib, weights, gates_x, y0, h0, weight_dtype, out_mask)


def launch_rows(lib: ctypes.CDLL, weights: Tuple[torch.Tensor, ...], gates_x: torch.Tensor,
                y0: torch.Tensor, h0: torch.Tensor, weight_dtype: torch.dtype,
                out_mask: Optional[torch.Tensor] = None):
    """Allocate outputs and scratch and launch the kernel of ``lib`` on the
    current stream for the rows given: ``weights`` = (wy, whh, bhh, wout,
    bout) as ``_weights`` makes them, contiguous."""
    dev = gates_x.device
    train = out_mask is not None
    wy, whh, bhh, wout, bout = weights
    _check_common("gru_ar", dev, weight_dtype,
                  [gates_x, y0, h0, *weights] + ([out_mask] if train else []))
    B, T, _ = gates_x.shape
    hidden = whh.shape[1]
    out_dim = wout.shape[0]

    with torch.cuda.device(dev):
        gx = gates_x.to(weight_dtype).contiguous()
        y0c = y0.to(_F32).contiguous()
        h0c = h0.to(_F32).contiguous()
        grid, units, slice_, lanes, smem = plan(lib, B, hidden, out_dim, weight_dtype, train,
                                                dev.index)
        trj = torch.empty((B, T, out_dim), dtype=_F32, device=dev)
        y_last = torch.empty((B, out_dim), dtype=_F32, device=dev)
        h_last = torch.empty((B, hidden), dtype=_F32, device=dev)
        # scratch, double-buffered by frame parity: h_t at the weight dtype,
        # rows padded to 16 bytes for the kernel's cp.async copies; each
        # block's partial of y laid out by the block that sums each slice;
        # y as frame-tagged 8-byte words (rows of out padded to 4), then the
        # frame count on its own 128-byte line (zeroed)
        per16 = 16 // torch.empty((), dtype=weight_dtype).element_size()
        hbuf = torch.empty((2, B, -(-hidden // per16) * per16), dtype=weight_dtype, device=dev)
        ypart = torch.empty((2, grid, grid, slice_), dtype=_F32, device=dev)
        words = -(-2 * B * _up4(out_dim) // 16) * 16
        ybuf = torch.zeros(words + 16, dtype=torch.int64, device=dev)
        ptrs = [gx, wy, whh, bhh, wout, bout, y0c, h0c]
        if train:
            mask = out_mask.to(weight_dtype).contiguous()
            h_seq = torch.empty((B, T, hidden), dtype=weight_dtype, device=dev)
            ptrs += [mask, trj, y_last, h_last, h_seq]
        else:
            ptrs += [trj, y_last, h_last]
        ptrs += [hbuf, ypart, ybuf]

        name = f"{'gru_ar_train' if train else 'gru_ar'}_{_WEIGHT_DTYPES[weight_dtype]}"
        fn = _entry(lib, name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
        err = fn(*(_ptr(t) for t in ptrs), B, T, hidden, out_dim, grid, units, slice_, lanes,
                 smem, _stream(dev))
        _build.check(lib, err, f"{name} launch")
    if train:
        return trj, y_last, h_last, h_seq
    return trj, y_last, h_last


def cuda_gru_ar_bwd(wout: torch.Tensor, whh: torch.Tensor, wy: torch.Tensor,
                    bhh: torch.Tensor, d_trj: torch.Tensor, gates_x: torch.Tensor,
                    y_prev: torch.Tensor, h_prev: torch.Tensor, out_mask: torch.Tensor,
                    d_hT: torch.Tensor, d_yT: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Reverse-time cotangent scan of the AR-GRU (K3), with the gates
    recomputed in the kernel.  Weights in torch layout: ``wout`` (out,H),
    ``whh`` (3H,H), ``wy`` (3H,out); the weight dtype is ``whh.dtype``.
    Returns (dgx, dgh (B,T,3H) at the weight dtype, dy_tot (B,T,out), dh0
    (B,H), dy0 (B,out) float32).  ``launches`` counts kernel launches: one
    per row block."""
    args = (wout, whh, wy, bhh, d_trj, gates_x, y_prev, h_prev, out_mask, d_hT, d_yT)
    if not _on_card(d_trj):
        return gru_ar_bwd_reference(*args)
    B, _, hidden, out_dim = _check_bwd(*args)
    lib = _build.load("gru_ar_bwd")
    wdt = whh.dtype
    w = lambda a: a.to(wdt).contiguous()
    weights = (w(wout), w(whh), w(wy), bhh.to(_F32).contiguous())
    per_row = (d_trj, gates_x, y_prev, h_prev, out_mask, d_hT, d_yT)
    return _row_blocks(cuda_gru_ar_bwd, "k3", B, hidden, out_dim, wdt, d_trj.device,
                       lambda r: launch_bwd_rows(lib, *weights, *(a[r] for a in per_row)))


cuda_gru_ar_bwd.launches = 0


def _check_bwd(wout, whh, wy, bhh, d_trj, gates_x, y_prev, h_prev, out_mask, d_hT, d_yT
               ) -> Tuple[int, int, int, int]:
    """(B, T, H, out) of a K3 call; raises on shapes that do not fit."""
    if whh.dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"the weight dtype must be float32 or bfloat16, got {whh.dtype}")
    B, T, hidden = h_prev.shape
    out_dim = d_trj.shape[-1]
    want = {"wout": (out_dim, hidden), "whh": (3 * hidden, hidden), "wy": (3 * hidden, out_dim),
            "bhh": (3 * hidden,), "d_trj": (B, T, out_dim), "gates_x": (B, T, 3 * hidden),
            "y_prev": (B, T, out_dim), "out_mask": (B, T, hidden), "d_hT": (B, hidden),
            "d_yT": (B, out_dim)}
    got = dict(wout=wout, whh=whh, wy=wy, bhh=bhh, d_trj=d_trj, gates_x=gates_x,
               y_prev=y_prev, out_mask=out_mask, d_hT=d_hT, d_yT=d_yT)
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{k} {tuple(got[k].shape)} is not {shape} "
                             f"(B={B}, T={T}, H={hidden}, out={out_dim})")
    if T < 1:
        raise ValueError("the gru_ar_bwd kernel needs T >= 1")
    return B, T, hidden, out_dim


def launch_bwd(lib: ctypes.CDLL, wout: torch.Tensor, whh: torch.Tensor, wy: torch.Tensor,
               bhh: torch.Tensor, d_trj: torch.Tensor, gates_x: torch.Tensor,
               y_prev: torch.Tensor, h_prev: torch.Tensor, out_mask: torch.Tensor,
               d_hT: torch.Tensor, d_yT: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One launch of the kernel of ``lib`` (a build of
    ``csrc/gru_ar_bwd.cu``) over all B rows, uncounted; raises where B rows
    do not fit one launch."""
    _check_bwd(wout, whh, wy, bhh, d_trj, gates_x, y_prev, h_prev, out_mask, d_hT, d_yT)
    return launch_bwd_rows(lib, wout, whh, wy, bhh, d_trj, gates_x, y_prev, h_prev, out_mask,
                           d_hT, d_yT)


def launch_bwd_rows(lib: ctypes.CDLL, wout: torch.Tensor, whh: torch.Tensor, wy: torch.Tensor,
                    bhh: torch.Tensor, d_trj: torch.Tensor, gates_x: torch.Tensor,
                    y_prev: torch.Tensor, h_prev: torch.Tensor, out_mask: torch.Tensor,
                    d_hT: torch.Tensor, d_yT: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Allocate outputs and scratch and launch the kernel of ``lib`` on the
    current stream for the rows given."""
    wdt = whh.dtype
    dev = d_trj.device
    _check_common("gru_ar_bwd", dev, wdt,
                  (wout, whh, wy, bhh, d_trj, gates_x, y_prev, h_prev, out_mask, d_hT, d_yT))
    B, T, hidden = h_prev.shape
    out_dim = d_trj.shape[-1]

    with torch.cuda.device(dev):
        w = lambda a: a.to(wdt).contiguous()
        f = lambda a: a.to(_F32).contiguous()
        ins = [f(d_trj), w(gates_x), w(y_prev), w(h_prev), w(out_mask), w(wout),
               w(whh), w(wy), f(bhh), f(d_hT), f(d_yT)]
        grid, units, stage_kk, smem = plan_bwd(lib, B, hidden, out_dim, wdt, dev.index)
        dgx = torch.empty((B, T, 3 * hidden), dtype=wdt, device=dev)
        dgh = torch.empty((B, T, 3 * hidden), dtype=wdt, device=dev)
        dy_tot = torch.empty((B, T, out_dim), dtype=_F32, device=dev)
        dh0 = torch.empty((B, hidden), dtype=_F32, device=dev)
        dy0 = torch.empty((B, out_dim), dtype=_F32, device=dev)
        # scratch: the six recomputed values (r, z, n, ghn, h_prev, mask) of
        # every (block, row, step, unit); then, double-
        # buffered by step parity, each block's partials of dh laid out by the
        # block that owns the columns (units padded to 4), each block's
        # partial of dy (slices of S values), and dy as step-tagged 8-byte
        # words followed by the two step counts (zeroed)
        slice_ = _up4(-(-B * out_dim // grid))
        gbuf = torch.empty((grid, 6, B, T, _up4(units)), dtype=_F32, device=dev)
        pbuf = torch.empty((2, grid, grid, B, _up4(units)), dtype=_F32, device=dev)
        dbuf = torch.empty((2, grid, grid * slice_), dtype=_F32, device=dev)
        words = (B * out_dim + 1) // 2 * 2
        ybuf = torch.zeros(2 * words + 1, dtype=torch.int64, device=dev)
        ptrs = ins + [dgx, dgh, dy_tot, dh0, dy0, gbuf, pbuf, dbuf, ybuf]

        fn = _entry(lib, f"gru_ar_bwd_{_WEIGHT_DTYPES[wdt]}",
                    [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        err = fn(*(_ptr(t) for t in ptrs), B, T, hidden, out_dim, grid, units, stage_kk,
                 smem, _stream(dev))
        _build.check(lib, err, "gru_ar_bwd launch")
    return dgx, dgh, dy_tot, dh0, dy0
