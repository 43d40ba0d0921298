"""WaveRNN autoregressive sampling (K4): CUDA kernel + plain version + Philox.

PyTorch counterpart of ``cyclevae_tpu/ops/pallas_wavernn.py``, with the same
contract: ``cuda_wavernn_generate(params, cfg, cond (B,T,cond_dim), seed,
temperature) -> (B, T)`` int32 mu-law indices, all steps in ONE launch of the
hand-written kernel ``csrc/wavernn.cu`` (design notes there) for CUDA tensors,
and its plain version ``wavernn_generate_reference`` for CPU tensors.  A CUDA
tensor never falls back: the kernel launches or the call raises.  The
wrapper's ``launches`` counts the kernel's launches.

As in the TPU wrapper, the (n_classes, 3H) embed gate table and the
conditioning gates ``cond @ w_cond^T + b_ih`` are computed outside the kernel
(``torch.matmul``); everything is float32.

Per step, for each batch row: the input gates are the conditioning gates
plus the table row of the previous sample (K//2 at t=0, with h=0); one GRU
cell; logits ``relu(h W1^T + b1) W2^T + b2``; then, when ``temperature > 0``,
scores ``logits / max(temperature, 1e-6) + g`` with Gumbel noise
``g = -log(-log(u + 1e-9) + 1e-9)`` from uniforms ``u = (bits & 0x7fffff) *
2^-23``, else scores = logits; the sample is the argmax (ties to the lowest
index), written out and fed back.

The TPU kernel's bits come from its on-chip generator, which no CUDA code can
reproduce.  Here they come from Philox4x32-10 (Salmon et al., SC'11), which
the kernel computes itself and ``philox4x32_10`` computes in torch: key
(seed, 0), counter (t, b, k // 4, 0), word k % 4 for class k.  So the kernel
and its plain version draw the same uniforms, and the sampled output can be
held index by index, not only in distribution.

The dual output (``WaveRNNConfig.dual``, the published WaveRNN's coarse and
fine softmax over 16-bit audio) has its own instantiation of the kernel in
the same source, one launch a call too, with the same contract: (B, T)
int32 16-bit samples u16 = c * 256 + f.  The wrapper passes the masked
input weights of [c~_{t-1}, f~_{t-1}, c~_t] where K4 takes the gate table.
One ``launch`` serves both instantiations, and one plain version both:
``models/wavernn.py``'s ``plain_sampler`` (the step's numerics are written
there) with the kernel's uniforms, the coarse head K4's counter (t, b,
k // 4, 0), the fine head (t, b, k // 4, 1).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from . import _build
from .cuda_gru import _cached_plan, _entry, _ptr, _stream, _up4
from ..utils.profiling import count
from ..models.wavernn import (WaveRNNConfig, cond_gates, dual_input_weights, embed_gate_table,
                              plain_sampler)

_F32 = torch.float32
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
# Over thousands of dependent argmaxes, a float32 near-tie can flip one index
# between the kernel and its plain version (they sum in different orders),
# after which the two trajectories part.  A flip is accepted only where the
# plain version's two best scores lie within this fraction of its largest
# |score| at that step.
NEAR_TIE_REL = 1e-4


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of the 64-bit product a * b of two 32-bit
    values, in int64 arithmetic without overflow (b split in 16-bit halves)."""
    x = a * (b & 0xFFFF)                 # < 2^48
    s = a * (b >> 16) + (x >> 16)        # < 2^49; a*b = s*2^16 + (x & 0xFFFF)
    return s >> 16, ((s & 0xFFFF) << 16) | (x & 0xFFFF)


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on int64 tensors holding 32-bit values: counter (..., 4)
    and key (..., 2), broadcast together -> (..., 4) random words."""
    c0, c1, c2, c3 = counter.to(torch.int64).unbind(-1)
    k0, k1 = key.to(torch.int64).unbind(-1)
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_uniforms(seed: int, t0: int, T: int, B: int, K: int,
                    device=None, head: int = 0) -> torch.Tensor:
    """The kernel's uniforms for steps [t0, t0+T): (T, B, K) float32 in
    [0, 1), u = (bits & 0x7fffff) * 2^-23 with bits the Philox word of
    counter (t, b, k // 4, head) and key (seed, 0); head 1 is the dual
    output's fine head."""
    words = (K + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    t = torch.arange(t0, t0 + T, **i64)[:, None, None].expand(T, B, words)
    b = torch.arange(B, **i64)[None, :, None].expand(T, B, words)
    w = torch.arange(words, **i64)[None, None, :].expand(T, B, words)
    counter = torch.stack([t, b, w, torch.full_like(t, head)], dim=-1)
    key = torch.tensor([seed & _MASK32, 0], **i64)
    bits = philox4x32_10(counter, key).reshape(T, B, 4 * words)[..., :K]
    return (bits & 0x7FFFFF).to(_F32) * (1.0 / (1 << 23))


def wavernn_generate_reference(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                               seed: int, temperature: float = 1.0,
                               margins: bool = False):
    """Plain PyTorch version of K4 and of its dual instantiation: the
    model's ``plain_sampler`` with the kernel's Philox uniforms.  Returns
    (B, T) int32 samples; with ``margins``, also each head's gap between its
    two largest scores and its largest |score| at each step ((B, T) float32
    tensors, the dual's (B, T, 2)), what a near-tie test reads."""
    B = cond.shape[0]

    def gumbel(t0: int, n: int, head: int) -> torch.Tensor:
        u = philox_uniforms(seed, t0, n, B, cfg.n_classes, cond.device, head=head)
        return -torch.log(-torch.log(u + 1e-9) + 1e-9)

    return plain_sampler(params, cfg, cond, gumbel if temperature > 0 else None, temperature,
                         margins)


def first_divergence(got: torch.Tensor, want: torch.Tensor, gap: torch.Tensor,
                     scale: torch.Tensor, rel: float = NEAR_TIE_REL) -> Tuple[List[int], bool]:
    """Hold the kernel's indices ``got`` (B, T) against the plain version's
    ``want`` with its ``margins`` (``gap``, ``scale``): every index before a
    row's first difference matches by definition, and the difference is
    accepted if the plain version's top-two gap there is below ``rel`` times
    its largest |score|.  With margins of the dual output's two heads (B, T,
    2), a difference is judged by the coarse head where the coarse bytes
    differ, else by the fine head.  Returns (first differing step of each
    row, -1 where none; whether every row passes)."""
    got, want = got.cpu(), want.cpu()
    gap, scale = gap.cpu(), scale.cpu()
    steps, ok = [], True
    for b in range(want.shape[0]):
        diff = torch.nonzero(got[b] != want[b])
        if len(diff) == 0:
            steps.append(-1)
            continue
        t = int(diff[0])
        steps.append(t)
        if gap.dim() == 3:
            head = 0 if int(got[b, t]) >> 8 != int(want[b, t]) >> 8 else 1
            ok &= bool(gap[b, t, head] < rel * scale[b, t, head])
        else:
            ok &= bool(gap[b, t] < rel * scale[b, t])
    return steps, ok


def _plan(lib: ctypes.CDLL, entry: str, batch: int, hidden: int, n_classes: int,
          fc_dim: int) -> Tuple[int, ...]:
    vals = [ctypes.c_int() for _ in range(5)]
    fn = _entry(lib, entry, [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 5)
    err = fn(batch, hidden, n_classes, fc_dim, *(ctypes.byref(v) for v in vals))
    _build.check(lib, err, f"{entry} for B={batch} H={hidden} K={n_classes} fc={fc_dim}")
    return tuple(v.value for v in vals)


def plan(lib: ctypes.CDLL, batch: int, hidden: int, n_classes: int,
         fc_dim: int, dual: bool = False) -> Tuple[int, int, int, int, int]:
    """(blocks, hidden units per block, blocks per cluster, fc1 values summed
    per pass, dynamic shared bytes) of one K4 launch on the current CUDA
    device; raises when the shapes cannot run there.  ``dual``: of the dual
    instantiation (``fc_dim`` unused: its heads' first layers are H/2 wide,
    summed in one pass).  Made once per shape and device, in the AR-GRU
    kernels' cache (``cuda_gru._cached_plan``)."""
    entry = "wavernn_dual_plan" if dual else "wavernn_plan"
    return _cached_plan(lib, entry, None, (batch, hidden, n_classes, fc_dim),
                        lambda: _plan(lib, entry, batch, hidden, n_classes, fc_dim))


def cuda_wavernn_generate(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                          seed: int, temperature: float = 1.0) -> torch.Tensor:
    """Generate mu-law sample indices (B, T) int32 for all steps in one
    kernel launch (K4), or for the dual output 16-bit samples u16 = c * 256
    + f (its instantiation of the kernel); the plain version for CPU
    tensors.  A launch counts the rows x samples it renders under
    ``wavernn.steps``."""
    if cond.device.type == "cpu":
        return wavernn_generate_reference(params, cfg, cond, seed, temperature)
    return launch(_build.load("wavernn"), params, cfg, cond, seed, temperature)


cuda_wavernn_generate.launches = 0


def launch(lib: ctypes.CDLL, params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
           seed: int, temperature: float) -> torch.Tensor:
    """Check the inputs, allocate the output and scratch, and launch the
    kernel of ``lib`` (a build of ``csrc/wavernn.cu``) once on the current
    stream: K4, or for the dual output its instantiation, which takes the
    masked input weights of [c~_{t-1}, f~_{t-1}, c~_t] where K4 takes the
    gate table, and the four weights of its two heads."""
    dev = cond.device
    if dev.type != "cuda":
        raise ValueError(f"the wavernn kernel runs on CUDA tensors, got {dev}")
    if cond.dim() != 3 or cond.shape[2] != cfg.cond_dim or cond.shape[1] < 1:
        raise ValueError(f"cond {tuple(cond.shape)} is not (B, T >= 1, {cfg.cond_dim})")
    B, T, _ = cond.shape
    H, K, FC = cfg.hidden_units, cfg.n_classes, cfg.fc_dim
    Hh = H // 2
    gru = {("gru", "w_ih"): (3 * H, cfg.input_dim + cfg.cond_dim), ("gru", "b_ih"): (3 * H,),
           ("gru", "w_hh"): (3 * H, H), ("gru", "b_hh"): (3 * H,)}
    if cfg.dual:
        heads = ("O1", "O2", "O3", "O4")
        want = {**gru, ("O1", "w"): (Hh, Hh), ("O1", "b"): (Hh,), ("O2", "w"): (K, Hh),
                ("O2", "b"): (K,), ("O3", "w"): (Hh, Hh), ("O3", "b"): (Hh,),
                ("O4", "w"): (K, Hh), ("O4", "b"): (K,)}
    else:
        heads = ("fc1", "fc2")
        want = {("embed", None): (K, cfg.embed_dim), **gru, ("fc1", "w"): (FC, H),
                ("fc1", "b"): (FC,), ("fc2", "w"): (K, FC), ("fc2", "b"): (K,)}
    for (net, name), shape in want.items():
        t = params[net] if name is None else params[net][name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{net}.{name} {tuple(t.shape)} is not {shape}")
        if t.device != dev:
            raise ValueError(f"{net}.{name} is on {t.device}, cond on {dev}")

    with torch.cuda.device(dev):
        f = lambda t: t.to(_F32).contiguous()
        inputs = dual_input_weights(params, cfg) if cfg.dual else embed_gate_table(params)
        ptrs = [f(cond_gates(params, cfg, cond.to(_F32))), f(inputs),
                f(params["gru"]["w_hh"]), f(params["gru"]["b_hh"]),
                *(f(params[k][n]) for k in heads for n in ("w", "b"))]
        grid, units, cluster, stage_rows, smem = plan(lib, B, H, K, 0 if cfg.dual else FC,
                                                      dual=cfg.dual)
        if cfg.dual:
            # exchange scratch, 0 at launch: per head and step parity the
            # head's first layer summed in each cluster of its half, by the
            # rank that owns the values (ceil(H/2 / cluster) a row, padded to
            # 4), then the half's h
            words = 4 * ((grid // 2) * B * _up4(-(-Hh // cluster)) + B * Hh)
            entry, what = "wavernn_dual_generate_f32", "wavernn dual launch"
            ints = (B, T, H, K, grid, units, cluster, smem)
        else:
            # exchange scratch, 0 at launch: per step parity the cluster
            # partials of f and h, each 8-byte word a float and the step that
            # wrote it (rows padded to 16 bytes); then the count of blocks'
            # stores
            words = 2 * ((grid // cluster) * B * _up4(FC) + B * _up4(H)) + 1
            entry, what = "wavernn_generate_f32", "wavernn launch"
            ints = (B, T, H, K, FC, grid, units, cluster, stage_rows, smem)
        out = torch.empty((B, T), dtype=torch.int32, device=dev)
        ptrs += [out, torch.zeros((words,), dtype=torch.int64, device=dev)]
        fn = _entry(lib, entry, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_uint32, ctypes.c_float]
                    + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        err = fn(*(_ptr(t) for t in ptrs), seed & _MASK32, float(temperature), *ints,
                 _stream(dev))
        _build.check(lib, err, what)
    _build.count_launch(cuda_wavernn_generate)
    count("wavernn.steps", B * T)
    return out
