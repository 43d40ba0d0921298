"""The fused autoregressive GRU with its hand-derived gradient: the training path.

PyTorch counterpart of ``cyclevae_tpu/ops/gru_ar_vjp.py``: ``gru_ar_fused``
is a ``torch.autograd.Function`` whose

  * forward runs K2 (``ops.cuda_gru.cuda_gru_ar_train_gates``) and saves the
    hidden-state sequence ``h_seq``, stored at the weight dtype, and the
    gates r, z, n and gh_n of every frame, in float32;
  * backward runs K3 (``ops.cuda_gru.cuda_gru_ar_bwd``), the reverse-time
    scan that reads each step's gates from the forward's, where the JAX
    package's kernel recomputes them from the residuals (gates_x, y_prev,
    h_prev), and carries only the sequential cotangents dh and dy;
  * weight gradients form as bulk float32 products over the per-step gate
    cotangents, as the JAX package leaves them to XLA einsums with float32
    accumulation (exact for bf16 operands).

On CPU tensors both directions run the kernels' plain versions; on CUDA
tensors the kernels, or an error.  The returned gradients are rounded to the
weight dtype where the JAX package's ``_bwd`` casts them to its (then bf16)
input dtypes, so the bf16 path keeps the JAX package's bounds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda_gru import cuda_gru_ar_bwd, cuda_gru_ar_train_gates

_F32 = torch.float32


class _GruArFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, weight_dtype, w_ih_y, w_hh, b_hh, w_out, b_out, gates_x, y0, h0,
                out_mask):
        # the kernel takes w_ih[:, conv_dim:]; hand it just the feedback
        # columns (the conv part is already inside gates_x)
        trj, y_T, h_T, h_seq, gates = cuda_gru_ar_train_gates(
            {"w_ih": w_ih_y, "w_hh": w_hh, "b_hh": b_hh}, {"w": w_out, "b": b_out},
            gates_x, y0, h0, out_mask, weight_dtype)
        ctx.weight_dtype = weight_dtype
        ctx.save_for_backward(w_ih_y, w_hh, b_hh, w_out, b_out, gates_x, y0, h0, out_mask,
                              trj, h_seq, gates)
        return trj, y_T, h_T

    @staticmethod
    def backward(ctx, d_trj, d_yT, d_hT):
        (w_ih_y, w_hh, b_hh, w_out, b_out, gates_x, y0, h0, out_mask,
         trj, h_seq, gates) = ctx.saved_tensors
        wdt = ctx.weight_dtype
        y_prev = torch.cat([y0[:, None].to(_F32), trj[:, :-1]], dim=1).to(wdt)
        h_prev = torch.cat([h0[:, None].to(wdt), h_seq[:, :-1]], dim=1)
        dgx, dgh, dy_seq, dh0, dy0 = cuda_gru_ar_bwd(
            w_out.to(wdt), w_hh.to(wdt), w_ih_y.to(wdt), b_hh, d_trj, gates_x,
            y_prev, h_prev, out_mask, d_hT, d_yT, gates)

        def cast(g, like):  # as the JAX _bwd: to the (weight) dtype, then back
            return g.to(wdt).to(like.dtype)

        f = lambda a: a.to(_F32)
        o = (f(h_seq) * f(out_mask.to(wdt))).to(wdt)
        need = ctx.needs_input_grad
        grads = [None,
                 cast(torch.einsum("btg,bto->go", f(dgx), f(y_prev)), w_ih_y) if need[1] else None,
                 cast(torch.einsum("btg,bth->gh", f(dgh), f(h_prev)), w_hh) if need[2] else None,
                 cast(f(dgh).sum(dim=(0, 1)), b_hh) if need[3] else None,
                 cast(torch.einsum("bto,bth->oh", dy_seq, f(o)), w_out) if need[4] else None,
                 cast(dy_seq.sum(dim=(0, 1)), b_out) if need[5] else None,
                 dgx.to(gates_x.dtype) if need[6] else None,
                 cast(dy0, y0) if need[7] else None,
                 cast(dh0, h0) if need[8] else None,
                 cast((dy_seq @ f(w_out)) * f(h_seq), out_mask) if need[9] else None]
        return tuple(grads)


def gru_ar_fused(w_ih_y: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 w_out: torch.Tensor, b_out: torch.Tensor, gates_x: torch.Tensor,
                 y0: torch.Tensor, h0: torch.Tensor, out_mask: torch.Tensor,
                 weight_dtype: torch.dtype = _F32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused single-layer AR-GRU with a hand-derived gradient.

    Args (torch weight layout, as stored in the parameter dicts):
      w_ih_y (3H, out): AR-feedback columns of w_ih.
      w_hh (3H, H), b_hh (3H,): hidden-side projection.
      w_out (out, H), b_out (out,): output projection (reference out_1).
      gates_x (B, T, 3H): hoisted conv-side input gates incl. b_ih.
      y0 (B, out), h0 (B, H): carried AR/hidden state.
      out_mask (B, T, H): inverted-dropout mask on the GRU output (ones = off).
      weight_dtype: float32, or bfloat16 to round the products' operands
        and the streams to bf16 (the JAX package's bf16 weights).

    Returns (trj (B, T, out), y_T, h_T), float32.
    """
    return _GruArFused.apply(weight_dtype, w_ih_y, w_hh, b_hh, w_out, b_out, gates_x,
                             y0, h0, out_mask)
