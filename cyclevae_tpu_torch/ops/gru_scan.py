"""Autoregressive GRU evaluation as a plain PyTorch loop with hoisted input
projections.

PyTorch counterpart of ``cyclevae_tpu/ops/gru_scan.py``.  The conv-context
part of the input-gate projection does not depend on the AR feedback, so it
is hoisted out of the recurrence as one (B*T, C_conv) @ (C_conv, 3H) matmul;
the loop keeps only what is sequential: the AR-feedback slice of the input
projection, the hidden-side matmul, the gates and the output projection that
produces the next feedback frame.  Gate math follows the torch GRU cell ([r, z,
n] rows; the reset gate multiplies the hidden-side candidate including its
bias).

This is the path for multi-layer and residual models, and the plain version
the single-layer CUDA kernel (``ops/cuda_gru.py``) is held against.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def precompute_input_gates(gru_layer0: Dict, conv_seq: torch.Tensor) -> torch.Tensor:
    """Hoisted input-side projection for layer 0: (B, T, C_conv) -> (B, T, 3H).

    Computes ``conv_seq @ w_ih[:, :C_conv].T + b_ih``.
    """
    c_conv = conv_seq.shape[-1]
    w_x = gru_layer0["w_ih"][:, :c_conv]  # (3H, C_conv)
    return conv_seq @ w_x.T + gru_layer0["b_ih"]


def _gru_cell(gates_x: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """One torch-semantics GRU cell step given precomputed input-side gates."""
    gates_h = h @ w_hh.T + b_hh
    r = torch.sigmoid(gates_x[..., :hidden] + gates_h[..., :hidden])
    z = torch.sigmoid(gates_x[..., hidden:2 * hidden] + gates_h[..., hidden:2 * hidden])
    n = torch.tanh(gates_x[..., 2 * hidden:] + r * gates_h[..., 2 * hidden:])
    return (1.0 - z) * n + z * h


def gru_ar_scan(
    gru_layers: List[Dict],
    out_proj: Dict,
    conv_seq: torch.Tensor,
    y0: torch.Tensor,
    h0: torch.Tensor,
    out_drop_mask: Optional[torch.Tensor] = None,
    res_seq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the AR recurrence over a whole segment.

    Args:
      gru_layers: torch-layout GRU params (see layers.init_gru_stack).
      out_proj:   dense H -> out_dim projection (reference out_1).
      conv_seq:   (B, T, C_conv) context embeddings.
      y0:         (B, out_dim) initial AR feedback (normalized domain).
      h0:         (L, B, H) initial hidden state.
      out_drop_mask: optional (B, T, H) inverted-dropout mask applied to the
        GRU output before the projection, so the AR feedback is dropped too.
      res_seq: optional (B, T, out_dim) residual added to the projection
        output inside the recurrence, so the AR feedback carries it too.

    Returns: (trj (B, T, out_dim) normalized-domain outputs, y_T, h_T (L, B, H)).
    """
    hidden = gru_layers[0]["w_hh"].shape[1]
    w_out, b_out = out_proj["w"], out_proj["b"]
    w_ih_y = gru_layers[0]["w_ih"][:, conv_seq.shape[-1]:]  # (3H, out_dim)

    gates_x0 = precompute_input_gates(gru_layers[0], conv_seq)  # (B, T, 3H)
    h = list(h0.unbind(0))
    y = y0
    trj = []
    for t in range(conv_seq.shape[1]):
        inp_gates = gates_x0[:, t] + y @ w_ih_y.T
        for l, p in enumerate(gru_layers):
            if l > 0:
                inp_gates = h[l - 1] @ p["w_ih"].T + p["b_ih"]
            h[l] = _gru_cell(inp_gates, h[l], p["w_hh"], p["b_hh"], hidden)
        out = h[-1]
        if out_drop_mask is not None:
            out = out * out_drop_mask[:, t]
        y = out @ w_out.T + b_out
        if res_seq is not None:
            y = res_seq[:, t] + y
        trj.append(y)
    return torch.stack(trj, dim=1), y, torch.stack(h)
