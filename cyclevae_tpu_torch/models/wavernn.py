"""WaveRNN-class neural vocoder: mu-law sample-level GRU conditioned on the
54-d acoustic features.

PyTorch counterpart of ``cyclevae_tpu/models/wavernn.py``, same parameter
dict (torch layout: GRU ``w_ih``/``w_hh`` (3H, in) with gate rows [r, z, n],
dense ``w`` (out, in)) and same functions:
  * training is teacher-forced: the previous sample is ground truth, so the
    only sequential op is the GRU hidden recurrence: one cuDNN GRU call on
    the card, a plain loop over samples on the CPU (autograd differentiates
    both; the loop hoists the input-side projections out of it);
  * the embedding side is fused with the GRU input projection: the previous
    sample takes one of ``n_classes`` values, so ``embed @ W_ih_embed^T`` is
    a (n_classes, 3H) gate table and generation needs a row gather per step;
  * ``generate_reference`` is the plain sampler (the JAX package's
    ``generate_xla``); the sampler on the card is the CUDA kernel behind
    ``ops/cuda_wavernn.py``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Optional, Tuple

import torch

from ..ops.gru_scan import _gru_cell
from .layers import init_dense, xavier_uniform

_F32 = torch.float32


@dataclass(frozen=True)
class WaveRNNConfig:
    n_classes: int = 256          # mu-law quantization levels
    embed_dim: int = 128
    cond_dim: int = 128
    hidden_units: int = 896
    fc_dim: int = 128
    feat_dim: int = 54
    # speaker conditioning: when > 0 the conditioning input is the acoustic
    # features with an n_spk one-hot speaker code appended
    n_spk: int = 0
    # samples per frame, fractional: 5 ms @ 22.05 kHz = 110.25 = 441/4
    hop: float = 110.25

    @property
    def cond_in_dim(self) -> int:
        return self.feat_dim + self.n_spk


def hop_fraction(cfg: WaveRNNConfig) -> Tuple[int, int]:
    """Exact rational (num, den) for the samples-per-frame hop."""
    fr = Fraction(cfg.hop).limit_denominator(1000)
    return fr.numerator, fr.denominator


def n_samples_for(cfg: WaveRNNConfig, n_frames: int) -> int:
    num, den = hop_fraction(cfg)
    return n_frames * num // den


# ---------------------------------------------------------------------------
# mu-law codec
# ---------------------------------------------------------------------------

def _log1p_mu(mu: int, device) -> torch.Tensor:
    # log1p(mu) rounded once to float32, on the tensor's device so that a
    # division by it is a true division (not a product with a reciprocal);
    # filled there, not copied from the host: a copy from pageable host
    # memory waits for the stream, e.g. for K4 before its samples are decoded
    return torch.full((), math.log1p(mu), dtype=_F32, device=device)


def mulaw_encode(x: torch.Tensor, n_classes: int = 256) -> torch.Tensor:
    """[-1, 1] float -> [0, n_classes) int32 mu-law indices."""
    mu = n_classes - 1
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / _log1p_mu(mu, x.device)
    return torch.clamp((y + 1.0) / 2.0 * mu + 0.5, 0, mu).to(torch.int32)


def mulaw_decode(idx: torch.Tensor, n_classes: int = 256) -> torch.Tensor:
    mu = n_classes - 1
    y = 2.0 * idx.to(_F32) / mu - 1.0
    return torch.sign(y) * torch.expm1(torch.abs(y) * _log1p_mu(mu, idx.device)) / mu


# ---------------------------------------------------------------------------
# params / cond net
# ---------------------------------------------------------------------------

def init_wavernn(generator: torch.Generator, cfg: WaveRNNConfig) -> Dict:
    """Random parameters drawn from ``generator``, on its device."""
    H = cfg.hidden_units
    in_dim = cfg.embed_dim + cfg.cond_dim
    dev = generator.device
    return {
        "embed": xavier_uniform(generator, (cfg.n_classes, cfg.embed_dim)),
        "cond": init_dense(generator, cfg.cond_in_dim, cfg.cond_dim),
        "gru": {
            "w_ih": xavier_uniform(generator, (3 * H, in_dim)),
            "w_hh": xavier_uniform(generator, (3 * H, H)),
            "b_ih": torch.zeros((3 * H,), device=dev),
            "b_hh": torch.zeros((3 * H,), device=dev),
        },
        "fc1": init_dense(generator, H, cfg.fc_dim),
        "fc2": init_dense(generator, cfg.fc_dim, cfg.n_classes),
    }


def upsample_cond(params: Dict, cfg: WaveRNNConfig, feats: torch.Tensor) -> torch.Tensor:
    """(B, F, feat_dim) frame features -> (B, n_samples_for(F), cond_dim) by
    dense + fractional-hop linear interpolation: sample n sits at frame
    position (n + 0.5)/hop - 0.5, so conditioning stays sample-accurate for
    non-integer hops (110.25 @ 22.05 kHz / 5 ms)."""
    c = torch.tanh(feats @ params["cond"]["w"].T + params["cond"]["b"])
    F = c.shape[1]
    N = n_samples_for(cfg, F)
    pos = (torch.arange(N, dtype=_F32, device=c.device) + 0.5) * (F / N) - 0.5
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, F - 1)
    i1 = torch.clamp(i0 + 1, max=F - 1)
    w = torch.clamp(pos - i0, 0.0, 1.0)[None, :, None]
    return c[:, i0] * (1.0 - w) + c[:, i1] * w


def embed_gate_table(params: Dict) -> torch.Tensor:
    """(n_classes, 3H) fused table: embed -> input-gate contribution."""
    w_emb = params["gru"]["w_ih"][:, :params["embed"].shape[1]]
    return params["embed"] @ w_emb.T


def cond_gates(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor) -> torch.Tensor:
    """The conditioning's input-gate contribution, b_ih included:
    (..., cond_dim) -> (..., 3H)."""
    w_cond = params["gru"]["w_ih"][:, cfg.embed_dim:]
    return cond @ w_cond.T + params["gru"]["b_ih"]


def _logits(params: Dict, h: torch.Tensor) -> torch.Tensor:
    f = torch.relu(h @ params["fc1"]["w"].T + params["fc1"]["b"])
    return f @ params["fc2"]["w"].T + params["fc2"]["b"]


def teacher_forced_logits(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                          prev_idx: torch.Tensor, h0: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: cond (B, T, cond_dim), prev_idx (B, T) ground-truth
    previous samples.  Returns (logits (B, T, n_classes), h_T).

    On CUDA tensors the recurrence is one cuDNN GRU call
    (``cudnn_recurrence``); on CPU tensors it is the plain loop
    (``plain_recurrence``).  Both compute the same function."""
    h0 = (torch.zeros((cond.shape[0], cfg.hidden_units), dtype=cond.dtype, device=cond.device)
          if h0 is None else h0)
    recurrence = plain_recurrence if cond.device.type == "cpu" else cudnn_recurrence
    hs = recurrence(params, cfg, cond, prev_idx.long(), h0)
    return _logits(params, hs), hs[:, -1]


def plain_recurrence(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                     prev_idx: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The teacher-forced GRU, one ``_gru_cell`` per sample with the input
    gates hoisted: (B, T, cond_dim), (B, T) -> hidden states (B, T, H)."""
    H = cfg.hidden_units
    gates_x = cond_gates(params, cfg, cond) + embed_gate_table(params)[prev_idx]
    h, hs = h0, []
    for t in range(cond.shape[1]):
        h = _gru_cell(gates_x[:, t], h, params["gru"]["w_hh"], params["gru"]["b_hh"], H)
        hs.append(h)
    return torch.stack(hs, dim=1)


def cudnn_recurrence(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                     prev_idx: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The same recurrence as ``plain_recurrence`` in one cuDNN GRU call over
    concat(embed[prev], cond) with the model's ``w_ih, w_hh, b_ih, b_hh``
    (torch's GRU is this cell: gates [r, z, n], ``b_hh``'s n part inside
    r * (...)).  The JAX package scans its cell with ``lax.scan``: no TPU
    kernel computes this, so a library call is its counterpart here.

    Runs in full float32: cuDNN's RNNs take TF32 from
    ``torch.backends.cudnn.allow_tf32`` (True by default), so the call turns
    it off (the backward pass runs under the caller's setting: callers that
    train, ``run_train_vocoder``, turn it off around the backward too,
    ``full_f32_cudnn``).  Raises where cuDNN is not there; no fallback."""
    if not torch.backends.cudnn.is_available():
        raise RuntimeError("the teacher-forced WaveRNN on CUDA needs cuDNN")
    g = params["gru"]
    x = torch.cat([params["embed"][prev_idx], cond], dim=-1)
    with full_f32_cudnn():
        hs, _ = torch._VF.gru(x, h0[None].contiguous(), [g["w_ih"], g["w_hh"], g["b_ih"], g["b_hh"]],
                              True, 1, 0.0, torch.is_grad_enabled(), False, True)
    return hs


@contextmanager
def full_f32_cudnn():
    """cuDNN on, and TF32 off, for the body; both flags restored after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled, cudnn.allow_tf32
    cudnn.enabled, cudnn.allow_tf32 = True, False
    try:
        yield
    finally:
        cudnn.enabled, cudnn.allow_tf32 = saved


def wavernn_loss(params: Dict, cfg: WaveRNNConfig, feats: torch.Tensor,
                 wav: torch.Tensor) -> torch.Tensor:
    """Teacher-forced NLL: feats (B, F, feat_dim), wav (B, F*hop) in [-1, 1]."""
    cond = upsample_cond(params, cfg, feats)
    idx = mulaw_encode(wav, cfg.n_classes).long()                 # (B, T)
    prev = torch.cat([torch.full_like(idx[:, :1], cfg.n_classes // 2), idx[:, :-1]], dim=1)
    logits, _ = teacher_forced_logits(params, cfg, cond, prev)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    return nll.mean()


def generate_reference(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                       temperature: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain AR sampler (the JAX package's ``generate_xla``), step by step.
    cond (T, cond_dim) -> sampled mu-law indices (T,) int32.

    Sampled mode (``temperature > 0``) adds Gumbel noise -log(-log(u)) to
    ``logits / temperature`` and takes the argmax; the uniforms ``u`` (T,
    n_classes) in [1e-9, 1) are drawn from ``generator``, or handed in."""
    H, K = cfg.hidden_units, cfg.n_classes
    T = cond.shape[0]
    emb_tab = embed_gate_table(params)
    gates = cond_gates(params, cfg, cond)                       # (T, 3H)
    gumbel = None
    if temperature > 0:
        if u is None:
            u = torch.rand((T, K), generator=generator, device=cond.device) * (1.0 - 1e-9) + 1e-9
        gumbel = -torch.log(-torch.log(u.to(device=cond.device, dtype=_F32)))
    h = torch.zeros((1, H), dtype=_F32, device=cond.device)
    prev = torch.full((), K // 2, dtype=torch.int64, device=cond.device)
    out = torch.empty((T,), dtype=torch.int32, device=cond.device)
    for t in range(T):
        gx = gates[t] + emb_tab[prev]
        h = _gru_cell(gx[None], h, params["gru"]["w_hh"], params["gru"]["b_hh"], H)
        logits = _logits(params, h)[0]
        if gumbel is not None:
            prev = torch.argmax(logits / temperature + gumbel[t])
        else:
            prev = torch.argmax(logits)
        out[t] = prev
    return out
