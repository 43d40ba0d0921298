"""WaveRNN-class neural vocoder: sample-level GRU conditioned on the 54-d
acoustic features, with one of two output layers: one mu-law softmax (the
default), or the published WaveRNN's dual softmax over 16-bit audio
(``WaveRNNConfig.dual``, below).

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
    ``generate_xla``), drawing its noise from a ``torch.Generator``; its
    step is ``plain_sampler``'s, for both output layers, which is also the
    kernel's plain version (``ops/cuda_wavernn.py``, with the kernel's
    noise); the sampler on the card is the CUDA kernel behind that module.

The dual output (Kalchbrenner et al., "Efficient Neural Audio Synthesis",
ICML 2018, arXiv:1802.08435, section 2, eq. 2 and Fig. 1; the JAX package
has no counterpart): a 16-bit sample s is u16 = s + 32768, coarse c = u16 >> 8
and fine f = u16 & 255.  The GRU's input is x_t = [c~_{t-1}, f~_{t-1}, c~_t]
(v~ = v / 127.5 - 1) beside the conditioning; ``w_ih``'s c~_t column is
masked to zero on the coarse half's rows of every gate, so the current
coarse sample reaches only the fine half.  h_t splits into y_c and y_f of
H/2 units each; P(c_t) = softmax(O2 relu(O1 y_c + b1) + b2) and P(f_t) =
softmax(O4 relu(O3 y_f + b3) + b4), O1 and O3 (H/2, H/2), O2 and O4
(n_classes, H/2).  A step: the coarse half, its head and c_t; then the fine
half, its head and f_t.  Training is teacher-forced with both samples known,
so the recurrence is one GRU over [c~_{t-1}, f~_{t-1}, c~_t, cond] with
``w_ih * mask`` (masked entries get zero gradient), and the loss is the sum
of the two heads' mean cross-entropies.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Dict, Optional, Tuple

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
    # the published output layer: 16-bit samples from a coarse and a fine
    # softmax of n_classes = 256 each over the two halves of h (see the
    # module's docstring; embed_dim and fc_dim are then unused); else one
    # n_classes mu-law softmax
    dual: bool = False

    def __post_init__(self):
        if self.dual and (self.n_classes != 256 or self.hidden_units % 8):
            raise ValueError("the dual output needs n_classes 256 (two bytes of a 16-bit "
                             f"sample) and hidden_units a multiple of 8, got {self.n_classes}, "
                             f"{self.hidden_units}")

    @property
    def cond_in_dim(self) -> int:
        return self.feat_dim + self.n_spk

    @property
    def input_dim(self) -> int:
        """The GRU's input columns ahead of the conditioning: the embedding
        of the previous sample, or the dual output's [c~_{t-1}, f~_{t-1},
        c~_t]."""
        return 3 if self.dual else self.embed_dim


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
# 16-bit codec of the dual output
# ---------------------------------------------------------------------------

def pcm16_encode(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1) float -> u16 = s + 32768 in [0, 65536), int32, with s the
    nearest 16-bit value of 32768 x (clipped)."""
    s = torch.clamp(torch.floor(x.to(_F32) * 32768.0 + 0.5), -32768.0, 32767.0)
    return s.to(torch.int32) + 32768


def pcm16_decode(u16: torch.Tensor) -> torch.Tensor:
    """u16 = c * 256 + f -> s / 32768 float32 (exact: |s| <= 2^15)."""
    return (u16.to(torch.int32) - 32768).to(_F32) / 32768.0


def split16(u16: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u16 -> (coarse, fine) bytes."""
    return u16 >> 8, u16 & 255


def scaled_byte(v: torch.Tensor) -> torch.Tensor:
    """A byte as the GRU's input: v / 127.5 - 1, float32 (a true division, as
    the kernel takes it)."""
    return v.to(_F32) / torch.full((), 127.5, dtype=_F32, device=v.device) - 1.0


def dual_input_mask(cfg: WaveRNNConfig, device=None) -> torch.Tensor:
    """(3H, 3 + cond_dim) ones with the c~_t column zero on the coarse
    half's rows of each gate [r, z, n]."""
    H = cfg.hidden_units
    m = torch.ones((3 * H, cfg.input_dim + cfg.cond_dim), dtype=_F32, device=device)
    for g in range(3):
        m[g * H:g * H + H // 2, 2] = 0.0
    return m


def dual_input_weights(params: Dict, cfg: WaveRNNConfig) -> torch.Tensor:
    """The masked weights (3H, 3) of [c~_{t-1}, f~_{t-1}, c~_t]."""
    w = params["gru"]["w_ih"]
    return w[:, :3] * dual_input_mask(cfg, w.device)[:, :3]


def dual_inputs(c_prev: torch.Tensor, f_prev: torch.Tensor, c_cur: torch.Tensor) -> torch.Tensor:
    """x_t = [c~_{t-1}, f~_{t-1}, c~_t]: (...) bytes -> (..., 3) float32."""
    return torch.stack([scaled_byte(c_prev), scaled_byte(f_prev), scaled_byte(c_cur)], dim=-1)


# ---------------------------------------------------------------------------
# params / cond net
# ---------------------------------------------------------------------------

def init_wavernn(generator: torch.Generator, cfg: WaveRNNConfig) -> Dict:
    """Random parameters drawn from ``generator``, on its device."""
    H = cfg.hidden_units
    in_dim = cfg.input_dim + cfg.cond_dim
    dev = generator.device
    if cfg.dual:
        Hh = H // 2
        return {
            "cond": init_dense(generator, cfg.cond_in_dim, cfg.cond_dim),
            "gru": {
                "w_ih": xavier_uniform(generator, (3 * H, in_dim)) * dual_input_mask(cfg, dev),
                "w_hh": xavier_uniform(generator, (3 * H, H)),
                "b_ih": torch.zeros((3 * H,), device=dev),
                "b_hh": torch.zeros((3 * H,), device=dev),
            },
            "O1": init_dense(generator, Hh, Hh),
            "O2": init_dense(generator, Hh, cfg.n_classes),
            "O3": init_dense(generator, Hh, Hh),
            "O4": init_dense(generator, Hh, cfg.n_classes),
        }
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
    w_cond = params["gru"]["w_ih"][:, cfg.input_dim:]
    return cond @ w_cond.T + params["gru"]["b_ih"]


def _logits(params: Dict, h: torch.Tensor) -> torch.Tensor:
    f = torch.relu(h @ params["fc1"]["w"].T + params["fc1"]["b"])
    return f @ params["fc2"]["w"].T + params["fc2"]["b"]


def dual_head(params: Dict, head: int, y: torch.Tensor) -> torch.Tensor:
    """The coarse (head 0: O1, O2) or fine (head 1: O3, O4) logits of a half
    ``y`` (..., H/2) of the hidden state."""
    a, b = (params["O1"], params["O2"]) if head == 0 else (params["O3"], params["O4"])
    return torch.relu(y @ a["w"].T + a["b"]) @ b["w"].T + b["b"]


def dual_teacher_forced_logits(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                               u16: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward of the dual output from h = 0: cond (B, T,
    cond_dim), u16 (B, T) the ground-truth samples (the first step's
    previous sample c = 128, f = 0).  Returns (coarse logits, fine logits
    (B, T, n_classes), h_T), through the recurrence ``teacher_forced_logits``
    uses."""
    c, f = split16(u16.long())
    c_prev = torch.cat([torch.full_like(c[:, :1], 128), c[:, :-1]], dim=1)
    f_prev = torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], dim=1)
    x = dual_inputs(c_prev, f_prev, c)
    h0 = torch.zeros((cond.shape[0], cfg.hidden_units), dtype=cond.dtype, device=cond.device)
    recurrence = plain_recurrence if cond.device.type == "cpu" else cudnn_recurrence
    hs = recurrence(params, cfg, cond, x, h0)
    Hh = cfg.hidden_units // 2
    return dual_head(params, 0, hs[..., :Hh]), dual_head(params, 1, hs[..., Hh:]), hs[:, -1]


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
    gates hoisted: (B, T, cond_dim), (B, T) previous indices (the dual
    output: (B, T, 3) inputs x_t) -> hidden states (B, T, H)."""
    H = cfg.hidden_units
    if cfg.dual:
        gates_x = cond_gates(params, cfg, cond) + prev_idx @ dual_input_weights(params, cfg).T
    else:
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
    w_ih = g["w_ih"]
    if cfg.dual:   # the inputs x_t, and the mask on the weights
        x = torch.cat([prev_idx, cond], dim=-1)
        w_ih = w_ih * dual_input_mask(cfg, w_ih.device)
    else:
        x = torch.cat([params["embed"][prev_idx], cond], dim=-1)
    with full_f32_cudnn():
        hs, _ = torch._VF.gru(x, h0[None].contiguous(), [w_ih, g["w_hh"], g["b_ih"], g["b_hh"]],
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
    """Teacher-forced NLL: feats (B, F, feat_dim), wav (B, F*hop) in [-1, 1].
    The dual output: the coarse head's mean cross-entropy plus the fine
    head's."""
    cond = upsample_cond(params, cfg, feats)
    if cfg.dual:
        u16 = pcm16_encode(wav).long()
        c, f = split16(u16)
        lc, lf, _ = dual_teacher_forced_logits(params, cfg, cond, u16)
        nll = lambda logits, idx: -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                                idx[..., None])[..., 0].mean()
        return nll(lc, c) + nll(lf, f)
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
    cond (T, cond_dim) -> sampled mu-law indices (T,) int32; the dual
    output: 16-bit samples u16 = c * 256 + f (T,) int32.

    Sampled mode (``temperature > 0``) adds Gumbel noise -log(-log(u)) to
    ``logits / temperature`` and takes the argmax; the uniforms ``u`` (T,
    n_classes), dual (T, 2, n_classes) a head each, in [1e-9, 1) are drawn
    from ``generator``, or handed in."""
    gumbel = None
    if temperature > 0:
        T, K = cond.shape[0], cfg.n_classes
        if u is None:
            u = (torch.rand((T, 2, K) if cfg.dual else (T, K), generator=generator,
                            device=cond.device) * (1.0 - 1e-9) + 1e-9)
        g = -torch.log(-torch.log(u.to(device=cond.device, dtype=_F32))).reshape(T, -1, K)
        gumbel = lambda t0, n, head: g[t0:t0 + n, head, None]
    return plain_sampler(params, cfg, cond[None], gumbel, temperature)[0]


def plain_sampler(params: Dict, cfg: WaveRNNConfig, cond: torch.Tensor,
                  gumbel: Optional[Callable[[int, int, int], torch.Tensor]] = None,
                  temperature: float = 1.0, margins: bool = False):
    """The AR sampler, step by step, float32, with the numerics of K4 and of
    its dual instantiation.  cond (B, T, cond_dim); ``gumbel(t0, n, head)``
    gives the noise (n, B, n_classes) of steps [t0, t0 + n) of a head (the
    mu-law output's is head 0; the dual's coarse head 0, fine head 1),
    drawn 4,096 steps at a time: the scores are logits / max(temperature,
    1e-6) + noise, and without it the logits; a head's sample is the argmax.

    A mu-law step: the conditioning gates plus the gate-table row of the
    previous sample (K // 2 at t = 0, with h = 0), ``_gru_cell``,
    ``_logits``.  A dual step: R h_{t-1} for both halves; the coarse half's
    gates, the conditioning gates plus x_t w_in one input at a time (x_t =
    [c~_{t-1}, f~_{t-1}, c~_{t-1}]: the mask zeroes the last column there),
    its head and c_t; then the fine half's with c~_t, its head and f_t.

    Returns (B, T) int32 samples: mu-law indices, or the dual's 16-bit
    samples u16 = c * 256 + f; with ``margins``, also float32 tensors of
    each head's gap between its two largest scores and its largest |score|,
    (B, T) for the mu-law output and (B, T, 2) for the dual."""
    B, T, _ = cond.shape
    H, K = cfg.hidden_units, cfg.n_classes
    Hh, dev = H // 2, cond.device
    n_heads = 2 if cfg.dual else 1
    f32 = lambda d: {n: t.to(_F32) for n, t in d.items()}
    gates = cond_gates(params, cfg, cond.to(_F32)).to(_F32)
    whh, bhh = params["gru"]["w_hh"].to(_F32), params["gru"]["b_hh"].to(_F32)
    if cfg.dual:
        # rows of each half: [r, z, n] of the coarse units, then of the fine ones
        perm = torch.cat([torch.arange(gi * H + p * Hh, gi * H + p * Hh + Hh, device=dev)
                          for p in (0, 1) for gi in range(3)])
        gates, whh, bhh = gates[..., perm], whh[perm], bhh[perm]
        w_in = dual_input_weights(params, cfg).to(_F32)[perm]
        heads = {k: f32(params[k]) for k in ("O1", "O2", "O3", "O4")}
    else:
        emb_tab = embed_gate_table(params).to(_F32)
        heads = {k: f32(params[k]) for k in ("fc1", "fc2")}
    # a tensor divisor, so that the division is a true division on every device
    tdiv = torch.full((1,), max(temperature, 1e-6), dtype=_F32, device=dev)

    h = torch.zeros((B, H), dtype=_F32, device=dev)
    c = torch.full((B,), K // 2, dtype=torch.int64, device=dev)   # mu-law: the previous sample
    f = torch.zeros((B,), dtype=torch.int64, device=dev)
    out = torch.empty((B, T), dtype=torch.int32, device=dev)
    gap = torch.empty((B, T, n_heads), dtype=_F32, device=dev) if margins else None
    scale = torch.empty((B, T, n_heads), dtype=_F32, device=dev) if margins else None

    def pick(logits: torch.Tensor, t: int, head: int, noise) -> torch.Tensor:
        scores = logits / tdiv + noise if noise is not None else logits
        if margins:
            top2 = torch.topk(scores, min(2, K), dim=-1).values
            gap[:, t, head] = top2[:, 0] - top2[:, -1]
            scale[:, t, head] = scores.abs().amax(dim=-1)
        return torch.argmax(scores, dim=-1)

    for t0 in range(0, T, 4096):     # bounds the noise drawn at once
        n = min(4096, T - t0)
        noise = [gumbel(t0, n, p) for p in range(n_heads)] if gumbel is not None else None
        for s in range(n):
            t = t0 + s
            noise_s = [z[s] for z in noise] if noise is not None else [None] * n_heads
            if not cfg.dual:
                h = _gru_cell(gates[:, t] + emb_tab[c], h, whh, bhh, H)
                c = pick(_logits(heads, h), t, 0, noise_s[0])
                out[:, t] = c
                continue
            gh = h @ whh.T + bhh                                   # R h_{t-1}, both halves
            halves, cur = [], c
            for p in (0, 1):
                rows = slice(3 * Hh * p, 3 * Hh * (p + 1))
                x = dual_inputs(c, f, cur)                         # c~_t: c_{t-1} for the coarse half
                gx = gates[:, t, rows]
                for i in range(3):
                    gx = gx + x[:, i:i + 1] * w_in[rows, i]
                ghp = gh[:, rows]
                r = torch.sigmoid(gx[:, :Hh] + ghp[:, :Hh])
                z = torch.sigmoid(gx[:, Hh:2 * Hh] + ghp[:, Hh:2 * Hh])
                nn = torch.tanh(gx[:, 2 * Hh:] + r * ghp[:, 2 * Hh:])
                y = (1.0 - z) * nn + z * h[:, p * Hh:(p + 1) * Hh]
                cur = pick(dual_head(heads, p, y), t, p, noise_s[p])
                halves.append(y)
                if p == 0:
                    c_t = cur
            h = torch.cat(halves, dim=-1)
            c, f = c_t, cur
            out[:, t] = c * 256 + f
    if not margins:
        return out
    return (out, gap, scale) if cfg.dual else (out, gap[..., 0], scale[..., 0])
