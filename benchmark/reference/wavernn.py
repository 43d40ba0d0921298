"""Plain float32 reference of the WaveRNN rendering (Kalchbrenner et al.,
arXiv:1802.08435, the single-GRU sampler of the cyclevae-vc recipe): the
conditioning net and its upsampling, and, teacher-forced on a rendering's own
sampled indices, every step's scores, so that each sampled index can be
judged against the best one.

Sampling rule the indices are judged by: at step t the scores are
``logits / max(temperature, 1e-6) + g`` with Gumbel noise
``g = -log(-log(u + 1e-9) + 1e-9)``, ``u = (bits & 0x7fffff) * 2**-23``, the
bits the Philox4x32-10 word of counter (t, row, k // 4, 0) and key (seed, 0)
for class k, and the sample is the argmax.  Philox4x32-10 is written out
below from Salmon et al., SC'11 (Random123), in int64 arithmetic.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Tuple

import torch

F32 = torch.float32
MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lo16 = a * (b & 0xFFFF)
    s = a * (b >> 16) + (lo16 >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (lo16 & 0xFFFF)


def philox(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10: counter (..., 4), key (..., 2) int64 holding 32-bit
    values -> (..., 4) words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], -1)


def gumbel(seed: int, t0: int, T: int, K: int, device, row: int = 0) -> torch.Tensor:
    """(T, K) Gumbel noise of steps [t0, t0 + T) of one row."""
    words = (K + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    t = torch.arange(t0, t0 + T, **i64)[:, None].expand(T, words)
    w = torch.arange(words, **i64)[None].expand(T, words)
    counter = torch.stack([t, torch.full_like(t, row), w, torch.zeros_like(t)], -1)
    key = torch.tensor([seed & MASK32, 0], **i64)
    bits = philox(counter, key).reshape(T, 4 * words)[:, :K]
    u = (bits & 0x7FFFFF).to(F32) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u + 1e-9) + 1e-9)


def n_samples(n_frames: int, hop: float) -> int:
    fr = Fraction(hop).limit_denominator(1000)
    return n_frames * fr.numerator // fr.denominator


def upsample(p: Dict, feats: torch.Tensor, hop: float) -> torch.Tensor:
    """(F, feat_dim) frames -> (N, cond_dim): tanh(dense(feats)) and linear
    interpolation at frame position (n + 0.5) * F / N - 0.5 of sample n."""
    c = torch.tanh(feats @ p["cond"]["w"].T + p["cond"]["b"])
    F = c.shape[0]
    N = n_samples(F, hop)
    pos = (torch.arange(N, dtype=F32, device=c.device) + 0.5) * (F / N) - 0.5
    i0 = torch.clamp(torch.floor(pos).long(), 0, F - 1)
    i1 = torch.clamp(i0 + 1, max=F - 1)
    w = torch.clamp(pos - i0, 0.0, 1.0)[:, None]
    return c[i0] * (1.0 - w) + c[i1] * w


def mulaw_table(K: int, device) -> torch.Tensor:
    """The waveform value of each of the K mu-law classes."""
    mu = K - 1
    y = 2.0 * torch.arange(K, dtype=F32, device=device) / mu - 1.0
    return torch.sign(y) * torch.expm1(torch.abs(y) * math.log1p(mu)) / mu


def classes_of(wave: torch.Tensor, K: int) -> torch.Tensor:
    """The class index of each sample of a rendered waveform (the nearest
    class value)."""
    tab = mulaw_table(K, wave.device)
    i = torch.clamp(torch.searchsorted(tab, wave), 1, K - 1)
    lower = (wave - tab[i - 1]).abs() <= (tab[i] - wave).abs()
    return torch.where(lower, i - 1, i)


@torch.no_grad()
def score_gaps(p: Dict, cond: torch.Tensor, idx: torch.Tensor, seed: int,
               temperature: float, chunk: int = 2048) -> torch.Tensor:
    """For a rendering's indices ``idx`` (N,) over conditioning ``cond`` (N,
    cond_dim): each step's gap (best score - score of the index taken) /
    largest |score|, with the GRU driven by the rendering's own previous
    indices (teacher forcing; the first step's previous index is K // 2)."""
    H = p["gru"]["w_hh"].shape[1]
    K = p["fc2"]["w"].shape[0]
    prev = torch.cat([torch.full((1,), K // 2, device=idx.device, dtype=torch.long),
                      idx[:-1].long()])
    x = torch.cat([p["embed"][prev], cond], -1)[None]             # (1, N, E + C)
    gru = torch.nn.GRU(x.shape[-1], H, batch_first=True).to(cond.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(p["gru"]["w_ih"])
        gru.weight_hh_l0.copy_(p["gru"]["w_hh"])
        gru.bias_ih_l0.copy_(p["gru"]["b_ih"])
        gru.bias_hh_l0.copy_(p["gru"]["b_hh"])
    # the recurrence in pieces of ``chunk`` steps, the state carried: one
    # library call over a whole rendering's 10**5 steps is refused
    hs, h = [], None
    for t0 in range(0, x.shape[1], chunk):
        y, h = gru(x[:, t0:t0 + chunk].contiguous(), h)
        hs.append(y)
    hs = torch.cat(hs, 1)
    out = torch.empty(idx.shape[0], dtype=F32, device=cond.device)
    tdiv = max(temperature, 1e-6)
    for t0 in range(0, idx.shape[0], chunk):
        h = hs[0, t0:t0 + chunk]
        logits = torch.relu(h @ p["fc1"]["w"].T + p["fc1"]["b"]) @ p["fc2"]["w"].T + p["fc2"]["b"]
        s = logits / tdiv
        if temperature > 0:
            s = s + gumbel(seed, t0, h.shape[0], K, cond.device)
        taken = s.gather(1, idx[t0:t0 + chunk].long()[:, None])[:, 0]
        out[t0:t0 + h.shape[0]] = (s.amax(1) - taken) / s.abs().amax(1)
    return out
