"""Plain float32 reference of the published WaveRNN-896 (Kalchbrenner et al.,
"Efficient Neural Audio Synthesis", ICML 2018, arXiv:1802.08435, section 2,
eq. 2 and Fig. 1): its dual 8-bit coarse / fine softmax over 16-bit audio.
It imports nothing of the program under test.

The model, in torch's GRU conventions (gate rows [r, z, n], ``b_hh``'s n
part inside r * (...); the paper's u = z and e = n).  A 16-bit sample s is
u16 = s + 32768, coarse c = u16 >> 8, fine f = u16 & 255, and the waveform
value s / 32768.  With v~ = v / 127.5 - 1 and H = 896 split into halves of
Hh = 448:
  x_t = [c~_{t-1}, f~_{t-1}, c~_t]
  gx  = cond_gates_t + (I * M) x_t,  gh = R h_{t-1} + b_hh,  R (3H, H)
  r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z), n = tanh(gx_n + r gh_n)
  h_t = (1 - z) n + z h_{t-1} = [y_c, y_f]
  P(c_t) = softmax(O2 relu(O1 y_c + b1) + b2)
  P(f_t) = softmax(O4 relu(O3 y_f + b3) + b4)
M zeroes the c~_t column on the coarse half's rows of every gate: the
current coarse sample reaches only the fine half.

Departures from the paper, each a choice the paper leaves open or a part of
the recipe it is run in:
  * biases: the paper's eq. 2 writes none on the gates; here b_ih and b_hh
    as torch's GRU has them, and b1..b4 on the output layers;
  * conditioning: the paper's WaveRNN is shown unconditioned; here the
    recipe's acoustic features (54-d) go through dense + tanh to 128 and
    are interpolated to each sample at the fractional hop (110.25 samples
    at 22.05 kHz; ``reference/wavernn.py``'s ``upsample``), and enter all
    3H gate rows through ``w_ih``'s conditioning columns (``cond_gates``);
  * O1 and O3 are Hh x Hh (448 x 448): the paper gives their output width
    only through Fig. 1, where each half's first output layer keeps the
    half's width;
  * the inputs are scaled to [-1, 1] as v / 127.5 - 1;
  * the first step sees c = 128, f = 0 (silence, s = 0) and h = 0;
  * the sampler's rule (as the program's): each head's scores are its
    logits / max(temperature, 1e-6) plus Gumbel noise from Philox4x32-10,
    key (seed, 0) and counter (t, row, k // 4, head) (``reference/wavernn.py``'s
    words, counter word 3 the head), and the sample is their argmax.

Everything is float32 with TF32 off for matrix products and cuDNN.  The
teacher-forced recurrence runs in chunks (the state carried), so that a
rendering of 10**5 steps fits one library call at a time.
"""

import torch

from benchmark.reference.wavernn import MASK32, n_samples, philox, upsample

F32 = torch.float32
HEADS = (("O1", "O2"), ("O3", "O4"))
__all__ = ["encode16", "decode16", "bytes_of", "input_mask", "gumbel", "teacher_forced",
           "head_logits", "score_gaps", "loss", "n_samples", "upsample"]


def _full_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def encode16(x: torch.Tensor) -> torch.Tensor:
    """Waveform values in [-1, 1) -> u16 = s + 32768 (int64), s the nearest
    16-bit value of 32768 x (halves up), clipped."""
    s = torch.clamp(torch.floor(x.double() * 32768.0 + 0.5), -32768, 32767)
    return s.long() + 32768


def decode16(u16: torch.Tensor) -> torch.Tensor:
    return (u16.long() - 32768).to(F32) / 32768.0


def bytes_of(wave: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(coarse, fine) of each sample of a rendered 16-bit waveform."""
    u16 = encode16(wave)
    return u16 >> 8, u16 & 255


def input_mask(H: int, n_in: int, device) -> torch.Tensor:
    """M: (3H, n_in) ones, the c~_t column (2) zero on each gate's coarse rows."""
    m = torch.ones((3 * H, n_in), dtype=F32, device=device)
    for g in range(3):
        m[g * H:g * H + H // 2, 2] = 0.0
    return m


def gumbel(seed: int, t0: int, T: int, K: int, device, row: int = 0,
           head: int = 0) -> torch.Tensor:
    """(T, K) Gumbel noise of one head for steps [t0, t0 + T) of one row."""
    words = (K + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    t = torch.arange(t0, t0 + T, **i64)[:, None].expand(T, words)
    w = torch.arange(words, **i64)[None].expand(T, words)
    counter = torch.stack([t, torch.full_like(t, row), w, torch.full_like(t, head)], -1)
    key = torch.tensor([seed & MASK32, 0], **i64)
    bits = philox(counter, key).reshape(T, 4 * words)[:, :K]
    u = (bits & 0x7FFFFF).to(F32) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u + 1e-9) + 1e-9)


def _inputs(c: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """x_t for samples (B, N) of coarse and fine bytes: (B, N, 3)."""
    s = lambda v: v.to(F32) / 127.5 - 1.0
    c_prev = torch.cat([torch.full_like(c[:, :1], 128), c[:, :-1]], 1)
    f_prev = torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], 1)
    return torch.stack([s(c_prev), s(f_prev), s(c)], -1)


def teacher_forced(p: dict, cond: torch.Tensor, c: torch.Tensor, f: torch.Tensor,
                   chunk: int = 2048) -> torch.Tensor:
    """Hidden states (B, N, H) of the GRU driven by the samples' own bytes
    c, f (B, N) over conditioning ``cond`` (B, N, cond_dim); differentiable
    in ``p``'s tensors (the GRU's weights are ``p``'s, the mask applied)."""
    _full_f32()
    H = p["gru"]["w_hh"].shape[1]
    x = torch.cat([_inputs(c, f), cond], -1)
    weights = {"weight_ih_l0": p["gru"]["w_ih"] * input_mask(H, x.shape[-1], cond.device),
               "weight_hh_l0": p["gru"]["w_hh"], "bias_ih_l0": p["gru"]["b_ih"],
               "bias_hh_l0": p["gru"]["b_hh"]}
    gru = torch.nn.GRU(x.shape[-1], H, batch_first=True, device=cond.device)
    hs, h = [], None
    for t0 in range(0, x.shape[1], chunk):
        y, h = torch.func.functional_call(gru, weights, (x[:, t0:t0 + chunk].contiguous(), h))
        hs.append(y)
    return torch.cat(hs, 1)


def head_logits(p: dict, head: int, y: torch.Tensor) -> torch.Tensor:
    """The coarse (0) or fine (1) head's logits of a half of h (..., Hh)."""
    a, b = (p[n] for n in HEADS[head])
    return torch.relu(y @ a["w"].T + a["b"]) @ b["w"].T + b["b"]


@torch.no_grad()
def score_gaps(p: dict, cond: torch.Tensor, c: torch.Tensor, f: torch.Tensor, seed: int,
               temperature: float, chunk: int = 2048,
               row: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """For a rendering's bytes c, f (N,) over conditioning ``cond`` (N,
    cond_dim), batch row ``row`` of its call: each step's gap (best score -
    score of the byte taken) / largest |score|, of the coarse head and of
    the fine head, with the GRU driven by the rendering's own samples
    (teacher forcing)."""
    hs = teacher_forced(p, cond[None], c[None], f[None], chunk)[0]
    Hh = hs.shape[-1] // 2
    K = p["O2"]["w"].shape[0]
    tdiv = max(temperature, 1e-6)
    gaps = []
    for head, (idx, y) in enumerate(((c, hs[:, :Hh]), (f, hs[:, Hh:]))):
        out = torch.empty(idx.shape[0], dtype=F32, device=cond.device)
        for t0 in range(0, idx.shape[0], chunk):
            s = head_logits(p, head, y[t0:t0 + chunk]) / tdiv
            if temperature > 0:
                s = s + gumbel(seed, t0, s.shape[0], K, cond.device, row=row, head=head)
            taken = s.gather(1, idx[t0:t0 + chunk].long()[:, None])[:, 0]
            out[t0:t0 + s.shape[0]] = (s.amax(1) - taken) / s.abs().amax(1)
        gaps.append(out)
    return gaps[0], gaps[1]


def loss(p: dict, cond: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
    """The training loss: the coarse head's mean cross-entropy plus the fine
    head's, teacher-forced; cond (B, N, cond_dim), wav (B, N) in [-1, 1)."""
    c, f = bytes_of(wav)
    hs = teacher_forced(p, cond, c, f)
    Hh = hs.shape[-1] // 2
    ce = lambda logits, idx: torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), idx.reshape(-1))
    return ce(head_logits(p, 0, hs[..., :Hh]), c) + ce(head_logits(p, 1, hs[..., Hh:]), f)
