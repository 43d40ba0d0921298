"""Plain float32 reference of Parallel WaveGAN's generator (Yamamoto, Song,
Kim, "Parallel WaveGAN", ICASSP 2020, arXiv:1910.11480, sections 3-4; the
published ``parallel_wavegan.v1.yaml`` of kan-bayashi/ParallelWaveGAN).  It
imports nothing of the program under test.

With x the (B, R, n) residual stream, c the upsampled conditioning and
d = 2^(l mod layers/stacks), layer l:
  a    = W_dil *_d x + b_dil + W_aux c      (G channels, kernel 3, zero padding d)
  g    = tanh(a[:G/2]) * sigmoid(a[G/2:])
  x   <- (x + W_out g + b_out) * sqrt(1/2),   skip <- skip + W_skip g + b_skip
Around the stack: x = W_first z + b_first with z ~ N(0, 1) of length
n = frames x hop; out: ReLU, 1x1 conv S -> S, ReLU, 1x1 conv S -> 1 on
skip * sqrt(1 / layers).  Upsampling (``ConvInUpsampleNetwork``): the
conditioning replicate-padded by the context window w and passed through
conv_in (kernel 2w + 1, no bias, no padding); then for each scale s a
nearest stretch by s (``F.interpolate``) and a Conv2d (1, 2s + 1) with no
bias, padding (0, s).

Parameters: the layout ``benchmark/drivers/vocode_pwg.py`` draws, weight norm
folded (PWG's inference removes it): upsample.conv_in (A, A, 2w+1),
upsample.kernels [(2s+1,)]; first.w (R, 1), first.b; layers stacked over the
layers (dil_w (L, G, R, 3), dil_b, aux_w (L, G, A), out_w (L, R, G/2), out_b,
skip_w (L, S, G/2), skip_b); last.w1 (S, S), b1, w2 (1, S), b2.

Departures from the published v1 generator, each of the configuration's
making (``configs/cyclevae-o2o-hu1024-pwg.json``): A = 54 (the recipe's
WORLD features) in place of 80 mel bands; the weights are random.

Everything is float32 with TF32 off for cuDNN's convolutions and for matrix
products (``precision`` "tf32" turns both on: the control's nearest lower
precision).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(name: str = "float32"):
    """float32 (TF32 off) or "tf32" (on) for cuDNN and matrix products, for
    the body; the flags restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = {"float32": False, "tf32": True}[name]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def upsample(p: Dict, c: torch.Tensor, scales: Sequence[int], window: int) -> torch.Tensor:
    """c (B, A, T) frames -> (B, A, T * prod(scales))."""
    c = F.conv1d(F.pad(c, (window, window), mode="replicate"), p["upsample"]["conv_in"])
    c = c.unsqueeze(1)
    for s, k in zip(scales, p["upsample"]["kernels"]):
        c = F.interpolate(c, scale_factor=(1, s), mode="nearest")
        c = F.conv2d(c, k.reshape(1, 1, 1, -1), padding=(0, s))
    return c.squeeze(1)


def layer(p: Dict, l: int, x: torch.Tensor, c: torch.Tensor, dilation: int):
    """Layer l: (x, c) -> (x', its skip output)."""
    q = {k: v[l] for k, v in p["layers"].items()}
    a = (F.conv1d(x, q["dil_w"], q["dil_b"], padding=dilation, dilation=dilation)
         + F.conv1d(c, q["aux_w"][..., None]))
    xa, xb = a.split(a.shape[1] // 2, dim=1)
    g = torch.tanh(xa) * torch.sigmoid(xb)
    s = F.conv1d(g, q["skip_w"][..., None], q["skip_b"])
    x = (F.conv1d(g, q["out_w"][..., None], q["out_b"]) + x) * math.sqrt(0.5)
    return x, s


def dilation(l: int, layers: int, stacks: int) -> int:
    return 2 ** (l % (layers // stacks))


def generate(p: Dict, v: Dict, feats: torch.Tensor, z: torch.Tensor,
             precision_name: str = "float32") -> torch.Tensor:
    """The waveform (n,) of conditioning ``feats`` (T, A) on the noise z
    (n,), n = T * hop; ``v`` the configuration's ``vocoder`` entry."""
    L, stacks = v["layers"], v["stacks"]
    with precision(precision_name):
        c = upsample(p, feats.t()[None].float(), v["upsample_scales"], v["aux_context_window"])
        x = F.conv1d(z.reshape(1, 1, -1), p["first"]["w"][..., None], p["first"]["b"])
        skips = 0
        for l in range(L):
            x, h = layer(p, l, x, c, dilation(l, L, stacks))
            skips = skips + h
        h = torch.relu(skips * math.sqrt(1.0 / L))
        h = torch.relu(F.conv1d(h, p["last"]["w1"][..., None], p["last"]["b1"]))
        return F.conv1d(h, p["last"]["w2"][..., None], p["last"]["b2"])[0, 0]
