"""Parallel WaveGAN's generator: a non-autoregressive neural vocoder.

Yamamoto, Song, Kim, "Parallel WaveGAN", ICASSP 2020, arXiv:1910.11480,
sections 3-4; the published generator is ``parallel_wavegan.v1.yaml`` of
github.com/kan-bayashi/ParallelWaveGAN: 30 layers in 3 stacks of dilated
convolutions (kernel 3, dilation 2^(l mod 10)), 64 residual, 128 gate and 64
skip channels, the conditioning upsampled by ``ConvInUpsampleNetwork``
(context window 2, scales [4, 4, 4, 4]: a hop of 256 samples at 22.05 kHz).
The JAX package has no counterpart: this is the port's own addition, held to
``benchmark/reference/pwg.py``.

With x the (B, R, n) residual stream, c the (B, A, n) upsampled conditioning
and d = 2^(l mod layers_per_stack), layer l computes
  a    = W_dil *_d x + b_dil + W_aux c          (G channels, zero padding d)
  g    = tanh(a[:G/2]) * sigmoid(a[G/2:])
  x   <- (x + W_out g + b_out) * sqrt(1/2),   skip <- skip + W_skip g + b_skip
around a first 1x1 convolution of the noise z ~ N(0, 1) (n = frames x hop)
and, after the stack, ReLU, 1x1 (S -> S), ReLU, 1x1 (S -> 1) on
skip * sqrt(1/layers).

Parameters are plain dicts of tensors, weight norm folded (PWG's inference
removes it; ``from_state_dict`` folds a trained generator's at load):
  upsample: conv_in (A, A, 2w+1), no bias; kernels: one (2s+1,) a scale,
            the Conv2d (1, 2s+1) of PWG's UpsampleNetwork, no bias
  first:    w (R, 1), b (R,)
  layers:   stacked over the L layers: dil_w (L, G, R, k), dil_b (L, G),
            aux_w (L, G, A), out_w (L, R, G/2), out_b (L, R),
            skip_w (L, S, G/2), skip_b (L, S)
  last:     w1 (S, S), b1 (S,), w2 (1, S), b2 (1,)

On a CUDA tensor the residual stack runs the fused layer kernel
(``ops/cuda_pwg.py``, one launch a layer); on a CPU tensor its plain
version.  A CUDA tensor never falls back: the kernel launches or the call
raises.  The upsampling and the first and last convolutions are plain torch
(cuDNN with TF32 off, float32 matrix products) on either device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..ops import cuda_pwg
from ..utils.profiling import count
from .wavernn import full_f32_cudnn

_F32 = torch.float32


@dataclass(frozen=True)
class PWGConfig:
    layers: int = 30
    stacks: int = 3
    kernel_size: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    # the recipe's 54-d WORLD features in place of the published 80 mel bands
    aux_channels: int = 54
    aux_context_window: int = 2
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    fs: int = 22050

    def __post_init__(self):
        # the layer kernel and its plain version take the published 3 taps
        if self.layers % self.stacks or self.kernel_size != 3 or self.gate_channels % 2:
            raise ValueError(f"layers {self.layers} must fill {self.stacks} stacks, the "
                             f"kernel ({self.kernel_size}) be 3 and the gate channels "
                             f"({self.gate_channels}) even")
        object.__setattr__(self, "upsample_scales", tuple(int(s) for s in self.upsample_scales))

    @property
    def hop(self) -> int:
        """Samples per frame: the product of the upsampling scales."""
        return math.prod(self.upsample_scales)

    def dilation(self, layer: int) -> int:
        return 2 ** (layer % (self.layers // self.stacks))


def init_pwg(generator: torch.Generator, cfg: PWGConfig) -> Dict:
    """Random parameters drawn from ``generator``, on its device, as PWG
    initialises them: convolution weights Kaiming-normal for ReLU (std
    sqrt(2 / fan_in)), biases 0, each upsampling kernel the box 1 / (2s+1)."""
    dev = generator.device
    L, k = cfg.layers, cfg.kernel_size
    R, G, S, A = (cfg.residual_channels, cfg.gate_channels, cfg.skip_channels,
                  cfg.aux_channels)

    def kaiming(*shape, fan_in):
        w = torch.empty(shape, dtype=_F32, device=dev)
        return w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)

    zeros = lambda *shape: torch.zeros(shape, dtype=_F32, device=dev)
    w = 2 * cfg.aux_context_window + 1
    return {
        "upsample": {"conv_in": kaiming(A, A, w, fan_in=A * w),
                     "kernels": [torch.full((2 * s + 1,), 1.0 / (2 * s + 1), device=dev)
                                 for s in cfg.upsample_scales]},
        "first": {"w": kaiming(R, 1, fan_in=1), "b": zeros(R)},
        "layers": {"dil_w": kaiming(L, G, R, k, fan_in=R * k), "dil_b": zeros(L, G),
                   "aux_w": kaiming(L, G, A, fan_in=A),
                   "out_w": kaiming(L, R, G // 2, fan_in=G // 2), "out_b": zeros(L, R),
                   "skip_w": kaiming(L, S, G // 2, fan_in=G // 2), "skip_b": zeros(L, S)},
        "last": {"w1": kaiming(S, S, fan_in=S), "b1": zeros(S),
                 "w2": kaiming(1, S, fan_in=S), "b2": zeros(1)},
    }


# ---------------------------------------------------------------------------
# Loading a trained generator
# ---------------------------------------------------------------------------

def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g v / ||v||, the norm over every dimension but the first (torch's
    ``weight_norm`` at dim 0, PWG's)."""
    norm = v.flatten(1).norm(dim=1).reshape((-1,) + (1,) * (v.dim() - 1))
    return g.reshape(norm.shape) * v / norm


def _weight(sd: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    """The weight of the module ``name`` in a state dict: plain, or weight
    norm's g and v (``weight_g`` / ``weight_v``, or the parametrization's
    ``original0`` / ``original1``), folded."""
    for g, v in ((f"{name}.weight_g", f"{name}.weight_v"),
                 (f"{name}.parametrizations.weight.original0",
                  f"{name}.parametrizations.weight.original1")):
        if g in sd:
            return fold_weight_norm(sd[g].to(_F32), sd[v].to(_F32))
    return sd[f"{name}.weight"].to(_F32)


def from_state_dict(sd: Mapping[str, torch.Tensor], cfg: PWGConfig, device=None) -> Dict:
    """The parameters of a ``ParallelWaveGANGenerator`` state dict
    (kan-bayashi/ParallelWaveGAN's names; a checkpoint's
    ``["model"]["generator"]``), weight norm folded, float32, on ``device``."""
    L = cfg.layers
    layer = lambda l, m: f"conv_layers.{l}.{m}"
    stack = lambda f: torch.stack([f(l) for l in range(L)])
    # the upsampling network's up_layers alternate a stretch and a Conv2d
    ups = [_weight(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}").reshape(-1)
           for i in range(len(cfg.upsample_scales))]
    p = {
        "upsample": {"conv_in": _weight(sd, "upsample_net.conv_in"), "kernels": ups},
        "first": {"w": _weight(sd, "first_conv").reshape(cfg.residual_channels, 1),
                  "b": sd["first_conv.bias"].to(_F32)},
        "layers": {
            "dil_w": stack(lambda l: _weight(sd, layer(l, "conv"))),
            "dil_b": stack(lambda l: sd[f"{layer(l, 'conv')}.bias"].to(_F32)),
            "aux_w": stack(lambda l: _weight(sd, layer(l, "conv1x1_aux"))[..., 0]),
            "out_w": stack(lambda l: _weight(sd, layer(l, "conv1x1_out"))[..., 0]),
            "out_b": stack(lambda l: sd[f"{layer(l, 'conv1x1_out')}.bias"].to(_F32)),
            "skip_w": stack(lambda l: _weight(sd, layer(l, "conv1x1_skip"))[..., 0]),
            "skip_b": stack(lambda l: sd[f"{layer(l, 'conv1x1_skip')}.bias"].to(_F32)),
        },
        "last": {"w1": _weight(sd, "last_conv_layers.1")[..., 0],
                 "b1": sd["last_conv_layers.1.bias"].to(_F32),
                 "w2": _weight(sd, "last_conv_layers.3")[..., 0],
                 "b2": sd["last_conv_layers.3.bias"].to(_F32)},
    }
    dev = torch.device(device) if device is not None else None
    move = lambda t: t.detach().to(dev).contiguous() if dev else t.detach().contiguous()
    return {k: {n: ([move(t) for t in v] if isinstance(v, list) else move(v))
                for n, v in sub.items()} for k, sub in p.items()}


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def upsample(params: Dict, cfg: PWGConfig, c: torch.Tensor) -> torch.Tensor:
    """``ConvInUpsampleNetwork``: c (B, A, T) frames -> (B, A, T * hop).
    Replicate-padded by the context window, conv_in (no bias, no padding),
    then per scale s a nearest stretch by s and the (1, 2s+1) kernel along
    time, the same for every channel, zero-padded by s."""
    B, A, _ = c.shape
    w = cfg.aux_context_window
    with full_f32_cudnn():
        c = F.conv1d(F.pad(c, (w, w), mode="replicate"), params["upsample"]["conv_in"])
        for s, k in zip(cfg.upsample_scales, params["upsample"]["kernels"]):
            c = torch.repeat_interleave(c, s, dim=2)
            c = F.conv1d(c.reshape(B * A, 1, -1), k.reshape(1, 1, -1), padding=s)
    return c.reshape(B, A, -1)


def pack_layers(params: Dict, cfg: PWGConfig):
    """Each layer's two products in the layout the layer kernel and its
    plain version read: w1 (L, Kp, G), the K = k*R + A inputs of a (the
    kernel's taps in order, each R channels of x at offset (j - k//2) d,
    then the A channels of c) by the G gate channels, zero rows past K up to
    Kp, a multiple of 16; b1 (L, G); w2 (L, G/2, R + S), the out and skip
    1x1 convolutions side by side; b2 (L, R + S)."""
    lp = params["layers"]
    L, G, R, k = lp["dil_w"].shape
    K = k * R + cfg.aux_channels
    Kp = -(-K // cuda_pwg.K_CHUNK) * cuda_pwg.K_CHUNK
    taps = lp["dil_w"].permute(0, 3, 2, 1).reshape(L, k * R, G)
    pad = taps.new_zeros((L, Kp - K, G))
    w1 = torch.cat([taps, lp["aux_w"].transpose(1, 2), pad], dim=1).contiguous()
    w2 = torch.cat([lp["out_w"], lp["skip_w"]], dim=1).transpose(1, 2).contiguous()
    b2 = torch.cat([lp["out_b"], lp["skip_b"]], dim=1).contiguous()
    return w1, lp["dil_b"].contiguous(), w2, b2


def pwg_generate(params: Dict, cfg: PWGConfig, c: torch.Tensor, z: torch.Tensor
                 ) -> torch.Tensor:
    """The waveform (B, n) from the upsampled conditioning c (B, A, n) and
    the noise z (B, n): the first 1x1 convolution, the L gated residual
    layers (``cuda_pwg.cuda_pwg_layer``: the kernel on a CUDA tensor), then
    ReLU, 1x1 (S -> S), ReLU, 1x1 (S -> 1) on their skip sum * sqrt(1/L)."""
    p = params["first"]
    x = (p["w"][None] * z[:, None, :] + p["b"][None, :, None]).contiguous()
    c = c.contiguous()
    w1, b1, w2, b2 = pack_layers(params, cfg)
    skip = None
    for l in range(cfg.layers):
        x, skip = cuda_pwg.cuda_pwg_layer(x, c, skip, w1[l], b1[l], w2[l], b2[l],
                                          cfg.dilation(l))
    count("pwg.samples", z.numel())
    p = params["last"]
    h = torch.relu(skip * math.sqrt(1.0 / cfg.layers)).transpose(1, 2)
    h = torch.relu(torch.matmul(h, p["w1"].t()) + p["b1"])
    return (torch.matmul(h, p["w2"].t()) + p["b2"])[..., 0]
