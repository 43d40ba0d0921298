"""Parallel WaveGAN's generator (``cyclevae_tpu_torch/models/pwg.py``) and
its gated residual layer kernel (``csrc/pwg.cu`` ``pwg_layer_kernel``).

Operations of a sample (multiply-adds x 2, the products only): a layer's
(k R + A) x G product (its k dilated taps and the conditioning) and its
G/2 x (R + S) product (the out and skip 1x1 convolutions), 79,360 at the
published widths and A = 54; the generator's L layers, its first 1x1
convolution (1 -> R) and its last two (S -> S, S -> 1): 2,389,248.  The
upsampling network is not counted.  Bytes of a layer: x read and written, c
read, skip written and, past the first layer, read, each once a sample; the
layer's weights read once a launch."""

from __future__ import annotations

from typing import Dict, Tuple


def _widths(v: Dict):
    return (v["kernel_size"], v["residual_channels"], v["gate_channels"], v["skip_channels"],
            v["aux_channels"])


def layer_flops(v: Dict) -> float:
    """Operations of one layer a sample."""
    k, R, G, S, A = _widths(v)
    return 2.0 * ((k * R + A) * G + (G // 2) * (R + S))


def layers_work(v: Dict, n: float) -> Tuple[float, float]:
    """Operations and bytes of the L layer launches over n samples."""
    k, R, G, S, A = _widths(v)
    L = v["layers"]
    weights = (k * R + A) * G + G + (G // 2) * (R + S) + R + S
    nbytes = 4.0 * (L * n * (2 * R + A + S) + (L - 1) * n * S + L * weights)
    return L * n * layer_flops(v), nbytes


def generator_flops(v: Dict) -> float:
    """Operations of the whole generator a sample."""
    R, S = v["residual_channels"], v["skip_channels"]
    return v["layers"] * layer_flops(v) + 2.0 * R + 2.0 * (S * S + S)
