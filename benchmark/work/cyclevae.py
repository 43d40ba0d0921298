"""Model FLOPs of the CycleVAE per real frame (multiply-adds x 2, matrix
products only): the conv window product, the GRU's input and hidden
products, the output projection.  After the JAX package's and the port's
``tools/bench.py`` ``flops_per_frame``: 93,706,832 a trained frame for the
one-to-one flagship (per cycle 2 encoder passes of 10,274,120 and 3 decoder
passes of 8,768,392, two cycles)."""

from __future__ import annotations

from typing import Dict


def net_flops(m: Dict, in_dim: int, out_dim: int) -> float:
    H = m["hidden_units"]
    rec = m["kernel_size"] ** m["dilation_size"]
    conv_dim = in_dim * rec
    conv = in_dim * rec * conv_dim
    gru = 3 * H * (conv_dim + out_dim) + 3 * H * H
    return 2.0 * (conv + gru + H * out_dim)


def encoder_flops(m: Dict) -> float:
    return net_flops(m, m["in_dim"], 2 * m["lat_dim"])


def decoder_flops(m: Dict) -> float:
    return net_flops(m, m["n_spk"] + m["lat_dim"], m["out_dim"])


def train_flops_per_frame(m: Dict) -> float:
    """One trained frame's forward: per cycle the encoder twice (the input,
    the converted) and the decoder three times (reconstruction, conversion,
    cyclic reconstruction)."""
    return m["n_cyc"] * (2 * encoder_flops(m) + 3 * decoder_flops(m))
