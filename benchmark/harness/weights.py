"""Random weights made on the device from the seed, in a few large draws.

The layout is the reference's (``reference/cyclevae.py``): per net ``conv``
{"w": [..], "b": [..]}, ``gru`` {w_ih, w_hh, b_ih, b_hh}, ``out`` {w, b}, and
the frozen scalers.  Weights are Xavier-uniform (the recipe's
initialisation); biases, which the recipe starts at zero, are drawn small
and non-zero so that their paths carry a signal."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BIAS = 0.05


def _shapes_cyclevae(m: Dict) -> Dict[str, List[Tuple[str, tuple]]]:
    k, L, H = m["kernel_size"], m["dilation_size"], m["hidden_units"]
    nets = {}
    for net, d_in, d_out in (("encoder", m["in_dim"], 2 * m["lat_dim"]),
                             ("decoder", m["lat_dim"] + m["n_spk"], m["out_dim"])):
        leaves = []
        for l in range(L):
            leaves += [(f"conv.w.{l}", (d_in * k ** (l + 1), d_in * k ** l, k)),
                       (f"conv.b.{l}", (d_in * k ** (l + 1),))]
        conv_dim = d_in * k ** L
        leaves += [("gru.w_ih", (3 * H, conv_dim + d_out)), ("gru.w_hh", (3 * H, H)),
                   ("gru.b_ih", (3 * H,)), ("gru.b_hh", (3 * H,)),
                   ("out.w", (d_out, H)), ("out.b", (d_out,))]
        nets[net] = leaves
    return nets


def _bound(shape: tuple) -> float:
    if len(shape) == 1:
        return BIAS
    rf = shape[2] if len(shape) == 3 else 1
    return math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))


def _fill(generator: torch.Generator, leaves: List[Tuple[str, tuple]], device) -> Dict:
    """One uniform draw for all leaves, cut and scaled."""
    n = sum(math.prod(s) for _, s in leaves)
    flat = torch.empty(n, device=device).uniform_(-1.0, 1.0, generator=generator)
    out, at = {}, 0
    for name, s in leaves:
        size = math.prod(s)
        out[name] = flat[at:at + size].reshape(s) * _bound(s)
        at += size
    return out


def cyclevae(generator: torch.Generator, m: Dict, mean: torch.Tensor, scale: torch.Tensor
             ) -> Dict:
    """Both nets of the CycleVAE; the encoder's input scaler and the
    decoder's output scaler from the given feature statistics."""
    dev = generator.device
    p = {}
    for net, leaves in _shapes_cyclevae(m).items():
        flat = _fill(generator, leaves, dev)
        L = m["dilation_size"]
        p[net] = {"conv": {"w": [flat[f"conv.w.{l}"] for l in range(L)],
                           "b": [flat[f"conv.b.{l}"] for l in range(L)]},
                  "gru": {k: flat[f"gru.{k}"] for k in ("w_ih", "w_hh", "b_ih", "b_hh")},
                  "out": {"w": flat["out.w"], "b": flat["out.b"]}}
    p["encoder"]["scale_in"] = {"mean": mean.to(dev), "scale": scale.to(dev)}
    st = m["stdim"]
    p["decoder"]["scale_out"] = {"mean": mean[st:].to(dev), "scale": scale[st:].to(dev)}
    return p


def wavernn(generator: torch.Generator, v: Dict) -> Dict:
    """The WaveRNN's embedding, conditioning net, GRU and two output layers."""
    H, K, E, C, FC = (v["hidden_units"], v["n_classes"], v["embed_dim"], v["cond_dim"],
                      v["fc_dim"])
    leaves = [("embed", (K, E)), ("cond.w", (C, v["feat_dim"] + v["n_spk"])), ("cond.b", (C,)),
              ("gru.w_ih", (3 * H, E + C)), ("gru.w_hh", (3 * H, H)), ("gru.b_ih", (3 * H,)),
              ("gru.b_hh", (3 * H,)), ("fc1.w", (FC, H)), ("fc1.b", (FC,)),
              ("fc2.w", (K, FC)), ("fc2.b", (K,))]
    flat = _fill(generator, leaves, generator.device)
    return {"embed": flat["embed"],
            "cond": {"w": flat["cond.w"], "b": flat["cond.b"]},
            "gru": {k: flat[f"gru.{k}"] for k in ("w_ih", "w_hh", "b_ih", "b_hh")},
            "fc1": {"w": flat["fc1.w"], "b": flat["fc1.b"]},
            "fc2": {"w": flat["fc2.w"], "b": flat["fc2.b"]}}


def clone(tree):
    """A deep copy of a tree of tensors (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree.detach().clone()


def as_port(p: Dict) -> Dict:
    """The same tensors in the program's layout: a net's ``gru`` is a list of
    layers."""
    return {net: {k: ([v] if k == "gru" else v) for k, v in p[net].items()} for net in p}
