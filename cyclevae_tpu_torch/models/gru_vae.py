"""GRU-RNN VAE nets: encoder / decoder with AR feedback, inference forward.

PyTorch counterpart of ``cyclevae_tpu/models/gru_vae.py``: the same forward
contract ``(trj_out, y_last, h_last) = gru_rnn_apply(params, cfg, x, y_in,
h_in)`` on the same parameter dicts.  Frozen input standardization and output
un-normalization are (mean, scale) vectors; the dilated-conv context
embedding is one window matmul; the GRU input is concat(conv_out[t], y_prev)
with y_prev the model's own previous normalized output; the encoder's
log-variance lanes are clamped at ln 1e-6 (Laplace: at -7.2543...).

The training forward follows the JAX package too: input noise, inverted
dropout on the conv output and on the GRU output (so the AR feedback is
dropped too), and, with ``use_pallas``, the fused kernels with their
hand-derived gradient (``ops.gru_ar_vjp.gru_ar_fused``).  Random numbers
come from a ``Draws`` (a ``torch.Generator``) in the JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .layers import (
    dilconv_effective,
    init_dense,
    init_dilconv,
    init_gru_stack,
    window_gather,
)
from ..ops.cuda_gru import cuda_gru_ar
from ..ops.gru_ar_vjp import gru_ar_fused
from ..ops.gru_scan import gru_ar_scan, precompute_input_gates
from ..utils.tree import tree_map

# ln(1e-6): minimum log-variance lane value (reference gru_vae.py:412)
LOG_VAR_MIN = -13.815510557964274
# Laplace log-scale clamp (reference gru_vae.py:417)
LOG_SCALE_MIN = -7.25432886926211

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class GRURNNConfig:
    in_dim: int = 54
    out_dim: int = 50
    hidden_units: int = 1024
    hidden_layers: int = 1
    kernel_size: int = 3
    dilation_size: int = 2          # number of conv layers; rec field = k**layers
    do_prob: float = 0.0
    scale_in: bool = True
    scale_out: bool = True
    # "bfloat16" runs the conv/GRU/projection products on bf16-rounded
    # operands (float32 master params, normalization, clamps); float32 by
    # default for reference-exact numerics
    compute_dtype: str = "float32"

    @property
    def rec_field(self) -> int:
        return self.kernel_size ** self.dilation_size

    @property
    def conv_dim(self) -> int:
        return self.in_dim * self.rec_field

    @property
    def tot_in_dim(self) -> int:
        return self.conv_dim + self.out_dim


def init_gru_rnn(generator: torch.Generator, cfg: GRURNNConfig) -> Dict:
    """Initialize parameters (xavier-uniform weights, zero biases) on the
    generator's device. Normalization stats start as identity; bake data
    stats in with ``set_scale_stats``."""
    dev = generator.device
    params = {
        "conv": init_dilconv(generator, cfg.in_dim, cfg.kernel_size, cfg.dilation_size),
        "gru": init_gru_stack(generator, cfg.tot_in_dim, cfg.hidden_units, cfg.hidden_layers),
        "out": init_dense(generator, cfg.hidden_units, cfg.out_dim),
    }
    if cfg.scale_in:
        params["scale_in"] = {"mean": torch.zeros((cfg.in_dim,), device=dev),
                              "scale": torch.ones((cfg.in_dim,), device=dev)}
    if cfg.scale_out:
        params["scale_out"] = {"mean": torch.zeros((cfg.out_dim,), device=dev),
                               "scale": torch.ones((cfg.out_dim,), device=dev)}
    return params


def set_scale_stats(params: Dict, mean_in=None, scale_in=None,
                    mean_out=None, scale_out=None) -> Dict:
    """Bake frozen normalization stats (reference train…py:344-347)."""
    params = dict(params)
    dev = params["out"]["w"].device
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    if mean_in is not None:
        params["scale_in"] = {"mean": as_t(mean_in), "scale": as_t(scale_in)}
    if mean_out is not None:
        params["scale_out"] = {"mean": as_t(mean_out), "scale": as_t(scale_out)}
    return params


def init_hidden(cfg: GRURNNConfig, batch: int, device=None) -> torch.Tensor:
    return torch.zeros((cfg.hidden_layers, batch, cfg.hidden_units), device=device)


class Draws:
    """The random numbers of the training forward, drawn from one
    ``torch.Generator`` on its device.  Callers draw in the JAX package's
    order (per ``gru_rnn_apply``: input noise, conv dropout mask, GRU-output
    dropout mask; per cycle of ``vi.train.cyclic_forward``: encoder, z_src,
    z_trg, the 2B decoder, cv encoder, z_cv, cyclic decoder), so a test can
    replay one recorded sequence into both packages by overriding these
    three methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def bernoulli(self, keep: float, shape) -> torch.Tensor:
        """Boolean draws, true with probability ``keep``."""
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device) < keep

    def normal(self, shape) -> torch.Tensor:
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device)

    def eps(self, shape, laplace: bool) -> torch.Tensor:
        """A posterior sampler's noise: standard normal, or (``laplace``)
        uniform on [-0.4999, 0.5)."""
        if not laplace:
            return self.normal(shape)
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device) * 0.9999 - 0.4999


def compose_conv(params: Dict, cfg: GRURNNConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The net's dilated conv stack composed into one window product
    (``dilconv_effective`` at the compute dtype): what ``gru_rnn_apply``
    applies, and takes as ``conv`` where the params are frozen."""
    cdt = _DTYPES[cfg.compute_dtype]
    return dilconv_effective(tree_map(lambda a: a.to(cdt), params["conv"]), cfg.kernel_size)


def gru_rnn_apply(
    params: Dict,
    cfg: GRURNNConfig,
    x: torch.Tensor,
    y_in: torch.Tensor,
    h_in: Optional[torch.Tensor] = None,
    do: bool = False,
    clamp_vae: bool = False,
    clamp_vae_laplace: bool = False,
    relu_vae: bool = False,
    lat_dim: int = 32,
    use_pallas: bool = False,
    softmax: bool = False,
    sigmoid: bool = False,
    exp: bool = False,
    res: bool = False,
    res_stdim: int = 0,
    res_endim: Optional[int] = None,
    noise: float = 0.0,
    differentiable: bool = False,
    draws: Optional[Draws] = None,
    conv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward over a (B, T, in_dim) segment.

    Returns (trj_out (B, T, out_dim), y_last (B, out_dim), h_last (L, B, H)).
    ``y_last`` is in the NORMALIZED domain (pre-scale_out): the value to feed
    back as ``y_in`` for the next segment.

    ``use_pallas`` (the JAX package's name for its fused kernels) routes a
    single-layer, non-residual model through the fused AR-GRU: with
    ``do``, ``differentiable`` or a gradient to take (grad mode on and a
    parameter or input that requires grad), ``ops.gru_ar_vjp.gru_ar_fused``
    (K2 forward, K3 backward; an all-ones mask without dropout), else
    ``ops.cuda_gru.cuda_gru_ar`` (K1).  Kernels for CUDA tensors, their plain
    versions for CPU tensors.  Everything else runs
    ``ops.gru_scan.gru_ar_scan``, under autograd.

    Training (reference gru_vae.py:348-399): ``noise`` adds N(0, noise^2) to
    the normalized input; ``do`` with ``cfg.do_prob > 0`` multiplies the
    conv output and then the GRU output by inverted-dropout masks (keep =
    1 - do_prob).  Both draw from ``draws``, which they then require.

    ``compute_dtype="bfloat16"`` follows the JAX package's dtype flow: the
    normalized input and the params are rounded to bf16, the conv taps
    compose in bf16, the hoisted gates come out in float32; the fused path
    then rounds its operands as the TPU kernel does.

    Aux surface: ``res`` (residual AR mode), ``softmax`` / ``sigmoid`` /
    ``exp`` output heads (the AR feedback stays pre-head), ``relu_vae``
    (variance lanes relu'd and clamped at 1e-6).

    ``conv``: ``compose_conv(params, cfg)`` made once, for frozen params
    (the ``Codec``); else the stack is composed here, ~60 small operations.
    """
    f32 = torch.float32
    B, T, _ = x.shape
    dropout = do and cfg.do_prob > 0.0
    if (noise > 0.0 or dropout) and draws is None:
        raise ValueError("input noise and dropout draw from `draws`: pass one")
    if cfg.scale_in:
        s = params["scale_in"]
        x = (x - s["mean"]) / s["scale"]
    if noise > 0.0:
        x = x + noise * draws.normal(x.shape).to(x.dtype)

    cdt = _DTYPES[cfg.compute_dtype]
    rounded = lambda t: tree_map(lambda a: a.to(cdt).to(f32), t)

    # context embedding: one window matmul (see layers.dilconv_apply)
    w_eff, b_eff = compose_conv(params, cfg) if conv is None else conv
    conv_seq = (window_gather(x.to(cdt).to(f32), cfg.rec_field) @ w_eff.to(f32)
                + b_eff.to(f32))  # (B, T, conv_dim)

    out_mask = None
    if dropout:
        keep = 1.0 - cfg.do_prob
        conv_seq = conv_seq * (draws.bernoulli(keep, conv_seq.shape).to(f32) / keep)
        out_mask = draws.bernoulli(keep, (B, T, cfg.hidden_units)).to(f32) / keep

    if h_in is None:
        h_in = init_hidden(cfg, B, device=x.device)
    y_in = y_in.to(f32)
    h_in = h_in.to(f32)

    res_seq = None
    if res:
        end = cfg.out_dim + res_stdim if res_endim is None else res_endim
        res_seq = x.to(cdt).to(f32)[..., res_stdim:end]

    gru_p = rounded(params["gru"])
    out_p = rounded(params["out"])
    if use_pallas and cfg.hidden_layers == 1 and res_seq is None:
        g0 = gru_p[0]
        gx = precompute_input_gates(g0, conv_seq)
        grad_needed = torch.is_grad_enabled() and any(
            t.requires_grad for t in (gx, out_p["w"], out_p["b"], g0["w_hh"], y_in, h_in))
        if do or differentiable or grad_needed:
            if out_mask is None:
                out_mask = torch.ones((B, T, cfg.hidden_units), device=x.device)
            conv_dim = conv_seq.shape[-1]
            trj, y_last, h_last1 = gru_ar_fused(
                g0["w_ih"][:, conv_dim:], g0["w_hh"], g0["b_hh"], out_p["w"],
                out_p["b"], gx, y_in, h_in[0], out_mask, weight_dtype=cdt)
        else:
            trj, y_last, h_last1 = cuda_gru_ar(g0, out_p, gx, y_in, h_in[0],
                                               weight_dtype=cdt)
        h_last = h_last1[None]
    else:
        trj, y_last, h_last = gru_ar_scan(gru_p, out_p, conv_seq, y_in, h_in,
                                          out_mask, res_seq)

    if cfg.scale_out:
        s = params["scale_out"]
        trj_out = trj * s["scale"] + s["mean"]
    else:
        trj_out = trj
        if clamp_vae or clamp_vae_laplace:
            if relu_vae:
                aux = torch.clamp(torch.relu(trj_out[..., lat_dim:]), min=1e-6)
            else:
                vmin = LOG_VAR_MIN if clamp_vae else LOG_SCALE_MIN
                aux = torch.clamp(trj_out[..., lat_dim:], min=vmin)
            trj_out = torch.cat([trj_out[..., :lat_dim], aux], dim=-1)
        elif relu_vae:
            trj_out = torch.cat([trj_out[..., :lat_dim],
                                 torch.relu(trj_out[..., lat_dim:])], dim=-1)

    # output heads (reference gru_vae.py:445-450); AR feedback stays pre-head
    if exp:
        trj_out = (torch.exp(trj_out) - 1.0) / 10000.0
    elif softmax:
        trj_out = torch.softmax(trj_out, dim=-1)
    elif sigmoid:
        trj_out = torch.sigmoid(trj_out)

    return trj_out, y_last, h_last


# ---------------------------------------------------------------------------
# Sampling (reference gru_vae.py:69-114)
# ---------------------------------------------------------------------------

def _noise(param: torch.Tensor, shape, generator, eps, draw) -> torch.Tensor:
    if eps is not None:
        return torch.as_tensor(eps, dtype=param.dtype, device=param.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or an eps tensor")
    return draw(shape, generator)


def sampling_vae_batch(param: torch.Tensor, lat_dim: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reparameterized Gaussian draw; param = concat(mu, log_var) on the last
    axis.  The standard-normal ``eps`` is drawn from ``generator`` unless given."""
    if lat_dim is None:
        lat_dim = param.shape[-1] // 2
    mu = param[..., :lat_dim]
    log_var = param[..., lat_dim:]
    e = _noise(param, mu.shape, generator, eps, lambda shape, g: torch.randn(
        shape, generator=g, dtype=param.dtype, device=param.device))
    return mu + torch.exp(log_var / 2.0) * e


def sampling_vae_laplace_batch(param: torch.Tensor, lat_dim: Optional[int] = None,
                               generator: Optional[torch.Generator] = None,
                               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Laplace reparameterization by inverse CDF; ``eps`` is uniform on
    [-0.4999, 0.5), drawn from ``generator`` unless given."""
    if lat_dim is None:
        lat_dim = param.shape[-1] // 2
    mu = param[..., :lat_dim]
    log_scale = param[..., lat_dim:]
    e = _noise(param, mu.shape, generator, eps, lambda shape, g: torch.rand(
        shape, generator=g, dtype=param.dtype, device=param.device) * 0.9999 - 0.4999)
    return mu - torch.exp(log_scale) * torch.sign(e) * torch.log1p(-2.0 * torch.abs(e))


# ---------------------------------------------------------------------------
# KL terms (reference gru_vae.py:116-144)
# ---------------------------------------------------------------------------

def _frame_mean(per_frame: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(per_frame, dim=-1)
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.sum(per_frame * mask, dim=-1) / denom


def loss_vae(param: torch.Tensor, lat_dim: Optional[int] = None,
             mask: Optional[torch.Tensor] = None,
             relu_vae: bool = False) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) = mean_T 0.5 * sum_D (exp(lv) + mu^2 - lv - 1).

    param: (..., T, 2D); mean over the frame axis, over the frames where
    ``mask`` (..., T) is set.  ``relu_vae``: the aux lanes hold the variance
    itself, 0.5 * sum(v + mu^2 - log v - 1).
    """
    if lat_dim is None:
        lat_dim = param.shape[-1] // 2
    mu = param[..., :lat_dim]
    lv = param[..., lat_dim:]
    if relu_vae:
        per_frame = 0.5 * torch.sum(lv + mu ** 2 - torch.log(lv) - 1.0, dim=-1)
    else:
        per_frame = 0.5 * torch.sum(torch.exp(lv) + mu ** 2 - lv - 1.0, dim=-1)
    return _frame_mean(per_frame, mask)


def loss_vae_laplace(param: torch.Tensor, lat_dim: Optional[int] = None,
                     mask: Optional[torch.Tensor] = None,
                     relu_vae: bool = False) -> torch.Tensor:
    """KL(Laplace(mu, b) || Laplace(0, 1)) per reference gru_vae.py:130-144.
    ``relu_vae``: the aux lanes hold the scale b itself."""
    if lat_dim is None:
        lat_dim = param.shape[-1] // 2
    mu = param[..., :lat_dim]
    aux = param[..., lat_dim:]
    mu_abs = torch.abs(mu)
    if relu_vae:
        scale, log_b = aux, torch.log(aux)
    else:
        scale, log_b = torch.exp(aux), aux
    per_frame = torch.sum(-log_b + scale * torch.exp(-mu_abs / scale) + mu_abs - 1.0, dim=-1)
    return _frame_mean(per_frame, mask)
