"""Plain float32 reference of the one-to-one CycleVAE (Tobing et al., the
cyclevae-vc recipe ``egs/one-to-one``): the encoder / decoder nets, the
cyclic flow, the segment loss, Adam, and the conversion request.

Written from the model's equations, in plain ``torch`` operations, step by
step in time; it imports nothing of the measured program.  The parameter
layout is the one the benchmark makes (``harness/weights.py``): torch GRU
layout (``w_ih`` / ``w_hh`` (3H, in), gate rows [r, z, n]), dense ``w``
(out, in), the two dilated conv layers ``w`` (out, in, k).

Semantics a reader must know (they are the model's, not the program's):
  * the conv stack is non-causal and linear: two layers, kernel 3, dilation
    1 and 3, zero padding, so each frame sees a 9-frame window;
  * the GRU input is concat(conv(x)[t], y[t-1]) with y the net's own
    previous output (normalized domain); the reset gate multiplies the
    hidden-side candidate including its bias (torch's GRU cell);
  * training dropout (keep 0.5, inverted) masks the conv output and the GRU
    output before the output projection, so the fed-back y is dropped too;
  * the encoder's log-variance lanes are clamped below at ln 1e-6.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

F32 = torch.float32
LOG_VAR_MIN = math.log(1e-6)
MCD_L1 = 10.0 / math.log(10.0) * math.sqrt(2.0)


@dataclass(frozen=True)
class Model:
    in_dim: int = 54
    out_dim: int = 50
    lat_dim: int = 32
    n_spk: int = 2
    hidden_units: int = 1024
    kernel_size: int = 3
    dilation_size: int = 2
    n_cyc: int = 2
    do_prob: float = 0.5
    stdim: int = 4

    @classmethod
    def of(cls, d: Dict) -> "Model":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__})


# ---------------------------------------------------------------------------
# One net: conv window, AR GRU, projection
# ---------------------------------------------------------------------------

def conv_stack(conv: Dict, x: torch.Tensor, k: int) -> torch.Tensor:
    """The dilated conv layers applied one after the other: the input is
    zero-padded once by (k**layers - 1) / 2 frames on each side, and layer l
    (dilation k**l) is a valid convolution, so the output keeps T frames
    (the recipe's ``TwoSidedDilConv1d``: padding on the first layer only)."""
    pad = (k ** len(conv["w"]) - 1) // 2
    h = torch.nn.functional.pad(x.transpose(1, 2), (pad, pad))   # (B, C, T + 2 pad)
    for l, (w, b) in enumerate(zip(conv["w"], conv["b"])):
        h = torch.nn.functional.conv1d(h, w, b, dilation=k ** l)
    return h.transpose(1, 2)


def ar_gru(gru: Dict, out: Dict, conv_seq: torch.Tensor, y0: torch.Tensor, h0: torch.Tensor,
           out_mask: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The AR recurrence frame by frame: (B, T, C) -> (trj (B, T, out), y_T, h_T)."""
    H = gru["w_hh"].shape[1]
    C = conv_seq.shape[-1]
    w_x, w_y = gru["w_ih"][:, :C], gru["w_ih"][:, C:]
    gx_all = conv_seq @ w_x.T + gru["b_ih"]
    h, y, trj = h0, y0, []
    for t in range(conv_seq.shape[1]):
        gx = gx_all[:, t] + y @ w_y.T
        gh = h @ gru["w_hh"].T + gru["b_hh"]
        r = torch.sigmoid(gx[:, :H] + gh[:, :H])
        z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        o = h if out_mask is None else h * out_mask[:, t]
        y = o @ out["w"].T + out["b"]
        trj.append(y)
    return torch.stack(trj, dim=1), y, h


def net_apply(net: Dict, m: Model, x: torch.Tensor, y0: torch.Tensor, h0: torch.Tensor,
              encoder: bool, masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One encoder or decoder pass over (B, T, in) -> (out (B, T, .), y_T, h_T).
    ``masks`` (conv mask, GRU-output mask), both already scaled by 1/keep."""
    if "scale_in" in net:
        x = (x - net["scale_in"]["mean"]) / net["scale_in"]["scale"]
    c = conv_stack(net["conv"], x, m.kernel_size)
    out_mask = None
    if masks is not None:
        c = c * masks[0]
        out_mask = masks[1]
    trj, y, h = ar_gru(net["gru"], net["out"], c, y0, h0, out_mask)
    if encoder:
        trj = torch.cat([trj[..., :m.lat_dim],
                         torch.clamp(trj[..., m.lat_dim:], min=LOG_VAR_MIN)], dim=-1)
    if "scale_out" in net:
        trj = trj * net["scale_out"]["scale"] + net["scale_out"]["mean"]
    return trj, y, h


def dec_y0(dec: Dict, B: int) -> torch.Tensor:
    """The decoder's first fed-back frame: the normalized zero mel-cepstrum."""
    s = dec["scale_out"]
    return ((0.0 - s["mean"]) / s["scale"]).expand(B, -1)


# ---------------------------------------------------------------------------
# Training: cyclic flow, segment loss, Adam
# ---------------------------------------------------------------------------

class ReplayMismatch(ValueError):
    """The draws handed over do not fit the model's definition."""


class Replay:
    """The training draws, handed over in the order the model's definition
    consumes them (per net: conv mask, GRU-output mask; per cycle: encoder,
    z_src, z_trg, the recon + conversion decodes, cv encoder, z_cv, cyclic
    decoder).  Each draw is checked against the kind and shape asked for."""

    def __init__(self, draws: Sequence[Tuple[str, torch.Tensor]]):
        self._it: Iterator = iter(draws)

    def take(self, kind: str, shape) -> torch.Tensor:
        got_kind, t = next(self._it, (None, None))
        if got_kind != kind or tuple(t.shape) != tuple(shape):
            got = None if t is None else tuple(t.shape)
            raise ReplayMismatch(f"draw {got_kind} {got} where {kind} {tuple(shape)} was due")
        return t

    def masks(self, m: Model, B: int, T: int, conv_dim: int):
        keep = 1.0 - m.do_prob
        c = self.take("bernoulli", (B, T, conv_dim)).to(F32) / keep
        o = self.take("bernoulli", (B, T, m.hidden_units)).to(F32) / keep
        return c, o


def _conv_dim(net: Dict) -> int:
    return net["conv"]["w"][-1].shape[0]


def cyclic_segment(p: Dict, m: Model, rp: Replay, seg: Dict, state: Dict):
    """One segment of the cyclic flow, every cycle; returns (outputs per
    cycle, new state).  ``state[k]`` holds one (y, h) per cycle per stream."""
    enc, dec = p["encoder"], p["decoder"]
    feats = seg["feats"]
    B, T, _ = feats.shape
    L = m.lat_dim
    new, outs = {}, []
    cyc_prev = None
    for i in range(m.n_cyc):
        x = feats if i == 0 else torch.cat([feats[..., :m.stdim], cyc_prev], dim=-1)
        lat, *new[("enc", i)] = net_apply(enc, m, x, *state[("enc", i)], True,
                                          rp.masks(m, B, T, _conv_dim(enc)))
        z_src = lat[..., :L] + torch.exp(lat[..., L:] / 2) * rp.take("normal", (B, T, L))
        z_trg = lat[..., :L] + torch.exp(lat[..., L:] / 2) * rp.take("normal", (B, T, L))
        # the reconstruction and the conversion decode in one batch of 2B:
        # the draws for both come as one batch of masks
        x2 = torch.cat([torch.cat([seg["src_code"], z_src], -1),
                        torch.cat([seg["trg_code"], z_trg], -1)], 0)
        y2 = torch.cat([state[("src", i)][0], state[("trg", i)][0]], 0)
        h2 = torch.cat([state[("src", i)][1], state[("trg", i)][1]], 0)
        o2, yo, ho = net_apply(dec, m, x2, y2, h2, False, rp.masks(m, 2 * B, T, _conv_dim(dec)))
        recon, conv = o2[:B], o2[B:]
        new[("src", i)], new[("trg", i)] = (yo[:B], ho[:B]), (yo[B:], ho[B:])
        lat_cv, *new[("cv", i)] = net_apply(
            enc, m, torch.cat([seg["cv_excit"], conv], -1), *state[("cv", i)], True,
            rp.masks(m, B, T, _conv_dim(enc)))
        z_cv = lat_cv[..., :L] + torch.exp(lat_cv[..., L:] / 2) * rp.take("normal", (B, T, L))
        cyc, *new[("cyc", i)] = net_apply(dec, m, torch.cat([seg["src_code"], z_cv], -1),
                                          *state[("cyc", i)], False,
                                          rp.masks(m, B, T, _conv_dim(dec)))
        cyc_prev = cyc
        outs.append((lat, lat_cv, recon, cyc))
    return outs, {k: tuple(v) for k, v in new.items()}


def init_state(p: Dict, m: Model, B: int, device) -> Dict:
    zeros_h = torch.zeros((B, m.hidden_units), device=device)
    st = {}
    for i in range(m.n_cyc):
        for k in ("enc", "cv"):
            st[(k, i)] = (torch.zeros((B, 2 * m.lat_dim), device=device), zeros_h)
        for k in ("src", "trg", "cyc"):
            st[(k, i)] = (dec_y0(p["decoder"], B), zeros_h)
    return st


def _masked_frame_mean(per_frame: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_frame * mask, -1) / torch.clamp(torch.sum(mask, -1), min=1.0)


def segment_loss(outs, m: Model, seg: Dict) -> torch.Tensor:
    """Sum over utterances with a real frame and over cycles of L1-MCD(recon)
    + L1-MCD(cyclic recon) + KL(lat) + KL(lat_cv), frame means over the
    real frames."""
    mcep = seg["feats"][..., m.stdim:]
    mask = seg["mask"]
    valid = (torch.sum(mask, -1) > 0).to(F32)
    L = m.lat_dim

    def mcd(a):
        return _masked_frame_mean(MCD_L1 * torch.sum(torch.abs(a - mcep), -1), mask)

    def kl(lat):
        mu, lv = lat[..., :L], lat[..., L:]
        return _masked_frame_mean(0.5 * torch.sum(torch.exp(lv) + mu ** 2 - lv - 1.0, -1), mask)

    loss = torch.zeros((), device=mcep.device)
    for lat, lat_cv, recon, cyc in outs:
        loss = loss + torch.sum((mcd(recon) + mcd(cyc) + kl(lat) + kl(lat_cv)) * valid)
    return loss


def trainable(p: Dict) -> List[torch.Tensor]:
    """Every parameter but the frozen scalers, in a fixed order."""
    out = []
    for net in ("encoder", "decoder"):
        n = p[net]
        out += list(n["conv"]["w"]) + list(n["conv"]["b"])
        out += [n["gru"][k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
        out += [n["out"]["w"], n["out"]["b"]]
    return out


class Adam:
    """Adam (Kingma & Ba) with bias correction, b1 0.9, b2 0.999, eps 1e-8."""

    def __init__(self, leaves: List[torch.Tensor], lr: float):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(x) for x in leaves]
        self.v = [torch.zeros_like(x) for x in leaves]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for x, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).add_(g * g, alpha=0.001)
            x.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))


def train_steps(p: Dict, m: Model, batches: Sequence[Dict], draws: Sequence[Sequence],
                lr: float, seg_len: int, n_segs: int, max_updates: Optional[int] = None):
    """Train ``p`` in place over ``batches``: per batch, TBPTT over segments
    of ``seg_len`` frames (state carried, detached), one Adam update per
    segment that holds a real frame; segments past every utterance are
    skipped; with ``max_updates``, it stops after that many updates.
    Returns (per batch the list of segment losses (None where skipped), the
    first update's gradients)."""
    if len(batches) != len(draws):
        raise ValueError(f"{len(batches)} batches but draws for {len(draws)}")
    leaves = trainable(p)
    for x in leaves:
        x.requires_grad_(True)
    opt = Adam(leaves, lr)
    first_grads, losses = None, []
    for batch, dr in zip(batches, draws):
        if max_updates is not None and opt.t >= max_updates:
            break
        rp = Replay(dr)
        dev = leaves[0].device
        T = seg_len * n_segs
        flens = torch.as_tensor(batch["flens"], device=dev)
        data = {k: torch.as_tensor(batch[k], dtype=F32, device=dev)[:, :T]
                for k in ("feats", "src_code", "trg_code", "cv_excit")}
        mask = (torch.arange(T, device=dev)[None] < flens[:, None]).to(F32)
        B = data["feats"].shape[0]
        state = init_state(p, m, B, dev)
        step_losses = []
        for s in range(n_segs):
            if max_updates is not None and opt.t >= max_updates:
                break
            if not bool(torch.any(flens > s * seg_len)):
                step_losses.append(None)
                continue
            w = slice(s * seg_len, (s + 1) * seg_len)
            seg = {k: v[:, w] for k, v in data.items()}
            seg["mask"] = mask[:, w]
            state = {k: tuple(t.detach() for t in v) for k, v in state.items()}
            outs, state = cyclic_segment(p, m, rp, seg, state)
            loss = segment_loss(outs, m, seg)
            grads = torch.autograd.grad(loss, leaves)
            if first_grads is None:
                first_grads = [g.detach().clone() for g in grads]
            opt.step(grads)
            step_losses.append(float(loss.detach()))
        losses.append(step_losses)
    for x in leaves:
        x.requires_grad_(False)
    return losses, first_grads


def follow_updates(params_at: Callable[[int], Dict], adam_at: Callable[[int, List], Adam],
                   m: Model, batch: Dict, draws: Sequence, seg_len: int, n_segs: int,
                   at: Sequence[int]) -> Dict[int, Tuple[float, List[torch.Tensor],
                                                         List[torch.Tensor]]]:
    """One train step followed from a trainer's own state, segment by
    segment: segment s runs with ``params_at(s)``, the parameters held before
    its update, and carries its state (detached) into the next, with masked
    rows and skipped segments as ``train_steps`` has them; at each segment
    in ``at`` it takes the loss and the gradient and makes one Adam update
    from the moments ``adam_at(s, leaves)`` holds.  Returns per segment of
    ``at`` (loss, gradients, the updated leaves in ``trainable`` order)."""
    rp = Replay(draws)
    dev = trainable(params_at(0))[0].device
    T = seg_len * n_segs
    flens = torch.as_tensor(batch["flens"], device=dev)
    data = {k: torch.as_tensor(batch[k], dtype=F32, device=dev)[:, :T]
            for k in ("feats", "src_code", "trg_code", "cv_excit")}
    mask = (torch.arange(T, device=dev)[None] < flens[:, None]).to(F32)
    state = init_state(params_at(0), m, data["feats"].shape[0], dev)
    out = {}
    for s in range(max(at) + 1):
        if not bool(torch.any(flens > s * seg_len)):
            continue
        w = slice(s * seg_len, (s + 1) * seg_len)
        seg = {k: v[:, w] for k, v in data.items()}
        seg["mask"] = mask[:, w]
        p = params_at(s)
        if s not in at:
            with torch.no_grad():
                _, state = cyclic_segment(p, m, rp, seg, state)
            continue
        leaves = trainable(p)
        for x in leaves:
            x.requires_grad_(True)
        outs, state = cyclic_segment(p, m, rp, seg, state)
        loss = segment_loss(outs, m, seg)
        grads = torch.autograd.grad(loss, leaves)
        state = {k: tuple(t.detach() for t in v) for k, v in state.items()}
        adam_at(s, leaves).step(grads)
        out[s] = (float(loss.detach()), [g.detach() for g in grads],
                  [x.detach().clone() for x in leaves])
        for x in leaves:
            x.requires_grad_(False)
    return out


# ---------------------------------------------------------------------------
# Conversion request: posterior mean of the latents, three decodes
# ---------------------------------------------------------------------------

def pad_to(x: torch.Tensor, T: int) -> torch.Tensor:
    """Zero frames appended to (B, t, D) up to T, as a bucketed request lays
    its utterances out (zeros of the raw features)."""
    return torch.nn.functional.pad(x, (0, 0, 0, T - x.shape[1]))


@torch.no_grad()
def convert_pair(p: Dict, m: Model, src: torch.Tensor, trg: torch.Tensor, Tp: int,
                 eps: torch.Tensor):
    """One conversion request over (T, in) source and target features laid
    out in a batch of ``Tp`` frames (Tp a multiple of the bucket): the
    encoder's posterior parameters of both, the latent posterior mean as the
    mean of the reparameterized draws with noise ``eps`` (n, 2, Tp, lat), and
    three decodes (source to target code, source to source code, target to
    target code).  Returns (lat_src, lat_trg, cv, src_rec, trg_rec), each
    over the utterance's real frames."""
    enc, dec = p["encoder"], p["decoder"]
    T, Tt = src.shape[0], trg.shape[0]
    L = m.lat_dim
    x = torch.stack([pad_to(src[None], Tp)[0], pad_to(trg[None], Tp)[0]])
    lat, _, _ = net_apply(enc, m, x, torch.zeros((2, 2 * L), device=x.device),
                          torch.zeros((2, m.hidden_units), device=x.device), True)
    z = (lat[..., :L] + torch.exp(lat[..., L:] / 2) * eps).mean(dim=0)     # (2, Tp, L)
    zs, zt = z[0, :T], z[1, :Tt]

    def code(n, idx):
        c = torch.zeros((n, m.n_spk), device=x.device)
        c[:, idx] = 1.0
        return c

    rows = [torch.cat([code(T, 1), zs], -1), torch.cat([code(T, 0), zs], -1),
            torch.cat([code(Tt, 1), zt], -1)]
    cz = torch.stack([pad_to(r[None], Tp)[0] for r in rows])
    out, _, _ = net_apply(dec, m, cz, dec_y0(dec, 3),
                          torch.zeros((3, m.hidden_units), device=x.device), False)
    return lat[0, :T], lat[1, :Tt], out[0, :T], out[1, :T], out[2, :Tt]
