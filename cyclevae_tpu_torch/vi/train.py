"""Cyclic-ELBO amortized VI: the CycleVAE training core.

PyTorch counterpart of ``cyclevae_tpu/vi/train.py``:

  * model assembly: ``CycleVAEConfig``, ``CycleVAEParams``, ``init_cyclevae``;
  * the cyclic flow per segment (``cyclic_forward``; reference
    train…py:1292-1353): encoder -> sample -> decoder(src and trg, fused into
    one 2B call) -> encoder(cv) -> decoder(src), per cycle;
  * the loss per segment (``segment_loss``; reference :1401-1410): per
    utterance L1-MCD(recon) + L1-MCD(cyc_recon) + KL(lat) + KL(lat_cv),
    summed over utterances and cycles; the src->trg MCD is logged only;
  * the train step (``make_train_step``): TBPTT over 80-frame segments,
    the carried AR/hidden state detached at every segment, one Adam update
    per segment, frozen scalers outside the optimizer, and segments past
    every utterance's length skipped (known on the host from ``flens``).

Random numbers come from ``models.gru_vae.Draws`` in the JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.gru_vae import (
    Draws,
    GRURNNConfig,
    gru_rnn_apply,
    init_gru_rnn,
    loss_vae,
    loss_vae_laplace,
    sampling_vae_batch,
    sampling_vae_laplace_batch,
)
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from .elbo import mcd_l1


@dataclass(frozen=True)
class CycleVAEConfig:
    """Encoder/decoder pair configuration (reference train…py:310-329)."""

    in_dim: int = 54
    out_dim: int = 50
    lat_dim: int = 32
    n_spk: int = 2
    hidden_units: int = 1024
    hidden_layers: int = 1
    kernel_size: int = 3
    dilation_size: int = 2
    n_cyc: int = 2
    do_prob: float = 0.5
    stdim: int = 4
    posterior: str = "gauss"    # "gauss" | "laplace" (reference gru_vae.py:101-144)
    # perf knobs (numerics-affecting): use_pallas routes the AR recurrence
    # through the fused kernels (ops/cuda_gru.py; on CPU tensors their plain
    # versions), on by default in the port, where the JAX package defaults
    # to its XLA path; use_pallas=False asks for the plain scan
    # (ops/gru_scan.py).  compute_dtype="bfloat16" rounds the products'
    # operands to bf16 with float32 master weights
    use_pallas: bool = True
    compute_dtype: str = "float32"

    @property
    def half_cyc(self) -> bool:
        return self.n_cyc < 1

    @property
    def eff_cyc(self) -> int:
        return max(self.n_cyc, 1)

    @property
    def enc_cfg(self) -> GRURNNConfig:
        return GRURNNConfig(
            in_dim=self.in_dim, out_dim=self.lat_dim * 2,
            hidden_units=self.hidden_units, hidden_layers=self.hidden_layers,
            kernel_size=self.kernel_size, dilation_size=self.dilation_size,
            do_prob=self.do_prob, scale_in=True, scale_out=False,
            compute_dtype=self.compute_dtype)

    @property
    def dec_cfg(self) -> GRURNNConfig:
        return GRURNNConfig(
            in_dim=self.lat_dim + self.n_spk, out_dim=self.out_dim,
            hidden_units=self.hidden_units, hidden_layers=self.hidden_layers,
            kernel_size=self.kernel_size, dilation_size=self.dilation_size,
            do_prob=self.do_prob, scale_in=False, scale_out=True,
            compute_dtype=self.compute_dtype)


class CycleVAEParams(NamedTuple):
    encoder: Dict
    decoder: Dict


def params_to(params: CycleVAEParams, device) -> CycleVAEParams:
    """The same parameters as float32 tensors on ``device`` (a no-op for
    tensors already there)."""
    move = lambda a: torch.as_tensor(a).to(device=device, dtype=torch.float32)
    return CycleVAEParams(*(tree_map(move, p) for p in params))


def init_cyclevae(generator: torch.Generator, cfg: CycleVAEConfig,
                  mean_jnt=None, scale_jnt=None, device=None) -> CycleVAEParams:
    """Init both nets from ``generator`` (drawn on its device, then moved to
    ``device``, CUDA by default); bake joint stats into the frozen scalers if
    given (encoder normalizes the full in_dim feature, decoder
    un-normalizes the out_dim mcep block = stats[stdim:])."""
    device = resolve_device(device)
    enc = init_gru_rnn(generator, cfg.enc_cfg)
    dec = init_gru_rnn(generator, cfg.dec_cfg)
    if mean_jnt is not None:
        mean_jnt = torch.as_tensor(mean_jnt, dtype=torch.float32)
        scale_jnt = torch.as_tensor(scale_jnt, dtype=torch.float32)
        enc["scale_in"] = {"mean": mean_jnt, "scale": scale_jnt}
        dec["scale_out"] = {"mean": mean_jnt[cfg.stdim:], "scale": scale_jnt[cfg.stdim:]}
    return params_to(CycleVAEParams(encoder=enc, decoder=dec), device)


# ---------------------------------------------------------------------------
# Carried AR/hidden state for the cyclic flow
# ---------------------------------------------------------------------------

def init_cycle_state(cfg: CycleVAEConfig, params: CycleVAEParams, batch: int) -> Dict:
    """Fresh-state init (reference train…py:357-363): encoder feedback zeros;
    decoder feedback the normalized zero mcep, (0 - mean) / scale.  Every
    entry is stacked over the cycles: (n_cyc, B, .) or (n_cyc, L, B, H)."""
    n = cfg.eff_cyc
    s = params.decoder["scale_out"]
    dev = s["mean"].device
    y_dec = ((0.0 - s["mean"]) / s["scale"]).expand(n, batch, cfg.out_dim).contiguous()
    y_enc = torch.zeros((n, batch, cfg.lat_dim * 2), device=dev)
    h = torch.zeros((n, cfg.hidden_layers, batch, cfg.hidden_units), device=dev)
    return {
        "enc_y": y_enc, "enc_h": h, "enc_cv_y": y_enc, "enc_cv_h": h,
        "dec_src_y": y_dec, "dec_src_h": h, "dec_trg_y": y_dec, "dec_trg_h": h,
        "dec_cyc_y": y_dec, "dec_cyc_h": h,
    }


def cyclic_forward(
    params: CycleVAEParams,
    cfg: CycleVAEConfig,
    draws: Draws,
    feats: torch.Tensor,       # (B, T, in_dim) raw (unnormalized) features
    src_code: torch.Tensor,    # (B, T, n_spk)
    trg_code: torch.Tensor,    # (B, T, n_spk) or (n_cyc, B, T, n_spk)
    cv_excit: torch.Tensor,    # (B, T, stdim) or (n_cyc, B, T, stdim)
    state: Dict,
    do: bool = False,
) -> Tuple[Dict, Dict]:
    """One segment of the cyclic flow for all cycles.  Returns (outputs,
    new_state); outputs holds per-cycle stacks lat, lat_cv (n, B, T, 2*lat)
    and recon, conv, cyc_recon (n, B, T, out).  ``trg_code`` / ``cv_excit``
    with a leading n_cyc axis convert to another speaker each cycle."""
    n = cfg.eff_cyc
    lat_dim = cfg.lat_dim
    laplace = cfg.posterior == "laplace"
    sample_fn = sampling_vae_laplace_batch if laplace else sampling_vae_batch
    clamp_kw = {"clamp_vae_laplace": True} if laplace else {"clamp_vae": True}

    def sample(lat):
        return sample_fn(lat, lat_dim, eps=draws.eps(lat.shape[:-1] + (lat_dim,), laplace))

    new = {k: list(v.unbind(0)) for k, v in state.items()}
    outs = {k: [] for k in ("lat", "lat_cv", "recon", "conv", "cyc_recon")}
    cyc_prev = None
    B = feats.shape[0]
    for i in range(n):
        trg_code_i = trg_code[i] if trg_code.ndim == 4 else trg_code
        cv_excit_i = cv_excit[i] if cv_excit.ndim == 4 else cv_excit
        enc_in = feats if i == 0 else torch.cat([feats[..., :cfg.stdim], cyc_prev], dim=-1)
        lat, new["enc_y"][i], new["enc_h"][i] = gru_rnn_apply(
            params.encoder, cfg.enc_cfg, enc_in, state["enc_y"][i], state["enc_h"][i],
            do=do, lat_dim=lat_dim, use_pallas=cfg.use_pallas, draws=draws, **clamp_kw)

        # recon (src code) and conversion (trg code) decodes are independent
        # given the latent draws: one decoder call on a 2B batch
        z_src = sample(lat)
        z_trg = sample(lat)
        dec_in = torch.cat([torch.cat([src_code, z_src], dim=-1),
                            torch.cat([trg_code_i, z_trg], dim=-1)], dim=0)
        y_in2 = torch.cat([state["dec_src_y"][i], state["dec_trg_y"][i]], dim=0)
        h_in2 = torch.cat([state["dec_src_h"][i], state["dec_trg_h"][i]], dim=1)
        out2, y2, h2 = gru_rnn_apply(params.decoder, cfg.dec_cfg, dec_in, y_in2, h_in2,
                                     do=do, use_pallas=cfg.use_pallas, draws=draws)
        recon, conv = out2[:B], out2[B:]
        new["dec_src_y"][i], new["dec_trg_y"][i] = y2[:B], y2[B:]
        new["dec_src_h"][i], new["dec_trg_h"][i] = h2[:, :B], h2[:, B:]

        lat_cv, new["enc_cv_y"][i], new["enc_cv_h"][i] = gru_rnn_apply(
            params.encoder, cfg.enc_cfg, torch.cat([cv_excit_i, conv], dim=-1),
            state["enc_cv_y"][i], state["enc_cv_h"][i], do=do, lat_dim=lat_dim,
            use_pallas=cfg.use_pallas, draws=draws, **clamp_kw)

        z_cv = sample(lat_cv)
        cyc_recon, new["dec_cyc_y"][i], new["dec_cyc_h"][i] = gru_rnn_apply(
            params.decoder, cfg.dec_cfg, torch.cat([src_code, z_cv], dim=-1),
            state["dec_cyc_y"][i], state["dec_cyc_h"][i], do=do,
            use_pallas=cfg.use_pallas, draws=draws)

        cyc_prev = cyc_recon
        for k, v in (("lat", lat), ("lat_cv", lat_cv), ("recon", recon), ("conv", conv),
                     ("cyc_recon", cyc_recon)):
            outs[k].append(v)
    outputs = {k: torch.stack(v) for k, v in outs.items()}
    return outputs, {k: torch.stack(v) for k, v in new.items()}


def metric_names(cfg: CycleVAEConfig) -> List[str]:
    """The keys of ``segment_loss``'s metrics, in order."""
    names = []
    for i in range(cfg.eff_cyc):
        names += [f"mcd_src_src_{i}", f"mcd_src_trg_src_{i}", f"mcd_src_trg_{i}",
                  f"kl_lat_{i}", f"kl_lat_cv_{i}"]
    return names + ["loss"]


def segment_loss(
    params: CycleVAEParams,
    cfg: CycleVAEConfig,
    draws: Draws,
    seg: Dict,
    state: Dict,
    do: bool = True,
) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
    """Loss over one TBPTT segment; ``seg`` holds feats / src_code / trg_code
    / cv_excit (B, S, .) and mask (B, S) of valid frames."""
    outputs, new_state = cyclic_forward(
        params, cfg, draws, seg["feats"], seg["src_code"], seg["trg_code"],
        seg["cv_excit"], state, do=do)
    mcep = seg["feats"][..., cfg.stdim:]
    mask = seg["mask"]
    utt_valid = (torch.sum(mask, dim=-1) > 0).to(mcep.dtype)  # (B,)
    nvalid = torch.clamp(torch.sum(utt_valid), min=1.0)
    kl_fn = loss_vae_laplace if cfg.posterior == "laplace" else loss_vae

    loss = 0.0
    metrics = {}
    for i in range(cfg.eff_cyc):
        mcd_rec = mcd_l1(outputs["recon"][i], mcep, mask)          # (B,)
        mcd_cyc = mcd_l1(outputs["cyc_recon"][i], mcep, mask)
        mcd_cv = mcd_l1(outputs["conv"][i], mcep, mask)            # logged only
        kl = kl_fn(outputs["lat"][i], cfg.lat_dim, mask)
        kl_cv = kl_fn(outputs["lat_cv"][i], cfg.lat_dim, mask)
        cyc_loss = mcd_rec + kl if cfg.half_cyc else mcd_rec + mcd_cyc + kl + kl_cv
        loss = loss + torch.sum(cyc_loss * utt_valid)
        for name, v in ((f"mcd_src_src_{i}", mcd_rec), (f"mcd_src_trg_src_{i}", mcd_cyc),
                        (f"mcd_src_trg_{i}", mcd_cv), (f"kl_lat_{i}", kl),
                        (f"kl_lat_cv_{i}", kl_cv)):
            metrics[name] = torch.sum(v * utt_valid) / nvalid
    metrics["loss"] = loss
    return loss, (new_state, metrics)


# ---------------------------------------------------------------------------
# Train step: TBPTT over segments with per-segment Adam updates
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """``params`` and ``opt_state`` (a ``torch.optim`` optimizer over the
    trainable leaves of ``params``) are updated in place by each step."""
    params: CycleVAEParams
    opt_state: Any
    rng: torch.Generator
    step: int


_FROZEN = ("scale_in", "scale_out")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def trainable_leaves(params: CycleVAEParams) -> List[torch.Tensor]:
    """The conv, gru and out tensors of both nets, in a fixed order; the
    frozen scalers are left out (reference train…py:369-377)."""
    return [leaf for net in params for k, v in net.items() if k not in _FROZEN
            for leaf in _leaves(v)]


@dataclass(frozen=True)
class Optimizer:
    """Adam, or AdamW when ``weight_decay > 0``, over the trainable leaves
    only, so the frozen scalers never change.  optax's ``adam`` / ``adamw``
    (the JAX package's) and ``torch.optim.Adam`` / ``AdamW`` share one
    update rule and defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    lr: float = 1e-4
    weight_decay: float = 0.0

    def init(self, params: CycleVAEParams) -> torch.optim.Optimizer:
        leaves = trainable_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        if self.weight_decay > 0:
            return torch.optim.AdamW(leaves, lr=self.lr, weight_decay=self.weight_decay)
        return torch.optim.Adam(leaves, lr=self.lr)


def make_optimizer(cfg: CycleVAEConfig, lr: float = 1e-4,
                   weight_decay: float = 0.0) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay)


def make_train_step(cfg: CycleVAEConfig, optimizer: Optimizer, seg_len: int, n_segs: int):
    """The single-device train step over one utterance batch (the JAX
    package's ``build_step_fn`` / ``make_train_step``).

    batch: feats (B, n_segs*seg_len, in_dim), src_code, trg_code (B, ., n_spk)
    or (n_cyc, B, ., n_spk), cv_excit (B, ., stdim) or (n_cyc, B, ., stdim),
    as tensors or numpy arrays, and flens (B,) on the host.  ``step(ts,
    batch, draws=None)`` returns (new_train_state, metrics): each metric an
    (n_segs,) tensor on the device, ``metrics["seg_valid"]`` flagging the
    segments with any real frame.  A segment past every utterance's length
    (``bucket_len`` rounds T up) is skipped: no forward, params and optimizer
    state unchanged, metrics 0, as the JAX package's gated update leaves them.
    ``draws`` defaults to ``Draws(ts.rng)``.
    """

    def step_fn(ts: TrainState, batch: Dict, draws: Optional[Draws] = None
                ) -> Tuple[TrainState, Dict]:
        flens = _host_flens(batch)
        seg_valid = [bool(np.any(flens > s * seg_len)) for s in range(n_segs)]
        per_seg = run_segments(cfg, seg_len, n_segs, ts, batch,
                               Draws(ts.rng) if draws is None else draws, seg_valid)
        return TrainState(ts.params, ts.opt_state, ts.rng, ts.step + 1), \
            stack_metrics(cfg, per_seg, seg_valid, ts.params.decoder["out"]["w"].device)

    return step_fn


def _host_flens(batch: Dict) -> np.ndarray:
    f = batch["flens"]
    return np.asarray(f.cpu() if torch.is_tensor(f) else f)


def run_segments(cfg: CycleVAEConfig, seg_len: int, n_segs: int, ts: TrainState,
                 batch: Dict, draws: Draws, seg_valid: List[bool],
                 reduce_grads: Optional[Callable[[List[torch.Tensor]], None]] = None
                 ) -> List[Optional[Dict]]:
    """The segments of one train step: for each segment flagged in
    ``seg_valid`` a forward, a backward and an update of ``ts`` in place;
    ``reduce_grads(leaves)`` (the data-parallel step's all-reduce) runs
    between each backward and its update.  Returns each segment's metrics
    (None where the segment was skipped)."""
    T = n_segs * seg_len
    dev = ts.params.decoder["out"]["w"].device
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    flens = _host_flens(batch)
    data = {k: as_t(batch[k])[..., :T, :]
            for k in ("feats", "src_code", "trg_code", "cv_excit")}
    mask = as_t(np.arange(T)[None, :] < flens[:, None])        # (B, T)
    leaves = [p for group in ts.opt_state.param_groups for p in group["params"]]
    state = init_cycle_state(cfg, ts.params, data["feats"].shape[0])
    per_seg = []
    for s in range(n_segs):
        if not seg_valid[s]:
            per_seg.append(None)
            continue
        win = slice(s * seg_len, (s + 1) * seg_len)
        seg = {k: v[..., win, :] for k, v in data.items()}
        seg["mask"] = mask[:, win]
        state = {k: v.detach() for k, v in state.items()}   # TBPTT
        ts.opt_state.zero_grad(set_to_none=True)
        loss, (state, metrics) = segment_loss(ts.params, cfg, draws, seg, state, do=True)
        loss.backward()
        if reduce_grads is not None:
            reduce_grads(leaves)
        ts.opt_state.step()
        per_seg.append({k: v.detach() for k, v in metrics.items()})
    return per_seg


def stack_metrics(cfg: CycleVAEConfig, per_seg: List[Optional[Dict]], seg_valid: List[bool],
                  dev) -> Dict[str, torch.Tensor]:
    """Per-segment metrics as (n_segs,) tensors, 0 where a segment was
    skipped, and ``seg_valid``."""
    zero = torch.zeros((), device=dev)
    out = {k: torch.stack([m[k] if m is not None else zero for m in per_seg])
           for k in metric_names(cfg)}
    out["seg_valid"] = torch.tensor(seg_valid, dtype=torch.float32, device=dev)
    return out


def make_eval_forward(cfg: CycleVAEConfig):
    """Full-length no-dropout cyclic forward for the eval epoch (reference
    train…py:817-1152 runs the same flow under no_grad); with ``use_pallas``
    it runs on K1."""

    @torch.no_grad()
    def eval_fn(params: CycleVAEParams, draws: Draws, batch: Dict) -> Dict:
        dev = params.decoder["out"]["w"].device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
        feats = as_t(batch["feats"])
        state0 = init_cycle_state(cfg, params, feats.shape[0])
        outputs, _ = cyclic_forward(
            params, cfg, draws, feats, as_t(batch["src_code"]), as_t(batch["trg_code"]),
            as_t(batch["cv_excit"]), state0, do=False)
        return outputs

    return eval_fn
