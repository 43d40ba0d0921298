"""VQ-CycleVAE trainer: the ``cyclevqvae`` variant as a runnable loop.

PyTorch counterpart of ``cyclevae_tpu/pipeline/train_stage_vq.py``.  The
reference names the variant (run.sh:183 ``mdl_name=cyclevqvae``) and ships
its latent helpers (nn_search / nn_search_batch / weighted_ctr,
src/nets/gru_vae.py:147-197); the training binary lives in the successor
repo.  The Gaussian posterior of vi/train is replaced by a K-centroid
vector quantizer over the encoder output (straight-through estimator
through the reference's L1 assignment), trained with the VQ-VAE objective in
the same cyclic flow:

  lat      = encoder(feats)                -> z_q = VQ(lat)
  recon    = decoder(src_code ++ z_q)
  conv     = decoder(trg_code ++ z_q)
  lat_cv   = encoder(cv_excit ++ conv)     -> z_q_cv = VQ(lat_cv)
  cyc      = decoder(src_code ++ z_q_cv)

  loss = L1-MCD(recon, mcep) + L1-MCD(cyc, mcep)
       + ||sg(lat) - q||^2 + beta * ||lat - sg(q)||^2   (both encodes)

Whole-utterance forward, no TBPTT segmentation.  The AR GRUs take
``use_pallas`` from the experiment's model config (the kernel route by
default; the JAX trainer calls its XLA scan): a step is 5 K2 and 5 K3
launches (two encodes, three decodes, all under autograd).  Randomness: the
encoder, decoder and codebook draw from a ``torch.Generator`` seeded with
``seed`` in that order, the dropout masks from one seeded with ``seed + 1``,
the batch order from ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gru_vae import Draws, GRURNNConfig, gru_rnn_apply, init_gru_rnn
from ..models.vq import (codebook_perplexity, nn_search_batch, vq_straight_through_batch,
                         weighted_ctr)
from ..utils.config import ExperimentConfig
from ..utils.device import resolve_device
from ..utils.store import read_store
from ..utils.tree import tree_map
from ..vi.elbo import mcd_l1
from ..vi.train import _FROZEN, _leaves
from .dataset import SingleVAEDataset, bucket_len, padding


def make_vq_cfgs(exp: ExperimentConfig) -> Tuple[GRURNNConfig, GRURNNConfig]:
    m = exp.model
    enc = GRURNNConfig(
        in_dim=m.in_dim, out_dim=m.lat_dim, hidden_units=m.hidden_units,
        hidden_layers=m.hidden_layers, kernel_size=m.kernel_size,
        dilation_size=m.dilation_size, do_prob=m.do_prob,
        scale_in=True, scale_out=False)
    dec = GRURNNConfig(
        in_dim=m.lat_dim + m.n_spk, out_dim=m.out_dim,
        hidden_units=m.hidden_units, hidden_layers=m.hidden_layers,
        kernel_size=m.kernel_size, dilation_size=m.dilation_size,
        do_prob=m.do_prob, scale_in=False, scale_out=True)
    return enc, dec


def vq_trainable(params: Dict) -> List[torch.Tensor]:
    """The codebook and the conv, gru and out tensors of both nets; the
    frozen scalers are left out."""
    return [params["centroids"]] + [leaf for net in ("encoder", "decoder")
                                    for k, v in params[net].items() if k not in _FROZEN
                                    for leaf in _leaves(v)]


def make_vq_step(enc_cfg: GRURNNConfig, dec_cfg: GRURNNConfig, stdim: int,
                 n_centroids: int, beta: float = 0.25, assignment: str = "st",
                 use_pallas: bool = True):
    """``step(params, opt, batch, draws) -> metrics``: one Adam step of the
    VQ-CycleVAE over whole (padded, masked) utterances, ``params`` and
    ``opt`` updated in place.

    ``assignment``: "st" = hard nearest-centroid with the straight-through
    estimator; "soft" = the reference's exp(-L1) posterior-weighted
    centroids (weighted_ctr, gru_vae.py:178-193), fully differentiable, the
    weighted distance being the codebook-fit penalty.  batch: feats,
    src_code, trg_code, cv_excit (B, T, .) and mask (B, T).  Returns
    {"loss", "mcd_rec", "mcd_cyc", "vq", "perplexity"} as device scalars."""
    if assignment not in ("st", "soft"):
        raise ValueError(f"assignment is 'st' or 'soft', not {assignment!r}")
    lat_dim = enc_cfg.out_dim

    def loss_fn(params, draws, batch):
        feats, mask = batch["feats"], batch["mask"]
        B, dev = feats.shape[0], feats.device
        mcep = feats[..., stdim:]
        denom = torch.clamp(torch.sum(mask), min=1.0)   # for the VQ frame means
        centroids = params["centroids"]

        def vq_terms(lat):
            if assignment == "soft":
                # weighted_ctr means over ALL frames (incl. padding), as the
                # JAX trainer's vmap of the reference helper
                wc, wd = zip(*(weighted_ctr(lat[b], centroids) for b in range(B)))
                ids = nn_search_batch(lat, centroids)             # logged only
                return torch.stack(wc), ids, beta * torch.mean(torch.stack(wd))
            st, hard, ids = vq_straight_through_batch(lat, centroids)
            sq = torch.sum((lat.detach() - hard) ** 2, -1)
            cm = torch.sum((lat - hard.detach()) ** 2, -1)
            return st, ids, torch.sum((sq + beta * cm) * mask) / denom

        def enc(x):
            return gru_rnn_apply(params["encoder"], enc_cfg, x, torch.zeros((B, lat_dim), device=dev),
                                 do=enc_cfg.do_prob > 0, use_pallas=use_pallas, draws=draws)[0]

        def dec(code, z):
            return gru_rnn_apply(params["decoder"], dec_cfg, torch.cat([code, z], -1),
                                 torch.zeros((B, dec_cfg.out_dim), device=dev),
                                 use_pallas=use_pallas)[0]

        z_q, ids, vq1 = vq_terms(enc(feats))
        recon = dec(batch["src_code"], z_q)
        conv = dec(batch["trg_code"], z_q)
        z_q_cv, _, vq2 = vq_terms(enc(torch.cat([batch["cv_excit"], conv], -1)))
        cyc = dec(batch["src_code"], z_q_cv)

        mcd_rec = torch.mean(mcd_l1(recon, mcep, mask))
        mcd_cyc = torch.mean(mcd_l1(cyc, mcep, mask))
        loss = mcd_rec + mcd_cyc + vq1 + vq2
        metrics = {"loss": loss, "mcd_rec": mcd_rec, "mcd_cyc": mcd_cyc, "vq": vq1 + vq2,
                   "perplexity": codebook_perplexity(ids, n_centroids, mask)}
        return loss, metrics

    def step(params: Dict, opt: torch.optim.Optimizer, batch: Dict,
             draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        dev = params["centroids"].device
        batch = {k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(params, draws, batch)
        loss.backward()
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _collate_vq(utts, seg_len: int) -> Dict:
    T = bucket_len(max(u.flen for u in utts), seg_len, 1)

    def pad_stack(get):
        return np.stack([padding(get(u), T).astype(np.float32) for u in utts])

    return {
        "feats": pad_stack(lambda u: u.feats),
        "src_code": pad_stack(lambda u: u.src_code),
        "trg_code": pad_stack(lambda u: u.trg_code),
        "cv_excit": pad_stack(lambda u: u.cv_excit),
        "mask": np.stack([(np.arange(T) < u.flen).astype(np.float32) for u in utts]),
    }


def init_vq(generator: torch.Generator, enc_cfg: GRURNNConfig, dec_cfg: GRURNNConfig,
            n_centroids: int, mean_jnt, scale_jnt, stdim: int, device) -> Dict:
    """Encoder, decoder and codebook (0.5 x standard normal: inside the
    encoder's operating range) drawn from ``generator``, the joint stats
    baked into the frozen scalers, on ``device``."""
    params = {
        "encoder": init_gru_rnn(generator, enc_cfg),
        "decoder": init_gru_rnn(generator, dec_cfg),
        "centroids": 0.5 * torch.randn((n_centroids, enc_cfg.out_dim), generator=generator,
                                       device=generator.device),
    }
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    mean, scale = as_t(mean_jnt), as_t(scale_jnt)
    params["encoder"]["scale_in"] = {"mean": mean, "scale": scale}
    params["decoder"]["scale_out"] = {"mean": mean[stdim:], "scale": scale[stdim:]}
    return tree_map(lambda t: t.to(device=device, dtype=torch.float32), params)


def run_train_vq(exp: ExperimentConfig, src_files: Sequence[str],
                 trg_files: Sequence[str], spk_src: str, stats_jnt: str,
                 expdir: str, n_centroids: int = 64, beta: float = 0.25,
                 assignment: str = "st", device=None) -> Dict:
    """Train the VQ-CycleVAE on ``device`` (CUDA unless ``device="cpu"``);
    returns {"history", "params", "enc_cfg", "dec_cfg"} and writes
    ``history_vq.json`` (per epoch: loss, MCDs, VQ term, codebook
    perplexity) to ``expdir``."""
    device = resolve_device(device)
    os.makedirs(expdir, exist_ok=True)
    enc_cfg, dec_cfg = make_vq_cfgs(exp)
    m, tcfg = exp.model, exp.train

    params = init_vq(torch.Generator(device=device).manual_seed(tcfg.seed), enc_cfg, dec_cfg,
                     n_centroids, read_store(stats_jnt, "/mean_feat_org_lf0_jnt"),
                     read_store(stats_jnt, "/scale_feat_org_lf0_jnt"), m.stdim, device)
    trainable = vq_trainable(params)
    for t in trainable:
        t.requires_grad_(True)
    # frozen scalers, as the gauss trainer (vi/train.Optimizer)
    opt = torch.optim.Adam(trainable, lr=tcfg.lr)
    draws = Draws(torch.Generator(device=device).manual_seed(tcfg.seed + 1))
    np_rng = np.random.default_rng(tcfg.seed)

    ds = SingleVAEDataset(list(src_files) + list(trg_files),
                          list(trg_files) + list(src_files), spk_src, n_spk=m.n_spk)
    step = make_vq_step(enc_cfg, dec_cfg, m.stdim, n_centroids, beta, assignment,
                        use_pallas=m.use_pallas)

    history: List[Dict] = []
    bsu = tcfg.batch_size_utt
    for epoch in range(tcfg.epoch_count):
        t0 = time.time()
        order = np_rng.permutation(len(ds))
        ms = []
        for s in range(0, len(order), bsu):
            idxs = order[s:s + bsu]
            if len(idxs) < bsu:
                idxs = np.concatenate([idxs, order[:bsu - len(idxs)]])
            m_ = step(params, opt, _collate_vq([ds[int(i)] for i in idxs], tcfg.batch_size),
                      draws)
            ms.append({k: float(v) for k, v in m_.items()})
        train_m = {k: float(np.mean([x[k] for x in ms])) for k in ms[0]}
        history.append({"epoch": epoch + 1, "train": train_m, "sec": time.time() - t0})
        logging.info("vq epoch %d: %s (%.1fs)", epoch + 1,
                     {k: round(v, 3) for k, v in train_m.items()}, history[-1]["sec"])

    with open(os.path.join(expdir, "history_vq.json"), "w") as f:
        json.dump({"history": history}, f, indent=2)
    return {"history": history, "params": params, "enc_cfg": enc_cfg, "dec_cfg": dec_cfg}


def main(argv=None):
    """CLI: train the VQ-CycleVAE variant on a prepared workspace (stages
    1-3 of the one-to-one recipe must have run; the same split)."""
    import argparse

    from ..utils.config import load_config
    from .recipe import RecipePaths

    p = argparse.ArgumentParser(prog="cyclevae_tpu_torch.pipeline.train_stage_vq")
    p.add_argument("--work", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n-train", type=int, default=40)
    p.add_argument("--n-centroids", type=int, default=64)
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--assignment", choices=("st", "soft"), default="st")
    p.add_argument("--wav-root", default=None, help="the corpus (not read by this trainer)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S")
    exp = load_config(args.config) if args.config else ExperimentConfig()
    if args.epochs is not None:
        exp.train.epoch_count = args.epochs
    paths = RecipePaths(wav_root=args.wav_root, work=args.work, n_train=args.n_train)
    # parallel-sentence head halves of both speakers (recipe train_lists)
    src = paths.h5s(exp.model.spk_src)[:paths.n_train]
    trg = paths.h5s(exp.model.spk_trg)[:paths.n_train]
    n = min(len(src), len(trg))
    expdir = os.path.join(paths.work, "exp", exp.name() + "_vq")
    res = run_train_vq(exp, src[:n], trg[:n], exp.model.spk_src, paths.stats_jnt(), expdir,
                       n_centroids=args.n_centroids, beta=args.beta,
                       assignment=args.assignment, device=args.device)
    logging.info("vq training done: %s", res["history"][-1])


if __name__ == "__main__":
    main()
