"""Speaker-classifier training driver over the Cls dataset variants.

PyTorch counterpart of ``cyclevae_tpu/pipeline/train_stage_cls.py``.  The
reference defines classifier-code datasets (FeatureDatasetMult*VAECls,
src/utils/dataset.py:290-492) whose training binary lives in its successor
repo; the class codes supervise a per-frame speaker classifier with the
GRU_RNN softmax output head (reference gru_vae.py:446-447): masked
cross-entropy on the per-frame class codes over ``MultSpkTrainClsDataset``,
frame accuracy on the deterministic ``MultSpkEvalClsDataset`` pairing.

The AR GRU takes ``use_pallas`` from the experiment's model config (the
kernel route by default): a train step is one K2 launch and one K3, an eval
forward one K1.  The JAX trainer calls its XLA scan here; the function is
the same.  The optimizer is Adam over every tensor of the classifier, its
input scaler included, as the JAX trainer's ``optax.adam`` over all leaves.
Randomness: the initial parameters from a ``torch.Generator`` seeded with
``seed``, the dropout masks from one seeded with ``seed + 1``, the batch
order from ``np.random.default_rng(seed)`` (the JAX package's order).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.gru_vae import Draws, GRURNNConfig, gru_rnn_apply, init_gru_rnn
from ..utils.config import ExperimentConfig
from ..utils.device import resolve_device
from ..utils.store import read_store
from ..vi.train import _leaves
from .dataset import bucket_len, padding
from .dataset_mult import MultSpkEvalClsDataset, MultSpkTrainClsDataset


def make_classifier_step(cfg: GRURNNConfig, use_pallas: bool = True):
    """``step(params, opt, batch, draws) -> metrics``: one Adam step of the
    masked per-frame cross-entropy through the softmax head, ``params`` and
    the optimizer ``opt`` updated in place.

    batch: feats (B, T, in_dim), cls (B, T) integer, mask (B, T), as tensors
    or numpy arrays.  Returns {"loss", "acc"} as device scalars."""

    def step(params: Dict, opt: torch.optim.Optimizer, batch: Dict,
             draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        dev = params["out"]["w"].device
        feats = torch.as_tensor(batch["feats"], dtype=torch.float32).to(dev)
        cls = torch.as_tensor(batch["cls"]).to(dev).long()
        mask = torch.as_tensor(batch["mask"], dtype=torch.float32).to(dev)
        opt.zero_grad(set_to_none=True)
        probs, _, _ = gru_rnn_apply(
            params, cfg, feats, torch.zeros((feats.shape[0], cfg.out_dim), device=dev),
            do=cfg.do_prob > 0, softmax=True, use_pallas=use_pallas, draws=draws)
        logp = torch.log(torch.clamp(probs, min=1e-12))
        nll = -torch.take_along_dim(logp, cls[..., None], dim=-1)[..., 0]   # (B, T)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = torch.sum(nll * mask) / denom
        acc = torch.sum((torch.argmax(probs, dim=-1) == cls) * mask) / denom
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "acc": acc.detach()}

    return step


def _collate_cls(utts, seg_len: int) -> Dict:
    T = bucket_len(max(u.flen for u in utts), seg_len, 1)
    feats = np.stack([padding(u.feats, T).astype(np.float32) for u in utts])
    cls = np.stack([padding(u.src_class_code, T).astype(np.int32) for u in utts])
    mask = np.stack([(np.arange(T) < u.flen).astype(np.float32) for u in utts])
    return {"feats": feats, "cls": cls, "mask": mask}


def classifier_config(exp: ExperimentConfig, n_spk: int) -> GRURNNConfig:
    m = exp.model
    return GRURNNConfig(
        in_dim=m.in_dim, out_dim=n_spk, hidden_units=m.hidden_units,
        hidden_layers=m.hidden_layers, kernel_size=m.kernel_size,
        dilation_size=m.dilation_size, do_prob=m.do_prob,
        scale_in=True, scale_out=False)


def run_train_cls(exp: ExperimentConfig, feat_files: Sequence[str],
                  eval_files_src_list: Sequence[Sequence[str]],
                  eval_files_trg_list: Sequence[Sequence[str]],
                  spk_src_list: Sequence[str], spk_trg_list: Sequence[str],
                  stats_jnt: str, expdir: str, device=None) -> Dict:
    """Train the per-frame speaker classifier on ``device`` (CUDA unless
    ``device="cpu"``); returns {"history", "params", "cfg"} and writes
    ``history_cls.json`` to ``expdir``."""
    device = resolve_device(device)
    os.makedirs(expdir, exist_ok=True)
    cfg = classifier_config(exp, len(spk_src_list) + len(spk_trg_list))
    use_pallas = exp.model.use_pallas
    tcfg = exp.train

    mean_jnt = read_store(stats_jnt, "/mean_feat_org_lf0_jnt")
    scale_jnt = read_store(stats_jnt, "/scale_feat_org_lf0_jnt")
    params = init_gru_rnn(torch.Generator(device=device).manual_seed(tcfg.seed), cfg)
    params["scale_in"] = {"mean": torch.as_tensor(mean_jnt, dtype=torch.float32, device=device),
                          "scale": torch.as_tensor(scale_jnt, dtype=torch.float32, device=device)}
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=tcfg.lr)
    draws = Draws(torch.Generator(device=device).manual_seed(tcfg.seed + 1))
    np_rng = np.random.default_rng(tcfg.seed)

    train_ds = MultSpkTrainClsDataset(feat_files, spk_src_list, spk_trg_list, n_cyc=1,
                                      seed=tcfg.seed)
    eval_ds = MultSpkEvalClsDataset(eval_files_src_list, eval_files_trg_list,
                                    spk_src_list, spk_trg_list)
    step = make_classifier_step(cfg, use_pallas)

    @torch.no_grad()
    def eval_forward(feats: np.ndarray) -> torch.Tensor:
        probs, _, _ = gru_rnn_apply(params, cfg, torch.as_tensor(feats, device=device),
                                    torch.zeros((1, cfg.out_dim), device=device),
                                    softmax=True, use_pallas=use_pallas)
        return probs

    history: List[Dict] = []
    bsu = tcfg.batch_size_utt
    for epoch in range(tcfg.epoch_count):
        t0 = time.time()
        order = np.arange(len(train_ds))
        np_rng.shuffle(order)
        ms = []
        for s in range(0, len(order), bsu):
            utts = [train_ds[i] for i in order[s:s + bsu]]
            m_ = step(params, opt, _collate_cls(utts, tcfg.batch_size), draws)
            ms.append({k: float(v) for k, v in m_.items()})
        train_m = {k: float(np.mean([x[k] for x in ms])) for k in ms[0]}

        # eval: frame accuracy over both directions of the deterministic pairs
        correct = total = 0.0
        for i in range(len(eval_ds)):
            item = eval_ds[i]
            for side in ("src", "trg"):
                r = item[side]
                pred = torch.argmax(eval_forward(r["feats"][None])[0], dim=-1).cpu().numpy()
                correct += float((pred == r["class_code"]).sum())
                total += len(pred)
        acc_eval = correct / max(total, 1.0)
        history.append({"epoch": epoch + 1, "train": train_m, "eval_acc": acc_eval})
        logging.info("cls epoch %d: train %s eval_acc %.3f (%.1fs)", epoch + 1,
                     {k: round(v, 3) for k, v in train_m.items()}, acc_eval, time.time() - t0)

    with open(os.path.join(expdir, "history_cls.json"), "w") as f:
        json.dump({"history": history}, f, indent=2)
    return {"history": history, "params": params, "cfg": cfg}


def main(argv=None):
    """CLI: train the per-frame speaker classifier over N speakers on a
    prepared workspace (per-speaker stages 1-3 must have run)."""
    import argparse

    from ..utils.config import load_config
    from .recipe import RecipePaths
    from .stats import calc_stats_joint

    p = argparse.ArgumentParser(prog="cyclevae_tpu_torch.pipeline.train_stage_cls")
    p.add_argument("--work", required=True)
    p.add_argument("--src-speakers", nargs="+", required=True)
    p.add_argument("--trg-speakers", nargs="+", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n-train", type=int, default=40)
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
    train_files = []
    for spk in list(args.src_speakers) + list(args.trg_speakers):
        train_files += paths.h5s(spk)[:paths.n_train]
    stats_jnt = os.path.join(paths.work, "stats", "stats_jnt_cls.npz")
    calc_stats_joint(train_files, [], stats_jnt)
    expdir = os.path.join(paths.work, "exp", exp.name() + "_cls")
    res = run_train_cls(exp, train_files,
                        [paths.h5s(s, True) for s in args.src_speakers],
                        [paths.h5s(s, True) for s in args.trg_speakers],
                        args.src_speakers, args.trg_speakers, stats_jnt, expdir,
                        device=args.device)
    logging.info("cls training done: eval_acc=%.3f", res["history"][-1]["eval_acc"])


if __name__ == "__main__":
    main()
