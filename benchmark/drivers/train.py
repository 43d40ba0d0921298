"""Closed loop of the port's train step (``vi/train.py`` ``make_train_step``).

Set-up makes a corpus of speech-like utterances (a fixed set of lengths,
features from the seed), groups it into batches of ``bsu`` utterances (a
fixed grouping, in an order drawn from the seed), makes the weights on the
device, and builds ONE train step with its optimizer.  It drives that step
through its first step, recording the draws (dropout masks, latent noise),
the first gradient as Adam holds it after one update, the parameters before
each update and Adam's moments before the updates the check follows; the
window then goes on with the same object.  Each unit is one step on the
next batch, ended by a host copy of its metrics, as a training loop logs
them.

The check runs the first optimizer update (one a segment) in the plain
reference from the same weights, batch and draws, and compares its loss
and each leaf's first-gradient norm.  It follows the later updates from
the program's own state, since from the same weights the two trajectories
part by rounding that grows update by update: the next ``check_updates`` -
1 updates, the first segment with a masked row (where the shortest
utterance ends) and the last valid segment.  The reference runs every
segment up to them with the program's parameters of that segment, carrying
its state across the mask boundary, and makes those updates from the
program's moments; it compares their losses and the median leaf's change,
and the number of updates the step made (none for the segments past every
utterance).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import speech, weights
from benchmark.harness.core import HERE, load_module
from benchmark.reference import cyclevae as ref
from benchmark.work import cyclevae as work

_K2 = load_module(HERE / "kernels" / "K2.py", "bench_kernel_K2")
_K3 = load_module(HERE / "kernels" / "K3.py", "bench_kernel_K3")


def leaf_names(p: Dict) -> Dict[str, torch.Tensor]:
    out = {}
    for net in ("encoder", "decoder"):
        n = p[net]
        for l, (w, b) in enumerate(zip(n["conv"]["w"], n["conv"]["b"])):
            out[f"{net}.conv.w.{l}"], out[f"{net}.conv.b.{l}"] = w, b
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            out[f"{net}.gru.{k}"] = n["gru"][k]
        out[f"{net}.out.w"], out[f"{net}.out.b"] = n["out"]["w"], n["out"]["b"]
    return out


def trainable_names(p: Dict) -> List[str]:
    """The leaves' names in the reference's ``trainable`` order."""
    name_of = {t.data_ptr(): k for k, t in leaf_names(p).items()}
    return [name_of[t.data_ptr()] for t in ref.trainable(p)]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep) -> List[float]:
    """Per kept leaf |got - want| / max(want, the median leaf's want)."""
    med = statistics.median(want[k] for k in keep)
    return [abs(got[k] - want[k]) / max(want[k], med) for k in keep]


class Driver:

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, dtype: str):
        self.m, self.tr, self.seed = config["model"], traffic, seed
        self.dev, self.dtype = device, dtype
        # the recipe's batch and TBPTT segment, from the configuration
        self.bsu, self.seg_len = config["batch_size_utt"], config["seg_len"]

    # ---- set-up ------------------------------------------------------
    def _batches(self, rng) -> List[Dict]:
        """``batches`` batches of ``bsu`` utterances.  Every batch holds the
        same set of lengths (``step_frames``), in an order drawn from the
        seed, so that every step and every seed asks for the same work."""
        tr, m = self.tr, self.m
        bsu, T = len(tr["step_frames"]), self.seg_len * tr["n_segs"]
        if bsu != self.bsu:
            raise ValueError(f"{bsu} step_frames for a batch of {self.bsu} utterances")
        batches, feats = [], []
        for _ in range(tr["batches"]):
            lens = [int(x) for x in rng.permutation(tr["step_frames"])]
            x = np.zeros((bsu, T, m["in_dim"]), np.float32)
            for b, n in enumerate(lens):
                f = speech.features(rng, n)
                x[b, :n] = f[:T]
                feats.append(f)
            code = np.zeros((bsu, T, m["n_spk"]), np.float32)
            src, trg = code.copy(), code.copy()
            src[..., 0], trg[..., 1] = 1.0, 1.0
            batches.append({"feats": x, "src_code": src, "trg_code": trg,
                            "cv_excit": x[..., :m["stdim"]].copy(),
                            "flens": np.asarray([min(n, T) for n in lens], np.int32)})
        self.mean, self.scale = speech.stats(feats)
        return batches

    def _work(self, flens: np.ndarray) -> Dict[str, float]:
        """The work a step needs: real frames only, per segment that has any."""
        m, sl = self.m, self.seg_len
        H, B = m["hidden_units"], len(flens)
        out = {"frames": float(flens.sum()), "model_flops": 0.0}
        for k in ("K2", "K3"):
            out[f"{k}.flops"] = out[f"{k}.bytes"] = 0.0
        for s in range(self.tr["n_segs"]):
            real = float(np.clip(flens - s * sl, 0, sl).sum())
            if real == 0:
                continue
            # per cycle: encoder, the 2B decode, cv encoder, cyclic decoder
            for rows, d_out in ((B, 2 * m["lat_dim"]), (2 * B, m["out_dim"]),
                                (B, 2 * m["lat_dim"]), (B, m["out_dim"])):
                for k, mod in (("K2", _K2), ("K3", _K3)):
                    f, b = mod.work(rows, real / B, H, d_out)
                    out[f"{k}.flops"] += m["n_cyc"] * f
                    out[f"{k}.bytes"] += m["n_cyc"] * b
        out["model_flops"] = 3.0 * work.train_flops_per_frame(m) * out["frames"]
        return out

    def setup(self) -> None:
        from cyclevae_tpu_torch.models.gru_vae import Draws
        from cyclevae_tpu_torch.vi.train import (CycleVAEConfig, CycleVAEParams, TrainState,
                                                 make_optimizer, make_train_step)

        class Recording(Draws):
            log = None

            def bernoulli(self, keep, shape):
                t = super().bernoulli(keep, shape)
                if self.log is not None:
                    self.log.append(("bernoulli", t))
                return t

            def normal(self, shape):
                t = super().normal(shape)
                if self.log is not None:
                    self.log.append(("normal", t))
                return t

        tr, m, dev = self.tr, self.m, self.dev
        rng = np.random.default_rng(self.seed)
        self.batches = self._batches(rng)
        self.works = [self._work(b["flens"]) for b in self.batches]
        g = torch.Generator(device=dev).manual_seed(self.seed)
        p = weights.cyclevae(g, m, torch.as_tensor(self.mean), torch.as_tensor(self.scale))
        self.p0 = weights.clone(p)
        keys = {k: m[k] for k in ("in_dim", "out_dim", "lat_dim", "n_spk", "hidden_units",
                                  "hidden_layers", "kernel_size", "dilation_size", "n_cyc",
                                  "do_prob", "stdim")}
        cfg = CycleVAEConfig(**keys, use_pallas=True, compute_dtype=self.dtype)
        params = CycleVAEParams(**weights.as_port(p))
        opt = make_optimizer(cfg, lr=tr["lr"])
        self.ts = TrainState(params, opt.init(params),
                             torch.Generator(device=dev).manual_seed(self.seed + 1), 0)
        self.step = make_train_step(cfg, opt, self.seg_len, tr["n_segs"])
        self.draws = Recording(self.ts.rng)
        self.names = leaf_names(p)
        by_ptr = {t.data_ptr(): k for k, t in self.names.items()}
        self.followed = self._followed(self.batches[0]["flens"])
        self.first_grad, self.before, self.after, self.moments = {}, {}, {}, {}
        self.updates = 0
        host = lambda t: t.detach().to("cpu", copy=True)

        def before_update(optimizer, args, kwargs):
            # the parameters each later segment runs with, and Adam's
            # moments before the updates the check follows (on the host)
            u = self.updates
            if u <= max(self.followed):
                self.before[u] = {k: host(t) for k, t in self.names.items()}
            if u in self.followed:
                st = optimizer.state
                self.moments[u] = {by_ptr[t.data_ptr()]: (
                    host(st[t]["exp_avg"]), host(st[t]["exp_avg_sq"]), int(st[t]["step"]))
                    if t in st else None for g in optimizer.param_groups for t in g["params"]}

        def after_update(optimizer, args, kwargs):
            # the first gradient as Adam holds it after one update
            # (exp_avg = (1 - b1) g), and the parameters after the followed ones
            self.updates += 1
            if self.updates == 1:
                for group in optimizer.param_groups:
                    for t in group["params"]:
                        m1 = optimizer.state[t]["exp_avg"]
                        self.first_grad[by_ptr[t.data_ptr()]] = float(
                            torch.linalg.vector_norm(m1) / 0.1)
            if self.updates - 1 in self.followed:
                self.after[self.updates - 1] = {k: host(t) for k, t in self.names.items()}

        hooks = (self.ts.opt_state.register_step_pre_hook(before_update),
                 self.ts.opt_state.register_step_post_hook(after_update))
        self.at = 0
        self.draws.log = []
        metrics = self._step()
        self.log = self.draws.log
        self.draws.log = None
        for h in hooks:
            h.remove()
        self.seg_losses = [float(x) for x in metrics["loss"].numpy()]

    def _followed(self, flens) -> List[int]:
        """The segments whose updates the check follows from the program's
        state: those after the first up to ``check_updates``, the first that
        masks a row, and the last with a real frame."""
        flens = np.asarray(flens)
        last = int(flens.max() - 1) // self.seg_len
        first_masked = min(int(flens.min()) // self.seg_len, last)
        return sorted({*range(1, min(self.tr["check_updates"], last + 1)), first_masked, last})

    def _step(self) -> Dict:
        b = self.batches[self.at % len(self.batches)]
        self.at += 1
        self.ts, metrics = self.step(self.ts, b, draws=self.draws)
        return {k: v.cpu() for k, v in metrics.items()}

    # ---- the window ---------------------------------------------------
    def unit(self) -> Dict[str, float]:
        w = self.works[self.at % len(self.batches)]
        self._step()
        return dict(w, steps=1.0)

    def release(self) -> None:
        del self.ts, self.step, self.draws, self.names

    # ---- the check ----------------------------------------------------
    def check(self) -> Dict[str, float]:
        out = self._check_start()
        out.update(self._check_followed())
        return out

    def _check_start(self) -> Dict[str, float]:
        """The first update, reference and program from the same weights."""
        bad = dict.fromkeys(("loss_gap", "grad_gap"), float("inf"))
        p = weights.clone(self.p0)
        try:
            losses, grads = ref.train_steps(p, ref.Model.of(self.m), self.batches[:1], [self.log],
                                            self.tr["lr"], self.seg_len, self.tr["n_segs"],
                                            max_updates=1)
        except ref.ReplayMismatch as e:
            # the program drew for other shapes than the model's definition
            # asks for: no sound step, no number
            print(f"benchmark: {e}", file=sys.stderr)
            return bad
        want = losses[0][0]
        if want is None:
            return bad
        ref_grad = self._norms_by_name(p, grads)
        gap = abs(self.seg_losses[0] - want) / abs(want)
        print(f"benchmark: first update's loss gap {gap:.3g}", file=sys.stderr)
        return {"loss_gap": gap,
                "grad_gap": max(leaf_gaps(self.first_grad, ref_grad, self._moved(ref_grad)))}

    def _check_followed(self) -> Dict[str, float]:
        """The later updates, followed from the program's own state."""
        bad = dict.fromkeys(("followed_loss_gap", "followed_update_gap"), float("inf"))
        flens = np.asarray(self.batches[0]["flens"])
        n_valid = sum(bool(np.any(flens > s * self.seg_len)) for s in range(self.tr["n_segs"]))
        if self.updates != n_valid or set(self.after) != set(self.followed):
            print(f"benchmark: the first step made {self.updates} updates for {n_valid} "
                  "segments with a real frame", file=sys.stderr)
            return bad

        def params_at(s):
            p = weights.clone(self.p0)
            for k, t in leaf_names(p).items():
                t.copy_(self.before[s][k])
            return p

        order = trainable_names(self.p0)

        def adam_at(s, leaves):
            # Adam from the program's moments and step count before update s
            held = self.moments[s]
            opt = ref.Adam(leaves, self.tr["lr"])
            opt.m = [held[k][0].to(x.device) if held[k] else torch.zeros_like(x)
                     for k, x in zip(order, leaves)]
            opt.v = [held[k][1].to(x.device) if held[k] else torch.zeros_like(x)
                     for k, x in zip(order, leaves)]
            steps = {held[k][2] if held[k] else 0 for k in order}
            if len(steps) != 1:
                raise ValueError(f"Adam's leaves are at different steps: {sorted(steps)}")
            opt.t = steps.pop()
            return opt

        try:
            got = ref.follow_updates(params_at, adam_at, ref.Model.of(self.m), self.batches[0],
                                     self.log, self.seg_len, self.tr["n_segs"], self.followed)
        except ref.ReplayMismatch as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return bad
        loss_gaps, update_gaps = [], []
        for s, (loss, grads, new) in got.items():
            ref_grad = dict(zip(order, (float(torch.linalg.vector_norm(g)) for g in grads)))
            ref_change = {k: float(torch.linalg.vector_norm(x.cpu() - self.before[s][k]))
                          for k, x in zip(order, new)}
            prog_change = {k: float(torch.linalg.vector_norm(self.after[s][k] - self.before[s][k]))
                           for k in order}
            loss_gaps.append(abs(self.seg_losses[s] - loss) / abs(loss))
            update_gaps.append(statistics.median(
                leaf_gaps(prog_change, ref_change, self._moved(ref_grad))))
        print("benchmark: from the program's state, segments "
              + " ".join(f"{s}: loss gap {a:.3g}, median leaf's change gap {b:.3g};"
                         for s, a, b in zip(got, loss_gaps, update_gaps)), file=sys.stderr)
        return {"followed_loss_gap": max(loss_gaps), "followed_update_gap": max(update_gaps)}

    @staticmethod
    def _norms_by_name(p: Dict, grads) -> Dict[str, float]:
        return {k: float(torch.linalg.vector_norm(g)) for k, g in zip(trainable_names(p), grads)}

    @staticmethod
    def _moved(ref_grad: Dict[str, float]) -> List[str]:
        """Leaves whose reference gradient is nought to rounding move by
        round-off alone under Adam: left out by this rule, never by name."""
        med = statistics.median(ref_grad.values())
        return [k for k, g in ref_grad.items() if g >= 1e-3 * med]
