"""Posterior inference over utterances, one after another, through the
port's stage entry ``pipeline/infer_stage.py`` ``posterior_convert_hmc``:
per utterance the batched log-joint of the frozen decoder
(``infer/logjoint.py``: K2 forward, K3 backward, the chains on the batch
axis) sampled by ``infer/hmc.py`` ``hmc_sample_batch`` from z = 0 with the
stage's settings, then the posterior-predictive decode of the last
``n_predictive`` samples through the target's code (K1); a unit ends when
the stage's statistics are on the host.

The draws come from the benchmark's ``Draws``, which counts the
transitions (one momentum and one accept uniform each) and keeps the first
utterance's.  While the first utterance runs, the stage's sampler is
wrapped so that its samples and adapted step and mass are kept for the
check.  The check follows the program from its own state: for sampling
transitions drawn from the seed it takes the program's sample before the
transition, the momentum and uniform drawn for it, the step size and
inverse mass the program adapted, runs the transition in the plain
reference, and compares the program's next sample with the reference's
end point, or start point where the reference rejects.  An accept decision
within rounding of its threshold may go either way; outside that band the
program's next sample has to lie nearer the point the reference chose.
It also decodes the program's last samples in the reference and compares
their mean with the stage's predictive mean.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
from typing import Dict

import numpy as np
import torch

from benchmark.drivers._conversion import MODEL_KEYS
from benchmark.harness import speech, weights
from benchmark.harness.core import HERE, load_module
from benchmark.reference import cyclevae as ref
from benchmark.reference import hmc as ref_hmc
from benchmark.work import cyclevae as work

_K2 = load_module(HERE / "kernels" / "K2.py", "bench_kernel_K2")
_K3 = load_module(HERE / "kernels" / "K3.py", "bench_kernel_K3")
# an accept decision is taken to be within rounding of its threshold where
# |(H0 - H1) - log u| is below this share of |H0| + |H1|
NEAR_TIE_REL = 1e-5
COMPARED = ("median_chain_gap", "accept_mismatch", "predictive_gap")


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest elementwise gap over the reference's RMS."""
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


class Driver:

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, dtype: str):
        self.config, self.tr, self.seed, self.dev, self.dtype = config, traffic, seed, device, dtype
        self.m = config["model"]

    def setup(self) -> None:
        from cyclevae_tpu_torch.infer.draws import Draws
        from cyclevae_tpu_torch.infer.hmc import HMCConfig
        from cyclevae_tpu_torch.pipeline import infer_stage
        from cyclevae_tpu_torch.vi.train import CycleVAEConfig, CycleVAEParams

        class Counting(Draws):
            """Counts the transitions; while ``keep`` is set, copies each
            transition's momentum and accept uniforms into buffers made in
            set-up (so the window allocates nothing for them)."""
            keep = False
            transitions = 0
            kept = 0

            def momentum(self, shape):
                t = super().momentum(shape)
                if self.keep:
                    self.momenta[self.kept].copy_(t)
                return t

            def accept(self, shape):
                t = super().accept(shape)
                if self.keep:
                    self.uniforms[self.kept].copy_(t)
                    self.kept += 1
                self.transitions += 1
                return t

        tr, m, dev = self.tr, self.m, self.dev
        rng = np.random.default_rng(self.seed)
        self.feats = speech.corpus(rng, [tr["utt_frames"]] * tr["pool_utts"])
        mean, scale = speech.stats(self.feats)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        p = weights.cyclevae(g, m, torch.as_tensor(mean), torch.as_tensor(scale))
        self.p_ref = weights.clone(p)
        self.cfg = CycleVAEConfig(**{k: m[k] for k in MODEL_KEYS}, use_pallas=True,
                                  compute_dtype=self.dtype)
        self.params = CycleVAEParams(**weights.as_port(p))
        self.stage = infer_stage
        self.hmc = HMCConfig(step_size=tr["step_size"], n_leapfrog=tr["n_leapfrog"],
                             n_warmup=tr["n_warmup"], n_samples=tr["n_samples"])
        self.draws = Counting(torch.Generator(device=dev).manual_seed(self.seed + 1))
        n_tr = tr["n_warmup"] + tr["n_samples"]
        self.draws.momenta = torch.empty((n_tr, tr["chains"], tr["utt_frames"], m["lat_dim"]),
                                         device=dev)
        self.draws.uniforms = torch.empty((n_tr, tr["chains"]), device=dev)
        self.work = self._work()
        # warm every shape of the window: a short chain on the same sizes,
        # as many predictive rows
        warm = -(-tr["n_predictive"] // tr["chains"])
        self._utterance(0, HMCConfig(tr["step_size"], 2, 2, warm))
        self.i, self.kept = 0, None

    def _work(self) -> Dict[str, float]:
        """The work an utterance needs."""
        tr, m = self.tr, self.m
        n_tr = tr["n_warmup"] + tr["n_samples"]
        C, T, H = tr["chains"], tr["utt_frames"], m["hidden_units"]
        k2, k3 = _K2.work(C, T, H, m["out_dim"]), _K3.work(C, T, H, m["out_dim"])
        # the least an L-step leapfrog needs: L value-and-gradient
        # evaluations a transition (the start point's carried over), each a
        # decoder forward and its input gradient (twice the forward's products);
        # then the predictive decodes, one forward each
        L = tr["n_leapfrog"]
        return {"transitions": float(n_tr), "draws": float(n_tr * C),
                "K2.flops": n_tr * L * k2[0], "K2.bytes": n_tr * L * k2[1],
                "K3.flops": n_tr * L * k3[0], "K3.bytes": n_tr * L * k3[1],
                "model_flops": (n_tr * L * 2.0 * C + tr["n_predictive"])
                * work.decoder_flops(m) * T}

    def _utterance(self, i: int, hmc, keep: bool = False):
        """One utterance through the stage; with ``keep``, also the
        sampler's (samples, info)."""
        tr, stage = self.tr, self.stage
        sampler, held = stage.hmc_sample_batch, {}

        def keeping(*args, **kwargs):
            held["out"] = sampler(*args, **kwargs)
            return held["out"]

        if keep:
            stage.hmc_sample_batch = keeping
        try:
            r = stage.posterior_convert_hmc(
                self.params, self.cfg, self.feats[i % len(self.feats)], 0, 1, self.draws,
                n_chains=tr["chains"], hmc=hmc, obs_scale=tr["obs_scale"],
                n_predictive=tr["n_predictive"])
        finally:
            stage.hmc_sample_batch = sampler
        return r, held.get("out")

    def unit(self) -> Dict[str, float]:
        first = self.kept is None
        self.draws.keep = first
        before = self.draws.transitions
        r, sampled = self._utterance(self.i, self.hmc, keep=first)
        done = self.draws.transitions - before
        if first:
            self.draws.keep = False
            self.kept = (self.i, r, sampled, self.draws.momenta[:self.draws.kept],
                         self.draws.uniforms[:self.draws.kept])
        self.i += 1
        out = dict(self.work)
        if done != out["transitions"]:
            out["failed"] = 1
        return out

    def release(self) -> None:
        del self.params

    def check(self) -> Dict[str, float]:
        tr, m = self.tr, self.m
        i, r, sampled, momenta, uniforms = self.kept
        nw = tr["n_warmup"]
        if (sampled is None or len(momenta) != nw + tr["n_samples"]
                or len(uniforms) != len(momenta)):
            return dict.fromkeys(COMPARED, float("inf"))
        samples, info = sampled
        feats = torch.as_tensor(self.feats[i % len(self.feats)], device=self.dev)
        code = torch.zeros((tr["utt_frames"], m["n_spk"]), device=self.dev)
        code[:, 0] = 1.0
        lj = ref_hmc.LogJoint(self.p_ref, ref.Model.of(m), feats, code, tr["obs_scale"])
        eps = float(info["step_size"])
        inv_mass = info["inv_mass"]
        if not (math.isfinite(eps) and eps > 0 and bool(torch.isfinite(inv_mass).all())
                and bool((inv_mass > 0).all())):
            # no sound sampler adapts to such a step or metric
            print(f"benchmark: the program adapted the step size {eps} and an inverse mass "
                  f"in [{float(inv_mass.min())}, {float(inv_mass.max())}]", file=sys.stderr)
            return dict.fromkeys(COMPARED, float("inf"))
        rng = np.random.default_rng(self.seed + 7)
        ks = 1 + rng.permutation(tr["n_samples"] - 1)[:tr["check_transitions"]]
        gaps, mismatch, ties, seen = [], 0, 0, []
        for k in ks:
            z = samples[k - 1]
            end, h0, h1 = ref_hmc.transition(lj, z, momenta[nw + k], eps, inv_mass,
                                             tr["n_leapfrog"])
            logu = torch.log(uniforms[nw + k])
            got = samples[k]
            for c in range(z.shape[0]):
                if not bool(torch.isfinite(h0[c])):
                    # no finite energy where the program's chain stands: no
                    # sound sampler gets there, and no decision is right
                    mismatch += 1
                    gaps.append(float("inf"))
                    continue
                dh = h0[c] - h1[c]
                accept = bool(logu[c] < dh)     # a proposal of no finite energy is rejected
                # the decision's distance from its threshold, as a share of
                # the energies (not finite where the proposal's energy is not)
                margin = float((dh - logu[c]) / (h0[c].abs() + h1[c].abs()))
                to_end, to_start = _gap(got[c], end[c]), _gap(got[c], z[c])
                seen.append((margin, to_end, to_start))
                if abs(margin) < NEAR_TIE_REL:
                    ties += 1
                    gaps.append(min(to_end, to_start))
                    continue
                gaps.append(to_end if accept else to_start)
                # the program's next sample lies nearer the point that the
                # reference did not choose: its accept decision differs
                mismatch += int((to_end < to_start) != accept)
        print("benchmark: accept decisions (margin over |H0| + |H1|, gap to the proposal, gap "
              "to the start): " + json.dumps([[float(f"{x:.4g}") for x in d] for d in seen]),
              file=sys.stderr)
        pred = self._predictive(samples, r["cv_mcep_mean"])
        print(f"benchmark: chain gaps: median {statistics.median(gaps):.3g}, "
              f"widest {max(gaps):.3g}; accept decisions differing {mismatch} of "
              f"{len(gaps) - ties} ({ties} within rounding of the threshold); program's accept "
              f"rate {float(info['accept_prob']):.3f}; predictive mean gap {pred:.3g}",
              file=sys.stderr)
        # the median chain's: a few chains' leapfrogs amplify rounding
        # thousands of times, so the widest chain's gap swings from seed to
        # seed and reaches the control's (PERF.md)
        return {"median_chain_gap": statistics.median(gaps),
                "accept_mismatch": float(mismatch), "predictive_gap": pred}

    @torch.no_grad()
    def _predictive(self, samples: torch.Tensor, got: np.ndarray) -> float:
        """The stage's posterior-predictive mean against the reference's
        decode, through the target's code, of the program's last samples."""
        tr, m = self.tr, self.m
        T = tr["utt_frames"]
        z = samples.reshape(-1, T, m["lat_dim"])[-tr["n_predictive"]:]
        code = torch.zeros((z.shape[0], T, m["n_spk"]), device=self.dev)
        code[..., 1] = 1.0
        dec = self.p_ref["decoder"]
        out, _, _ = ref.net_apply(dec, ref.Model.of(m), torch.cat([code, z], -1),
                                  ref.dec_y0(dec, z.shape[0]),
                                  torch.zeros((z.shape[0], m["hidden_units"]), device=self.dev),
                                  False)
        return _gap(torch.as_tensor(got, device=self.dev), out.mean(0))
