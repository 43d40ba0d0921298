"""Closed loop of vocoded conversions rendered by the published WaveRNN-896:
``drivers/vocode.py``'s requests, one client, back to back, with the
vocoder's output layer the dual 8-bit coarse / fine softmax over 16-bit
audio (``WaveRNNConfig.dual``; K4's dual instantiation on the card).

The check compares the conversion with the plain reference's, as
``vocode.py`` does, then rebuilds the conditioning from the reference's
conversion and, teacher-forced on the rendering's own 16-bit samples
(``reference/wavernn_dual.py``), judges each sampled coarse and fine byte by
how far its score lies below its head's best.

Set-up fails at once, before any weight or input is made, where the
program has no dual output.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.drivers import _conversion as conv
from benchmark.drivers import vocode
from benchmark.harness import speech, weights
from benchmark.harness.core import HERE, load_module
from benchmark.reference import dsp as ref_dsp
from benchmark.reference import wavernn_dual as ref_dual

_WORK = load_module(HERE / "work" / "wavernn_dual.py", "bench_work_wavernn_dual")


def dual_weights(generator: torch.Generator, v: Dict) -> Dict:
    """The dual WaveRNN's conditioning net, GRU and four output layers, drawn
    as ``harness/weights.py`` draws the single one.  Every entry of ``w_ih``
    is drawn, the masked ones too: the program and the reference each apply
    the mask."""
    H, K, C, Hh = v["hidden_units"], v["n_classes"], v["cond_dim"], v["head_dim"]
    leaves = [("cond.w", (C, v["feat_dim"] + v["n_spk"])), ("cond.b", (C,)),
              ("gru.w_ih", (3 * H, 3 + C)), ("gru.w_hh", (3 * H, H)), ("gru.b_ih", (3 * H,)),
              ("gru.b_hh", (3 * H,))]
    for o, shape in (("O1", (Hh, H // 2)), ("O2", (K, Hh)), ("O3", (Hh, H // 2)), ("O4", (K, Hh))):
        leaves += [(f"{o}.w", shape), (f"{o}.b", (shape[0],))]
    flat = weights._fill(generator, leaves, generator.device)
    p = {"cond": {"w": flat["cond.w"], "b": flat["cond.b"]},
         "gru": {k: flat[f"gru.{k}"] for k in ("w_ih", "w_hh", "b_ih", "b_hh")}}
    p.update({o: {"w": flat[f"{o}.w"], "b": flat[f"{o}.b"]} for o in ("O1", "O2", "O3", "O4")})
    return p


class Driver(vocode.Driver):

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, dtype: str):
        super().__init__(config, traffic, seed, device, dtype)
        # the 16-bit output fixes both: two bytes of 256 classes, and heads
        # over the halves of h (the configuration states the same numbers)
        self.v = {**self.v, "n_classes": 256, "head_dim": self.v["hidden_units"] // 2}

    def _work(self, T_src: int) -> Dict[str, float]:
        """The work a rendering needs: the source's encoding and its one
        conversion decode, the conditioning net per frame and its input
        gates per sample, and the dual sampler per sample."""
        v = self.v
        H, K, C = v["hidden_units"], v["n_classes"], v["cond_dim"]
        n = ref_dual.n_samples(T_src, v["hop"])
        w = conv.conversion_work(self.m, [T_src], [T_src])
        f4, b4 = _WORK.work(1, n, H, K)
        w.update({"K4.flops": f4, "K4.bytes": b4, "samples": float(n),
                  "audio_s": n / v["fs"]})
        w["model_flops"] += (2.0 * T_src * v["feat_dim"] * C + 2.0 * n * (C + 3) * 3 * H + f4)
        return w

    def setup(self) -> None:
        from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig
        if "dual" not in getattr(WaveRNNConfig, "__dataclass_fields__", {}):
            raise SystemExit("benchmark: the program's WaveRNNConfig has no dual output "
                             "(a coarse and a fine softmax over 16-bit audio)")
        from cyclevae_tpu_torch.pipeline.decode import device_decode_pair, gv_postfilter
        from cyclevae_tpu_torch.pipeline.features import convert_f0
        from cyclevae_tpu_torch.pipeline.vocoder_stage import (converted_conditioning,
                                                               synthesize_vocoder)
        self._fns = (device_decode_pair, gv_postfilter, convert_f0, converted_conditioning,
                     synthesize_vocoder)
        rng = np.random.default_rng(self.seed)
        self.pool = conv.Pool(self.tr, rng)
        mean, scale = speech.stats(self.pool.feats)
        mcep = np.concatenate(self.pool.feats)[:, self.m["stdim"] + 1:].astype(np.float64)
        self.gv_data = mcep.var(axis=0)
        self.gv_model = self.gv_data * rng.uniform(0.5, 1.0, size=self.gv_data.shape)
        lf0 = np.log(np.concatenate([f[f > 0] for f in self.pool.f0]))
        self.f0_stats = (float(lf0.mean()), float(lf0.std()),
                         float(lf0.mean() + np.log(self.tr["f0_ratio"])),
                         float(lf0.std() * self.tr["f0_std_ratio"]))
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        p = weights.cyclevae(g, self.m, torch.as_tensor(mean), torch.as_tensor(scale))
        self.vp = dual_weights(g, self.v)
        self.p_ref, self.vp_ref = weights.clone(p), weights.clone(self.vp)
        self.codec = conv.make_codec(self.config, p, self.dev, self.dtype)
        v = self.v
        self.vcfg = WaveRNNConfig(**{k: v[k] for k in ("n_classes", "cond_dim", "hidden_units",
                                                       "feat_dim", "n_spk", "hop", "dual")})
        self.works = [self._work(self.pool.lens[a]) for a, _ in self.pool.pairs]
        for a, b in self.pool.warm_pairs(self.config["bucket"]):
            self._request(a, b, 0)
        self.i = 0
        self.kept = {}

    def check(self) -> Dict[str, float]:
        gaps = {"convert_gap": 0.0, "coarse_gap": 0.0, "fine_gap": 0.0}
        for k in self.pool.checked(self.seed + 7, self.tr["check_requests"], self.kept):
            i, (cv, wave) = self.kept[k]
            a, b = self.pool.pairs[k]
            rs = conv.request_seed(self.seed, i)
            src = self.pool.feats[a]
            want = conv.reference_conversion(self.config, self.p_ref, src, self.pool.feats[b],
                                             rs, self.dev)
            cv_ref = ref_dsp.gv_postfilter(want[2].double().cpu().numpy(), self.gv_data,
                                           self.gv_model)
            gaps["convert_gap"] = max(gaps["convert_gap"], conv.gap(
                cv, torch.as_tensor(cv_ref, dtype=torch.float32, device=self.dev)))
            f0 = ref_dsp.convert_f0(self.pool.f0[a], *self.f0_stats)
            feat = ref_dsp.conditioning(src, cv_ref, f0, self.tr["shiftms"])
            cond = ref_dual.upsample(self.vp_ref, torch.as_tensor(feat, device=self.dev),
                                     self.v["hop"])
            w = torch.as_tensor(np.asarray(wave, np.float32), device=self.dev)
            if w.shape[0] != cond.shape[0]:
                return {**gaps, "coarse_gap": float("inf"), "fine_gap": float("inf")}
            c, f = ref_dual.bytes_of(w)
            gc, gf = ref_dual.score_gaps(self.vp_ref, cond, c, f, rs % (1 << 32),
                                         self.config["temperature"])
            gaps["coarse_gap"] = max(gaps["coarse_gap"], float(gc.max()))
            gaps["fine_gap"] = max(gaps["fine_gap"], float(gf.max()))
        return gaps
