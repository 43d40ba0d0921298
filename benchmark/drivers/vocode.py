"""Closed loop of vocoded conversions, one client, requests back to back.

A request takes a (source, target) pair of feature matrices and the source's
F0 track through: ``device_decode_pair`` (K1), the GV postfilter
(``gv_postfilter``), the log-Gaussian F0 transform (``convert_f0``), the
vocoder's conditioning (``converted_conditioning``), and the WaveRNN
rendering (``synthesize_vocoder``: the conditioning net and its upsampling,
then K4) at the cell's temperature with a seed for each request; it ends
when the waveform is on the host.

The check takes, once the window has closed, the longest pair served and
others drawn from the seed.  It compares the conversion with the plain
reference's, then rebuilds the conditioning from the reference's conversion
and, teacher-forced on the rendering's own samples, judges each sampled
class by how far its score lies below the reference's best.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.drivers import _conversion as conv
from benchmark.harness import speech, weights
from benchmark.harness.core import HERE, load_module
from benchmark.reference import dsp as ref_dsp
from benchmark.reference import wavernn as ref_voc

_K4 = load_module(HERE / "kernels" / "K4.py", "bench_kernel_K4")


class Driver:

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, dtype: str):
        self.config, self.tr, self.seed, self.dev, self.dtype = config, traffic, seed, device, dtype
        self.m, self.v = config["model"], config["vocoder"]

    def _work(self, T_src: int) -> Dict[str, float]:
        """The work a rendering needs: the source's encoding and its one
        conversion decode (the other two directions are not rendered), the
        conditioning net per frame and its input gates per sample, and K4
        per sample."""
        v = self.v
        H, K, FC, C = v["hidden_units"], v["n_classes"], v["fc_dim"], v["cond_dim"]
        n = ref_voc.n_samples(T_src, v["hop"])
        w = conv.conversion_work(self.m, [T_src], [T_src])
        f4, b4 = _K4.work(1, n, H, K, FC)
        w.update({"K4.flops": f4, "K4.bytes": b4, "samples": float(n),
                  "audio_s": n / v["fs"]})
        w["model_flops"] += (2.0 * T_src * v["feat_dim"] * C + 2.0 * n * C * 3 * H + f4)
        return w

    def setup(self) -> None:
        from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig
        from cyclevae_tpu_torch.pipeline.decode import device_decode_pair, gv_postfilter
        from cyclevae_tpu_torch.pipeline.features import convert_f0
        from cyclevae_tpu_torch.pipeline.vocoder_stage import (converted_conditioning,
                                                               synthesize_vocoder)
        self._fns = (device_decode_pair, gv_postfilter, convert_f0, converted_conditioning,
                     synthesize_vocoder)
        rng = np.random.default_rng(self.seed)
        self.pool = conv.Pool(self.tr, rng)
        mean, scale = speech.stats(self.pool.feats)
        # the target speaker's GV and the model's converted GV (smaller, as a
        # trained model's is), the two speakers' log-F0 statistics
        mcep = np.concatenate(self.pool.feats)[:, self.m["stdim"] + 1:].astype(np.float64)
        self.gv_data = mcep.var(axis=0)
        self.gv_model = self.gv_data * rng.uniform(0.5, 1.0, size=self.gv_data.shape)
        lf0 = np.log(np.concatenate([f[f > 0] for f in self.pool.f0]))
        self.f0_stats = (float(lf0.mean()), float(lf0.std()),
                         float(lf0.mean() + np.log(self.tr["f0_ratio"])),
                         float(lf0.std() * self.tr["f0_std_ratio"]))
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        p = weights.cyclevae(g, self.m, torch.as_tensor(mean), torch.as_tensor(scale))
        self.vp = weights.wavernn(g, self.v)
        self.p_ref, self.vp_ref = weights.clone(p), weights.clone(self.vp)
        self.codec = conv.make_codec(self.config, p, self.dev, self.dtype)
        v = self.v
        self.vcfg = WaveRNNConfig(**{k: v[k] for k in ("n_classes", "embed_dim", "cond_dim",
                                                       "hidden_units", "fc_dim", "feat_dim",
                                                       "n_spk", "hop")})
        self.works = [self._work(self.pool.lens[a]) for a, _ in self.pool.pairs]
        for a, b in self.pool.warm_pairs(self.config["bucket"]):
            self._request(a, b, 0)
        self.i = 0
        self.kept = {}

    def _request(self, a: int, b: int, seed: int):
        decode, postfilter, f0_conv, conditioning, synthesize = self._fns
        g = torch.Generator(device=self.dev).manual_seed(seed)
        src = self.pool.feats[a]
        _, _, cv, _, _ = decode(self.codec, g, src, self.pool.feats[b])
        cv = postfilter(cv, self.gv_data, self.gv_model)
        f0 = f0_conv(self.pool.f0[a], *self.f0_stats)
        feat = conditioning(src, cv, f0, self.tr["shiftms"])
        wave = synthesize(self.vp, self.vcfg, feat, seed=seed % (1 << 32),
                          temperature=self.config["temperature"], device=self.dev)
        return cv, wave

    def unit(self) -> Dict[str, float]:
        k = self.pool.order[self.i % len(self.pool.order)]
        a, b = self.pool.pairs[k]
        out = self._request(a, b, conv.request_seed(self.seed, self.i))
        if k not in self.kept:
            self.kept[k] = (self.i, out)
        self.i += 1
        return dict(self.works[k], requests=1.0)

    def release(self) -> None:
        del self.codec, self.vp

    def check(self) -> Dict[str, float]:
        conv_gap = k4_gap = 0.0
        for k in self.pool.checked(self.seed + 7, self.tr["check_requests"], self.kept):
            i, (cv, wave) = self.kept[k]
            a, b = self.pool.pairs[k]
            rs = conv.request_seed(self.seed, i)
            src = self.pool.feats[a]
            want = conv.reference_conversion(self.config, self.p_ref, src, self.pool.feats[b],
                                             rs, self.dev)
            # the program's cv is postfiltered: compare the reference's
            # postfiltered conversion with it
            cv_ref = ref_dsp.gv_postfilter(want[2].double().cpu().numpy(), self.gv_data,
                                           self.gv_model)
            conv_gap = max(conv_gap, conv.gap(cv, torch.as_tensor(cv_ref, dtype=torch.float32,
                                                                  device=self.dev)))
            f0 = ref_dsp.convert_f0(self.pool.f0[a], *self.f0_stats)
            feat = ref_dsp.conditioning(src, cv_ref, f0, self.tr["shiftms"])
            cond = ref_voc.upsample(self.vp_ref, torch.as_tensor(feat, device=self.dev),
                                    self.v["hop"])
            w = torch.as_tensor(np.asarray(wave, np.float32), device=self.dev)
            if w.shape[0] != cond.shape[0]:
                return {"convert_gap": conv_gap, "k4_gap": float("inf")}
            idx = ref_voc.classes_of(w, self.v["n_classes"])
            gaps = ref_voc.score_gaps(self.vp_ref, cond, idx, rs % (1 << 32),
                                      self.config["temperature"])
            k4_gap = max(k4_gap, float(gaps.max()))
        return {"convert_gap": conv_gap, "k4_gap": k4_gap}
