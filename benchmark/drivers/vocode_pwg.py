"""Closed loop of vocoded conversions rendered by Parallel WaveGAN's
generator (v1): ``drivers/vocode.py``'s requests, one client, back to back,
at PWG's frame rate (256-sample frames), rendered by ``synthesize_vocoder``
with a ``PWGConfig`` (the upsampling network, then the noise, the first
convolution, the 30 gated residual layers: the layer kernel on the card,
and the last convolutions), the noise drawn from a generator on the device
seeded per request; a request ends when the waveform is on the host.  The
conversion stays on the device from the encode to the waveform
(``device_decode_pair(..., on_device=True)``), so the host queues each
step while the device runs the one before.

The check takes, once the window has closed, the longest pair served and
others drawn from the seed.  It compares the conversion with the plain
reference's, as ``vocode.py`` does, then renders the reference's own
postfiltered conversion with the plain generator (``reference/pwg.py``) on
the same noise (the same seed on the same device) and reads ``pwg_gap``:
the widest |w - w_ref| over the widest |w_ref|.

Set-up fails at once, before any weight or input is made, where the
program has no Parallel WaveGAN generator.
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
from benchmark.reference import pwg as ref_pwg

_WORK = load_module(HERE / "work" / "pwg.py", "bench_work_pwg")

CONFIG_KEYS = ("layers", "stacks", "kernel_size", "residual_channels", "gate_channels",
               "skip_channels", "aux_channels", "aux_context_window", "upsample_scales", "fs")


def pwg_weights(generator: torch.Generator, v: Dict) -> Dict:
    """The generator's parameters in the layout ``reference/pwg.py`` reads,
    drawn as ``harness/weights.py`` draws the others (one uniform draw,
    Xavier bounds, biases within +-0.05), each layer's leaves on their own
    and then stacked; then each upsampling kernel, the box 1 / (2s+1) within
    +-50% (PWG starts it at the box; a kernel far from it would scale the
    conditioning by its sum four times over)."""
    k, R, G, S, A = (v["kernel_size"], v["residual_channels"], v["gate_channels"],
                     v["skip_channels"], v["aux_channels"])
    L, w = v["layers"], 2 * v["aux_context_window"] + 1
    per_layer = (("dil_w", (G, R, k)), ("dil_b", (G,)), ("aux_w", (G, A)),
                 ("out_w", (R, G // 2)), ("out_b", (R,)), ("skip_w", (S, G // 2)),
                 ("skip_b", (S,)))
    leaves = [("conv_in", (A, A, w)), ("first.w", (R, 1)), ("first.b", (R,)),
              ("last.w1", (S, S)), ("last.b1", (S,)), ("last.w2", (1, S)), ("last.b2", (1,))]
    leaves += [(f"{name}.{l}", shape) for l in range(L) for name, shape in per_layer]
    flat = weights._fill(generator, leaves, generator.device)
    kernels = [(1.0 + 0.5 * torch.empty(2 * s + 1, device=generator.device)
                .uniform_(-1.0, 1.0, generator=generator)) / (2 * s + 1)
               for s in v["upsample_scales"]]
    return {"upsample": {"conv_in": flat["conv_in"], "kernels": kernels},
            "first": {"w": flat["first.w"], "b": flat["first.b"]},
            "layers": {name: torch.stack([flat[f"{name}.{l}"] for l in range(L)])
                       for name, _ in per_layer},
            "last": {n: flat[f"last.{n}"] for n in ("w1", "b1", "w2", "b2")}}


class Driver(vocode.Driver):

    def _work(self, T_src: int) -> Dict[str, float]:
        """The work a rendering needs: the source's encoding and its one
        conversion decode (the other two directions are not rendered), the
        layer kernel's 30 launches and the whole generator, per sample."""
        n = T_src * self.v["hop"]
        w = conv.conversion_work(self.m, [T_src], [T_src])
        flops, nbytes = _WORK.layers_work(self.v, n)
        w.update({"PWG.flops": flops, "PWG.bytes": nbytes, "samples": float(n),
                  "audio_s": n / self.v["fs"]})
        w["model_flops"] += n * _WORK.generator_flops(self.v)
        return w

    def setup(self) -> None:
        try:
            from cyclevae_tpu_torch.models.pwg import PWGConfig
        except ImportError:
            raise SystemExit("benchmark: the program has no Parallel WaveGAN generator "
                             "(cyclevae_tpu_torch.models.pwg)") from None
        from cyclevae_tpu_torch.pipeline.decode import device_decode_pair, gv_postfilter
        from cyclevae_tpu_torch.pipeline.features import convert_f0
        from cyclevae_tpu_torch.pipeline.vocoder_stage import (converted_conditioning,
                                                               synthesize_vocoder)
        self._fns = (device_decode_pair, gv_postfilter, convert_f0, converted_conditioning,
                     synthesize_vocoder)
        rng = np.random.default_rng(self.seed)
        self.pool = conv.Pool(self.tr, rng)
        mean, scale = speech.stats(self.pool.feats)
        # the statistics of vocode.py's set-up (it has no hook to share them)
        mcep = np.concatenate(self.pool.feats)[:, self.m["stdim"] + 1:].astype(np.float64)
        self.gv_data = mcep.var(axis=0)
        self.gv_model = self.gv_data * rng.uniform(0.5, 1.0, size=self.gv_data.shape)
        lf0 = np.log(np.concatenate([f[f > 0] for f in self.pool.f0]))
        self.f0_stats = (float(lf0.mean()), float(lf0.std()),
                         float(lf0.mean() + np.log(self.tr["f0_ratio"])),
                         float(lf0.std() * self.tr["f0_std_ratio"]))
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        p = weights.cyclevae(g, self.m, torch.as_tensor(mean), torch.as_tensor(scale))
        self.vp = pwg_weights(g, self.v)
        self.p_ref, self.vp_ref = weights.clone(p), weights.clone(self.vp)
        self.codec = conv.make_codec(self.config, p, self.dev, self.dtype)
        self.vcfg = PWGConfig(**{k: self.v[k] for k in CONFIG_KEYS})
        self.works = [self._work(self.pool.lens[a]) for a, _ in self.pool.pairs]
        # every pair once: the rendering's shapes follow the source's length
        # (the upsampling's convolutions, the allocator's blocks), so each
        # pair is a shape of its own, where the conversion's are its buckets
        for a, b in self.pool.pairs:
            self._request(a, b, 0)
        self.i = 0
        self.kept = {}

    def _request(self, a: int, b: int, seed: int):
        decode, postfilter, f0_conv, conditioning, synthesize = self._fns
        g = torch.Generator(device=self.dev).manual_seed(seed)
        src = self.pool.feats[a]
        _, _, cv, _, _ = decode(self.codec, g, src, self.pool.feats[b], on_device=True)
        cv = postfilter(cv, self.gv_data, self.gv_model)
        f0 = f0_conv(self.pool.f0[a], *self.f0_stats)
        feat = conditioning(src, cv, f0, self.tr["shiftms"])
        return cv, synthesize(self.vp, self.vcfg, feat, seed=seed, device=self.dev)

    def check(self) -> Dict[str, float]:
        gaps = {"convert_gap": 0.0, "pwg_gap": 0.0}
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
                cv.cpu(), torch.as_tensor(cv_ref, dtype=torch.float32, device=self.dev)))
            f0 = ref_dsp.convert_f0(self.pool.f0[a], *self.f0_stats)
            feat = ref_dsp.conditioning(src, cv_ref, f0, self.tr["shiftms"])
            n = len(feat) * self.v["hop"]
            z = torch.randn((1, n), generator=torch.Generator(device=self.dev).manual_seed(rs),
                            device=self.dev)[0]
            w_ref = ref_pwg.generate(self.vp_ref, self.v, torch.as_tensor(feat, device=self.dev),
                                     z)
            w = torch.as_tensor(np.asarray(wave, np.float32), device=self.dev)
            if w.shape != w_ref.shape:
                return {**gaps, "pwg_gap": float("inf")}
            gaps["pwg_gap"] = max(gaps["pwg_gap"],
                                  float((w - w_ref).abs().max() / w_ref.abs().max()))
        return gaps
