"""Closed loop of conversion requests, one client: each request is one
``device_decode_pair`` (``pipeline/decode.py``: the fused encode and
posterior mean of both utterances, the three-direction decode; K1) on the
next (source, target) pair, its latent noise from a generator on the device
seeded for the request; the request ends when its outputs are on the host.

The check takes, once the window has closed, the longest pair served and
others drawn from the seed, and compares their encoder outputs and three
decodes with the plain reference's on the same weights, features and noise.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import speech, weights
from benchmark.drivers import _conversion as conv


class Driver:

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, dtype: str):
        self.config, self.tr, self.seed, self.dev, self.dtype = config, traffic, seed, device, dtype
        self.m = config["model"]

    def setup(self) -> None:
        from cyclevae_tpu_torch.pipeline.decode import device_decode_pair
        self._decode = device_decode_pair
        rng = np.random.default_rng(self.seed)
        self.pool = conv.Pool(self.tr, rng)
        mean, scale = speech.stats(self.pool.feats)
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        p = weights.cyclevae(g, self.m, torch.as_tensor(mean), torch.as_tensor(scale))
        self.p_ref = weights.clone(p)
        self.codec = conv.make_codec(self.config, p, self.dev, self.dtype)
        lens = self.pool.lens
        self.works = [conv.conversion_work(self.m, [lens[a], lens[b]], [lens[a], lens[a], lens[b]])
                      for a, b in self.pool.pairs]
        for a, b in self.pool.warm_pairs(self.config["bucket"]):
            self._request(a, b, 0)
        self.i = 0
        self.kept = {}

    def _request(self, a: int, b: int, seed: int):
        g = torch.Generator(device=self.dev).manual_seed(seed)
        return self._decode(self.codec, g, self.pool.feats[a], self.pool.feats[b])

    def unit(self) -> Dict[str, float]:
        k = self.pool.order[self.i % len(self.pool.order)]
        a, b = self.pool.pairs[k]
        t0 = time.perf_counter()
        out = self._request(a, b, conv.request_seed(self.seed, self.i))
        ms = (time.perf_counter() - t0) * 1e3
        if k not in self.kept:
            self.kept[k] = (self.i, out)
        self.i += 1
        return dict(self.works[k], requests=1.0, latency_ms=ms)

    def release(self) -> None:
        del self.codec

    def check(self) -> Dict[str, float]:
        lat_gap = dec_gap = 0.0
        for k in self.pool.checked(self.seed + 7, self.tr["check_requests"], self.kept):
            i, got = self.kept[k]
            a, b = self.pool.pairs[k]
            want = conv.reference_conversion(self.config, self.p_ref, self.pool.feats[a],
                                             self.pool.feats[b], conv.request_seed(self.seed, i),
                                             self.dev)
            lat_gap = max(lat_gap, *(conv.gap(g, w) for g, w in zip(got[:2], want[:2])))
            dec_gap = max(dec_gap, *(conv.gap(g, w) for g, w in zip(got[2:], want[2:])))
        return {"latent_gap": lat_gap, "decoded_gap": dec_gap}
