"""What the conversion mixes share: the pool of utterances and its pairs,
the port's conversion engine, and the check of one request's conversion
against the plain reference."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import speech, weights
from benchmark.harness.core import HERE, load_module
from benchmark.reference import cyclevae as ref
from benchmark.work import cyclevae as work

_K1 = load_module(HERE / "kernels" / "K1.py", "bench_kernel_K1")

MODEL_KEYS = ("in_dim", "out_dim", "lat_dim", "n_spk", "hidden_units", "hidden_layers",
              "kernel_size", "dilation_size", "n_cyc", "do_prob", "stdim")


def request_seed(seed: int, i: int) -> int:
    return (seed * 1_000_003 + i) % (1 << 62)


class Pool:
    """``pool_utts`` utterances (a fixed set of lengths; features from the
    seed) and ``pairs`` (source, target) pairs of them (a fixed set), served
    in an order drawn from the seed, again and again."""

    def __init__(self, traffic: Dict, rng: np.random.Generator):
        tr = traffic
        self.lens = speech.lengths(tr["pool_utts"], *tr["frames"], tr["corpus_seed"])
        self.feats = speech.corpus(rng, self.lens)
        self.f0 = [speech.f0_track(rng, f) for f in self.feats]
        fixed = np.random.default_rng(tr["corpus_seed"] + 1)
        n = len(self.lens)
        self.pairs = [tuple(int(x) for x in fixed.choice(n, 2, replace=False))
                      for _ in range(tr["pairs"])]
        self.order = [int(i) for i in rng.permutation(len(self.pairs))]

    def warm_pairs(self, bucket: int) -> List[Tuple[int, int]]:
        """One pair for each count of buckets the pairs pad to: the shapes
        set-up warms."""
        seen = {}
        for a, b in self.pairs:
            seen.setdefault(-(-max(self.lens[a], self.lens[b]) // bucket), (a, b))
        return list(seen.values())

    def checked(self, seed: int, n: int, served) -> List[int]:
        """The pairs whose first serving the check compares, once the window
        has closed: the longest pair served and ``n - 1`` others drawn from
        the seed."""
        total = lambda k: self.lens[self.pairs[k][0]] + self.lens[self.pairs[k][1]]
        cand = sorted(served)
        longest = max(cand, key=total)
        rng = np.random.default_rng(seed)
        return [longest] + [int(k) for k in rng.permutation(cand) if k != longest][:n - 1]


def make_codec(config: Dict, p: Dict, device, dtype: str):
    from cyclevae_tpu_torch.pipeline.decode import Codec
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, CycleVAEParams

    m = config["model"]
    cfg = CycleVAEConfig(**{k: m[k] for k in MODEL_KEYS}, use_pallas=True, compute_dtype=dtype)
    return Codec(CycleVAEParams(**weights.as_port(p)), cfg, n_smpl_dec=config["n_smpl_dec"],
                 bucket=config["bucket"], device=device)


def conversion_work(m: Dict, enc_frames: List[int], dec_frames: List[int]) -> Dict[str, float]:
    """The work of one conversion on its real frames: the encoder over the
    utterances of ``enc_frames``, the decoder over the directions of
    ``dec_frames``, each one batched pass of K1."""
    H = m["hidden_units"]
    f1, b1 = _K1.work(len(enc_frames), sum(enc_frames) / len(enc_frames), H, 2 * m["lat_dim"])
    f2, b2 = _K1.work(len(dec_frames), sum(dec_frames) / len(dec_frames), H, m["out_dim"])
    return {"K1.flops": f1 + f2, "K1.bytes": b1 + b2,
            "model_flops": work.encoder_flops(m) * sum(enc_frames)
            + work.decoder_flops(m) * sum(dec_frames)}


def gap(got, want: torch.Tensor) -> float:
    """The widest gap of ``got`` from ``want``, over the root mean square of
    ``want``."""
    got = torch.as_tensor(np.asarray(got, np.float32), device=want.device)
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def reference_conversion(config: Dict, p: Dict, src: np.ndarray, trg: np.ndarray, seed: int,
                         device):
    """The plain reference of one request.  The posterior mean's noise is
    drawn again from the request's seed: a generator on the device, one
    standard-normal draw of shape (n_smpl_dec, 2, Tp, lat) with Tp the
    request's length rounded up to the bucket, as the request's own draw."""
    m = config["model"]
    bucket = config["bucket"]
    Tp = -(-max(len(src), len(trg)) // bucket) * bucket
    g = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((config["n_smpl_dec"], 2, Tp, m["lat_dim"]), generator=g, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return ref.convert_pair(p, ref.Model.of(m), as_t(src), as_t(trg), Tp, eps)
