"""A speech-like two-speaker corpus made from seeds, and the recipe's stages
on it: the corpus the vocoder tools and re-eval are measured on, since no
speech corpus is in the repository.

Each speaker gets ``--n-utts`` train-directory wavs (``<root>/wav/<spk>/``)
and ``--n-eval`` eval wavs (``<root>/wav/eval/<spk>/``) of 1.5-2.5 s at
22,050 Hz: a sawtooth source at the speaker's F0 (plus 3% per utterance)
through two moving formant resonators, breath noise, silence at the edges.
The speakers are named after two of the recipe's bundled speakers, so that
their F0 and power bounds (``pipeline/recipe.py`` ``DEFAULT_SPEAKERS``) suit
the F0 each is made at.  With ``--stages`` (e.g. ``1a2345``) the one-to-one
recipe then runs on it at the flagship width (``ModelConfig`` defaults) for
``--epochs`` epochs, into ``<root>/work``.

    python -m cyclevae_tpu_torch.tools.speech_corpus --root R [--stages 1a2345]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# (speaker, F0 in Hz): the bundled bounds are 60-199 Hz and 138-343 Hz
SPEAKERS = (("VCC2SM1", 120.0), ("VCC2TF1", 220.0))
FS = 22050


def speechlike_wav(f0: float, n: int, seed: int, fs: int = FS) -> np.ndarray:
    """n samples of a sawtooth source through two moving formant resonators,
    with breath noise and silence at the edges, in int16 range (the recipe
    of the repository's end-to-end pipeline test)."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    dur = n / fs
    ph = np.cumsum(f0 * (1.0 + 0.05 * np.sin(2 * np.pi * 2.0 * t))) / fs
    src = 2.0 * (ph % 1.0) - 1.0
    f1 = 600 + 200 * np.sin(2 * np.pi * 1.3 * t)
    out = np.zeros(n)
    for s in range(0, n, 2048):
        e = min(s + 2048, n)
        for fc, bw in ((np.mean(f1[s:e]), 120.0), (1800.0, 200.0)):
            r = np.exp(-np.pi * bw / fs)
            th = 2 * np.pi * fc / fs
            out[s:e] += lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], src[s:e])
    out += 0.01 * rng.normal(size=n)
    env = np.minimum(1.0, np.maximum(0.0, np.sin(np.pi * t / dur) * 1.5))
    return out * env * 8000.0


def make_corpus(wav_root: str, n_utts: int, n_eval: int, seed: int = 0) -> None:
    from ..utils.wavio import write_wav

    secs = np.linspace(1.5, 2.5, n_utts)
    for k, (spk, f0) in enumerate(SPEAKERS):
        for d in (os.path.join(wav_root, spk), os.path.join(wav_root, "eval", spk)):
            os.makedirs(d, exist_ok=True)
        for i, sec in enumerate(secs):
            write_wav(os.path.join(wav_root, spk, f"utt{i:03d}.wav"), FS,
                      speechlike_wav(f0 * (1 + 0.03 * (i % 10)), int(sec * FS),
                                     seed=seed + 1000 * k + i))
        for i in range(n_eval):
            write_wav(os.path.join(wav_root, "eval", spk, f"e{i}.wav"), FS,
                      speechlike_wav(f0 * (1.02 + 0.01 * i), int(2.0 * FS),
                                     seed=seed + 1000 * k + 500 + i))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--n-utts", type=int, default=45)
    ap.add_argument("--n-eval", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", default="", help="recipe stages to run on the corpus")
    ap.add_argument("--epochs", type=int, default=10, help="stage 4's epochs")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    wav_root, work = os.path.join(args.root, "wav"), os.path.join(args.root, "work")
    make_corpus(wav_root, args.n_utts, args.n_eval, args.seed)
    out = {"wav_root": wav_root, "work": work, "speakers": [s for s, _ in SPEAKERS]}
    if args.stages:
        from ..pipeline.recipe import RecipePaths, run_stages
        from ..utils.config import ExperimentConfig, ModelConfig, TrainConfig, save_config

        exp = ExperimentConfig(model=ModelConfig(spk_src=SPEAKERS[0][0], spk_trg=SPEAKERS[1][0]),
                               train=TrainConfig(epoch_count=args.epochs))
        run_stages(args.stages, exp, RecipePaths(wav_root, work, args.n_train),
                   device=args.device)
        out["config"] = os.path.join(args.root, "exp.json")
        save_config(exp, out["config"])
        out["expdir"] = os.path.join(work, "exp", exp.name())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
