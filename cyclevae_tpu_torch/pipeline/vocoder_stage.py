"""Neural-vocoder training and synthesis (WaveRNN-class).

PyTorch counterpart of ``cyclevae_tpu/pipeline/vocoder_stage.py``:
teacher-forced training over wav/feature pairs of the feature store
(``sample_clips``, ``run_train_vocoder``: a cuDNN GRU on the card),
checkpointing and resume, mu-law AR synthesis (``synthesize_vocoder``: the
CUDA kernel K4 on the card), the conditioning of a converted utterance
(``converted_conditioning``) and copy-synthesis scoring
(``eval_copy_synthesis``: WORLD re-analysis and DTW MCD on the host).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..dsp import dtw as dtw_c
from ..models.wavernn import (
    WaveRNNConfig,
    full_f32_cudnn,
    generate_reference,
    hop_fraction,
    init_wavernn,
    mulaw_decode,
    n_samples_for,
    upsample_cond,
    wavernn_loss,
)
from ..ops.cuda_wavernn import cuda_wavernn_generate
from ..utils.device import resolve_device
from ..utils.profiling import fetch, span
from ..utils.tree import tree_map
from ..utils.wavio import low_pass_filter, read_wav, write_wav
from ..vi.checkpoint import load_checkpoint, restore_np_rng, save_checkpoint, to_torch
from .dataset_mult import NeuVocoDataset
from .features import convert_continuos_f0


def sample_clips(ds: NeuVocoDataset, idxs, clip_frames: int,
                 cfg: WaveRNNConfig, rng: np.random.Generator):
    """Random fixed-length (clip_frames) wav/feature crops for one batch, as
    float32 CPU tensors (B, clip_frames, feat) and (B, n_samples_for(clip)).
    Clip starts align to hop_den frames so the fractional hop (441/4 samples
    per frame) maps to an exact integer sample offset — no cumulative
    frame/sample drift across the crop.  ``rng`` draws the starts in the JAX
    package's order, so the clips are its clips for a seed."""
    num, den = hop_fraction(cfg)
    n_samp_clip = n_samples_for(cfg, clip_frames)
    feats, wavs = [], []
    for i in idxs:
        item = ds[int(i)]
        F = item["feat"].shape[0]
        n_frames = min(clip_frames, F)
        start = int(rng.integers(0, max(F - clip_frames, 0) + 1))
        start -= start % den
        f = item["feat"][start:start + n_frames]
        s0 = start * num // den
        w = item["x"][s0:s0 + n_samples_for(cfg, n_frames)]
        if n_frames < clip_frames or len(w) < n_samp_clip:
            f = np.pad(f, ((0, clip_frames - n_frames), (0, 0)))
            w = np.pad(w, (0, n_samp_clip - len(w)))
        feats.append(f)
        wavs.append(w)
    return (torch.from_numpy(np.stack(feats).astype(np.float32)),
            torch.from_numpy(np.stack(wavs).astype(np.float32)))


def cosine_decay(steps: int, alpha: float = 0.1):
    """The factor on the base rate at update k (from 0): optax's
    ``cosine_decay_schedule(lr, steps, alpha)`` over ``lr``, for a
    ``LambdaLR`` stepped after each update (optax's count starts at 0 too)."""
    def factor(k: int) -> float:
        cos = 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps))
        return (1.0 - alpha) * cos + alpha
    return factor


def run_train_vocoder(cfg: WaveRNNConfig, wav_files: Sequence[str],
                      feat_files: Sequence[str], expdir: str,
                      epochs: int = 10, batch_size: int = 8,
                      clip_frames: int = 24, lr: float = 2e-4,
                      seed: int = 1, lr_decay: bool = False,
                      ckpt_every: int = 25,
                      resume: Optional[str] = None,
                      spk_ids: Optional[Sequence[int]] = None, device=None) -> Dict:
    """Train a WaveRNN on wav/feature pairs (feature files of the store) by
    teacher-forced NLL over random clips, Adam (optax's ``adam(lr)``; with
    ``lr_decay`` a cosine decay to lr/10 over the run), on ``device`` (CUDA
    unless the caller passes ``device="cpu"``).  Writes
    ``checkpoint-latest.pkl`` every epoch, ``checkpoint-<epoch>.pkl`` every
    ``ckpt_every`` epochs and at the last, and ``history.json``; ``resume``
    (a checkpoint path) restores params, Adam state, generator and numpy
    states and keeps the history of the epochs before it.  Returns
    {"params", "history"}."""
    device = resolve_device(device)
    os.makedirs(expdir, exist_ok=True)
    ds = NeuVocoDataset(wav_files, feat_files, cfg.hop, spk_ids=spk_ids, n_spk=cfg.n_spk)
    generator = torch.Generator(device=device).manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    params = init_wavernn(generator, cfg)
    start_epoch, opt_state = 0, None
    if resume:
        ckpt = load_checkpoint(resume)
        params = tree_map(lambda t: t.to(device), to_torch(ckpt["params"]))
        opt_state = to_torch(ckpt["opt_state"])
        generator.set_state(torch.from_numpy(np.asarray(ckpt["rng_state"], dtype=np.uint8)))
        np_rng = restore_np_rng(ckpt["np_rng_state"])
        start_epoch = int(ckpt["epoch"])
        logging.info("vocoder resume from %s at epoch %d", resume, start_epoch)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr, eps=1e-8)
    steps_per_epoch = max(1, (len(ds) + batch_size - 1) // batch_size)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
        for g in opt.param_groups:     # the schedule starts from the base rate
            g["lr"] = lr
            g.pop("initial_lr", None)
    sched = None
    if lr_decay:
        factor = cosine_decay(steps_per_epoch * epochs)
        done = start_epoch * steps_per_epoch
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: factor(k + done))

    history = []
    hist_path = os.path.join(expdir, "history.json")
    if resume and os.path.exists(hist_path):
        # splice: keep the pre-resume epochs' history entries
        with open(hist_path) as f:
            history = [h for h in json.load(f)["history"] if h["epoch"] <= start_epoch]
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        order = np_rng.permutation(len(ds))
        losses = []
        for s in range(0, len(order), batch_size):
            idxs = order[s:s + batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs, order[:batch_size - len(idxs)]])
            feats, wavs = sample_clips(ds, idxs, clip_frames, cfg, np_rng)
            opt.zero_grad(set_to_none=True)
            # cuDNN's GRU in full float32, forward and backward (see
            # models.wavernn.cudnn_recurrence)
            with full_f32_cudnn():
                loss = wavernn_loss(params, cfg, feats.to(device), wavs.to(device))
                loss.backward()
            opt.step()
            if sched is not None:
                sched.step()
            losses.append(float(loss.detach()))
        history.append({"epoch": epoch + 1, "nll": float(np.mean(losses)),
                        "sec": time.time() - t0})
        logging.info("vocoder epoch %d: nll=%.3f (%.1fs)", epoch + 1,
                     history[-1]["nll"], history[-1]["sec"])
        # rolling latest every epoch; numbered keepers are ~40 MB each, so
        # thin them to every ckpt_every epochs (+ the final one)
        save_checkpoint(expdir, params, opt, generator, np_rng, epoch + 1,
                        name="checkpoint-latest.pkl")
        if (epoch + 1) % ckpt_every == 0 or epoch + 1 == epochs:
            save_checkpoint(expdir, params, opt, generator, np_rng, epoch + 1)
    with open(hist_path, "w") as f:
        json.dump({"history": history}, f, indent=2)
    return {"params": tree_map(lambda t: t.detach(), params), "history": history}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


@torch.inference_mode()
def synthesize_vocoder(params: Dict, cfg: WaveRNNConfig, feats: np.ndarray,
                       seed: int = 0, temperature: float = 1.0,
                       use_pallas: bool = True, spk_id: Optional[int] = None,
                       device=None) -> np.ndarray:
    """Features (F, feat_dim) -> waveform samples (n_samples_for(F),) in
    [-1, 1], float32.  For a multi-speaker model (cfg.n_spk > 0) pass
    ``spk_id`` to append the one-hot speaker code the model was trained with.

    Runs on ``device`` (CUDA by default).  ``use_pallas`` samples with
    ``cuda_wavernn_generate`` (the kernel on a CUDA device; its plain version
    with the kernel's Philox uniforms on the CPU), else with the plain
    ``generate_reference`` and a ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    feats = np.asarray(feats, np.float32)
    if cfg.n_spk > 0:
        if spk_id is None:
            raise ValueError("a multi-speaker vocoder needs spk_id")
        code = np.zeros((feats.shape[0], cfg.n_spk), np.float32)
        code[:, spk_id] = 1.0
        feats = np.concatenate([feats, code], axis=1)
    with span("vocoder.synthesize"):
        params = tree_map(lambda t: t.to(device), params)
        with span("vocoder.upsample"):
            cond = upsample_cond(params, cfg, torch.as_tensor(feats, device=device)[None])
        with span("vocoder.generate"):
            if use_pallas:
                idx = cuda_wavernn_generate(params, cfg, cond, seed=seed,
                                            temperature=temperature)[0]
            else:
                idx = generate_reference(
                    params, cfg, cond[0], temperature,
                    generator=torch.Generator(device=device).manual_seed(seed))
        return fetch(mulaw_decode(idx, cfg.n_classes)).numpy()


def converted_conditioning(src_feat: np.ndarray, cvmcep: np.ndarray,
                           cvf0: np.ndarray, shiftms: float) -> np.ndarray:
    """Assemble neural-vocoder conditioning for a CONVERTED utterance in the
    training feature layout: [uv, log cont-F0-lpf, codeap, mcep] with the
    converted F0 trajectory and converted mceps in place of the naturals;
    codeap stays the source's.

    src_feat: (T, feat_dim) natural source features (layout above).
    cvmcep:   (T, mcep_dim+1) converted (typically GV-postfiltered) mceps.
    cvf0:     (T,) converted F0 in Hz (0 = unvoiced).
    """
    with span("vocoder.conditioning"):
        uv, contf0 = convert_continuos_f0(np.array(cvf0))
        cont_lpf = low_pass_filter(contf0, int(1.0 / (shiftms * 0.001)), cutoff=20)
        # degenerate all-unvoiced trajectory: the continuous F0 is 0 everywhere
        # and log() would poison the conditioning with -inf; floor at 1 Hz
        # (uv = 0 already tells the vocoder these frames are unvoiced)
        cont_lpf = np.maximum(cont_lpf, 1.0)
        n_codeap = src_feat.shape[1] - 2 - cvmcep.shape[1]
        return np.c_[uv[:, None], np.log(cont_lpf)[:, None],
                     src_feat[:, 2:2 + n_codeap], cvmcep].astype(np.float32)


def eval_copy_synthesis(params: Dict, cfg: WaveRNNConfig, exp,
                        eval_wavs: Sequence[str], sc, outdir: str,
                        temperature: float = 1.0,
                        spk_id: Optional[int] = None, device=None) -> Dict:
    """Copy-synthesis quality on held-out utterances: analyze -> vocode the
    natural features (K4 on the card) -> re-analyze, report DTW MCD vs the
    original mcep plus voiced-F0 relative error and U/V agreement.  ``sc``:
    SpeakerConf bounds.  Returns the aggregate dict (means + stds), {} when
    ``eval_wavs`` is empty."""
    from .decode import _feat_from_wav

    fcfg = exp.feature
    os.makedirs(outdir, exist_ok=True)
    mets = []
    for i, wf in enumerate(eval_wavs):
        fs, x = read_wav(wf, cutoff=int(fcfg.highpass_cutoff))
        ana = _feat_from_wav(x, fs, sc.minf0, sc.maxf0, sc.pow_threshold, fcfg)
        # vocoder samples are [-1, 1]; host IO/analysis are int16-scale
        y = synthesize_vocoder(params, cfg, ana["feat"], seed=i, temperature=temperature,
                               spk_id=spk_id, device=device) * 32768.0
        write_wav(os.path.join(outdir, os.path.basename(wf)), fs, y.astype(np.float32))
        re = _feat_from_wav(y.astype(np.float64), fs, sc.minf0, sc.maxf0,
                            sc.pow_threshold, fcfg)
        m = {}
        a = ana["mcep"][ana["spcidx"]].astype(np.float64)
        b = re["mcep"][re["spcidx"]].astype(np.float64)
        _, _, m["mcdpow"], _ = dtw_c.dtw_org_to_trg(b, a)
        _, _, m["mcd"], _ = dtw_c.dtw_org_to_trg(b[:, 1:], a[:, 1:])
        n = min(len(ana["f0"]), len(re["f0"]))
        v = (ana["f0"][:n] > 0) & (re["f0"][:n] > 0)
        m["f0_rel_err_median"] = float(np.median(
            np.abs(re["f0"][:n][v] - ana["f0"][:n][v]) / ana["f0"][:n][v])) \
            if v.any() else float("nan")
        m["uv_agree"] = float(np.mean((ana["f0"][:n] > 0) == (re["f0"][:n] > 0)))
        mets.append(m)
        logging.info("vocoded %s: %s", os.path.basename(wf),
                     {k: round(v, 4) for k, v in m.items()})
    if not mets:  # eval skipped (n_eval=0): train-only stage run
        return {}
    agg = {k: float(np.mean([m[k] for m in mets])) for k in mets[0]}
    agg.update({f"{k}_std": float(np.std([m[k] for m in mets])) for k in mets[0]})
    return agg
