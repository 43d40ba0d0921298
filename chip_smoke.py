#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cyclevae_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one line or more each; any failure exits non-zero:
  1. build    every CUDA kernel of the port from ``cyclevae_tpu_torch/csrc``
              (``gru_ar.cu``, ``gru_ar_bwd.cu``, ``wavernn.cu``, ``pwg.cu``; one nvcc per
              source, all started together) and, beside them, the host DSP
              library from ``cyclevae_tpu_torch/dsp/native`` (``make``);
  2. kernels  each kernel against its plain PyTorch version on the card,
              float32 and bf16, with kernel and plain times from CUDA events
              and the bound: K1 at the conversion path's shapes (H=1024,
              T=1120: encoder B=2 out=64, decoder B=3 out=50); K2 and K3 at the
              training step's four calls (T=80: encoder B=5 out=64, fused 2B
              decoder B=10 out=50, cv encoder B=5 out=64, cyclic decoder B=5
              out=50), and K3 also at T=560; past one launch's rows (row
              blocks, ``ops.cuda_gru.max_batch``): K2 and K3 at a bsu-64
              step's fused 2B decoder (B=128, T=80) and K1 at B=64, T=256,
              each with its launches per call; each K2 row also checks the
              (B, T, 4, H) gates K2 keeps against the plain forward's; at
              stage i's log-joint (B=8, T=800, float32) K2, K3, and K3 on
              the gates K2 kept (the training path's K3, its bound without
              the gate recompute); each K1, K2 and K3 row with its
              plan (K1, K2: grid, units per block, y values each block sums,
              lanes per (row, unit) in the gate phase, shared bytes; K3: grid,
              units, dh partials per pass, shared bytes, cluster size 1);
              K4 (the WaveRNN sampler, hu896, 256 classes, T=4,000 samples)
              at B=1 and B=4, greedy and sampled, held index by index by the
              near-tie rule, with its plan (grid, units per block, cluster
              size, f stage, shared bytes), and its sampled draws against the
              categorical distribution they follow; beside it K4's dual
              instantiation (the published WaveRNN-896's coarse and fine
              softmax over 16-bit audio, 448 + 448 units) at the same T, B,
              greedy and sampled, held the same way, one launch a call; and
              Parallel WaveGAN's gated residual layer kernel (``pwg.cu``, the
              published widths: R = S = 64, G = 128, 54 aux channels) at n =
              130 and 390 frames of 256 samples, dilations 1, 16 and 512,
              against its plain version, then 390 frames rendered by the
              whole generator through ``synthesize_vocoder`` (30 launches)
              against the plain reference ``benchmark/reference/pwg.py``;
  3. main     the stage-6 conversion path of the flagship hu1024 CycleVAE
              (random weights from a seed, stats baked in): 4 requests
              through ``Codec`` + ``device_decode_pair`` per dtype, with the
              kernel launch counts read around them, then the same requests
              through the plain path to check the outputs;
  4. train    the stage-4 train step of the same model (bsu 5, 7 segments of
              80 frames, do_prob 0.5, ``use_pallas``): per dtype one warm-up
              step and 10 steps through ``make_train_step`` timed by
              ``utils.profiling.measure_steps`` (CUDA events, their median),
              with the K2 and K3 launch counts of each step; then one step each of
              the kernel path and of the plain path (``use_pallas=False``) on
              the same replayed draws, their losses compared;
  5. vocode   neural-vocoder synthesis of converted speech: phase 3's 4
              requests converted (float32 ``Codec``, K1), power-corrected
              (``mod_pow``) before and after the GV postfilter, their F0
              converted, assembled into vocoder conditioning and
              rendered by the hu896 WaveRNN through ``synthesize_vocoder``
              (K4, temperature 0.8), plus one request through a 2-speaker
              vocoder; the launch counts read around them; then the first
              4,000 samples of one request held against the plain sampler;
  6. convert-wav  the whole stage-6 conversion, wav in to wavs out: speech-like
              wavs of two speakers made from the seed (300 + 420 and 900 + 845
              frames), analysed on the host (``analyze_pair``: WORLD, SPTK)
              and converted by ``decode_pair`` on a float32 ``Codec`` (K1),
              the first pair also on bf16; per pair the K1 launches (2), the 8
              wav files, the metrics, the host time of each stage, and the
              same analyses and draws through the plain path;
  7. recipe   the one-to-one recipe, ``run_stages`` over stages 1, a, 2, 3,
              4, 5, 6, i and v in turn, at the flagship width (``ModelConfig``
              defaults: the kernel route) on a corpus of two speech-like
              speakers made from the seed (8 parallel train-directory
              utterances of 1.5-2.5 s each, n_train 4, 1 eval utterance
              each): per stage the host seconds, the K1, K2 and K3 launches
              and the plain scan's calls (none); stage 4's seconds per step
              and real frames/s, stage 6's request time and real-time factor;
              every stage's artifacts; then epoch 1 of stage 4 and stage 5
              on the plain path (``use_pallas=False``) from the same seeds,
              held to the kernel run's epoch metrics and cvgv statistics;
              then stages i and v: HMC over the source's eval latents (K2,
              K3; K1 for the posterior predictive) and the hu896 WaveRNN for
              2 epochs (a cuDNN GRU) with copy synthesis (K4), their launch
              counts (K2 = K3 = 1 + L x HMC steps a run), times and
              artifacts; then the teacher-forced WaveRNN loss and gradient
              on one batch of the recipe's clips, cuDNN against the plain
              loop on the card;
  8. infer    posterior inference at full width (hu1024, an 800-frame
              utterance, random weights from the seed): the log-joint's
              value and gradient at 8 chains and 1, float32 and bf16, and 3
              HMC steps on replayed draws, kernel route against the plain
              path (``use_pallas=False``); short NUTS and batched NUTS runs,
              SMC over 256 particles; K2 and K3 at B=8 and B=1 and K1 at
              B=16 timed beside their bounds; the largest batch K1, K2 and K3
              plan;
  9. variants the model variants on phase 7's corpus and work directory
              plus a third speech-like speaker (~170 Hz, made from the seed,
              the same counts; stage 1's analysis and its statistics): the
              many-to-many recipe, ``run_mult_stages`` 3, 4, 5, 6 in turn
              over src [SPKA], trg [SPKB, SPKC] at the ``ModelConfig``
              defaults (n_spk 3), 2 epochs, per stage the host seconds and
              the K1, K2 and K3 launches (4m: 8 K2 + 8 K3 per valid segment,
              8 K1 per eval batch; 5m: 2 K1 per training utterance; 6m: 2
              K1 per eval pair over the 6 ordered directions and per
              interpolation), its artifacts, then epoch 1 of 4m and stage 5m
              on the plain path within phase 7's bounds; the speaker
              classifier (``run_train_cls``: 1 K2 + 1 K3 a step, 2 K1 per
              eval pair) and the VQ-CycleVAE (``run_train_vq``: 5 K2 + 5 K3
              a step) for 2 epochs each with their launches; one step of
              each, kernel route against the plain path on the same
              weights, batch and draws (f32 loss within 1e-5 relative,
              gradients within 2e-4 of scale); K2 and K3 at the
              classifier's out = 3 and the VQ encoder's out = 32 (B = bsu,
              T = 560) and K1 at stage 5m's B = 3 and the classifier's
              eval B = 1, timed beside their bounds;
 11. tools    the port's tools (``cyclevae_tpu_torch.tools``, run after phase 9
              in the same work directory) through their ``main`` at full
              width and reduced depth: the train-throughput bench (bsu 5
              and 64, f32 and bf16, the kernel route), the HMC chain sweep
              (32 and 128 chains), NUTS (32 chains, depth 4), SMC (256
              particles, 64 frames), the trajectory-length sweep (2
              points), the scaling curves (1 and 2 gloo ranks on the card),
              vocode-converted and train-and-eval of the vocoder (1 epoch)
              on phase 7's speaker, re-eval over phase 7's checkpoints; each
              tool's K1-K4 launches against the prediction from the
              kernels' row-block limits (``ops.cuda_gru.max_batch``: a
              batch past one launch's rows runs in ceil(B / limit) launches);
              then the fused-vs-sequential conversion bench on phase 7's
              best checkpoint (T = 600, 3 timed pairs a path: 2 K1 launches
              a pair fused, 5 sequential), stage 6's wall time with the
              analysis prefetch on and off through the recipe's command
              line (1 pair; both runs must write the same outputs), the
              battery's runner on the fusion bench as a process (its last
              stdout line is its artifact) and on a stub that exits 1
              (refused, nothing written), and K1 at the sequential path's
              B = 1 shapes (T = 1120 and 560) against its plain version;
 10. parallel the data-parallel layer (``cyclevae_tpu_torch.parallel``) on the
              one card: 2 gloo ranks spawned on cuda:0 (NCCL refuses two
              ranks on one card; gloo stages each collective through host
              copies) run the dry run's rank function: one sharded flagship
              f32 train step over a global batch of 10 (5 per rank), 7
              segments of 80, with its per-rank launches (8 K2 + 8 K3 per
              valid segment), 5 more timed; sharded HMC (2 x 4 chains, hu1024,
              400 frames) and sharded SMC (2 x 128 particles); then 1 NCCL
              rank takes the same step; each held against the single-device
              run here on the same generators (losses, the first update's
              all-reduced gradients, HMC accepts and z, the log-marginal);
then the card's name and power limit, one JSON line of the kernels, and as
the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
H = 1024
T_KERNEL = 1120                     # two 560-frame buckets: a 900-frame request
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; float32 outside
# the tensor cores and dense bf16 operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# tolerances of kernel vs plain version on the card:
#   float32: the two sum in different orders; after 1120 AR frames the max
#   abs difference of the normalized outputs was 4.8e-7 on an H100, and this
#   leaves room for other orders of summation
F32_ATOL = 1e-4
#   bf16: operands round to 8 bits of mantissa at every product, the JAX
#   package's own bound for its bf16 kernel path
BF16_REL_L2 = 3e-2
BF16_COS = 0.999
# requests: (source frames, target frames), 1.5-4.5 s of speech at 5 ms
REQUESTS = [(300, 420), (512, 688), (760, 604), (900, 845)]
WARMUP = [(350, 450), (650, 900)]   # both 560-frame bucket counts
# training: bsu 5 utterances of 300-560 frames (the longest exactly 560: one
# bucket of 7 segments of 80 frames, all of them valid)
SEG_LEN = 80
TRAIN_FLENS = [560, 300, 417, 489, 351]
TRAIN_STEPS = 10                    # timed steps per dtype: measure_steps' median
# phase 2's row-blocked rows: the fused 2B decoder of a bsu-64 train step
# (128 rows, T = 80) and K1 at 64 rows over the HMC sweep's T = 256, past one
# launch's rows at H = 1024 in float32 (K1, K2 46, K3 51) and bf16 (82, 148)
ROWS_BSU = 64
K1_ROWS_B, K1_ROWS_T = 64, 256
# the four AR-GRU calls of a training segment: (name, B, out, conv_dim)
TRAIN_CALLS = [("encoder", 5, 64, 486), ("decoder2B", 10, 50, 306),
               ("cv_encoder", 5, 64, 486), ("cyc_decoder", 5, 50, 306)]
T_BWD_LONG = 560
#   K3's float32 gradients: sums of up to 3H products in another order and
#   carried over T steps; held at 2e-4 of the largest value, the JAX package's
#   gradient tolerance (tests/test_gru_ar_vjp.py)
GRAD_SCALE_TOL = 2e-4
#   train-step loss, kernel path vs plain path, same draws, float32: segment
#   0 starts from the same weights, so only the order of float32 sums
#   differs: the JAX package's ELBO parity bound, 2e-4 relative
#   (tests/test_elbo_parity.py); later segments start from weights that
#   Adam moved by ~lr per weight, so a gradient near 0 summed in another
#   order can move a weight the other way: 2e-3 relative
LOSS_F32_SEG0 = 2e-4
LOSS_F32_ALL = 2e-3
# the WaveRNN vocoder (WaveRNNConfig defaults: hu896, 256 mu-law classes,
# fc 128) and its sampler
T_VOC = 4000                        # samples held against the plain sampler
VOC_TEMPERATURE = 0.8               # the recipe's vocoder_temperature
VOC_DIST_ROWS, VOC_DIST_T = 4, 50_000   # 200,000 draws for the distribution check
SAMPLE_RATE = 22050                 # 5 ms frames at hop 110.25
SHIFT_MS = 5.0
# Parallel WaveGAN (v1, PWGConfig defaults: 30 layers, 64 / 128 / 64
# channels, 54 aux, hop 256): the layer kernel at the shortest and longest
# utterance of voc-vocode-pwg (frames of 256 samples), three dilations of a
# stack (its first, a middle and its last layer), 20 timed launches each
PWG_FRAMES = (130, 390)
PWG_DILATIONS = (1, 16, 512)
PWG_ITERS = 20
#   the kernel sums each product (256 and 64 terms) in order with FMA, the
#   plain version through cuBLAS in another order: a few ulps of the larger
#   partial sums, ~1e-6 of a layer's largest output; 30 layers carry them on
#   (tests/test_torch_cuda_pwg.py holds the same bounds)
PWG_LAYER_TOL = 1e-5
PWG_WAVE_TOL = 2e-5
MCEP_ALPHA, IRLEN = 0.455, 1024     # FeatureConfig defaults: mod_pow's warping, IR length
# wav-to-wav conversion: speech-like wavs of a source (~120 Hz) and a target
# (~220 Hz) speaker at the shortest and longest request lengths, each pair
# through analyze_pair + decode_pair on a float32 Codec; the first also on bf16
WAV_PAIRS = [REQUESTS[0], REQUESTS[-1]]
WAV_F0 = {"src": 120.0, "trg": 220.0}
# (min F0, max F0, power threshold) of the two speakers, as the recipe's
# speaker table holds them (tests/test_e2e_pipeline.py's synthetic speakers)
WAV_RANGE = {"src": (70.0, 400.0, -25.0), "trg": (100.0, 500.0, -25.0)}
#   the same analyses and draws through the plain path: f32 metrics within
#   1e-3 relative, each wav within 1e-3 relative L2 (bf16: 3e-2 both)
WAV_F32_REL = 1e-3
# the recipe (phase 7): two speakers' train directories of RECIPE_UTTS
# utterances of 1.5-2.5 s, utterance i of both with the same content (length,
# formants, noise) so that the pair sets are parallel, and one 2.0 s eval
# utterance each; the first RECIPE_N_TRAIN of each speaker are the source's
# training set, the rest the target's (the recipe's non-parallel split), so 8
# utterances train, 2 steps of bsu 5 per epoch
RECIPE_SPEAKERS = {"SPKA": WAV_F0["src"], "SPKB": WAV_F0["trg"]}
RECIPE_UTTS, RECIPE_N_TRAIN, RECIPE_EPOCHS = 8, 4, 2
RECIPE_SECONDS = np.linspace(1.5, 2.5, RECIPE_UTTS)
RECIPE_EVAL_SECONDS = 2.0
#   epoch 1 of stage 4 on the plain path from the same seeds: every epoch
#   train metric within 2e-3 relative (the per-segment train bound above);
#   stage 5 on the plain path, from the same checkpoint and seed: the cvgv
#   statistics within 1e-3 relative
RECIPE_TRAIN_REL = LOSS_F32_ALL
RECIPE_CVGV_REL = 1e-3
# stages i and v of the recipe after stages 1-6: stage i at its defaults
# (HMC, 8 chains, 100 + 100 steps of 8 leapfrogs, 16 predictive draws) on the
# source speaker's eval utterance; stage v at its defaults (the hu896
# WaveRNN, 96-frame clips, batch 8, copy synthesis at temperature 0.8) but 2
# epochs
RECIPE_STAGES = "1a23456iv"
RECIPE_VOC_EPOCHS = 2
RECIPE_VOC_HU, RECIPE_VOC_CLIP = 896, 96       # run_stages' vocoder defaults
#   the teacher-forced WaveRNN loss, cuDNN's GRU against the plain loop on
#   one batch of the recipe's clips: the loss within 1e-5 relative (float32
#   sums of 10,584 steps in another order), every gradient within 2e-4 of
#   its largest value (GRAD_SCALE_TOL)
TF_LOSS_REL = 1e-5
# phase 8, posterior inference at full width: an eval-length utterance of
# 800 frames (4 s), the stage's 8 chains and a single chain; the log-joint's
# value against the plain path within 1e-5 relative in float32 (the JAX
# package's ELBO bound is 2e-4; here sums of 40,000 |residuals| whose terms
# differ by ~1e-6), its gradient within GRAD_SCALE_TOL of its largest value;
# bf16 within the bf16 bounds; 3 HMC steps of 4 leapfrogs on replayed draws,
# kernel against plain: the same accepts, z within 1e-3 relative L2
T_INFER = 800
INFER_CHAINS = (8, 1)
INFER_OBS_SCALE = 50.0              # the stage's obs_scale
LOGJOINT_F32_REL = 1e-5
HMC_Z_REL = 1e-3
SMC_PARTICLES = 256
# phase 9, the model variants, on phase 7's corpus and work directory with a
# third speech-like speaker (~170 Hz, made from the seed like the other two,
# the same counts: RECIPE_UTTS train-directory utterances of 1.5-2.5 s and
# one eval utterance; its min F0, max F0, power threshold); the many-to-many
# recipe over src [SPKA], trg [SPKB, SPKC] at the ModelConfig defaults (n_spk
# 3) for 2 epochs (VCC2018: 4 + 4 speakers, 500 epochs; cut to fit a smoke
# run, widths unchanged); its epoch 1 and stage 5m on the plain path within
# the recipe's bounds; the classifier and the VQ-CycleVAE trainers for 2
# epochs each; one step of each, kernel route against the plain path on the
# same weights, batch and draws: the f32 loss within 1e-5 relative, every
# gradient within GRAD_SCALE_TOL of its largest value
VARIANT_SPEAKER, VARIANT_F0, VARIANT_RANGE = "SPKC", 170.0, (90.0, 450.0, -25.0)
VARIANT_EPOCHS = 2
VARIANT_LOSS_REL = 1e-5
VARIANT_T = 560                     # the longest whole-utterance bucket (2.5 s at 5 ms)
# phase 10, the data-parallel layer on the one card of the card's machine:
# NCCL refuses two ranks on one card, so 2 gloo ranks share cuda:0 (their
# collectives staged through host copies) and 1 NCCL rank (world size 1)
# runs alone.  The train step: the flagship f32, global B = 10 (two of
# phase 4's bsu-5 batches, 5 utterances per rank), 7 segments of 80, do_prob
# 0.5, against the single-device step on the same generator: per-segment
# losses within DP_LOSS_REL (float32 sums over two ranks' rows in another
# order), the first segment's all-reduced gradients within GRAD_SCALE_TOL of
# scale of the single-device ones (before Adam: its first step is ~lr *
# sign(g), so a near-0 gradient whose sign flips moves a weight by 2 lr:
# compare gradients, not weights); sharded HMC at hu1024 on a 400-frame
# utterance, 2 ranks x 4 chains, L = 4, 2 warm-up steps and 2 samples,
# against hmc_sample_chains over the same 8 chains (the same accepts, z
# within DP_Z_REL rel-L2); sharded SMC on the decoder SSM, 2 x 128
# particles against 256, the log-marginal within DP_LM_REL relative
DP_RANKS = 2
DP_TIMED_STEPS = 5
DP_LOSS_REL = 2e-4
DP_T = 400
DP_CHAINS = 8
DP_HMC = (0.002, 4, 2, 2)               # step size, leapfrogs, warm-up, samples
DP_Z_REL = 1e-4
DP_PARTICLES = 256
DP_LM_REL = 1e-4
# phase 11, the port's tools (cyclevae_tpu_torch/tools) at full width and
# reduced depth, in phase 7's work directory: the train-throughput bench at
# bsu 5 and 64 in f32 and bf16 on the kernel route (1 + 3 steps of 2
# segments of 80); HMC at 32 and 128 chains (T = 256, L = 8, 2 warm-up + 2
# samples, both dtypes); NUTS at 32 chains, depth 4; SMC with 256 particles
# over 64 frames; the trajectory-length sweep at 2 points of 32 chains; the
# scaling curves at 1 and 2 gloo ranks on the card; the vocoder tools on
# phase 7's speaker SPKB (vocode-converted with its stage-v vocoder, then
# train-and-eval for 1 epoch); re-eval over phase 7's 2 checkpoints.  Each
# tool's launches are held to their prediction from the row-block limits,
# and any "error" or "fault" row fails the phase
TOOLS_BENCH_BSU = (5, 64)
TOOLS_BENCH_STEPS = 3
TOOLS_HMC_CHAINS = (32, 128)
TOOLS_ITERS = 2                     # warm-up and sampling iterations each
# the fused-vs-sequential conversion bench at the JAX tool's T on phase 7's
# checkpoint (hu1024, f32), 3 timed pairs a path after one warm-up pair
TOOLS_FUSION_T = 600
TOOLS_FUSION_REPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


PR_SET_CHILD_SUBREAPER = 36         # linux/prctl.h


def adopt_orphans() -> None:
    """Make this process the subreaper of everything it starts: a process
    whose parent ends before it is handed to this one, not to init, so
    that ``stop_leftovers`` finds it."""
    import ctypes
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)


def _children() -> dict:
    """{pid: (state, command line)} of this process's children."""
    me, found = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me:
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:             # ended while being read
            continue
        found[int(d)] = (fields[0], cmd)
    return found


def _reap(pid: int, wait_s: float) -> bool:
    """Wait up to ``wait_s`` for child ``pid`` to end and collect it."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                return True
        except ChildProcessError:   # already collected
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.05)


def stop_leftovers() -> list:
    """Stop every process this one started that is still there, and return
    the command lines of those that were still running.

    multiprocessing's resource tracker (started by the first ``spawn``-context
    process: stage 1's feature workers, the spawned ranks) ignores SIGTERM and
    would otherwise end only after this process, when it reads end of file;
    it is closed last, once no other child can hold its pipe.  Every other
    child, orphans handed here by ``adopt_orphans`` included, gets SIGTERM,
    then SIGKILL after 5 s, and is collected.
    """
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    stopped = []
    for _ in range(10):             # a stopped child's orphans come here next
        others = {p: v for p, v in _children().items() if p != tracker._pid}
        if not others:
            break
        for pid, (state, cmd) in others.items():
            if state != "Z":
                stopped.append(cmd)
                try:
                    os.kill(pid, 15)
                except ProcessLookupError:
                    pass
        for pid in others:
            if not _reap(pid, 5.0):
                try:
                    os.kill(pid, 9)
                except ProcessLookupError:
                    pass
                _reap(pid, 5.0)
    if tracker._pid is not None:
        stopped.append(f"multiprocessing's resource tracker (pid {tracker._pid})")
    tracker._stop()
    for cmd in stopped:
        print(f"chip_smoke: stopped a leftover process: {cmd}", file=sys.stderr, flush=True)
    return stopped


# the conversion engine's CUDA graph captures in this process
# (``decode._PairPhase``: one a padded length a codec, at its first
# request); the run off each capture launches K1 as a request does, so a
# window that holds captures counts 2 K1 a pair and 2 more a capture
CAPTURES = [0]


def count_captures() -> None:
    """Counts under ``CAPTURES`` each phase that ``decode._PairPhase``
    captures as a CUDA graph, from here to the end of the process."""
    from cyclevae_tpu_torch.pipeline import decode
    init = decode._PairPhase.__init__

    def counted(self, codec, Tp):
        init(self, codec, Tp)
        CAPTURES[0] += self.graph is not None

    decode._PairPhase.__init__ = counted


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))


def gru_ar_bound_ms(B: int, T: int, out: int, wdt: torch.dtype):
    """Least time for one call: its operations over the peak rate of the
    input type, or its bytes (each input read once, each output written
    once) over HBM bandwidth, whichever is larger."""
    wb = torch.empty((), dtype=wdt).element_size()
    ops = 2 * T * B * (3 * H * H + 3 * H * out + H * out)
    nbytes = ((3 * H * H + 3 * H * out + out * H) * wb + (3 * H + out) * 4
              + B * T * 3 * H * wb + (B * out + B * H) * 4
              + B * T * out * 4 + (B * out + B * H) * 4)
    t_ops, t_bytes = ops / PEAK_OPS[wdt] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def elementwise_bound_ms(ops: float, nbytes: float, wdt: torch.dtype):
    t_ops, t_bytes = ops / PEAK_OPS[wdt] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gru_ar_train_bound_ms(B: int, T: int, out: int, wdt: torch.dtype):
    """K2: operations as ``pallas_gru.py:191-197`` counts them; bytes of
    each input read once (gates, mask, weights, biases, y0, h0) and each
    output written once (trj, y_T, h_T, h_seq)."""
    wb = torch.empty((), dtype=wdt).element_size()
    ops = 2 * T * B * (3 * H * H + 3 * H * out + H * out)
    nbytes = (B * T * (3 * H + H) * wb + (3 * H * H + 3 * H * out + out * H) * wb
              + (3 * H + out) * 4 + (B * out + B * H) * 4
              + B * T * out * 4 + (B * out + B * H) * 4 + B * T * H * wb)
    return elementwise_bound_ms(ops, nbytes, wdt)


def gru_ar_bwd_bound_ms(B: int, T: int, out: int, wdt: torch.dtype):
    """K3: operations as ``pallas_gru.py:349-354`` counts them; bytes of
    each input read once (d_trj, gates_x, y_prev, h_prev, mask, weights,
    b_hh, dh_T, dy_T) and each output written once (dgx, dgh, dy_tot, dh0,
    dy0)."""
    wb = torch.empty((), dtype=wdt).element_size()
    ops = 2 * T * B * (out * H + 2 * 3 * H * H + 2 * 3 * H * out)
    nbytes = (B * T * out * 4 + B * T * (3 * H + out + 2 * H) * wb
              + (out * H + 3 * H * H + 3 * H * out) * wb + 3 * H * 4 + (B * H + B * out) * 4
              + 2 * B * T * 3 * H * wb + B * T * out * 4 + (B * H + B * out) * 4)
    return elementwise_bound_ms(ops, nbytes, wdt)


def gru_ar_bwd_saved_bound_ms(B: int, T: int, out: int, wdt: torch.dtype):
    """K3 on the gates K2 kept: the cotangents' products only (``dy_tot .
    Wout``, ``dgh . Whh``, ``dgx . Wy``; no gate recompute); bytes of each
    input it reads once (d_trj, h_prev, mask, the (B, T, 4, H) float32
    gates, Wout, Whh, Wy, dh_T, dy_T) and each output written once."""
    wb = torch.empty((), dtype=wdt).element_size()
    ops = 2 * T * B * (out * H + 3 * H * H + 3 * H * out)
    nbytes = (B * T * out * 4 + B * T * 2 * H * wb + B * T * 4 * H * 4
              + (out * H + 3 * H * H + 3 * H * out) * wb + (B * H + B * out) * 4
              + 2 * B * T * 3 * H * wb + B * T * out * 4 + (B * H + B * out) * 4)
    return elementwise_bound_ms(ops, nbytes, wdt)


def wavernn_bound_ms(B: int, T: int, cfg):
    """K4: operations as ``pallas_wavernn.py:138-142`` counts them; bytes of
    the conditioning gates read once, the weights (gate table, Whh, b_hh,
    W1, b1, W2, b2) read once and the indices written once."""
    H, K, FC = cfg.hidden_units, cfg.n_classes, cfg.fc_dim
    ops = 2 * T * B * (H * 3 * H + H * FC + FC * K)
    nbytes = (T * B * 3 * H * 4 + (K * 3 * H + 3 * H * H + 3 * H + FC * H + FC + K * FC + K) * 4
              + T * B * 4)
    return elementwise_bound_ms(ops, nbytes, torch.float32)


def wavernn_dual_bound_ms(B: int, T: int, cfg):
    """K4's dual instantiation: operations and bytes as
    ``benchmark/work/wavernn_dual.py`` counts them: the recurrent product
    and each head's two layers over its half; the conditioning gates, the
    weights and the samples moved once."""
    H, K = cfg.hidden_units, cfg.n_classes
    Hh = H // 2
    ops = 2 * T * B * (3 * H * H + 2 * Hh * Hh + 2 * K * Hh)
    weights = 3 * H * 3 + 3 * H * H + 3 * H + 2 * (Hh * Hh + Hh + K * Hh + K)
    nbytes = T * B * 3 * H * 4 + weights * 4 + T * B * 4
    return elementwise_bound_ms(ops, nbytes, torch.float32)


def pwg_layer_bound_ms(n: int, cfg, first: bool = False):
    """The PWG layer kernel: operations and bytes as
    ``benchmark/work/pwg.py`` counts one layer over n samples: the (kR + A) x
    G and G/2 x (R + S) products; x read and written, c read, skip written
    and (past the first layer) read, each once, the weights once."""
    k, R, G, S, A = (cfg.kernel_size, cfg.residual_channels, cfg.gate_channels,
                     cfg.skip_channels, cfg.aux_channels)
    ops = 2 * n * ((k * R + A) * G + (G // 2) * (R + S))
    weights = (k * R + A) * G + G + (G // 2) * (R + S) + R + S
    nbytes = 4 * (n * (2 * R + A + S + (0 if first else S)) + weights)
    return elementwise_bound_ms(ops, nbytes, torch.float32)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from cyclevae_tpu_torch.dsp import _lib as dsp_lib
    from cyclevae_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:     # the host DSP library beside nvcc
        dsp = pool.submit(dsp_lib.get_lib)
        paths = _build.build(["gru_ar", "gru_ar_bwd", "wavernn", "pwg"])
        dsp.result()
    log(f"[build] {len(paths)} kernel source(s) and the host DSP library ({dsp_lib._LIB_PATH}) "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _k1_rows(dev, gen, calls, T, dtypes, tag="kernels"):
    """K1 against its plain version on random weights, gates and feedback:
    per (call, B, out, conv_dim) of ``calls`` and dtype, the max abs
    difference, kernel and plain times (CUDA events), the bound and the plan."""
    from cyclevae_tpu_torch.models.layers import init_dense, init_gru_stack
    from cyclevae_tpu_torch.ops import _build
    from cyclevae_tpu_torch.ops.cuda_gru import (PLAN_KEYS, cuda_gru_ar, gru_ar_reference,
                                                 max_batch, plan)
    from cyclevae_tpu_torch.ops.gru_scan import precompute_input_gates

    results = {}
    for call, B, out, conv_dim in calls:
        layer = init_gru_stack(gen, conv_dim + out, H, 1)[0]
        layer["b_ih"].uniform_(-0.1, 0.1, generator=gen)
        layer["b_hh"].uniform_(-0.1, 0.1, generator=gen)
        proj = init_dense(gen, H, out)
        conv = torch.randn((B, T, conv_dim), generator=gen, device=dev)
        gx = precompute_input_gates(layer, conv)
        y0 = 0.5 * torch.randn((B, out), generator=gen, device=dev)
        h0 = torch.zeros((B, H), device=dev)
        for wdt in dtypes:
            args = (layer, proj, gx, y0, h0, wdt)
            before = cuda_gru_ar.launches
            got = cuda_gru_ar(*args)
            launches = cuda_gru_ar.launches - before
            want = gru_ar_reference(*args)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rl2, cos = rel_l2(got[0], want[0]), cosine(got[0], want[0])
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ok = finite and (err <= F32_ATOL if wdt == torch.float32
                             else rl2 < BF16_REL_L2 and cos > BF16_COS)
            ms = cuda_ms(lambda: cuda_gru_ar(*args), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: gru_ar_reference(*args), iters=2)
            bound_ms, bound_by = gru_ar_bound_ms(B, T, out, wdt)
            # past one launch's rows: row blocks of at most max_batch rows,
            # ceil(B / max_batch) launches a call; the first block's plan
            limit = max_batch("k1", H, out, wdt)
            ok &= launches == -(-B // limit)
            pl = dict(zip(PLAN_KEYS, plan(_build.load("gru_ar"), min(B, limit), H, out, wdt)))
            key = f"{call}/{str(wdt).split('.')[-1]}"
            results[key] = dict(B=B, T=T, out=out, max_abs_err=err,
                                rel_l2=rl2, cosine=cos, ms=ms,
                                us_per_frame=ms * 1e3 / T, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, plan=pl,
                                launches_per_call=launches, ok=ok)
            plan_txt = " ".join(f"{k}={v}" for k, v in pl.items())
            log(f"[{tag}] gru_ar {key} B={B} T={T} H={H} out={out} "
                f"plan: {plan_txt}; {launches} launch(es) a call; max_abs={err:.3e} "
                f"rel_l2={rl2:.3e} cos={cos:.6f} kernel={ms:.3f} ms "
                f"({ms * 1e3 / T:.2f} us/frame) plain={plain_ms:.1f} ms "
                f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}")
    return results


def phase_kernels(dev):
    """K1 against its plain version at the conversion path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = _k1_rows(dev, gen, (("encoder", 2, 64, 486), ("decoder", 3, 50, 306)), T_KERNEL,
                    (torch.float32, torch.bfloat16))
    # row blocks: 64 rows at the HMC sweep's T (past the f32 limit of 46)
    rows.update(_k1_rows(dev, gen, ((f"decoderB{K1_ROWS_B}", K1_ROWS_B, 50, 306),), K1_ROWS_T,
                         (torch.float32, torch.bfloat16)))
    return rows


def _match(got, want, wdt, scale_tol):
    """(max abs difference, relative L2, cosine, ok) of a kernel's outputs
    against its plain version's: float32 within ``scale_tol`` of the largest
    value (at least 1); bf16 within the JAX package's bf16 bounds."""
    err, worst_rl2, worst_cos, ok = 0.0, 0.0, 1.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        e = float((g - w).abs().max())
        rl2, cos = rel_l2(g, w), cosine(g, w)
        err, worst_rl2, worst_cos = max(err, e), max(worst_rl2, rl2), min(worst_cos, cos)
        ok &= bool(torch.isfinite(g).all())
        if wdt == torch.float32:
            ok &= e <= scale_tol * max(float(w.abs().max()), 1.0)
        else:
            ok &= rl2 < BF16_REL_L2 and cos > BF16_COS
    return err, worst_rl2, worst_cos, ok


def _train_rows(dev, gen, runs, dtypes, tag="kernels"):
    """K2 and K3 against their plain versions on random weights, gates,
    feedback and dropout masks: per (call, B, out, conv_dim, T, kernels) of
    ``runs`` and dtype, as ``_k1_rows``.  K2's row checks the gates it keeps
    too (``cuda_gru_ar_train_gates``), against the plain forward's.  Kernel
    "gru_ar_bwd_saved" is K3 on those gates, as the training path runs it,
    against the plain K3 recomputing its gates from the plain forward's
    residuals, with a bound of the work it does (no recompute)."""
    from cyclevae_tpu_torch.models.layers import init_dense, init_gru_stack
    from cyclevae_tpu_torch.ops import _build
    from cyclevae_tpu_torch.ops.cuda_gru import (BWD_PLAN_KEYS, PLAN_KEYS, cuda_gru_ar_bwd,
                                                 cuda_gru_ar_train, cuda_gru_ar_train_gates,
                                                 gru_ar_bwd_reference, gru_ar_train_reference,
                                                 _forward_reference, max_batch, plan,
                                                 plan_bwd)
    from cyclevae_tpu_torch.ops.gru_scan import precompute_input_gates

    results = {}
    for call, B, out, conv_dim, T, kernels in runs:
        layer = init_gru_stack(gen, conv_dim + out, H, 1)[0]
        layer["b_ih"].uniform_(-0.1, 0.1, generator=gen)
        layer["b_hh"].uniform_(-0.1, 0.1, generator=gen)
        proj = init_dense(gen, H, out)
        gx = precompute_input_gates(layer, torch.randn((B, T, conv_dim), generator=gen, device=dev))
        y0 = 0.5 * torch.randn((B, out), generator=gen, device=dev)
        h0 = 0.1 * torch.randn((B, H), generator=gen, device=dev)
        mask = (torch.rand((B, T, H), generator=gen, device=dev) < 0.5).float() * 2.0
        for wdt in dtypes:
            dname = str(wdt).split('.')[-1]
            # K3's inputs from the plain forward: its residuals as the
            # backward sees them, and random output cotangents
            trj, _, _, h_seq = gru_ar_train_reference(layer, proj, gx, y0, h0, mask, wdt)
            y_prev = torch.cat([y0[:, None], trj[:, :-1]], dim=1).to(wdt)
            h_prev = torch.cat([h0[:, None].to(wdt), h_seq[:, :-1]], dim=1)
            bwd_args = (proj["w"].to(wdt), layer["w_hh"].to(wdt), layer["w_ih"][:, -out:].to(wdt),
                        layer["b_hh"], torch.randn((B, T, out), generator=gen, device=dev), gx,
                        y_prev, h_prev, mask, torch.randn((B, H), generator=gen, device=dev),
                        torch.randn((B, out), generator=gen, device=dev))
            for kname in kernels:
                # past one launch's rows: row blocks of at most max_batch
                # rows, ceil(B / max_batch) launches a call; the first
                # block's plan
                if kname == "gru_ar_train":
                    # all five outputs: trj, y_T, h_T, h_seq and the gates
                    args = (layer, proj, gx, y0, h0, mask, wdt)
                    fn, ref, tol = cuda_gru_ar_train_gates, _forward_reference, F32_ATOL
                    counter = cuda_gru_ar_train
                    bound_ms, bound_by = gru_ar_train_bound_ms(B, T, out, wdt)
                    limit = max_batch("k2", H, out, wdt)
                    pl = dict(zip(PLAN_KEYS, plan(_build.load("gru_ar"), min(B, limit), H, out,
                                                  wdt, train=True)))
                else:
                    args, fn, ref = bwd_args, cuda_gru_ar_bwd, gru_ar_bwd_reference
                    tol, counter = GRAD_SCALE_TOL, cuda_gru_ar_bwd
                    bound_ms, bound_by = gru_ar_bwd_bound_ms(B, T, out, wdt)
                    if kname == "gru_ar_bwd_saved":
                        args += (cuda_gru_ar_train_gates(layer, proj, gx, y0, h0, mask, wdt)[4],)
                        # the plain K3 recomputes its gates: no kernel output
                        # reaches the reference
                        ref = lambda *a: gru_ar_bwd_reference(*a[:-1])
                        bound_ms, bound_by = gru_ar_bwd_saved_bound_ms(B, T, out, wdt)
                    limit = max_batch("k3", H, out, wdt)
                    # K3 runs without thread-block clusters: its exchange
                    # crosses L2 (see csrc/gru_ar_bwd.cu)
                    pl = dict(zip(BWD_PLAN_KEYS, plan_bwd(_build.load("gru_ar_bwd"),
                                                          min(B, limit), H, out, wdt)), cluster=1)
                before = counter.launches
                got = fn(*args)
                launches = counter.launches - before
                want = ref(*args)
                torch.cuda.synchronize()
                err, rl2, cos, ok = _match(got, want, wdt, tol)
                ok &= launches == -(-B // limit)
                ms = cuda_ms(lambda: fn(*args), iters=10, warmup=2)
                plain_ms = cuda_ms(lambda: ref(*args), iters=2)
                key = f"{kname}/{call}/T{T}/{dname}"
                results[key] = dict(kernel=kname, call=call, B=B, T=T, out=out, dtype=dname,
                                    max_abs_err=err, rel_l2=rl2, cosine=cos, ms=ms,
                                    us_per_step=ms * 1e3 / T, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by, plan=pl,
                                    launches_per_call=launches, ok=ok)
                plan_txt = " ".join(f"{k}={v}" for k, v in pl.items())
                log(f"[{tag}] {key} B={B} H={H} out={out} plan: {plan_txt}; {launches} "
                    f"launch(es) a call; max_abs={err:.3e} "
                    f"rel_l2={rl2:.3e} cos={cos:.6f} kernel={ms:.3f} ms "
                    f"({ms * 1e3 / T:.2f} us/step) plain={plain_ms:.1f} ms "
                    f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}")
    return results


def phase_train_kernels(dev):
    """K2 and K3 against their plain versions at the train step's shapes, and
    at stage i's, K3 there also on the gates K2 kept."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    runs = [(name, B, out, conv, SEG_LEN, ("gru_ar_train", "gru_ar_bwd"))
            for name, B, out, conv in TRAIN_CALLS]
    # K3 only: past launch cost
    runs.append(("decoder2B", 10, 50, 306, T_BWD_LONG, ("gru_ar_bwd",)))
    # row blocks: a bsu-64 step's fused 2B decoder, 128 rows
    runs.append((f"decoder2B_bsu{ROWS_BSU}", 2 * ROWS_BSU, 50, 306, SEG_LEN,
                 ("gru_ar_train", "gru_ar_bwd")))
    rows = _train_rows(dev, gen, runs, (torch.float32, torch.bfloat16))
    # stage i's log-joint (float32): K2, K3 recomputing its gates, and K3 on
    # the gates K2 kept, as the log-joint's gradient runs it
    rows.update(_train_rows(dev, gen, [("stage_i", max(INFER_CHAINS), 50, 306, T_INFER,
                                        ("gru_ar_train", "gru_ar_bwd", "gru_ar_bwd_saved"))],
                            (torch.float32,)))
    return rows


def _vocoder(dev, seed: int, n_spk: int = 0):
    """The flagship WaveRNN (``WaveRNNConfig`` defaults) with random weights
    from ``seed`` and non-zero biases."""
    from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, init_wavernn

    cfg = WaveRNNConfig(n_spk=n_spk)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_wavernn(gen, cfg)
    params["gru"]["b_ih"].uniform_(-0.5, 0.5, generator=gen)
    params["gru"]["b_hh"].uniform_(-0.5, 0.5, generator=gen)
    params["fc1"]["b"].uniform_(-0.1, 0.1, generator=gen)
    params["fc2"]["b"].uniform_(-0.02, 0.02, generator=gen)
    return cfg, params


def _vocoder_dual(dev, seed: int):
    """The published WaveRNN-896 (``WaveRNNConfig(dual=True)``: a coarse and
    a fine 8-bit softmax over 16-bit audio) with random weights from
    ``seed``, the masked input entries and every bias non-zero."""
    from cyclevae_tpu_torch.models.wavernn import WaveRNNConfig, init_wavernn

    cfg = WaveRNNConfig(dual=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_wavernn(gen, cfg)
    params["gru"]["w_ih"].uniform_(-0.05, 0.05, generator=gen)   # the masked entries too
    for k in ("b_ih", "b_hh"):
        params["gru"][k].uniform_(-0.5, 0.5, generator=gen)
    for k in ("O1", "O2", "O3", "O4"):
        params[k]["b"].uniform_(-0.05, 0.05, generator=gen)
    return cfg, params


def phase_vocoder_kernel(dev):
    """K4 against its plain version at the sampler's shapes, and its sampled
    draws against the distribution they follow."""
    from scipy import stats

    from cyclevae_tpu_torch.models.wavernn import mulaw_decode
    from cyclevae_tpu_torch.ops import _build
    from cyclevae_tpu_torch.ops.cuda_wavernn import (NEAR_TIE_REL, cuda_wavernn_generate,
                                                     first_divergence, plan,
                                                     wavernn_generate_reference)

    cfg, params = _vocoder(dev, SEED + 4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    results, ok = {}, True
    for B in (1, 4):
        cond = torch.tanh(torch.randn((B, T_VOC, cfg.cond_dim), generator=gen, device=dev))
        grid, units, cluster, stage_rows, smem = plan(_build.load("wavernn"), B, cfg.hidden_units,
                                                      cfg.n_classes, cfg.fc_dim)
        pl = dict(grid=grid, units=units, cluster=cluster, stage_rows=stage_rows, smem=smem)
        for temp in (0.0, VOC_TEMPERATURE):
            args = (params, cfg, cond, SEED + B, temp)
            got = cuda_wavernn_generate(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want, gap, scale = wavernn_generate_reference(*args, margins=True)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            steps, match = first_divergence(got, want, gap, scale)
            err = float((mulaw_decode(got) - mulaw_decode(want)).abs().max())
            ms = cuda_ms(lambda: cuda_wavernn_generate(*args), iters=3)
            bound_ms, bound_by = wavernn_bound_ms(B, T_VOC, cfg)
            key = f"B{B}/{'greedy' if temp == 0 else f'sampled{temp}'}"
            results[key] = dict(B=B, T=T_VOC, temperature=temp, first_divergence=steps,
                                max_abs_err=err, ms=ms, us_per_sample=ms * 1e3 / T_VOC,
                                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                plan=pl, ok=match)
            ok &= match
            first = ", ".join("none" if t < 0 else str(t) for t in steps)
            log(f"[kernels] wavernn_generate {key} H={cfg.hidden_units} K={cfg.n_classes} "
                f"fc={cfg.fc_dim} T={T_VOC} plan: grid {grid} blocks x {units} units in "
                f"clusters of {cluster}, f stage {stage_rows}, shared {smem} bytes; "
                f"first divergence per row: {first} "
                f"(near-tie rule {NEAR_TIE_REL}) max_abs (decoded) {err:.3e} "
                f"kernel={ms:.3f} ms ({ms * 1e3 / T_VOC:.2f} us/sample) plain={plain_ms:.1f} ms "
                f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if match else 'FAIL'}")

    # fc2.w = 0: the logits are b2 at every step, so the draws are i.i.d.
    # categorical(softmax(b2 / temperature))
    flat = {**params, "fc2": {"w": torch.zeros_like(params["fc2"]["w"]),
                              "b": torch.randn(cfg.n_classes, generator=gen, device=dev)}}
    cond = torch.tanh(torch.randn((VOC_DIST_ROWS, VOC_DIST_T, cfg.cond_dim), generator=gen,
                                  device=dev))
    idx = cuda_wavernn_generate(flat, cfg, cond, SEED + 9, VOC_TEMPERATURE)
    counts = np.bincount(idx.cpu().numpy().ravel(), minlength=cfg.n_classes)
    p = np.exp(flat["fc2"]["b"].double().cpu().numpy() / VOC_TEMPERATURE)
    expected = p / p.sum() * idx.numel()
    keep = expected >= 5
    chi2 = float((((counts - expected) ** 2) / expected)[keep].sum())
    limit = float(stats.chi2.ppf(0.999, int(keep.sum()) - 1))
    hot = {**flat, "fc2": {"w": flat["fc2"]["w"], "b": torch.zeros_like(flat["fc2"]["b"])}}
    hot["fc2"]["b"][5] = 10.0
    frac_hot = float((cuda_wavernn_generate(hot, cfg, cond[:, :2000], SEED + 10, 1.0) == 5)
                     .float().mean())
    dist_ok = chi2 < limit and frac_hot > 0.9
    ok &= dist_ok
    log(f"[kernels] wavernn_generate distribution: {idx.numel()} draws at temperature "
        f"{VOC_TEMPERATURE}, chi-square {chi2:.1f} over {int(keep.sum())} classes (< {limit:.1f}, "
        f"the 0.999 quantile); hot class (logit 10) in {frac_hot:.4f} of draws (> 0.9) "
        f"{'ok' if dist_ok else 'FAIL'}")
    return results, ok


def phase_vocoder_dual_kernel(dev):
    """K4's dual instantiation against its plain version at the published
    widths (H = 896 in halves of 448, two 256-way heads), T = 4,000, B = 1
    and 4, greedy and sampled: its samples held by the near-tie rule of the
    head that differs, its launches, times and bound."""
    from cyclevae_tpu_torch.models.wavernn import pcm16_decode
    from cyclevae_tpu_torch.ops import _build
    from cyclevae_tpu_torch.ops.cuda_wavernn import (NEAR_TIE_REL, cuda_wavernn_generate,
                                                     first_divergence, plan,
                                                     wavernn_generate_reference)

    cfg, params = _vocoder_dual(dev, SEED + 40)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    results, ok = {}, True
    for B in (1, 4):
        cond = torch.tanh(torch.randn((B, T_VOC, cfg.cond_dim), generator=gen, device=dev))
        grid, units, cluster, stage_rows, smem = plan(_build.load("wavernn"), B, cfg.hidden_units,
                                                      cfg.n_classes, 0, dual=True)
        pl = dict(grid=grid, units=units, cluster=cluster, stage_rows=stage_rows, smem=smem)
        for temp in (0.0, VOC_TEMPERATURE):
            args = (params, cfg, cond, SEED + 40 + B, temp)
            before = cuda_wavernn_generate.launches
            got = cuda_wavernn_generate(*args)
            launches = cuda_wavernn_generate.launches - before
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want, gap, scale = wavernn_generate_reference(*args, margins=True)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            equal = bool(torch.equal(got, want))
            steps, match = first_divergence(got, want, gap, scale)
            match &= launches == 1
            err = float((pcm16_decode(got) - pcm16_decode(want)).abs().max())
            ms = cuda_ms(lambda: cuda_wavernn_generate(*args), iters=3)
            bound_ms, bound_by = wavernn_dual_bound_ms(B, T_VOC, cfg)
            key = f"B{B}/{'greedy' if temp == 0 else f'sampled{temp}'}"
            results[key] = dict(B=B, T=T_VOC, temperature=temp, first_divergence=steps,
                                equal=equal, max_abs_err=err, ms=ms,
                                us_per_sample=ms * 1e3 / T_VOC, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, plan=pl,
                                launches_per_call=launches, ok=match)
            ok &= match
            first = ", ".join("none" if t < 0 else str(t) for t in steps)
            log(f"[kernels] wavernn_generate dual {key} H={cfg.hidden_units} (2 x "
                f"{cfg.hidden_units // 2}) K=2x{cfg.n_classes} T={T_VOC} plan: grid {grid} blocks "
                f"x {units} units in clusters of {cluster}, shared {smem} bytes; {launches} "
                f"launch(es); equal {equal}, first divergence per row: {first} (near-tie rule "
                f"{NEAR_TIE_REL}) max_abs (decoded) {err:.3e} kernel={ms:.3f} ms ({ms * 1e3 / T_VOC:.2f} us/sample) "
                f"plain={plain_ms:.1f} ms bound={bound_ms:.4f} ms ({bound_by}) "
                f"{'ok' if match else 'FAIL'}")
    return results, ok


def phase_pwg(dev):
    """Parallel WaveGAN's layer kernel against its plain version at the
    published widths (n = 130 and 390 frames of 256 samples, dilations 1,
    16 and 512, the first layer's skip written and a later one's
    accumulated), with its time, the plain version's and the bound; then the
    main path: ``synthesize_vocoder`` renders 390 frames of features with
    the generator (30 launches), held against the plain reference
    (``benchmark/reference/pwg.py``) on the same noise, and timed."""
    from benchmark.drivers.vocode_pwg import pwg_weights
    from benchmark.reference import pwg as ref
    from cyclevae_tpu_torch.models.pwg import PWGConfig, pack_layers
    from cyclevae_tpu_torch.ops.cuda_pwg import cuda_pwg_layer, pwg_layer_reference
    from cyclevae_tpu_torch.pipeline.vocoder_stage import synthesize_vocoder

    cfg = PWGConfig()
    v = dataclasses.asdict(cfg)
    R, S, A = cfg.residual_channels, cfg.skip_channels, cfg.aux_channels
    p = pwg_weights(torch.Generator(device=dev).manual_seed(SEED + 50), v)
    w1, b1, w2, b2 = pack_layers(p, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    gap = lambda got, want: float((got - want).abs().max() / want.abs().max())
    results, ok = {}, True
    for frames in PWG_FRAMES:
        n = frames * cfg.hop
        x = torch.randn((1, R, n), generator=gen, device=dev)
        c = torch.randn((1, A, n), generator=gen, device=dev)
        skip = torch.randn((1, S, n), generator=gen, device=dev)
        for d in PWG_DILATIONS:
            l = next(i for i in range(cfg.layers) if cfg.dilation(i) == d)
            for first in ((True, False) if d == 1 else (False,)):
                s_in = None if first else skip
                args = lambda: (x, c, None if first else skip.clone(), w1[l], b1[l], w2[l],
                                b2[l], d)
                before = cuda_pwg_layer.launches
                got = cuda_pwg_layer(*args())
                launches = cuda_pwg_layer.launches - before
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                want = pwg_layer_reference(x, c, s_in, w1[l], b1[l], w2[l], b2[l], d)
                end.record()
                torch.cuda.synchronize()
                plain_ms = start.elapsed_time(end)
                err = max(gap(got[0], want[0]), gap(got[1], want[1]))
                timed = args()
                ms = cuda_ms(lambda: cuda_pwg_layer(*timed), iters=PWG_ITERS)
                bound_ms, bound_by = pwg_layer_bound_ms(n, cfg, first)
                row_ok = err <= PWG_LAYER_TOL and launches == 1
                ok &= row_ok
                key = f"n{n}/d{d}/{'first' if first else 'accumulate'}"
                results[key] = dict(n=n, dilation=d, first=first, max_abs_err=err, ms=ms,
                                    us_per_ksample=ms * 1e6 / n, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    roofline_pct=100 * bound_ms / ms,
                                    launches_per_call=launches, ok=row_ok)
                log(f"[kernels] pwg_layer {key} ({frames} frames) R={R} G={cfg.gate_channels} "
                    f"S={S} A={A}: {launches} launch; max gap {err:.3e} of the largest output "
                    f"(<= {PWG_LAYER_TOL}) kernel={ms:.4f} ms plain={plain_ms:.3f} ms "
                    f"bound={bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%) "
                    f"{'ok' if row_ok else 'FAIL'}")

    # the main path, against the reference on the same noise
    frames = PWG_FRAMES[-1]
    feats = torch.randn((frames, A), generator=gen, device=dev)
    seed = SEED + 52
    before = cuda_pwg_layer.launches
    wave = synthesize_vocoder(p, cfg, feats.cpu().numpy(), seed=seed, device=dev)
    launches = cuda_pwg_layer.launches - before
    z = torch.randn((1, frames * cfg.hop), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)[0]
    want = ref.generate(p, v, feats, z)
    err = gap(torch.as_tensor(wave, device=dev), want)
    tf32 = gap(ref.generate(p, v, feats, z, precision_name="tf32"), want)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        synthesize_vocoder(p, cfg, feats.cpu().numpy(), seed=seed, device=dev)
    render_ms = (time.perf_counter() - t0) / 5 * 1e3
    main_ok = launches == cfg.layers and err <= PWG_WAVE_TOL < tf32
    ok &= main_ok
    results["synthesize"] = dict(frames=frames, samples=frames * cfg.hop, launches=launches,
                                 max_abs_err=err, tf32_gap=tf32, render_ms=render_ms, ok=main_ok)
    log(f"[vocode] pwg synthesize_vocoder {frames} frames ({frames * cfg.hop} samples): "
        f"{launches} layer launches; gap {err:.3e} from the reference (<= {PWG_WAVE_TOL}; the "
        f"reference in TF32 {tf32:.3e}); {render_ms:.2f} ms a rendering (host clock) "
        f"{'ok' if main_ok else 'FAIL'}")
    return results, ok, launches


def synth_features(rng: np.random.Generator, T: int, in_dim: int = 54) -> np.ndarray:
    """Smooth feature trajectories laid out as the recipe's 54-d vector:
    [U/V, log F0, 2 coded aperiodicities, 50 mel-cepstra]."""
    walk = np.cumsum(rng.normal(size=(T, in_dim)), axis=0) * 0.05
    walk -= walk.mean(axis=0)
    feat = walk + rng.normal(size=(T, in_dim)) * 0.1
    feat[:, 0] = (np.sin(np.arange(T) / 37.0) > -0.3).astype(np.float64)
    feat[:, 1] += 5.3
    feat[:, 4] += -3.0
    return feat.astype(np.float32)


def phase_main(dev):
    """The conversion path: Codec + device_decode_pair, as the recipe drives it."""
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

    rng = np.random.default_rng(SEED)
    pairs = [(synth_features(rng, s), synth_features(rng, t)) for s, t in REQUESTS]
    warm = [(synth_features(rng, s), synth_features(rng, t)) for s, t in WARMUP]
    allf = np.concatenate([f for p in pairs for f in p])
    mean, scale = allf.mean(axis=0), allf.std(axis=0) + 1e-3

    codecs = {}
    for dt in ("float32", "bfloat16"):
        cfg = CycleVAEConfig(use_pallas=True, compute_dtype=dt)
        params = init_cyclevae(torch.Generator(device=dev).manual_seed(SEED), cfg,
                               mean, scale, device=dev)
        n = sum(p.numel() for net in params for p in _leaves(net))
        log(f"[main] {dt}: flagship hl{cfg.hidden_layers} hu{cfg.hidden_units} "
            f"ld{cfg.lat_dim} ks{cfg.kernel_size} ds{cfg.dilation_size} "
            f"n_spk{cfg.n_spk}: {n} params")
        codecs[dt] = (Codec(params, cfg, device=dev),
                      Codec(params, dataclasses.replace(cfg, use_pallas=False), device=dev))
        for src, trg in warm:   # warm-up, not counted
            device_decode_pair(codecs[dt][0], None, src, trg)

    # ---- the main path: counts set to 0 just before, read just after ----
    outs, lat_ms, launches = {}, {}, {}
    cuda_gru_ar.launches = 0
    for dt, (codec, _) in codecs.items():
        before = cuda_gru_ar.launches
        outs[dt], lat_ms[dt] = [], []
        for i, (src, trg) in enumerate(pairs):
            t0 = time.perf_counter()
            outs[dt].append(device_decode_pair(
                codec, torch.Generator(device=dev).manual_seed(100 + i), src, trg))
            lat_ms[dt].append((time.perf_counter() - t0) * 1e3)
        launches[dt] = cuda_gru_ar.launches - before
    total_launches = cuda_gru_ar.launches

    ok = True
    for dt, (_, plain) in codecs.items():
        want_launches = 2 * len(pairs)
        ok &= launches[dt] == want_launches
        worst_rl2, worst_abs = 0.0, 0.0
        for i, ((src, trg), got) in enumerate(zip(pairs, outs[dt])):
            ref = device_decode_pair(
                plain, torch.Generator(device=dev).manual_seed(100 + i), src, trg)
            shapes = [(len(src), 64), (len(trg), 64), (len(src), 50),
                      (len(src), 50), (len(trg), 50)]
            ok &= all(g.shape == s and np.isfinite(g).all() for g, s in zip(got, shapes))
            for g, r in zip(got[2:], ref[2:]):
                worst_rl2 = max(worst_rl2, float(np.linalg.norm(g - r) / np.linalg.norm(r)))
                worst_abs = max(worst_abs, float(np.abs(g - r).max()))
        tol = 1e-4 if dt == "float32" else BF16_REL_L2
        ok &= worst_rl2 < tol and (dt != "float32" or worst_abs <= F32_ATOL)
        frames = [s + t for s, t in REQUESTS]
        log(f"[main] {dt}: {len(pairs)} requests, K1 launches {launches[dt]} "
            f"(want {want_launches}); latency ms "
            + ", ".join(f"{m:.1f}" for m in lat_ms[dt])
            + "; frames/s " + ", ".join(f"{f / m * 1e3:.0f}" for f, m in zip(frames, lat_ms[dt]))
            + f"; vs plain path: rel_l2 {worst_rl2:.3e} (< {tol}), max_abs {worst_abs:.3e}")
    log(f"[main] {'ok' if ok else 'FAIL'}")
    return ok, total_launches


def train_batch(rng: np.random.Generator):
    """The bsu-5 batch of synthetic utterances: smooth 54-d trajectories,
    a one-to-one speaker pair, the converted excitation a shifted copy of
    the source's (U/V, log F0 + 0.3, aperiodicities)."""
    from cyclevae_tpu_torch.pipeline.dataset import Utterance, make_batch
    utts = []
    for i, T in enumerate(TRAIN_FLENS):
        f = synth_features(rng, T)
        cv = f[:, :4].copy()
        cv[:, 1] += 0.3
        code = np.zeros((T, 2), np.float32)
        utts.append(Utterance(f"utt{i}", f"utt{i}", f, cv, np.arange(T), code + [1, 0],
                              code + [0, 1], f, np.arange(T), True))
    return make_batch(utts, SEG_LEN, quantum_segs=7), np.concatenate([u.feats for u in utts])


def _draws_classes():
    from cyclevae_tpu_torch.models.gru_vae import Draws

    class Record(Draws):
        """Draws from the generator, keeping every tensor drawn."""

        def __init__(self, generator):
            super().__init__(generator)
            self.seq = []

        def bernoulli(self, keep, shape):
            self.seq.append(super().bernoulli(keep, shape))
            return self.seq[-1]

        def normal(self, shape):
            self.seq.append(super().normal(shape))
            return self.seq[-1]

    class Replay(Draws):
        """A recorded sequence of draws, in order."""

        def __init__(self, seq):
            self.seq = list(seq)

        def _pop(self, shape):
            t = self.seq.pop(0)
            if tuple(t.shape) != tuple(shape):
                raise RuntimeError(f"replayed draw {tuple(t.shape)} where {tuple(shape)} is drawn")
            return t

        def bernoulli(self, keep, shape):
            return self._pop(shape)

        def normal(self, shape):
            return self._pop(shape)

    return Record, Replay


def phase_train(dev):
    """The stage-4 train step, as ``make_train_step`` drives it."""
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar, cuda_gru_ar_bwd, cuda_gru_ar_train
    from cyclevae_tpu_torch.utils.profiling import measure_steps
    from cyclevae_tpu_torch.vi.train import (CycleVAEConfig, TrainState, init_cyclevae,
                                             make_optimizer, make_train_step)

    (batch, meta), real_feats = train_batch(np.random.default_rng(SEED + 2))
    mean, scale = real_feats.mean(axis=0), real_feats.std(axis=0) + 1e-3
    n_segs, real_frames = meta["n_segs"], int(batch["flens"].sum())
    want = 8 * n_segs   # 2 cycles x 4 AR-GRU calls per segment

    def fresh(dt, use_pallas=True):
        cfg = CycleVAEConfig(hidden_units=H, use_pallas=use_pallas, compute_dtype=dt)
        params = init_cyclevae(torch.Generator(device=dev).manual_seed(SEED), cfg, mean, scale,
                               device=dev)
        opt = make_optimizer(cfg, lr=1e-4)
        ts = TrainState(params, opt.init(params), torch.Generator(device=dev).manual_seed(SEED + 3), 0)
        return cfg, ts, make_train_step(cfg, opt, SEG_LEN, n_segs)

    host = lambda m: {k: v.cpu().numpy() for k, v in m.items()}
    runs = {}
    for dt in ("float32", "bfloat16"):
        cfg, ts, step = fresh(dt)
        ts, _ = step(ts, batch)          # warm-up, not counted
        runs[dt] = [ts, step]
        log(f"[train] {dt}: flagship hl{cfg.hidden_layers} hu{cfg.hidden_units} ld{cfg.lat_dim} "
            f"n_cyc{cfg.n_cyc} do_prob{cfg.do_prob}; bsu {len(TRAIN_FLENS)}, bucket "
            f"{batch['feats'].shape[1]} = {n_segs} x {SEG_LEN}, {real_frames} real frames")

    # ---- the main path: counts set to 0 just before, read just after ----
    ok = True
    cuda_gru_ar.launches = cuda_gru_ar_train.launches = cuda_gru_ar_bwd.launches = 0
    for dt, (ts, step) in runs.items():
        mets, per_step = [], []

        def counted(ts_, batch_):
            before = (cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches)
            ts_, m = step(ts_, batch_)
            mets.append(m)
            per_step.append((cuda_gru_ar_train.launches - before[0],
                             cuda_gru_ar_bwd.launches - before[1]))
            return ts_, m

        timed = measure_steps(counted, ts, batch, n_steps=TRAIN_STEPS, warmup=0)
        mets = [host(m) for m in mets]
        secs, med = timed["step_seconds"], timed["median_seconds"]
        finite = all(np.isfinite(m["loss"]).all() for m in mets)
        valid = all((m["seg_valid"] == 1.0).all() for m in mets)
        launches_ok = all(k2 == want and k3 == want for k2, k3 in per_step)
        ok &= finite and valid and launches_ok
        log(f"[train] {dt}: {TRAIN_STEPS} steps (measure_steps, CUDA events), median s/step "
            f"{med:.4f} ({real_frames / med:.0f} real frames/s); s/step "
            + ", ".join(f"{t:.4f}" for t in secs)
            + f"; K2 and K3 launches per step {sorted(set(per_step))} (want {want} each); "
            + "per-segment loss " + ", ".join(f"{v:.2f}" for v in mets[-1]["loss"])
            + f"; finite {finite}, all segments valid {valid}")
    launches = (cuda_gru_ar_train.launches, cuda_gru_ar_bwd.launches)
    k1_in_train = cuda_gru_ar.launches
    ok &= k1_in_train == 0
    log(f"[train] main path: K2 {launches[0]}, K3 {launches[1]}, K1 {k1_in_train} launches")

    # ---- the kernel path against the plain path, the same replayed draws ----
    Record, Replay = _draws_classes()
    _, ts, step = fresh("float32")
    rec = Record(ts.rng)
    losses = {"kernel/float32": host(step(ts, batch, rec)[1])["loss"]}
    _, ts, step = fresh("bfloat16")
    losses["kernel/bfloat16"] = host(step(ts, batch, Replay(rec.seq))[1])["loss"]
    _, ts, step = fresh("float32", use_pallas=False)
    t0 = time.perf_counter()
    ref = host(step(ts, batch, Replay(rec.seq))[1])["loss"]
    plain_s = time.perf_counter() - t0
    rel = {k: np.abs(v - ref) / np.abs(ref) for k, v in losses.items()}
    ok &= bool(rel["kernel/float32"][0] < LOSS_F32_SEG0 and rel["kernel/float32"].max() < LOSS_F32_ALL)
    ok &= bool(rel["kernel/bfloat16"].max() < BF16_REL_L2)
    log(f"[train] vs plain path ({plain_s:.1f} s/step), per-segment relative loss difference: "
        f"f32 max {rel['kernel/float32'].max():.3e} (segment 0 {rel['kernel/float32'][0]:.3e} < "
        f"{LOSS_F32_SEG0}, all < {LOSS_F32_ALL}); bf16 max {rel['kernel/bfloat16'].max():.3e} "
        f"(< {BF16_REL_L2})")
    log(f"[train] {'ok' if ok else 'FAIL'}")
    return ok, launches


def phase_vocode(dev):
    """Neural-vocoder synthesis of converted speech, as
    ``tools/vocode_converted.py`` drives it: with the mu-law WaveRNN (one and
    two speakers) and with the published dual WaveRNN-896 (16-bit audio).
    Returns (ok, mu-law K4 launches, dual launches) of the main path."""
    from cyclevae_tpu_torch.models.wavernn import (mulaw_decode, n_samples_for, pcm16_encode,
                                                   upsample_cond)
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    from cyclevae_tpu_torch.ops.cuda_wavernn import (NEAR_TIE_REL, cuda_wavernn_generate,
                                                     first_divergence,
                                                     wavernn_generate_reference)
    from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair, gv_postfilter
    from cyclevae_tpu_torch.pipeline.features import convert_f0, mod_pow
    from cyclevae_tpu_torch.pipeline.vocoder_stage import (converted_conditioning,
                                                           synthesize_vocoder)
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

    rng = np.random.default_rng(SEED)   # phase 3's requests
    pairs = [(synth_features(rng, s), synth_features(rng, t)) for s, t in REQUESTS]
    allf = np.concatenate([f for p in pairs for f in p])
    mean, scale = allf.mean(axis=0), allf.std(axis=0) + 1e-3
    cfg = CycleVAEConfig(use_pallas=True, compute_dtype="float32")
    codec = Codec(init_cyclevae(torch.Generator(device=dev).manual_seed(SEED), cfg, mean, scale,
                                device=dev), cfg, device=dev)
    vcfg, vparams = _vocoder(dev, SEED + 5)
    vcfg2, vparams2 = _vocoder(dev, SEED + 6, n_spk=2)
    vcfg_d, vparams_d = _vocoder_dual(dev, SEED + 7)
    # GV and log-F0 statistics of the synthetic speakers (the recipe reads
    # them from stage 2's HDF5 stats)
    f0 = lambda f: np.where(f[:, 0] > 0.5, np.exp(f[:, 1]), 0.0)
    lf0 = lambda fs: np.log(np.concatenate([f0(f)[f0(f) > 0] for f in fs]))
    lf0_src, lf0_trg = lf0([s for s, _ in pairs]), lf0([t for _, t in pairs])
    gv_trg = np.mean([np.var(t[:, 5:], axis=0) for _, t in pairs], axis=0)
    warm = converted_conditioning(pairs[0][0][:50], pairs[0][0][:50, 4:], f0(pairs[0][0][:50]),
                                  SHIFT_MS)
    synthesize_vocoder(vparams, vcfg, warm, seed=0, temperature=VOC_TEMPERATURE, device=dev)
    synthesize_vocoder(vparams2, vcfg2, warm, seed=0, temperature=VOC_TEMPERATURE, spk_id=1,
                       device=dev)
    synthesize_vocoder(vparams_d, vcfg_d, warm, seed=0, temperature=VOC_TEMPERATURE, device=dev)

    # ---- the main path: counts set to 0 just before, read just after ----
    cuda_gru_ar.launches = cuda_wavernn_generate.launches = 0
    captures = CAPTURES[0]
    cvmceps = [device_decode_pair(codec, torch.Generator(device=dev).manual_seed(100 + i),
                                  src, trg)[2] for i, (src, trg) in enumerate(pairs)]
    captures = CAPTURES[0] - captures
    cvgv = np.mean([np.var(c[:, 1:], axis=0) for c in cvmceps], axis=0)

    def postprocess(src, cvmcep):
        # the power correction before and after the GV postfilter, each
        # request's natural mel-cepstra as the reference
        # (tools/vocode_converted.py:144-148)
        cvmcep = mod_pow(cvmcep, src[:, 4:], alpha=MCEP_ALPHA, irlen=IRLEN)
        return mod_pow(gv_postfilter(cvmcep, gv_trg, cvgv), src[:, 4:], alpha=MCEP_ALPHA,
                       irlen=IRLEN)

    feats_cv = [converted_conditioning(
        src, postprocess(src, c),
        convert_f0(f0(src), lf0_src.mean(), lf0_src.std(), lf0_trg.mean(), lf0_trg.std()),
        SHIFT_MS) for (src, _), c in zip(pairs, cvmceps)]
    jobs = [(f"req{i}", vparams, vcfg, f, i, None) for i, f in enumerate(feats_cv)]
    jobs.append(("req0/n_spk2", vparams2, vcfg2, feats_cv[0], 0, 1))
    jobs += [(f"req{i}/dual", vparams_d, vcfg_d, f, i, None) for i, f in enumerate(feats_cv)]
    ok, waves, k4, k4_dual = True, {}, 0, 0
    for name, params, vc, feat, seed, spk in jobs:
        before = cuda_wavernn_generate.launches
        t0 = time.perf_counter()
        y = synthesize_vocoder(params, vc, feat, seed=seed, temperature=VOC_TEMPERATURE,
                               spk_id=spk, device=dev)
        sec = time.perf_counter() - t0
        launches = cuda_wavernn_generate.launches - before
        n = n_samples_for(vc, len(feat))
        good = (y.shape == (n,) and bool(np.isfinite(y).all()) and float(np.abs(y).max()) <= 1.0
                and launches == 1 and np.isfinite(feat).all() and len(np.unique(y)) > 1)
        if vc.dual:   # 16-bit: every sample a whole number of 2^-15 in [-1, 1)
            s16 = y.astype(np.float64) * 32768.0
            good &= bool((s16 == np.round(s16)).all() and s16.min() >= -32768 and s16.max() <= 32767)
            k4_dual += launches
        else:
            k4 += launches
        ok &= good
        waves[name] = y
        log(f"[vocode] {name}: {len(feat)} frames -> {n} samples (n_spk {vc.n_spk}, "
            f"{'dual 16-bit' if vc.dual else 'mu-law'}); vocoder "
            f"{sec * 1e3:.1f} ms, {n / sec:.0f} samples/s, real-time factor "
            f"{sec / (n / SAMPLE_RATE):.4f}; K4 launches {launches} (want 1); "
            f"range [{float(y.min()):.5f}, {float(y.max()):.5f}] {'ok' if good else 'FAIL'}")
    k1, n_dual = cuda_gru_ar.launches, sum(vc.dual for _, _, vc, _, _, _ in jobs)
    want_k1 = 2 * (len(pairs) + captures)
    ok &= (k1 == want_k1 and k4 == len(jobs) - n_dual and k4_dual == n_dual
           and cuda_wavernn_generate.launches == len(jobs))
    log(f"[vocode] main path: K1 {k1} (want {want_k1}: 2 a pair, 2 for each of {captures} "
        f"graph capture(s)), K4 {k4} (want "
        f"{len(jobs) - n_dual}), K4 dual {k4_dual} (want {n_dual}) launches")

    # ---- the first T_VOC samples of request 0 against the plain sampler ----
    with torch.inference_mode():
        cond = upsample_cond(vparams, vcfg, torch.as_tensor(feats_cv[0], device=dev)[None])
        want, gap, scale = wavernn_generate_reference(vparams, vcfg, cond[:, :T_VOC], 0,
                                                      VOC_TEMPERATURE, margins=True)
        cond_d = upsample_cond(vparams_d, vcfg_d, torch.as_tensor(feats_cv[0], device=dev)[None])
        want_d, gap_d, scale_d = wavernn_generate_reference(vparams_d, vcfg_d, cond_d[:, :T_VOC],
                                                            0, VOC_TEMPERATURE, margins=True)
    got = torch.as_tensor(waves["req0"][:T_VOC])[None]
    steps, match = first_divergence(got, mulaw_decode(want).cpu(), gap, scale)
    # the dual rendering's 16-bit samples, back to u16 = c * 256 + f (exact)
    got_d = pcm16_encode(torch.as_tensor(waves["req0/dual"][:T_VOC]))[None]
    steps_d, match_d = first_divergence(got_d, want_d, gap_d, scale_d)
    ok &= match and match_d
    for what, st, m in (("mu-law", steps, match), ("dual", steps_d, match_d)):
        log(f"[vocode] req0's first {T_VOC} samples ({what}) against the plain sampler: first "
            f"divergence {'none' if st[0] < 0 else st[0]} (near-tie rule {NEAR_TIE_REL}) "
            f"{'ok' if m else 'FAIL'}")
    log(f"[vocode] {'ok' if ok else 'FAIL'}")
    return ok, k4, k4_dual


def speechlike_wav(f0: float, n: int, seed: int, fs: int = SAMPLE_RATE) -> np.ndarray:
    """n samples of a sawtooth source through two moving formant resonators,
    with breath noise and silence at the edges, in int16 range
    (``cyclevae_tpu_torch.tools.speech_corpus``, whose corpus the tools are
    measured on)."""
    from cyclevae_tpu_torch.tools.speech_corpus import speechlike_wav as make
    return make(f0, n, seed, fs)


def phase_convert_wav(dev):
    """The whole stage-6 conversion, wav in to wavs out: ``analyze_pair``
    (WORLD/SPTK analysis on the host) and ``decode_pair`` (the device call
    through ``Codec``, DTW metrics, ``mod_pow``, the GV postfilter, seven
    WORLD syntheses and an MLSA filtering), as the recipe drives it."""
    from scipy.io import wavfile

    from cyclevae_tpu_torch.dsp import _lib as dsp_lib
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    from cyclevae_tpu_torch.pipeline.decode import (Codec, analyze_pair, decode_pair,
                                                    device_decode_pair)
    from cyclevae_tpu_torch.utils import profiling
    from cyclevae_tpu_torch.utils.config import ExperimentConfig
    from cyclevae_tpu_torch.utils.wavio import write_wav
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

    # host seconds of each stage-6 span recorded in the body of recording()
    stage_s = lambda: {sp.name.split(".")[-1]: sp.seconds for sp in profiling.spans()
                       if sp.name.startswith("stage6.")}
    exp = ExperimentConfig()
    fs, hop = exp.feature.fs, exp.feature.fs * exp.feature.shiftms / 1000.0
    suffixes = ("_noGV", "_noGV_src", "_noGV_trg", "_GV", "_GV_src", "_GV_trg", "_DiffGV",
                "_DiffGVF0")
    ranges = (*WAV_RANGE["src"][:2], *WAV_RANGE["trg"][:2], WAV_RANGE["src"][2],
              WAV_RANGE["trg"][2])
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wav") as tmp:
        # ---- inputs: speech-like wavs from the seed, analysed on the host ----
        jobs = []
        for i, frames in enumerate(WAV_PAIRS):
            paths = []
            for side, T in zip(("src", "trg"), frames):
                path = os.path.join(tmp, f"pair{i}_{side}.wav")
                # T frames of 5 ms: the analysis makes int(n / hop) + 1 frames
                write_wav(path, fs, speechlike_wav(WAV_F0[side] * (1 + 0.05 * i),
                                                   int((T - 1) * hop) + 1, seed=SEED + 20 + 2 * i
                                                   + (side == "trg")))
                paths.append(path)
            with profiling.recording():
                ana = analyze_pair(exp, *paths, *ranges)
            ana_s = stage_s()["analysis"]
            got = (len(ana["src"]["feat"]), len(ana["trg"]["feat"]))
            ok &= got == frames
            jobs.append((f"pair{i}", paths, ana, ana_s))
            log(f"[convert-wav] pair{i}: {frames[0]} + {frames[1]} frames ({got} analysed), "
                f"analysis {ana_s * 1e3:.1f} ms")

        # statistics of the two speakers (the recipe reads them from stage 2's
        # and stage 5's HDF5 statistics, not ported yet): log-F0 mean and std
        # of the analysed wavs; GV from the natural mel-cepstra and from one
        # earlier pass of the device phase over the same pairs
        lf0 = {side: np.log(np.concatenate([a[side]["f0"][a[side]["f0"] > 0]
                                            for _, _, a, _ in jobs])) for side in ("src", "trg")}
        f0stats = {f"lf0_{m}_{side}": float(getattr(v, m)()) for side, v in lf0.items()
                   for m in ("mean", "std")}
        allf = np.concatenate([a[side]["feat"] for _, _, a, _ in jobs for side in ("src", "trg")])
        mean, scale = allf.mean(axis=0), allf.std(axis=0) + 1e-3
        codecs = {}
        for dt in ("float32", "bfloat16"):
            cfg = CycleVAEConfig(use_pallas=True, compute_dtype=dt)
            params = init_cyclevae(torch.Generator(device=dev).manual_seed(SEED), cfg, mean, scale,
                                   device=dev)
            codecs[dt] = (Codec(params, cfg, device=dev),
                          Codec(params, dataclasses.replace(cfg, use_pallas=False), device=dev))
        first = [device_decode_pair(codecs["float32"][0],
                                    torch.Generator(device=dev).manual_seed(300 + i),
                                    a["src"]["feat"], a["trg"]["feat"])
                 for i, (_, _, a, _) in enumerate(jobs)]
        device_decode_pair(codecs["bfloat16"][0], None, jobs[0][2]["src"]["feat"],
                           jobs[0][2]["trg"]["feat"])   # bf16 warm-up
        gvar = lambda mats: np.mean([np.var(m[:, 1:], axis=0) for m in mats], axis=0)
        gv = {"gv_mean_src": gvar([a["src"]["mcep"] for _, _, a, _ in jobs]),
              "gv_mean_trg": gvar([a["trg"]["mcep"] for _, _, a, _ in jobs]),
              "cvgv_mean": gvar([o[2] for o in first]),
              "cvgvsrc_mean": gvar([o[3] for o in first]),
              "cvgvtrg_mean": gvar([o[4] for o in first])}
        runs = [(dt, job) for dt in ("float32",) for job in jobs] + [("bfloat16", jobs[0])]

        def convert(codec, dt, name, paths, ana, seed):
            outdir = os.path.join(tmp, f"{name}_{dt}_{'kernel' if codec.cfg.use_pallas else 'plain'}")
            with profiling.recording():
                metrics = decode_pair(codec, exp, torch.Generator(device=dev).manual_seed(seed),
                                      *paths, outdir, f0stats, gv, *ranges, out_name=name,
                                      analysis=ana)
            timings = stage_s()
            wavs = {}
            for sfx in suffixes:
                rate, y = wavfile.read(os.path.join(outdir, f"{name}{sfx}.wav"))
                wavs[sfx] = (rate, y.astype(np.float64))
            return metrics, wavs, timings

        # ---- the main path: counts set to 0 just before, read just after ----
        results = []
        cuda_gru_ar.launches = 0
        for k, (dt, (name, paths, ana, ana_s)) in enumerate(runs):
            before = cuda_gru_ar.launches
            metrics, wavs, timings = convert(codecs[dt][0], dt, name, paths, ana, 400 + k)
            results.append((dt, name, paths, ana, ana_s, metrics, wavs, timings,
                            cuda_gru_ar.launches - before))
        launches = cuda_gru_ar.launches

        # ---- each request's outputs, and the plain path on the same analyses ----
        lib = dsp_lib.get_lib()
        for k, (dt, name, paths, ana, ana_s, metrics, wavs, timings, n_k1) in enumerate(results):
            T, Tt = len(ana["src"]["feat"]), len(ana["trg"]["feat"])
            n_syn = {sfx: lib.cvdsp_synthesis_length(Tt if sfx.endswith("_trg") else T, fs,
                                                     exp.feature.shiftms) for sfx in suffixes}
            n_syn["_DiffGV"] = len(ana["x"])
            shapes = all(wavs[sfx][0] == fs and wavs[sfx][1].shape == (n_syn[sfx],)
                         and np.isfinite(wavs[sfx][1]).all() and np.abs(wavs[sfx][1]).max() > 0
                         for sfx in suffixes)
            finite = all(np.isfinite(v) for v in metrics.values()) and len(metrics) == 9
            p_metrics, p_wavs, _ = convert(codecs[dt][1], dt, name, paths, ana, 400 + k)
            m_rel = max(abs(metrics[m] - p_metrics[m]) / abs(p_metrics[m]) for m in metrics)
            w_rel = max(float(np.linalg.norm(wavs[s][1] - p_wavs[s][1])
                              / np.linalg.norm(p_wavs[s][1])) for s in suffixes)
            tol = WAV_F32_REL if dt == "float32" else BF16_REL_L2
            good = n_k1 == 2 and shapes and finite and m_rel < tol and w_rel < tol
            ok &= good
            total = ana_s + timings["decode_pair"]
            speech_s = (len(ana["x"])) / fs
            log(f"[convert-wav] {name} {dt}: {T} + {Tt} frames, {speech_s:.3f} s of source speech; "
                f"host ms: analysis {ana_s * 1e3:.1f}, device {timings['device'] * 1e3:.1f}, "
                f"metrics+mod_pow+postfilter {timings['metrics'] * 1e3:.1f}, "
                f"8 syntheses {timings['synthesis'] * 1e3:.1f}, request total {total * 1e3:.1f} "
                f"(x{total / speech_s:.3f} of the speech); K1 launches {n_k1} (want 2); "
                f"8 wavs of the synthesis length {shapes}; metrics "
                + ", ".join(f"{m} {v:.4f}" for m, v in metrics.items())
                + f"; vs plain path: metrics rel {m_rel:.3e}, wav rel_l2 {w_rel:.3e} (< {tol}) "
                f"{'ok' if good else 'FAIL'}")
    ok &= launches == 2 * len(runs)
    log(f"[convert-wav] main path: K1 {launches} launches (want {2 * len(runs)})")
    log(f"[convert-wav] {'ok' if ok else 'FAIL'}")
    return ok, launches


def _max_rel(got: dict, want: dict) -> float:
    """The largest |got - want| / |want| over every value of every key."""
    return max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))
                            / np.abs(np.asarray(want[k])))) for k in want)


def timed_steps(make_train_step, into: list):
    """``make_train_step`` whose steps append (host seconds, real frames,
    valid segments) to ``into``, each step ended by a synchronize."""
    def make(cfg_, opt, seg_len, n_segs):
        step = make_train_step(cfg_, opt, seg_len, n_segs)

        def timed(ts, batch, *a):
            t0 = time.perf_counter()
            out = step(ts, batch, *a)
            torch.cuda.synchronize()
            flens = np.asarray(batch["flens"])
            valid = sum(bool(np.any(flens > s * seg_len)) for s in range(n_segs))
            into.append((time.perf_counter() - t0, int(flens.sum()), valid))
            return out
        return timed
    return make


def _plain_work(paths, work: str, expname: str):
    """A second work directory for a rerun on the plain path: the features
    of ``paths`` linked, its statistics copied (a rerun rewrites them), an
    empty ``exp/<expname>``."""
    import shutil

    from cyclevae_tpu_torch.pipeline.recipe import RecipePaths
    os.makedirs(os.path.join(work, "exp", expname))
    os.symlink(os.path.join(paths.work, "hdf5"), os.path.join(work, "hdf5"))
    shutil.copytree(os.path.join(paths.work, "stats"), os.path.join(work, "stats"))
    return RecipePaths(wav_root=paths.wav_root, work=work, n_train=paths.n_train)


def phase_recipe(dev, tmp: str):
    """The one-to-one recipe, wav corpus to trained model to converted wavs,
    through ``run_stages`` as ``python -m cyclevae_tpu_torch --stage
    1a23456`` drives it, one stage at a time so that each stage's launches
    are read around it.  The corpus and the work directory are made in
    ``tmp``; phase 9 goes on from them."""
    from cyclevae_tpu_torch.dsp import _lib as dsp_lib
    from cyclevae_tpu_torch.models import gru_vae, wavernn
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar, cuda_gru_ar_bwd, cuda_gru_ar_train
    from cyclevae_tpu_torch.ops.cuda_wavernn import cuda_wavernn_generate
    from cyclevae_tpu_torch.pipeline import decode, infer_stage, recipe, train_stage, vocoder_stage
    from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
    from cyclevae_tpu_torch.utils.store import read_store
    from cyclevae_tpu_torch.utils.wavio import write_wav

    def experiment(**model):
        return ExperimentConfig(model=ModelConfig(spk_src="SPKA", spk_trg="SPKB", **model),
                                train=TrainConfig(epoch_count=RECIPE_EPOCHS))

    exp = experiment()
    fs = exp.feature.fs
    src, trg = RECIPE_SPEAKERS
    cfg = train_stage.model_config(exp)
    log(f"[recipe] flagship hl{cfg.hidden_layers} hu{cfg.hidden_units} ld{cfg.lat_dim} "
        f"n_cyc{cfg.n_cyc} {cfg.compute_dtype} use_pallas {cfg.use_pallas}; bsu "
        f"{exp.train.batch_size_utt}, {exp.train.epoch_count} epochs, n_train {RECIPE_N_TRAIN}")

    # instruments, removed in the finally below: calls of the plain scan and
    # of the WaveRNN's two teacher-forced routes, the time and real frames of
    # each train step, the time of each stage-6 request's analysis and
    # conversion, of each stage-i utterance and each stage-v synthesis
    scans, steps, analyses, requests = [0], [], [], []
    tf_calls, posteriors, syntheses = {"plain": 0, "cudnn": 0}, [], []
    orig = {"scan": gru_vae.gru_ar_scan, "step": train_stage.make_train_step,
            "analyze": decode.analyze_pair, "decode": decode.decode_pair,
            "plain_tf": wavernn.plain_recurrence, "cudnn_tf": wavernn.cudnn_recurrence,
            "posterior": infer_stage.posterior_convert_hmc,
            "synth": vocoder_stage.synthesize_vocoder}

    def counted_scan(*a, **k):
        scans[0] += 1
        return orig["scan"](*a, **k)

    def counted(name, fn):
        def call(*a, **k):
            tf_calls[name] += 1
            return fn(*a, **k)
        return call

    def timed_call(fn, into):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append(time.perf_counter() - t0)
            return out
        return timed

    ok = True
    totals = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    # ---- the corpus, made from the seed ----
    wav_root, conf = os.path.join(tmp, "wav"), os.path.join(tmp, "conf")
    for k, (spk, f0) in enumerate(RECIPE_SPEAKERS.items()):
        side = ("src", "trg")[k]
        for d in (os.path.join(wav_root, spk), os.path.join(wav_root, "eval", spk), conf):
            os.makedirs(d, exist_ok=True)
        for i, sec in enumerate(RECIPE_SECONDS):
            write_wav(os.path.join(wav_root, spk, f"utt{i}.wav"), fs,
                      speechlike_wav(f0 * (1 + 0.03 * i), int(sec * fs), seed=SEED + 40 + i))
        write_wav(os.path.join(wav_root, "eval", spk, "e0.wav"), fs,
                  speechlike_wav(f0 * 1.02, int(RECIPE_EVAL_SECONDS * fs), seed=SEED + 60))
        minf0, maxf0, pw = WAV_RANGE[side]
        with open(os.path.join(conf, f"{spk}.f0"), "w") as f:
            f.write(f"{minf0} {maxf0}")
        with open(os.path.join(conf, f"{spk}.pow"), "w") as f:
            f.write(f"{pw}")
    paths = recipe.RecipePaths(wav_root=wav_root, work=os.path.join(tmp, "work"),
                               n_train=RECIPE_N_TRAIN)
    expdir = os.path.join(paths.work, "exp", exp.name())

    # ---- the main path: counts set to 0 just before each stage, read just after ----
    gru_vae.gru_ar_scan = counted_scan
    train_stage.make_train_step = timed_steps(orig["step"], steps)
    decode.analyze_pair = timed_call(orig["analyze"], analyses)
    decode.decode_pair = timed_call(orig["decode"], requests)
    wavernn.plain_recurrence = counted("plain", orig["plain_tf"])
    wavernn.cudnn_recurrence = counted("cudnn", orig["cudnn_tf"])
    infer_stage.posterior_convert_hmc = timed_call(orig["posterior"], posteriors)
    vocoder_stage.synthesize_vocoder = timed_call(orig["synth"], syntheses)
    stage_runs = {}
    try:
        for stage in RECIPE_STAGES:
            cuda_gru_ar.launches = cuda_gru_ar_train.launches = cuda_gru_ar_bwd.launches = 0
            cuda_wavernn_generate.launches = 0
            scans[0] = tf_calls["plain"] = tf_calls["cudnn"] = 0
            captures = CAPTURES[0]
            t0 = time.perf_counter()
            recipe.run_stages(stage, exp, paths, conf_dir=conf, n_jobs=8, device=dev,
                              vocoder_epochs=RECIPE_VOC_EPOCHS,
                              vocoder_hidden_units=RECIPE_VOC_HU,
                              vocoder_clip_frames=RECIPE_VOC_CLIP)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            stage_runs[stage] = dict(sec=sec, K1=cuda_gru_ar.launches,
                                     K2=cuda_gru_ar_train.launches,
                                     K3=cuda_gru_ar_bwd.launches,
                                     K4=cuda_wavernn_generate.launches, scan=scans[0],
                                     tf_plain=tf_calls["plain"], tf_cudnn=tf_calls["cudnn"],
                                     captures=CAPTURES[0] - captures)
            for k in totals:
                totals[k] += stage_runs[stage][k]
            log(f"[recipe] stage {stage}: {sec:.2f} s host; launches K1 "
                f"{cuda_gru_ar.launches}, K2 {cuda_gru_ar_train.launches}, K3 "
                f"{cuda_gru_ar_bwd.launches}, K4 {cuda_wavernn_generate.launches}; plain "
                f"scan calls {scans[0]}; teacher-forced WaveRNN calls: cuDNN "
                f"{tf_calls['cudnn']}, plain loop {tf_calls['plain']}; conversion graphs "
                f"captured {stage_runs[stage]['captures']}")
    finally:
        gru_vae.gru_ar_scan = orig["scan"]
        train_stage.make_train_step = orig["step"]
        decode.analyze_pair = orig["analyze"]
        decode.decode_pair = orig["decode"]
        wavernn.plain_recurrence = orig["plain_tf"]
        wavernn.cudnn_recurrence = orig["cudnn_tf"]
        infer_stage.posterior_convert_hmc = orig["posterior"]
        vocoder_stage.synthesize_vocoder = orig["synth"]

    # ---- stage 4's steps and stage 6's request ----
    secs = [t for t, _, _ in steps]
    log(f"[recipe] stage 4: {len(steps)} train steps, s/step "
        + ", ".join(f"{t:.4f}" for t in secs) + "; real frames/s "
        + ", ".join(f"{n / t:.0f}" for t, n, _ in steps)
        + f" (median {np.median(secs):.4f} s/step); valid segments per step "
        + ", ".join(str(v) for _, _, v in steps))
    eval_wavs = {spk: paths.wavs(spk, eval_set=True) for spk in RECIPE_SPEAKERS}
    speech_s = sum(len(_read_wav_samples(w)) for w in eval_wavs[src]) / fs
    request_s = sum(analyses) + sum(requests)
    log(f"[recipe] stage 6: {len(requests)} request(s), analysis "
        + ", ".join(f"{t * 1e3:.1f}" for t in analyses) + " ms, conversion "
        + ", ".join(f"{t * 1e3:.1f}" for t in requests)
        + f" ms; {speech_s:.3f} s of source speech, real-time factor "
        f"{request_s / speech_s:.3f} (stage {stage_runs['6']['sec'] / speech_s:.3f})")
    hmc_cfg, n_pred = (inspect.signature(orig["posterior"]).parameters[k].default
                       for k in ("hmc", "n_predictive"))
    n_post = len(eval_wavs[src][:4])
    hmc_steps = hmc_cfg.n_warmup + hmc_cfg.n_samples
    grads = stage_runs["i"]["K3"]
    log(f"[recipe] stage i: {n_post} utterance(s) of HMC ({hmc_steps} steps of "
        f"{hmc_cfg.n_leapfrog} leapfrogs, 8 chains), s per utterance "
        + ", ".join(f"{t:.2f}" for t in posteriors)
        + f"; {grads} gradient evaluations, {grads / max(sum(posteriors), 1e-9):.1f} per s; "
        f"{sum(posteriors) / max(n_post * hmc_steps, 1) * 1e3:.1f} ms per HMC step")
    vexpdir = os.path.join(paths.work, "exp", f"vocoder_{trg}_hu{RECIPE_VOC_HU}")
    with open(os.path.join(vexpdir, "history.json")) as f:
        voc_hist = json.load(f)["history"]
    voc_train = paths.wavs(trg)[:RECIPE_N_TRAIN]
    voc_steps = -(-len(voc_train) // 8)         # run_train_vocoder's batch of 8
    voc_samples = 8 * vocoder_stage.n_samples_for(wavernn.WaveRNNConfig(), RECIPE_VOC_CLIP)
    voc_step_s = [h["sec"] / voc_steps for h in voc_hist]
    trg_speech_s = sum(len(_read_wav_samples(w)) for w in eval_wavs[trg][:5]) / fs
    log(f"[recipe] stage v: {len(voc_hist)} epochs of {voc_steps} train step(s) (batch 8 "
        f"x {RECIPE_VOC_CLIP} frames, {voc_samples} samples), s per step "
        + ", ".join(f"{t:.3f}" for t in voc_step_s) + ", samples/s "
        + ", ".join(f"{voc_samples / t:.0f}" for t in voc_step_s)
        + "; copy synthesis " + ", ".join(f"{t:.3f}" for t in syntheses)
        + f" s for {trg_speech_s:.3f} s of speech (real-time factor "
        f"{sum(syntheses) / trg_speech_s:.3f})")

    # ---- every stage's artifacts ----
    wavs = [w for spk in RECIPE_SPEAKERS for e in (False, True) for w in paths.wavs(spk, e)]
    feats = [f for spk in RECIPE_SPEAKERS for e in (False, True) for f in paths.h5s(spk, e)]
    art = {"features": len(feats) == len(wavs) == 2 * (RECIPE_UTTS + 1)
           and all(read_store(f, "/cvuvlogf0fil_ap").shape[1] == 4 for f in feats)}
    art["spk_stat"] = all(os.path.getsize(os.path.join(paths.work, "init_spk_stat",
                                                       f"{spk}.{x}.txt")) > 0
                          for spk in RECIPE_SPEAKERS for x in ("f0", "pow"))
    art["stats"] = all(os.path.exists(p) for p in (paths.stats(src), paths.stats(trg),
                                                   paths.stats_jnt()))
    with open(os.path.join(expdir, "history.json")) as f:
        hist = json.load(f)
    best = hist["best"]["epoch"]
    art["history"] = best in (1, 2) and len(hist["history"]) == RECIPE_EPOCHS
    art["checkpoints"] = all(os.path.exists(os.path.join(expdir, f"checkpoint-{n}.pkl"))
                             for n in ("1", "2", "latest", "final"))
    model_id = f"{exp.name()}_ep{best}"
    cvgv = {f"{k}_{m}": read_store(paths.stats(src), f"/{k}_{m}_{model_id}")
            for k in ("cvgv", "cvgvsrc", "cvgvtrg") for m in ("mean", "var")}
    art["cvgv"] = all(v.shape == (cfg.out_dim - 1,) and np.isfinite(v).all()
                      for v in cvgv.values())
    with open(os.path.join(expdir, f"decode_metrics_ep{best}.json")) as f:
        dm = json.load(f)
    art["decode_metrics"] = len(dm) == 18 and all(np.isfinite(v) for v in dm.values())
    lib = dsp_lib.get_lib()
    T, Tt = (len(read_store(paths.h5s(spk, True)[0], "/feat_org_lf0"))
             for spk in (src, trg))
    out_wavs = {}
    outdir = os.path.join(expdir, f"wav_cv_ep{best}")
    for name in sorted(os.listdir(outdir)):
        out_wavs[name] = _read_wav_samples(os.path.join(outdir, name))
    want_len = {f"e0{sfx}.wav": lib.cvdsp_synthesis_length(
        Tt if sfx.endswith("_trg") else T, fs, exp.feature.shiftms)
        for sfx in ("_noGV", "_noGV_src", "_noGV_trg", "_GV", "_GV_src", "_GV_trg",
                    "_DiffGVF0")}
    want_len["e0_DiffGV.wav"] = len(_read_wav_samples(eval_wavs[src][0]))
    art["wavs"] = sorted(out_wavs) == sorted(want_len) and all(
        len(y) == want_len[n] and np.abs(y).max() > 0 for n, y in out_wavs.items())
    post = os.path.join(expdir, f"posterior_ep{best}.npz")
    post_frames = {os.path.basename(f)[:-4]: len(read_store(f, "/feat_org_lf0"))
                   for f in paths.h5s(src, True)[:4]}
    art["posterior"] = all(
        read_store(post, f"/{b}/{k}").shape == (n, dim)
        and np.isfinite(read_store(post, f"/{b}/{k}")).all()
        for b, n in post_frames.items()
        for k, dim in (("z_mean", cfg.lat_dim), ("z_std", cfg.lat_dim),
                       ("cv_mcep_mean", cfg.out_dim), ("cv_mcep_std", cfg.out_dim)))
    with open(os.path.join(vexpdir, "vocoder_eval.json")) as f:
        voc_eval = json.load(f)
    cs = voc_eval["copy_synthesis"]
    art["vocoder"] = (
        [h["epoch"] for h in voc_hist] == list(range(1, RECIPE_VOC_EPOCHS + 1))
        and all(np.isfinite(h["nll"]) for h in voc_hist)
        and voc_eval["final_nll"] == voc_hist[-1]["nll"]
        and all(os.path.exists(os.path.join(vexpdir, f"checkpoint-{n}.pkl"))
                for n in ("latest", str(RECIPE_VOC_EPOCHS)))
        and len(cs) == 8 and np.isfinite(cs["mcd"]) and 0 <= cs["uv_agree"] <= 1
        and all(len(_read_wav_samples(os.path.join(vexpdir, "wav_vocoded",
                                                   os.path.basename(w)))) > 0
                for w in eval_wavs[trg][:5]))
    ok &= all(art.values())
    log("[recipe] artifacts: " + ", ".join(f"{k} {v}" for k, v in art.items())
        + f"; best epoch {best} (criterion {hist['best']['criterion']:.4f}); decode "
        + ", ".join(f"{k} {dm[k]:.4f}" for k in ("mcdpow_cv", "mcd_cv", "mcd_cvgv", "lat_rmse"))
        + f"; vocoder nll {voc_hist[0]['nll']:.4f} -> {voc_hist[-1]['nll']:.4f}, copy "
        + ", ".join(f"{k} {cs[k]:.4f}" for k in ("mcdpow", "mcd", "f0_rel_err_median",
                                                 "uv_agree")))

    # ---- the launches of each stage ----
    r = stage_runs
    # 4 AR-GRU calls per cycle: K2 and K3 per valid segment of a train
    # step, K1 per eval batch (one source and one target batch an epoch);
    # stage 5: 2 K1 launches per training utterance; stage 6: 2 per pair;
    # any stage 2 more for each conversion graph it captures (CAPTURES);
    # stage i per utterance 1 + L x HMC steps K2 and as many K3 (the start's
    # evaluation, then one a leapfrog), and one K1 for the posterior
    # predictive; stage v one K4 per eval utterance,
    # one cuDNN teacher-forced call per train step, no plain loop
    want = {st: dict(K1=0, K2=0, K3=0, K4=0, scan=0, tf_plain=0, tf_cudnn=0)
            for st in RECIPE_STAGES}
    want_k2 = 4 * cfg.n_cyc * sum(v for _, _, v in steps)
    want["4"].update(K1=RECIPE_EPOCHS * 2 * 4 * cfg.n_cyc, K2=want_k2, K3=want_k2)
    want["5"]["K1"] = 2 * 2 * RECIPE_N_TRAIN
    want["6"]["K1"] = 2 * len(eval_wavs[src])
    hmc_evals = n_post * (1 + hmc_steps * hmc_cfg.n_leapfrog)
    want["i"].update(K1=n_post, K2=hmc_evals, K3=hmc_evals)
    want["v"].update(K4=len(eval_wavs[trg][:5]), tf_cudnn=RECIPE_VOC_EPOCHS * voc_steps)
    for st in RECIPE_STAGES:
        want[st]["K1"] += 2 * r[st]["captures"]
    launches_ok = want_k2 > 0 and all(r[st][k] == v for st, w in want.items()
                                      for k, v in w.items())
    ok &= launches_ok
    for st in RECIPE_STAGES:
        if any(want[st].values()) or any(r[st][k] for k in want[st]):
            log(f"[recipe] launches stage {st}: "
                + ", ".join(f"{k} {r[st][k]} (want {v})" for k, v in want[st].items()))
    log(f"[recipe] launches and calls of every stage as wanted "
        f"{'ok' if launches_ok else 'FAIL'}")

    # ---- the plain path from the same seeds: epoch 1 of stage 4, then stage 5 ----
    def plain_work(name):
        return _plain_work(paths, os.path.join(tmp, name), exp.name())

    plain_exp = experiment(use_pallas=False)
    plain_exp.train.epoch_count = 1
    p4 = plain_work("plain4")
    t0 = time.perf_counter()
    recipe.run_stages("4", plain_exp, p4, conf_dir=conf, n_jobs=8, device=dev)
    plain4_s = time.perf_counter() - t0
    with open(os.path.join(p4.work, "exp", exp.name(), "history.json")) as f:
        plain_train = json.load(f)["history"][0]["train"]
    train_rel = _max_rel(hist["history"][0]["train"], plain_train)
    p5 = plain_work("plain5")
    for name in ("history.json", f"checkpoint-{best}.pkl"):
        os.symlink(os.path.join(expdir, name), os.path.join(p5.work, "exp", exp.name(), name))
    t0 = time.perf_counter()
    recipe.run_stages("5", plain_exp, p5, conf_dir=conf, n_jobs=8, device=dev)
    plain5_s = time.perf_counter() - t0
    plain_cvgv = {k: read_store(p5.stats(src), f"/{k}_{model_id}") for k in cvgv}
    cvgv_rel = _max_rel(cvgv, plain_cvgv)
    plain_ok = train_rel < RECIPE_TRAIN_REL and cvgv_rel < RECIPE_CVGV_REL
    ok &= plain_ok
    log(f"[recipe] vs plain path: epoch-1 train metrics max rel {train_rel:.3e} (< "
        f"{RECIPE_TRAIN_REL}; stage 4 plain, 1 epoch: {plain4_s:.1f} s); cvgv statistics max "
        f"rel {cvgv_rel:.3e} (< {RECIPE_CVGV_REL}; stage 5 plain: {plain5_s:.1f} s) "
        f"{'ok' if plain_ok else 'FAIL'}")
    ok &= _teacher_forced_check(dev, os.path.join(vexpdir, "checkpoint-latest.pkl"),
                                voc_train, paths.h5s(trg)[:RECIPE_N_TRAIN])
    log(f"[recipe] {'ok' if ok else 'FAIL'}")
    return ok, totals


def _teacher_forced_check(dev, ckpt_path: str, wavs, feats) -> bool:
    """The teacher-forced WaveRNN loss and its gradient on one batch of the
    recipe's clips (batch 8 x RECIPE_VOC_CLIP frames) with stage v's weights:
    cuDNN's GRU (the route on the card) against the plain loop on the card."""
    from cyclevae_tpu_torch.models import wavernn
    from cyclevae_tpu_torch.pipeline.dataset_mult import NeuVocoDataset
    from cyclevae_tpu_torch.pipeline.vocoder_stage import sample_clips
    from cyclevae_tpu_torch.vi.checkpoint import load_checkpoint

    cfg = wavernn.WaveRNNConfig(hidden_units=RECIPE_VOC_HU)
    saved = load_checkpoint(ckpt_path)["params"]
    ds = NeuVocoDataset(wavs, feats, cfg.hop)
    f, w = sample_clips(ds, np.arange(8) % len(ds), RECIPE_VOC_CLIP, cfg,
                        np.random.default_rng(SEED))
    f, w = f.to(dev), w.to(dev)

    def run():
        params = {k: ({kk: torch.as_tensor(vv, device=dev).requires_grad_()
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else torch.as_tensor(v, device=dev).requires_grad_())
                  for k, v in saved.items()}
        leaves = list(_leaves(params))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with wavernn.full_f32_cudnn():
            loss = wavernn.wavernn_loss(params, cfg, f, w)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return float(loss.detach()), grads, time.perf_counter() - t0

    loss_c, g_c, sec_c = run()
    cudnn = wavernn.cudnn_recurrence
    wavernn.cudnn_recurrence = wavernn.plain_recurrence
    try:
        loss_p, g_p, sec_p = run()
    finally:
        wavernn.cudnn_recurrence = cudnn
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_c, g_p))
    good = loss_rel < TF_LOSS_REL and grad_err <= GRAD_SCALE_TOL
    log(f"[recipe] teacher-forced WaveRNN, batch 8 x {w.shape[1]} samples: cuDNN loss "
        f"{loss_c:.6f} in {sec_c:.3f} s, plain loop {loss_p:.6f} in {sec_p:.3f} s (forward and "
        f"gradient); loss rel {loss_rel:.3e} (< {TF_LOSS_REL}), gradients max err / scale "
        f"{grad_err:.3e} (<= {GRAD_SCALE_TOL}) {'ok' if good else 'FAIL'}")
    return good


def recorded_draws(generator: torch.Generator):
    """A ``Draws`` whose numbers come from ``generator`` on the first pass
    and are replayed on the next (after ``.replay()``), so that the kernel
    route and the plain path see the same momenta and uniforms."""
    from cyclevae_tpu_torch.infer import Draws

    class Recorded(Draws):
        def __init__(self, gen):
            super().__init__(gen)
            self.tape, self.at = [], None

        def replay(self):
            self.at = 0

        def _draw(self, fresh, shape):
            if self.at is None:
                self.tape.append(fresh(shape))
                return self.tape[-1]
            self.at += 1
            return self.tape[self.at - 1]

        def normal(self, shape):
            return self._draw(super().normal, shape)

        def uniform(self, shape):
            return self._draw(super().uniform, shape)

    return Recorded(generator)


def phase_infer(dev):
    """Posterior inference at full width (stage i's samplers on the flagship
    hu1024 CycleVAE, random weights from the seed, on an eval-length
    utterance): the log-joint's value and gradient and 3 HMC steps, kernel
    route against the plain path; short NUTS, batched NUTS and SMC runs; K2
    and K3 at the chain counts and K1 at the predictive's, timed beside their
    bounds; the largest chain count one K1, K2 and K3 launch takes."""
    from cyclevae_tpu_torch.infer import (Draws, HMCConfig, NUTSConfig, hmc_sample_batch,
                                          make_utterance_logjoint_batched, nuts_sample,
                                          nuts_sample_batch)
    from cyclevae_tpu_torch.infer.logjoint import value_and_grad
    from cyclevae_tpu_torch.ops.cuda_gru import (cuda_gru_ar, cuda_gru_ar_bwd,
                                                 cuda_gru_ar_train, gru_ar_bwd_reference,
                                                 gru_ar_reference, gru_ar_train_reference,
                                                 max_batch)
    from cyclevae_tpu_torch.ops.gru_scan import precompute_input_gates
    from cyclevae_tpu_torch.pipeline.infer_stage import posterior_marginal_smc
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae

    def counts():
        return {"K1": cuda_gru_ar.launches, "K2": cuda_gru_ar_train.launches,
                "K3": cuda_gru_ar_bwd.launches}

    def zero():
        cuda_gru_ar.launches = cuda_gru_ar_train.launches = cuda_gru_ar_bwd.launches = 0

    ok, results = True, {}
    rng = np.random.default_rng(SEED + 80)
    stats = synth_features(rng, 4000)
    mean, scale = stats.mean(axis=0), stats.std(axis=0) + 1e-3
    cfg = CycleVAEConfig(hidden_units=H)
    params = init_cyclevae(torch.Generator(device=dev).manual_seed(SEED + 80), cfg, mean, scale,
                           device=dev)
    feats = torch.as_tensor(synth_features(rng, T_INFER), device=dev)
    code = torch.zeros((T_INFER, cfg.n_spk), device=dev)
    code[:, 0] = 1.0
    log(f"[infer] flagship hl{cfg.hidden_layers} hu{cfg.hidden_units} ld{cfg.lat_dim}, an "
        f"utterance of {T_INFER} frames, obs_scale {INFER_OBS_SCALE}")

    def logjoint(**kw):
        return make_utterance_logjoint_batched(params, dataclasses.replace(cfg, **kw), feats,
                                               code, obs_scale=INFER_OBS_SCALE)

    # ---- the log-joint's value and gradient, kernel route against the plain path ----
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    for C in INFER_CHAINS:
        z = 0.5 * torch.randn((C, T_INFER, cfg.lat_dim), generator=gen, device=dev)
        for dt in ("float32", "bfloat16"):
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v_k, g_k = value_and_grad(logjoint(compute_dtype=dt), z)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            n = counts()
            v_p, g_p = value_and_grad(logjoint(compute_dtype=dt, use_pallas=False), z)
            val_rel = float(((v_k - v_p).abs() / v_p.abs()).max())
            grad_err = float((g_k - g_p).abs().max() / g_p.abs().max())
            rl2, cos = rel_l2(g_k, g_p), cosine(g_k, g_p)
            finite = bool(torch.isfinite(v_k).all() and torch.isfinite(g_k).all())
            good = finite and n == {"K1": 0, "K2": 1, "K3": 1} and (
                val_rel < LOGJOINT_F32_REL and grad_err <= GRAD_SCALE_TOL if dt == "float32"
                else val_rel < BF16_REL_L2 and rl2 < BF16_REL_L2 and cos > BF16_COS)
            ok &= good
            log(f"[infer] log-joint C={C} {dt}: value {float(v_k[0]):.3f} in {sec * 1e3:.1f} ms "
                f"with its gradient (K2 {n['K2']}, K3 {n['K3']}); vs plain path: value rel "
                f"{val_rel:.3e}, gradient max err / scale {grad_err:.3e}, rel_l2 {rl2:.3e}, cos "
                f"{cos:.6f} {'ok' if good else 'FAIL'}")

    # ---- 3 HMC steps on replayed draws, kernel route against the plain path ----
    # one warmup step from a small step size (dual averaging then moves it
    # ~15x, to the stage's scale), two sampling steps
    hcfg = HMCConfig(step_size=0.002, n_leapfrog=4, n_warmup=1, n_samples=2, adapt_mass=False)
    C = INFER_CHAINS[0]
    z0 = torch.zeros((C, T_INFER, cfg.lat_dim), device=dev)
    draws = recorded_draws(torch.Generator(device=dev).manual_seed(SEED + 82))
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_k, info_k = hmc_sample_batch(draws, logjoint(), z0, hcfg)
    torch.cuda.synchronize()
    sec_k = time.perf_counter() - t0
    n = counts()
    draws.replay()
    t0 = time.perf_counter()
    s_p, info_p = hmc_sample_batch(draws, logjoint(use_pallas=False), z0, hcfg)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    moved = lambda s_: (torch.diff(torch.cat([z0[None], s_]), dim=0).abs().amax(dim=(2, 3)) > 0)
    acc_k, acc_p = moved(s_k), moved(s_p)
    z_rel = rel_l2(s_k, s_p)
    steps = 1 + hcfg.n_samples
    evals = 1 + steps * hcfg.n_leapfrog
    want_n = {"K1": 0, "K2": evals, "K3": evals}
    good = bool(torch.equal(acc_k, acc_p)) and z_rel < HMC_Z_REL and n == want_n
    ok &= good
    log(f"[infer] HMC C={C}, {steps} steps of {hcfg.n_leapfrog} leapfrogs: kernel route "
        f"{sec_k:.3f} s (K2 {n['K2']}, K3 {n['K3']}; want {want_n['K2']}, {want_n['K3']}), plain "
        f"path {sec_p:.3f} s; accepts {acc_k.int().tolist()} vs {acc_p.int().tolist()}, z rel_l2 "
        f"{z_rel:.3e} (< {HMC_Z_REL}), accept prob {float(info_k['accept_prob']):.4f} vs "
        f"{float(info_p['accept_prob']):.4f} {'ok' if good else 'FAIL'}")

    # ---- short NUTS runs (kernel route), SMC ----
    ncfg = NUTSConfig(step_size=0.02, max_depth=3, n_warmup=2, n_samples=2)
    lj = logjoint()
    for name, run in (("NUTS C=1", lambda d: nuts_sample(d, lambda z: lj(z[None])[0], z0[0],
                                                           ncfg)),
                      (f"batched NUTS C={C}", lambda d: nuts_sample_batch(d, lj, z0, ncfg))):
        zero()
        t0 = time.perf_counter()
        s_n, info_n = run(Draws(torch.Generator(device=dev).manual_seed(SEED + 83)))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = counts()
        good = bool(torch.isfinite(s_n).all()) and n["K2"] == n["K3"] > 0
        ok &= good
        log(f"[infer] {name}: {ncfg.n_warmup} + {ncfg.n_samples} transitions (max depth "
            f"{ncfg.max_depth}) in {sec:.3f} s, K2 {n['K2']}, K3 {n['K3']} (one value and "
            f"gradient a leaf), mean leapfrogs {float(info_n['mean_leapfrog']):.2f}, accept stat "
            f"{float(info_n['accept_stat']):.4f}, samples finite {'ok' if good else 'FAIL'}")
    zero()
    t0 = time.perf_counter()
    smc = posterior_marginal_smc(params, cfg, feats.cpu().numpy(), 0,
                                 Draws(torch.Generator(device=dev).manual_seed(SEED + 84)),
                                 n_particles=SMC_PARTICLES, obs_scale=INFER_OBS_SCALE)
    sec = time.perf_counter() - t0
    n = counts()
    good = (np.isfinite(smc["log_marginal"]) and 0 < smc["mean_ess"] <= SMC_PARTICLES
            and n == {"K1": 0, "K2": 0, "K3": 0})
    ok &= good
    log(f"[infer] SMC, {SMC_PARTICLES} particles over {T_INFER} frames: {sec:.3f} s, log "
        f"marginal {smc['log_marginal']:.2f}, mean ESS {smc['mean_ess']:.1f}, resample rate "
        f"{smc['resample_rate']:.3f}; no kernel (launches {n}) {'ok' if good else 'FAIL'}")

    # ---- K2 and K3 at the chain counts, K1 at the predictive's, timed ----
    layer, proj = params.decoder["gru"][0], params.decoder["out"]
    out, conv_dim = cfg.out_dim, cfg.dec_cfg.conv_dim
    wdt = torch.float32
    for kname, B in (("gru_ar_train", 8), ("gru_ar_train", 1), ("gru_ar_bwd", 8),
                     ("gru_ar_bwd", 1), ("gru_ar", 16)):
        gx = precompute_input_gates(layer, torch.randn((B, T_INFER, conv_dim), generator=gen,
                                                       device=dev))
        y0 = 0.5 * torch.randn((B, out), generator=gen, device=dev)
        h0 = torch.zeros((B, H), device=dev)
        mask = torch.ones((B, T_INFER, H), device=dev)
        if kname == "gru_ar":
            args = (layer, proj, gx, y0, h0, wdt)
            fn, ref, tol = cuda_gru_ar, gru_ar_reference, F32_ATOL
            bound_ms, bound_by = gru_ar_bound_ms(B, T_INFER, out, wdt)
        elif kname == "gru_ar_train":
            args = (layer, proj, gx, y0, h0, mask, wdt)
            fn, ref, tol = cuda_gru_ar_train, gru_ar_train_reference, F32_ATOL
            bound_ms, bound_by = gru_ar_train_bound_ms(B, T_INFER, out, wdt)
        else:
            trj, _, _, h_seq = gru_ar_train_reference(layer, proj, gx, y0, h0, mask, wdt)
            args = (proj["w"], layer["w_hh"], layer["w_ih"][:, conv_dim:], layer["b_hh"],
                    torch.randn((B, T_INFER, out), generator=gen, device=dev), gx,
                    torch.cat([y0[:, None], trj[:, :-1]], dim=1),
                    torch.cat([h0[:, None], h_seq[:, :-1]], dim=1), mask,
                    torch.zeros((B, H), device=dev), torch.zeros((B, out), device=dev))
            fn, ref, tol = cuda_gru_ar_bwd, gru_ar_bwd_reference, GRAD_SCALE_TOL
            bound_ms, bound_by = gru_ar_bwd_bound_ms(B, T_INFER, out, wdt)
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        err, rl2, cos, good = _match(got, want, wdt, tol)
        ms = cuda_ms(lambda: fn(*args), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: ref(*args), iters=1, warmup=0)
        key = f"{kname}/B{B}/T{T_INFER}/float32"
        results[key] = dict(B=B, T=T_INFER, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, ok=good)
        ok &= good
        log(f"[infer] {key}: max_abs={err:.3e} kernel={ms:.3f} ms ({ms * 1e3 / T_INFER:.2f} "
            f"us/step) plain={plain_ms:.1f} ms bound={bound_ms:.4f} ms ({bound_by}) "
            f"{'ok' if good else 'FAIL'}")

    # ---- the largest chain count one K1, K2 and K3 launch takes at H=1024 ----
    for wdt in (torch.float32, torch.bfloat16):
        c1, c2, c3 = (max_batch(k, H, out, wdt) for k in ("k1", "k2", "k3"))
        results[f"largest_C/{str(wdt).split('.')[-1]}"] = dict(K1=c1, K2=c2, K3=c3)
        # stage i runs K1 at its 16 predictive draws, K2 and K3 at its 8
        # chains, each in one launch
        good = c1 >= 16 and min(c2, c3) >= max(INFER_CHAINS)
        ok &= good
        log(f"[infer] largest batch one launch takes at H={H} out={out} "
            f"{str(wdt).split('.')[-1]}: K1 {c1}, K2 {c2}, K3 {c3} (more rows run in row "
            f"blocks) {'ok' if good else 'FAIL'}")
    log(f"[infer] {'ok' if ok else 'FAIL'}")
    return ok, results


def _grad_gap(got, want) -> float:
    """The largest |got - want| of any gradient over that gradient's largest
    magnitude."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
               for g, w in zip(got, want))


def phase_variants(dev, tmp: str):
    """The model variants on phase 7's corpus plus a third speaker: the
    many-to-many recipe (``run_mult_stages`` 3, 4, 5, 6 in turn, each
    stage's launches read around it), its epoch 1 and stage 5m on the plain
    path, the speaker classifier (``run_train_cls``) and the VQ-CycleVAE
    (``run_train_vq``) trainers with their launches, one step of each on both
    routes, and K1, K2 and K3 at the shapes these paths add."""
    from cyclevae_tpu_torch.models import gru_vae
    from cyclevae_tpu_torch.models.gru_vae import init_gru_rnn
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar, cuda_gru_ar_bwd, cuda_gru_ar_train
    from cyclevae_tpu_torch.pipeline import recipe, recipe_mult, train_stage_cls, train_stage_mult
    from cyclevae_tpu_torch.pipeline import train_stage_vq
    from cyclevae_tpu_torch.pipeline.dataset import SingleVAEDataset
    from cyclevae_tpu_torch.pipeline.dataset_mult import (MultSpkEvalClsDataset,
                                                          MultSpkTrainClsDataset)
    from cyclevae_tpu_torch.pipeline.features import extract_one
    from cyclevae_tpu_torch.pipeline.stats import calc_stats, calc_stats_joint
    from cyclevae_tpu_torch.pipeline.train_stage import model_config
    from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig, TrainConfig
    from cyclevae_tpu_torch.utils.store import read_store
    from cyclevae_tpu_torch.utils.wavio import write_wav
    from cyclevae_tpu_torch.vi.train import _leaves

    def experiment(**model):
        src, trg = RECIPE_SPEAKERS
        return ExperimentConfig(model=ModelConfig(spk_src=src, spk_trg=trg, **model),
                                train=TrainConfig(epoch_count=VARIANT_EPOCHS))

    exp = experiment()
    tcfg, fs = exp.train, exp.feature.fs
    src_list, trg_list = [list(RECIPE_SPEAKERS)[0]], [list(RECIPE_SPEAKERS)[1], VARIANT_SPEAKER]
    all_spk = src_list + trg_list
    wav_root, conf = os.path.join(tmp, "wav"), os.path.join(tmp, "conf")
    paths = recipe.RecipePaths(wav_root=wav_root, work=os.path.join(tmp, "work"),
                               n_train=RECIPE_N_TRAIN)
    expdir = os.path.join(paths.work, "exp", exp.name() + "_m2m")

    # ---- speaker C: its wavs from the seed (the same content as A's and
    # B's), stage 1's analysis of each file and stage 2's statistics ----
    t0 = time.perf_counter()
    minf0, maxf0, pw = VARIANT_RANGE
    with open(os.path.join(conf, f"{VARIANT_SPEAKER}.f0"), "w") as f:
        f.write(f"{minf0} {maxf0}")
    with open(os.path.join(conf, f"{VARIANT_SPEAKER}.pow"), "w") as f:
        f.write(f"{pw}")
    utts = [(False, f"utt{i}", VARIANT_F0 * (1 + 0.03 * i), sec, SEED + 40 + i)
            for i, sec in enumerate(RECIPE_SECONDS)]
    utts.append((True, "e0", VARIANT_F0 * 1.02, RECIPE_EVAL_SECONDS, SEED + 60))
    for eval_set, name, f0, sec, seed in utts:
        d = os.path.join(wav_root, "eval", VARIANT_SPEAKER) if eval_set else \
            os.path.join(wav_root, VARIANT_SPEAKER)
        os.makedirs(d, exist_ok=True)
        wav = os.path.join(d, f"{name}.wav")
        write_wav(wav, fs, speechlike_wav(f0, int(sec * fs), seed=seed))
        extract_one(wav, os.path.join(paths.h5dir(VARIANT_SPEAKER, eval_set), f"{name}.npz"),
                    None, exp.feature, minf0, maxf0, pw)
    calc_stats(paths.h5s(VARIANT_SPEAKER)[:RECIPE_N_TRAIN], paths.stats(VARIANT_SPEAKER),
               spkr=VARIANT_SPEAKER)
    log(f"[variants] speaker {VARIANT_SPEAKER} (~{VARIANT_F0:.0f} Hz): {len(utts)} utterances "
        f"analysed and its statistics in {time.perf_counter() - t0:.2f} s host; "
        f"speakers src {src_list} trg {trg_list}")

    # ---- the many-to-many recipe: counts set to 0 just before each stage,
    # read just after ----
    cfg = dataclasses.replace(model_config(exp), n_spk=len(all_spk))
    log(f"[variants] m2m flagship hl{cfg.hidden_layers} hu{cfg.hidden_units} ld{cfg.lat_dim} "
        f"n_cyc{cfg.n_cyc} n_spk{cfg.n_spk} use_pallas {cfg.use_pallas}; bsu "
        f"{tcfg.batch_size_utt}, {tcfg.epoch_count} epochs, n_train {RECIPE_N_TRAIN}")
    scans, steps = [0], []
    orig = {"scan": gru_vae.gru_ar_scan, "step": train_stage_mult.make_train_step}

    def counted_scan(*a, **k):
        scans[0] += 1
        return orig["scan"](*a, **k)

    def counts():
        return dict(K1=cuda_gru_ar.launches, K2=cuda_gru_ar_train.launches,
                    K3=cuda_gru_ar_bwd.launches, scan=scans[0])

    def zero():
        cuda_gru_ar.launches = cuda_gru_ar_train.launches = cuda_gru_ar_bwd.launches = 0
        scans[0] = 0

    ok = True
    totals = {"K1": 0, "K2": 0, "K3": 0}
    runs = {}
    gru_vae.gru_ar_scan = counted_scan
    train_stage_mult.make_train_step = timed_steps(orig["step"], steps)
    try:
        for stage in "3456":
            zero()
            t0 = time.perf_counter()
            recipe_mult.run_mult_stages(stage, exp, paths, src_list, trg_list, conf_dir=conf,
                                        device=dev)
            torch.cuda.synchronize()
            runs[f"{stage}m"] = dict(sec=time.perf_counter() - t0, **counts())
    finally:
        gru_vae.gru_ar_scan = orig["scan"]
        train_stage_mult.make_train_step = orig["step"]

    secs = [t for t, _, _ in steps]
    log(f"[variants] stage 4m: {len(steps)} train steps, s/step "
        + ", ".join(f"{t:.4f}" for t in secs) + "; real frames/s "
        + ", ".join(f"{n / t:.0f}" for t, n, _ in steps)
        + "; valid segments per step " + ", ".join(str(v) for _, _, v in steps))

    # ---- its artifacts ----
    with open(os.path.join(expdir, "history.json")) as f:
        hist = json.load(f)
    best = hist["best"]["epoch"]
    model_id = f"{exp.name()}_m2m_ep{best}"
    feats = [f for s in all_spk for e in (False, True) for f in paths.h5s(s, e)]
    art = {"cv_excitation": len(feats) == 3 * (RECIPE_UTTS + 1) and all(
        read_store(f, f"/cvuvlogf0fil_ap_{o}").shape[1] == 4
        for f in feats for o in all_spk if f"{os.sep}{o}{os.sep}" not in f)}
    art["history"] = best in (1, 2) and [h["epoch"] for h in hist["history"]] == [1, 2] and all(
        np.isfinite(v) for h in hist["history"] for part in ("train", "eval")
        for v in h[part].values())
    art["checkpoints"] = all(os.path.exists(os.path.join(expdir, f"checkpoint-{n}.pkl"))
                             for n in (1, 2))
    cvgv = {f"{s}/{t}/{m}": read_store(paths.stats(s), f"/cvgv_{m}_{t}_{model_id}")
            for s in all_spk for t in all_spk for m in ("mean", "var")}
    art["cvgv"] = len(cvgv) == 18 and all(v.shape == (cfg.out_dim - 1,) and np.isfinite(v).all()
                                          for v in cvgv.values())
    with open(os.path.join(expdir, f"decode_metrics_m2m_ep{best}.json")) as f:
        dm = json.load(f)
    art["decode_metrics"] = len(dm["per_direction"]) == 6 and all(
        np.isfinite(v) for d in [dm["overall"]] + list(dm["per_direction"].values())
        for v in d.values())
    outdir = os.path.join(expdir, f"wav_m2m_ep{best}")
    names = sorted(os.listdir(outdir))
    # every speaker's eval utterance is e0.wav: a target's directions share a name
    want_names = sorted({f"e0_to_{t}{sfx}.wav" for t in all_spk for sfx in ("_noGV", "_GV")}
                        | {f"e0_to_mix-{w:.2f}-{1 - w:.2f}-0.00{sfx}.wav"
                           for w in (0.75, 0.5, 0.25) for sfx in ("_noGV", "_GV")})
    art["wavs"] = names == want_names and all(
        np.abs(_read_wav_samples(os.path.join(outdir, n))).max() > 0 for n in names)
    ok &= all(art.values())
    log("[variants] m2m artifacts: " + ", ".join(f"{k} {v}" for k, v in art.items())
        + f"; best epoch {best}; eval mcdpow_rec " + ", ".join(
            f"{h['eval']['mcdpow_rec_mean']:.4f}" for h in hist["history"])
        + "; decode overall " + ", ".join(f"{k} {v:.4f}" for k, v in dm["overall"].items()))

    # ---- the launches of each stage ----
    n_eval = len([f for s in all_spk for f in paths.h5s(s, True)])
    n_pairs = sum(min(len(paths.wavs(s, True)), len(paths.wavs(t, True)))
                  for s in all_spk for t in all_spk if s != t)
    want_k2 = 4 * cfg.n_cyc * sum(v for _, _, v in steps)
    want = {"3m": dict(K1=0, K2=0, K3=0, scan=0),
            # 4 AR-GRU calls per cycle: K2 and K3 per valid segment, K1 per eval batch
            "4m": dict(K1=VARIANT_EPOCHS * -(-n_eval // tcfg.batch_size_utt_eval) * 4 * cfg.n_cyc,
                       K2=want_k2, K3=want_k2, scan=0),
            # an encode and one decode of all N directions per training utterance
            "5m": dict(K1=2 * RECIPE_N_TRAIN * len(all_spk), K2=0, K3=0, scan=0),
            # an encode and a decode per eval pair and per interpolation
            "6m": dict(K1=2 * n_pairs + 2 * 3, K2=0, K3=0, scan=0)}
    launches_ok = want_k2 > 0 and all(runs[st][k] == v for st, w in want.items()
                                      for k, v in w.items())
    ok &= launches_ok
    for st in want:
        totals = {k: totals[k] + runs[st][k] for k in totals}
        log(f"[variants] stage {st}: {runs[st]['sec']:.2f} s host; launches "
            + ", ".join(f"{k} {runs[st][k]} (want {v})" for k, v in want[st].items()))
    log(f"[variants] m2m launches as wanted {'ok' if launches_ok else 'FAIL'}")

    # ---- the plain path from the same seeds: epoch 1 of 4m, then 5m ----
    def plain_work(name):
        return _plain_work(paths, os.path.join(tmp, name), exp.name() + "_m2m")

    plain_exp = experiment(use_pallas=False)
    plain_exp.train.epoch_count = 1
    p4 = plain_work("variants_plain4")
    t0 = time.perf_counter()
    recipe_mult.run_mult_stages("4", plain_exp, p4, src_list, trg_list, conf_dir=conf, device=dev)
    plain4_s = time.perf_counter() - t0
    with open(os.path.join(p4.work, "exp", exp.name() + "_m2m", "history.json")) as f:
        train_rel = _max_rel(hist["history"][0]["train"], json.load(f)["history"][0]["train"])
    p5 = plain_work("variants_plain5")
    for name in ("history.json", f"checkpoint-{best}.pkl"):
        os.symlink(os.path.join(expdir, name),
                   os.path.join(p5.work, "exp", exp.name() + "_m2m", name))
    t0 = time.perf_counter()
    recipe_mult.run_mult_stages("5", plain_exp, p5, src_list, trg_list, conf_dir=conf, device=dev)
    plain5_s = time.perf_counter() - t0
    cvgv_rel = _max_rel(cvgv, {k: read_store(p5.stats(k.split("/")[0]),
                                             f"/cvgv_{k.split('/')[2]}_{k.split('/')[1]}"
                                             f"_{model_id}") for k in cvgv})
    plain_ok = train_rel < RECIPE_TRAIN_REL and cvgv_rel < RECIPE_CVGV_REL
    ok &= plain_ok
    log(f"[variants] m2m vs plain path: epoch-1 train metrics max rel {train_rel:.3e} (< "
        f"{RECIPE_TRAIN_REL}; stage 4m plain, 1 epoch: {plain4_s:.1f} s); cvgv statistics max "
        f"rel {cvgv_rel:.3e} (< {RECIPE_CVGV_REL}; stage 5m plain: {plain5_s:.1f} s) "
        f"{'ok' if plain_ok else 'FAIL'}")

    # ---- the classifier and VQ trainers: counts set to 0 just before each,
    # read just after ----
    train_files = [f for s in all_spk for f in paths.h5s(s)[:RECIPE_N_TRAIN]]
    evals = ([paths.h5s(s, True) for s in src_list], [paths.h5s(s, True) for s in trg_list])
    stats_cls = os.path.join(paths.work, "stats", "stats_jnt_cls.npz")
    calc_stats_joint(train_files, [], stats_cls)
    vq_src = paths.h5s(src_list[0])[:RECIPE_N_TRAIN]
    vq_trg = paths.h5s(trg_list[0])[:RECIPE_N_TRAIN]
    bsu = tcfg.batch_size_utt
    n_cls_pairs = len(MultSpkEvalClsDataset(*evals, src_list, trg_list))
    trainers = {
        "cls": (lambda: train_stage_cls.run_train_cls(
            exp, train_files, *evals, src_list, trg_list, stats_cls,
            os.path.join(paths.work, "exp", exp.name() + "_cls"), device=dev),
            # one K2 and one K3 a step; one K1 per eval forward, 2 per eval pair
            dict(K2=VARIANT_EPOCHS * -(-len(train_files) // bsu),
                 K3=VARIANT_EPOCHS * -(-len(train_files) // bsu),
                 K1=VARIANT_EPOCHS * 2 * n_cls_pairs, scan=0)),
        "vq": (lambda: train_stage_vq.run_train_vq(
            exp, vq_src, vq_trg, src_list[0], paths.stats_jnt(),
            os.path.join(paths.work, "exp", exp.name() + "_vq"), device=dev),
            # two encodes and three decodes a step, all under autograd
            dict(K2=VARIANT_EPOCHS * -(-(len(vq_src) + len(vq_trg)) // bsu) * 5,
                 K3=VARIANT_EPOCHS * -(-(len(vq_src) + len(vq_trg)) // bsu) * 5,
                 K1=0, scan=0)),
    }
    gru_vae.gru_ar_scan = counted_scan
    res = {}
    try:
        for name, (run, want_n) in trainers.items():
            zero()
            t0 = time.perf_counter()
            res[name] = run()
            torch.cuda.synchronize()
            runs[name] = dict(sec=time.perf_counter() - t0, **counts())
            good = all(runs[name][k] == v for k, v in want_n.items())
            ok &= good
            totals = {k: totals[k] + runs[name][k] for k in totals}
            h = res[name]["history"]
            finite = all(np.isfinite(v) for e in h for v in e["train"].values())
            ok &= finite and len(h) == VARIANT_EPOCHS
            score = ([("eval_acc", e["eval_acc"]) for e in h] if name == "cls"
                     else [("perplexity", e["train"]["perplexity"]) for e in h])
            extra = f"{score[0][0]} " + ", ".join(f"{v:.3f}" for _, v in score)
            log(f"[variants] {name}: {len(h)} epochs in {runs[name]['sec']:.2f} s host; loss "
                + ", ".join(f"{e['train']['loss']:.4f}" for e in h) + f"; {extra}; launches "
                + ", ".join(f"{k} {runs[name][k]} (want {v})" for k, v in want_n.items())
                + f" {'ok' if good and finite else 'FAIL'}")
    finally:
        gru_vae.gru_ar_scan = orig["scan"]

    # ---- one step of each trainer, kernel route against the plain path:
    # the same weights, batch and draws (lr 0, so the step leaves the
    # weights and hands back the gradients) ----
    Record, Replay = _draws_classes()
    ccfg = train_stage_cls.classifier_config(exp, len(all_spk))
    cls_ds = MultSpkTrainClsDataset(train_files, src_list, trg_list, 1, seed=tcfg.seed)
    cls_batch = train_stage_cls._collate_cls([cls_ds[i] for i in range(bsu)], tcfg.batch_size)
    enc_cfg, dec_cfg = train_stage_vq.make_vq_cfgs(exp)
    vq_ds = SingleVAEDataset(vq_src + vq_trg, vq_trg + vq_src, src_list[0], n_spk=exp.model.n_spk)
    vq_batch = train_stage_vq._collate_vq([vq_ds[i] for i in range(bsu)], tcfg.batch_size)
    mean, scale = (read_store(stats_cls, f"/{k}_feat_org_lf0_jnt") for k in ("mean", "scale"))

    def cls_step(use_pallas, draws):
        params = init_gru_rnn(torch.Generator(device=dev).manual_seed(SEED + 90), ccfg)
        params["scale_in"] = {"mean": torch.as_tensor(mean, dtype=torch.float32, device=dev),
                              "scale": torch.as_tensor(scale, dtype=torch.float32, device=dev)}
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        m = train_stage_cls.make_classifier_step(ccfg, use_pallas)(
            params, torch.optim.SGD(leaves, lr=0.0), cls_batch, draws)
        return float(m["loss"]), [t.grad for t in leaves]

    def vq_step(use_pallas, draws):
        params = train_stage_vq.init_vq(torch.Generator(device=dev).manual_seed(SEED + 91),
                                        enc_cfg, dec_cfg, 64, mean, scale, exp.model.stdim, dev)
        leaves = train_stage_vq.vq_trainable(params)
        for t in leaves:
            t.requires_grad_(True)
        m = train_stage_vq.make_vq_step(enc_cfg, dec_cfg, exp.model.stdim, 64,
                                        use_pallas=use_pallas)(
            params, torch.optim.SGD(leaves, lr=0.0), vq_batch, draws)
        return float(m["loss"]), [t.grad for t in leaves]

    for name, step, T in (("cls", cls_step, cls_batch["feats"].shape[1]),
                          ("vq", vq_step, vq_batch["feats"].shape[1])):
        rec = Record(torch.Generator(device=dev).manual_seed(SEED + 92))
        t0 = time.perf_counter()
        loss_k, grads_k = step(True, rec)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_p, grads_p = step(False, Replay(rec.seq))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        rel, gap = abs(loss_k - loss_p) / abs(loss_p), _grad_gap(grads_k, grads_p)
        good = rel < VARIANT_LOSS_REL and gap < GRAD_SCALE_TOL and np.isfinite(loss_k)
        ok &= good
        log(f"[variants] {name} step B={bsu} T={T}, kernel route vs plain path on the same "
            f"draws: loss {loss_k:.6f} / {loss_p:.6f}, rel {rel:.3e} (< {VARIANT_LOSS_REL}); "
            f"gradients max gap {gap:.3e} of scale (< {GRAD_SCALE_TOL}); {kernel_s:.3f} s / "
            f"{plain_s:.3f} s host {'ok' if good else 'FAIL'}")

    # ---- the kernel shapes these paths add, timed beside their bounds ----
    gen = torch.Generator(device=dev).manual_seed(SEED + 93)
    conv_in = exp.model.in_dim * 9
    rows = _train_rows(dev, gen, [
        ("cls", bsu, len(all_spk), conv_in, VARIANT_T, ("gru_ar_train", "gru_ar_bwd")),
        ("vq_encoder", bsu, exp.model.lat_dim, conv_in, VARIANT_T,
         ("gru_ar_train", "gru_ar_bwd"))], (torch.float32,), tag="variants")
    rows.update(_k1_rows(dev, gen, (
        ("m2m_decoder_N", len(all_spk), exp.model.out_dim, (exp.model.lat_dim + len(all_spk)) * 9),
        ("cls_eval", 1, len(all_spk), conv_in)), VARIANT_T, (torch.float32,), tag="variants"))
    ok &= all(r["ok"] for r in rows.values())
    log(f"[variants] launches on the main paths: K1 {totals['K1']}, K2 {totals['K2']}, "
        f"K3 {totals['K3']}")
    log(f"[variants] {'ok' if ok else 'FAIL'}")
    return ok, totals, rows


def phase_tools(dev, tmp: str):
    """The port's tools (``cyclevae_tpu_torch.tools``) through their
    ``main``, each at full width and reduced depth, in phase 7's work
    directory: their JSON rows, their kernel launches against the
    prediction from each kernel's row-block limit (``max_batch``), and no
    "error" or "fault" row.  Returns (ok, the launches of the tools run in
    this process, those of the scaling ranks)."""
    from cyclevae_tpu_torch.ops.cuda_gru import max_batch
    from cyclevae_tpu_torch.tools import (bench, bench_battery, bench_decode_fusion,
                                          bench_hmc_chains, bench_hmc_trajlen, bench_nuts,
                                          bench_scaling, bench_smc_particles, bench_stage6_wall,
                                          reeval_criterion, train_eval_vocoder,
                                          vocode_converted)
    from cyclevae_tpu_torch.tools._common import decode_epoch, kernel_launches, launches_since
    from cyclevae_tpu_torch.utils.config import (ExperimentConfig, ModelConfig, TrainConfig,
                                                 load_config)

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "tools")
    os.makedirs(out, exist_ok=True)
    work, wav_root = os.path.join(tmp, "work"), os.path.join(tmp, "wav")
    ok, fails = True, []
    blocks = lambda kind, B, out_dim, wdt: -(-B // max_batch(kind, H, out_dim, wdt))
    dtypes = {"f32": torch.float32, "fast": torch.bfloat16}
    before_all = kernel_launches()

    def check(name, good, msg):
        nonlocal ok
        ok &= bool(good)
        if not good:
            fails.append(name)
        log(f"[tools] {name}: {msg} {'ok' if good else 'FAIL'}")

    def timed_main(mod, argv):
        t0 = time.perf_counter()
        res = mod.main(argv + ["--device", str(dev)])
        return res, time.perf_counter() - t0

    # ---- the train-throughput bench: K2 / K3 per step from the limits ----
    bench.VARIANTS = [(f"{dname}_pallas_bsu{B}", dict(use_pallas=True, compute_dtype=cd), B)
                      for B in TOOLS_BENCH_BSU
                      for dname, cd in (("f32", "float32"), ("bf16", "bfloat16"))]
    bench.TIMED_STEPS = TOOLS_BENCH_STEPS
    res, sec = timed_main(bench, ["--out", os.path.join(out, "bench.json")])
    for label, over, B in bench.VARIANTS:
        wdt = torch.bfloat16 if over["compute_dtype"] == "bfloat16" else torch.float32
        # per segment and cycle: encoder and cv encoder (B rows, out 64), the
        # fused 2B decoder (2B rows, out 50), the cyclic decoder (B, out 50)
        want = {k: bench.N_SEGS * 2 * (2 * blocks(kind, B, 64, wdt) + blocks(kind, 2 * B, 50, wdt)
                                       + blocks(kind, B, 50, wdt))
                for k, kind in (("K2", "k2"), ("K3", "k3"))}
        fps = res["variants"][label]
        got = res["launches_per_step"].get(label)
        check(f"bench {label}", isinstance(fps, float) and got == want,
              f"{fps} frames/s (median of {TOOLS_BENCH_STEPS}, "
              f"{res['median_step_seconds'].get(label, float('nan')):.4f} s a step), MFU "
              f"{res['mfu_per_variant'].get(label)}, launches a step {got} (predicted {want})")
    log(f"[tools] bench: measured bf16 peak {res['measured_bf16_peak_tflops']} TFLOP/s; "
        f"{sec:.1f} s")

    # ---- HMC chains: 1 + L x iterations K2 and K3 calls a run, each in blocks ----
    L, iters = 8, 2 * TOOLS_ITERS
    res, sec = timed_main(bench_hmc_chains, [
        "--chains", *map(str, TOOLS_HMC_CHAINS), "--iters", str(TOOLS_ITERS), "--warmup",
        str(TOOLS_ITERS), "--adapt-mass", "on", "--out", os.path.join(out, "hmc.json")])
    for mode, rows in res["sweep"].items():
        wdt = dtypes[mode]
        for r in rows:
            C = r["chains"]
            want = tuple(blocks(kind, C, 50, wdt) * (1 + L * iters) / iters
                         for kind in ("k2", "k3"))
            got = (r["k2_launches_per_iter"], r["k3_launches_per_iter"])
            check(f"hmc {mode} C={C}", r["finite"] and got == want,
                  f"{r['samples_per_sec_per_chip']} samples/s, {r['iter_ms']:.1f} ms an "
                  f"iteration (kinetic loop {r['kinetic_ms_per_iter']:.2f} ms), accept "
                  f"{r['accept']}, ESS/s {r['ess_per_sec_per_chip']}; K2, K3 an iteration {got} "
                  f"(predicted {want})")
    log(f"[tools] bench_hmc_chains {sec:.1f} s")

    # ---- NUTS: one K2 and one K3 per leaf for all chains in lockstep ----
    res, sec = timed_main(bench_nuts, [
        "--chains", "32", "--max-depths", "4", "--iters", str(TOOLS_ITERS), "--warmup",
        str(TOOLS_ITERS), "--out", os.path.join(out, "nuts.json")])
    for r in res["sweep"]["fast"]:
        k2, k3 = r["k2_launches_per_iter"], r["k3_launches_per_iter"]
        check("nuts fast C=32 depth 4",
              r["finite"] and k2 == k3 and r["mean_leapfrog_per_iter"] <= k2 <= 2 ** 4,
              f"{r['grad_evals_per_sec_per_chip']} grad-evals/s, {r['iter_ms']} ms an "
              f"iteration, {r['mean_leapfrog_per_iter']} leapfrogs (cap {r['leapfrog_cap']}), "
              f"K2 = K3 {k2} an iteration (predicted: equal, from the mean leapfrogs to 16)")
    log(f"[tools] bench_nuts {sec:.1f} s")

    # ---- SMC: no kernel in the filter; one K1 for the amortized guide ----
    before = kernel_launches()
    res, sec = timed_main(bench_smc_particles, [
        "--frames", "64", "--particles", "256", "--reps", "1",
        "--out", os.path.join(out, "smc.json")])
    n = launches_since(before)
    rows = {p: r[0] for p, r in res["sweep"].items()}
    check("smc 256 particles", n == {"K1": 1, "K2": 0, "K3": 0, "K4": 0}
          and all(np.isfinite(r["log_marginal"]) for r in rows.values()),
          ", ".join(f"{p} {r['particle_steps_per_sec_per_chip']} particle-steps/s ESS "
                    f"{r['mean_ess']}" for p, r in rows.items())
          + f"; launches {n} (predicted K1 1); {sec:.1f} s")

    # ---- the trajectory-length sweep: 2 points, no fault row ----
    res, sec = timed_main(bench_hmc_trajlen, [
        "--chains", "32", "--iters", str(TOOLS_ITERS), "--warmup", str(TOOLS_ITERS),
        "--points", "8,0.9,on", "16,0.8,on", "--out", os.path.join(out, "trajlen.json")])
    check("trajlen 2 points", res["n_faulting_points"] == 0 and all(
        r["k2_launches_per_iter"] == (1 + r["n_leapfrog"] * iters) / iters for r in res["rows"]),
        "; ".join(f"L={r['n_leapfrog']} ESS/s {r['ess_per_sec_per_chip']} K2 an iteration "
                  f"{r['k2_launches_per_iter']}" for r in res["rows"] if not r.get("fault"))
        + f"; {sec:.1f} s")

    # ---- scaling: 1 and 2 gloo ranks on the card ----
    res, sec = timed_main(bench_scaling, ["--ranks", "1", "2",
                                          "--out", os.path.join(out, "scaling.json")])
    hmc = bench_scaling.HMC
    # a chain's run: one evaluation at its start, one a leapfrog; two runs a
    # point (the warm and the timed), fixed 2 chains x2 points, weak 1 and 2 chains
    chain_runs = 2 * (2 + 2 + 1 + 2)
    evals = chain_runs * (1 + hmc["n_leapfrog"] * (hmc["n_warmup"] + hmc["n_samples"]))
    want = {"K2": evals, "K3": evals}
    scaling_launches = res["launches"]
    check("scaling 1-2 ranks", {k: scaling_launches.get(k) for k in want} == want,
          f"fixed {res['fixed_work']}, weak {res['weak_scaling']}; launches in the ranks "
          f"{scaling_launches} (predicted {want}); {sec:.1f} s")

    # ---- the vocoder tools on phase 7's experiment ----
    # phase 7's experiment (as its run_train saved it) and stage v's vocoder
    exp = ExperimentConfig(model=ModelConfig(spk_src="SPKA", spk_trg="SPKB"),
                           train=TrainConfig(epoch_count=RECIPE_EPOCHS))
    exp_path = os.path.join(work, "exp", exp.name(), "model.json")
    exp = load_config(exp_path)
    vexp = os.path.join(work, "exp", f"vocoder_SPKB_hu{RECIPE_VOC_HU}")
    before, captures = kernel_launches(), CAPTURES[0]
    res, sec = timed_main(vocode_converted, [
        "--work", work, "--wav-root", wav_root, "--config", exp_path, "--vocoder-exp", vexp,
        "--hidden-units", str(RECIPE_VOC_HU), "--n-train", str(RECIPE_N_TRAIN),
        "--out", os.path.join(out, "vocode_converted.json")])
    n, captures = launches_since(before), CAPTURES[0] - captures
    m = res["metrics"]
    want = {"K1": 2 * (res["n_eval"] + captures), "K2": 0, "K3": 0, "K4": res["n_eval"]}
    check("vocode_converted", n == want
          and all(np.isfinite(m[k]) for k in ("mcd_cv_voc", "mcd_cv_world")),
          f"{res['n_eval']} pair(s): MCD neural {m['mcd_cv_voc']:.2f} dB, WORLD "
          f"{m['mcd_cv_world']:.2f} dB, F0 rel err {m['f0_rel_err_median']:.3f}, U/V "
          f"{m['uv_agree']:.3f}; launches {n} (predicted K1 2, K4 1 a pair, K1 2 a graph "
          f"capture: {want}); {sec:.1f} s")
    before = kernel_launches()
    res, sec = timed_main(train_eval_vocoder, [
        "--work", work, "--wav-root", wav_root, "--speaker", "SPKB", "--epochs", "1",
        "--n-train", str(RECIPE_N_TRAIN), "--hidden-units", str(RECIPE_VOC_HU),
        "--out", os.path.join(out, "vocoder_eval.json")])
    n = launches_since(before)
    cs = res["copy_synthesis"]
    check("train_eval_vocoder 1 epoch", n["K4"] == res["n_eval"] and np.isfinite(res["final_nll"])
          and np.isfinite(cs["mcd"]),
          f"nll {res['final_nll']:.3f}, copy MCD {cs['mcd']:.2f} dB, F0 rel err "
          f"{cs['f0_rel_err_median']:.3f}; launches {n} (predicted K4 1 an eval utterance); "
          f"{sec:.1f} s")

    # ---- re-eval: each checkpoint's eval epoch replayed on K1 ----
    with open(os.path.join(os.path.dirname(exp_path), "history.json")) as f:
        hist = {h["epoch"]: h["eval"]["criterion"] for h in json.load(f)["history"] if h["eval"]}
    before = kernel_launches()
    res, sec = timed_main(reeval_criterion, [
        "--work", work, "--wav-root", wav_root, "--config", exp_path,
        "--n-train", str(RECIPE_N_TRAIN)])
    n = launches_since(before)
    gap = max(abs(r["criterion_src"] / hist[r["epoch"]] - 1) for r in res["results"])
    n_batches = 2 * -(-1 // exp.train.batch_size_utt_eval)     # 1 eval utterance a speaker
    want = 8 * n_batches * len(res["results"])
    check("reeval_criterion", n["K1"] == want and gap < 1e-6 and len(res["results"]) == 2,
          f"criteria {[(r['epoch'], round(r['criterion_src'], 4)) for r in res['results']]}, "
          f"against the history's {gap:.2e} relative; K1 {n['K1']} (predicted {want}); "
          f"{sec:.1f} s")

    # ---- decode fusion on phase 7's best checkpoint: K1 2 a pair fused, 5 sequential ----
    expdir = os.path.dirname(exp_path)
    ckpt = os.path.join(expdir, f"checkpoint-{decode_epoch(expdir)}.pkl")
    pairs = TOOLS_FUSION_REPS + 1                       # one warm-up pair a path
    fusion_argv = [ckpt, exp_path, "--frames", str(TOOLS_FUSION_T), "--reps",
                   str(TOOLS_FUSION_REPS)]
    before, captures = kernel_launches(), CAPTURES[0]
    res, sec = timed_main(bench_decode_fusion, fusion_argv + [
        "--out", os.path.join(out, "decode_fusion.json")])
    n, captures = launches_since(before), CAPTURES[0] - captures
    want = {"K1": (2 + 5) * pairs + 2 * captures, "K2": 0, "K3": 0, "K4": 0}
    check("decode_fusion", n == want and (res["k1_launches_fused"], res["k1_launches_sequential"])
          == (2, 5) and all(np.isfinite(res[k]) and res[k] > 0
                            for k in ("fused_ms", "sequential_ms")),
          f"T={res['frames']}, {TOOLS_FUSION_REPS} pairs a path: fused {res['fused_ms']} ms, "
          f"sequential {res['sequential_ms']} ms a pair (speedup {res['speedup']}); K1 a pair "
          f"{res['k1_launches_fused']} / {res['k1_launches_sequential']} (predicted 2 / 5); "
          f"launches {n} (predicted K1 {want['K1']}, {captures} graph capture(s)); "
          f"{sec:.1f} s")

    # ---- stage 6's wall time, prefetch on and off, through the recipe's CLI ----
    res, sec = timed_main(bench_stage6_wall, [
        "--work", work, "--wav-root", wav_root, "--config", exp_path, "--conf-dir",
        os.path.join(tmp, "conf"), "--out", os.path.join(out, "stage6_wall.json")])
    check("stage6_wall", res["outputs_equal"] is True and res["n_pairs"] == 1
          and res["value"] > 0 and res["sequential_baseline_s"] > 0,
          f"{res['n_pairs']} pair(s), epoch {res['decode_epoch']}: prefetch on {res['value']} s, "
          f"off {res['sequential_baseline_s']} s ({res['overlap_speedup']}x; one pair: the "
          f"tool, not the overlap), outputs equal {res['outputs_equal']}; {sec:.1f} s")

    # ---- the battery's runner: the fusion bench as a process, then a failing stub ----
    bdir = os.path.join(out, "battery")
    os.makedirs(bdir)
    t0 = time.perf_counter()
    ran = bench_battery.run_bench(bench_battery.Bench(
        "bench_decode_fusion", 1200, "BENCH_TORCH_DECODE_FUSION.json",
        [sys.executable, "-m", "cyclevae_tpu_torch.tools.bench_decode_fusion", *fusion_argv,
         "--out", os.path.join(bdir, "own.json"), "--device", str(dev)]), bdir, bdir)
    with open(os.path.join(bdir, "bench_decode_fusion.out")) as f:
        last = (f.read().splitlines() or [""])[-1]
    artifact = os.path.join(bdir, "BENCH_TORCH_DECODE_FUSION.json")
    written = False
    if os.path.exists(artifact):
        with open(artifact) as f:
            written = f.read() == last + "\n"
    row = json.loads(last) if written else {}
    refused = not bench_battery.run_bench(bench_battery.Bench(
        "stub_fails", 60, "STUB.json", [sys.executable, "-c", "print('{}'); raise SystemExit(1)"]),
        bdir, bdir) and not os.path.exists(os.path.join(bdir, "STUB.json"))
    check("battery runner", ran and written and refused
          and (row.get("k1_launches_fused"), row.get("k1_launches_sequential")) == (2, 5),
          f"the fusion bench's last line written as its artifact {written} (fused "
          f"{row.get('fused_ms')} ms, sequential {row.get('sequential_ms')} ms); a stub that "
          f"exits 1 refused, nothing written {refused}; {time.perf_counter() - t0:.1f} s")

    launches = launches_since(before_all)
    # K1 at the sequential path's one-row shapes (the 600-frame source in its
    # 1120-frame bucket, the 560-frame target in one bucket) against the plain
    # version; after the count, as a comparison's launches do not count
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for T in (2 * 560, 560):
        rows = _k1_rows(dev, gen, (("encoderB1", 1, 64, 486), ("decoderB1", 1, 50, 306)), T,
                        (torch.float32,), tag="tools")
        check(f"K1 B=1 T={T}", all(r["ok"] for r in rows.values()),
              ", ".join(f"{k} {r['ms']:.3f} ms (bound {r['bound_ms']:.4f})"
                        for k, r in rows.items()))
    log(f"[tools] launches in this process: {launches}; in the scaling ranks: "
        f"{scaling_launches}; phase {time.perf_counter() - t_phase:.1f} s")
    log(f"[tools] {'ok' if ok else 'FAIL: ' + ', '.join(fails)}")
    return ok, launches, scaling_launches


def phase_parallel(dev):
    """The data-parallel layer (``cyclevae_tpu_torch.parallel``) through the
    dry run's rank function (``parallel.dryrun.rank_on_device``) in ranks
    spawned by ``parallel.spawn``: 2 gloo ranks on cuda:0 take one sharded
    flagship train step (and DP_TIMED_STEPS more, timed), run sharded HMC
    and sharded SMC; 1 NCCL rank takes the same step; each held against the
    single-device run in this process on the same generators."""
    from cyclevae_tpu_torch.infer import (Draws, HMCConfig, SMCConfig, hmc_sample_chains,
                                          make_decoder_ssm, make_utterance_logjoint, smc_filter)
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar_bwd, cuda_gru_ar_train
    from cyclevae_tpu_torch.parallel.dryrun import model_of, rank_on_device
    from cyclevae_tpu_torch.parallel.spawn import spawn_ranks
    from cyclevae_tpu_torch.utils.profiling import measure_steps
    from cyclevae_tpu_torch.vi.train import (TrainState, make_optimizer, make_train_step,
                                             trainable_leaves)

    t_phase = time.perf_counter()
    (b1, meta), f1 = train_batch(np.random.default_rng(SEED + 2))
    (b2, _), f2 = train_batch(np.random.default_rng(SEED + 102))
    batch = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    real = np.concatenate([f1, f2])
    n_segs, real_frames = meta["n_segs"], int(batch["flens"].sum())
    model = dict(hidden_units=H, mean=real.mean(axis=0), scale=real.std(axis=0) + 1e-3,
                 seed=SEED + 90)
    train = dict(tag="flagship f32", seg_len=SEG_LEN, n_segs=n_segs, batch=batch,
                 rng_seed=SEED + 91, grads=True, **model)
    rng = np.random.default_rng(SEED + 92)
    feats = synth_features(rng, DP_T)
    code = np.tile([1.0, 0.0], (DP_T, 1)).astype(np.float32)
    infer = dict(feats=feats, code=code, obs_scale=INFER_OBS_SCALE, **model)
    spec = {"train": [dict(train, timed_steps=DP_TIMED_STEPS)],
            "hmc": dict(infer, chains=DP_CHAINS, hmc=DP_HMC, draws_seed=SEED + 93),
            "smc": dict(infer, particles=DP_PARTICLES, draws_seed=SEED + 94)}
    card = [str(dev)] * DP_RANKS

    t0 = time.perf_counter()
    # 2 host threads a rank: the ranks' work is on the card, and 8 threads
    # each would oversubscribe the machine's cores
    gloo = spawn_ranks(rank_on_device, DP_RANKS, (card, spec), backend="gloo",
                       timeout_s=600, threads=2)
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = spawn_ranks(rank_on_device, 1, (card[:1], {"train": [train]}),
                       backend="nccl", timeout_s=600, threads=2)[0]
    nccl_s = time.perf_counter() - t0

    # ---- the single-device runs in this process, the same seeds ----
    cfg, params = model_of(train, dev)
    opt = make_optimizer(cfg, lr=1e-4)
    ts = TrainState(params, opt.init(params),
                    torch.Generator(device=dev).manual_seed(train["rng_seed"]), 0)
    grads = []

    def first_update(optimizer, args, kwargs):
        if not grads:
            grads.extend(p.grad.detach().cpu().clone() for p in trainable_leaves(ts.params))
    hook = ts.opt_state.register_step_pre_hook(first_update)
    step = make_train_step(cfg, opt, SEG_LEN, n_segs)
    ts, m = step(ts, batch)
    hook.remove()
    single_loss = m["loss"].cpu()
    single = measure_steps(step, ts, batch, n_steps=DP_TIMED_STEPS, warmup=0)
    cfg_i, params_i = model_of(infer, dev)
    feats_t, code_t = torch.as_tensor(feats, device=dev), torch.as_tensor(code, device=dev)
    lj = make_utterance_logjoint(params_i, cfg_i, feats_t, code_t, obs_scale=INFER_OBS_SCALE)
    z0 = torch.zeros((DP_CHAINS, DP_T, cfg_i.lat_dim), device=dev)
    t0 = time.perf_counter()
    s_ref, _ = hmc_sample_chains(Draws(torch.Generator(device=dev).manual_seed(SEED + 93)), lj,
                                 z0, HMCConfig(*DP_HMC))
    torch.cuda.synchronize()
    hmc_single_s = time.perf_counter() - t0
    init, prop, logw = make_decoder_ssm(params_i, cfg_i, feats_t, code_t,
                                        obs_scale=INFER_OBS_SCALE)
    t0 = time.perf_counter()
    _, smc_ref = smc_filter(Draws(torch.Generator(device=dev).manual_seed(SEED + 94)), DP_T,
                            init, prop, logw, SMCConfig(n_particles=DP_PARTICLES))
    lm_ref = float(smc_ref["log_marginal"])
    smc_single_s = time.perf_counter() - t0

    # ---- the checks ----
    ok = True
    want_seg = 8 * n_segs            # 8 K2 + 8 K3 per valid segment, per rank
    steps = DP_HMC[2] + DP_HMC[3]
    c_local = DP_CHAINS // DP_RANKS
    # a run per local chain: 1 + L x steps K2 and as many K3 (the start's
    # evaluation, then one at each leapfrog's end point)
    evals = c_local * (1 + DP_HMC[1] * steps)
    want_hmc = {"K1": 0, "K2": evals, "K3": evals}
    launches = {"K2": 0, "K3": 0}
    for r, res in enumerate(gloo):
        t = res["train"][0]
        rel = float(((t["metrics"]["loss"] - single_loss).abs() / single_loss.abs()).max())
        gap = _grad_gap(t["grads"], grads)
        n = t["launches"]
        good = (rel < DP_LOSS_REL and gap <= GRAD_SCALE_TOL and n["K2"] == n["K3"] == want_seg
                and n["K1"] == 0)
        ok &= good
        log(f"[parallel] gloo rank {r}/{DP_RANKS} on {card[r]}: one sharded step of B = "
            f"{len(batch['flens']) // DP_RANKS} (global {len(batch['flens'])}), {n_segs} x "
            f"{SEG_LEN}: {t['seconds']:.3f} s, K2 {n['K2']}, K3 {n['K3']} (want {want_seg} "
            f"each); vs single device: per-segment loss rel {rel:.3e} (< {DP_LOSS_REL}), first "
            f"all-reduced gradients max err / scale {gap:.3e} (<= {GRAD_SCALE_TOL}); "
            f"{DP_TIMED_STEPS} more steps, median s/step {t['median_seconds']:.4f} "
            f"{'ok' if good else 'FAIL'}")
        h = res["hmc"]
        s_mine = h["samples"]
        s_want = s_ref[r * c_local:(r + 1) * c_local].cpu()
        moved = lambda s_: (torch.diff(torch.cat([torch.zeros_like(s_[:, :1]), s_], dim=1),
                                       dim=1).abs().amax(dim=(2, 3)) > 0)
        z_rel = rel_l2(s_mine, s_want)
        good = (bool(torch.equal(moved(s_mine), moved(s_want))) and z_rel < DP_Z_REL
                and h["launches"] == want_hmc)
        ok &= good
        log(f"[parallel] gloo rank {r}: sharded HMC, {c_local} of {DP_CHAINS} chains, {steps} "
            f"steps of L = {DP_HMC[1]} on {DP_T} frames: {h['seconds']:.3f} s, K2 "
            f"{h['launches']['K2']}, K3 {h['launches']['K3']} (want {want_hmc['K2']}, "
            f"{want_hmc['K3']}); accepts {moved(s_mine).int().tolist()} vs "
            f"{moved(s_want).int().tolist()}, z rel_l2 {z_rel:.3e} (< {DP_Z_REL}) "
            f"{'ok' if good else 'FAIL'}")
        sm = res["smc"]
        lm_rel = abs(sm["log_marginal"] - lm_ref) / abs(lm_ref)
        good = lm_rel < DP_LM_REL and sm["launches"] == {"K1": 0, "K2": 0, "K3": 0}
        ok &= good
        log(f"[parallel] gloo rank {r}: sharded SMC, {DP_PARTICLES // DP_RANKS} of "
            f"{DP_PARTICLES} particles over {DP_T} frames: {sm['seconds']:.3f} s, log marginal "
            f"{sm['log_marginal']:.4f} vs {lm_ref:.4f} (rel {lm_rel:.3e} < {DP_LM_REL}), mean "
            f"ESS {sm['mean_ess']:.1f} {'ok' if good else 'FAIL'}")
        for k in launches:
            launches[k] += t["launches_all"][k] + h["launches"][k]
    t = nccl["train"][0]
    equal = bool(torch.equal(t["metrics"]["loss"], single_loss)) and all(
        torch.equal(a, b) for a, b in zip(t["grads"], grads))
    rel = float(((t["metrics"]["loss"] - single_loss).abs() / single_loss.abs()).max())
    n = t["launches"]
    good = equal and n["K2"] == n["K3"] == want_seg
    ok &= good
    for k in launches:
        launches[k] += t["launches_all"][k]
    log(f"[parallel] NCCL rank 0/1 on {card[0]}: one sharded step of B = "
        f"{len(batch['flens'])}: {t['seconds']:.3f} s, K2 {n['K2']}, K3 {n['K3']}; losses and "
        f"first gradients equal to the single-device step's: {equal} (loss rel {rel:.3e}) "
        f"{'ok' if good else 'FAIL'}")
    med = gloo[0]["train"][0]["median_seconds"]
    log(f"[parallel] median s/step over {DP_TIMED_STEPS} steps (measure_steps, CUDA events): "
        f"sharded 2 gloo ranks on one card {med:.4f} ({real_frames / med:.0f} real frames/s, "
        f"per rank {' '.join(f'{r_['train'][0]['median_seconds']:.4f}' for r_ in gloo)}), "
        f"single device {single['median_seconds']:.4f} ({real_frames / single['median_seconds']:.0f}"
        f" real frames/s); single-device HMC {hmc_single_s:.3f} s, SMC {smc_single_s:.3f} s; "
        f"spawn + work: gloo x{DP_RANKS} {gloo_s:.1f} s, NCCL x1 {nccl_s:.1f} s; one "
        f"segment's gradient all-reduce alone ({gloo[0]['train'][0]['all_reduce_bytes'] / 1e6:.1f}"
        f" MB, gloo through host copies): "
        + ", ".join(f"{r_['train'][0]['all_reduce_seconds'] * 1e3:.1f}" for r_ in gloo)
        + " ms per rank")
    log(f"[parallel] launches in the ranks: K2 {launches['K2']}, K3 {launches['K3']}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; NCCL across cards not measured (one card)")
    log(f"[parallel] {'ok' if ok else 'FAIL'}")
    return ok, launches


def _read_wav_samples(path: str) -> np.ndarray:
    from scipy.io import wavfile
    return wavfile.read(path)[1].astype(np.float64)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import cyclevae_tpu_torch  # noqa: F401  (fails outside the repository)

    adopt_orphans()
    count_captures()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    kern = phase_kernels(dev)
    train_kern = phase_train_kernels(dev)
    voc_kern, voc_kern_ok = phase_vocoder_kernel(dev)
    dual_kern, dual_kern_ok = phase_vocoder_dual_kernel(dev)
    pwg_kern, pwg_ok, pwg_launches = phase_pwg(dev)
    main_ok, launches = phase_main(dev)
    train_ok, (k2_launches, k3_launches) = phase_train(dev)
    vocode_ok, k4_launches, k4_dual_launches = phase_vocode(dev)
    wav_ok, wav_launches = phase_convert_wav(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe") as tmp:
        recipe_ok, recipe_launches = phase_recipe(dev, tmp)
        infer_ok, _ = phase_infer(dev)
        variants_ok, variant_launches, _ = phase_variants(dev, tmp)
        tools_ok, tool_launches, scaling_launches = phase_tools(dev, tmp)
    parallel_ok, parallel_launches = phase_parallel(dev)
    launches += (wav_launches + recipe_launches["K1"] + variant_launches["K1"]
                 + tool_launches["K1"] + scaling_launches.get("K1", 0))
    k2_launches += (recipe_launches["K2"] + variant_launches["K2"] + parallel_launches["K2"]
                    + tool_launches["K2"] + scaling_launches.get("K2", 0))
    k3_launches += (recipe_launches["K3"] + variant_launches["K3"] + parallel_launches["K3"]
                    + tool_launches["K3"] + scaling_launches.get("K3", 0))
    k4_launches += recipe_launches["K4"] + tool_launches["K4"]
    ok = (main_ok and train_ok and vocode_ok and wav_ok and recipe_ok and infer_ok and variants_ok
          and tools_ok and parallel_ok and voc_kern_ok and dual_kern_ok and pwg_ok
          and all(r["ok"] for r in kern.values())
          and all(r["ok"] for r in train_kern.values()))

    def entry(name, source, replaces, n, r):
        # no PyTorch call computes an AR GRU or its reverse scan
        # (torch.nn.GRU has no output feedback), nor an AR sampler:
        # library_ms is null
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        entry("gru_ar", "cyclevae_tpu_torch/csrc/gru_ar.cu",
              "cyclevae_tpu/ops/pallas_gru.py:365", launches, kern["decoder/float32"]),
        entry("gru_ar_train", "cyclevae_tpu_torch/csrc/gru_ar.cu",
              "cyclevae_tpu/ops/pallas_gru.py:109", k2_launches,
              train_kern[f"gru_ar_train/decoder2B/T{SEG_LEN}/float32"]),
        entry("gru_ar_bwd", "cyclevae_tpu_torch/csrc/gru_ar_bwd.cu",
              "cyclevae_tpu/ops/pallas_gru.py:272", k3_launches,
              train_kern[f"gru_ar_bwd/decoder2B/T{SEG_LEN}/float32"]),
        entry("wavernn_generate", "cyclevae_tpu_torch/csrc/wavernn.cu",
              "cyclevae_tpu/ops/pallas_wavernn.py:82", k4_launches,
              voc_kern[f"B1/sampled{VOC_TEMPERATURE}"]),
        # the main path: the converted requests rendered by the dual
        # WaveRNN through synthesize_vocoder (phase_vocode)
        entry("wavernn_generate_dual", "cyclevae_tpu_torch/csrc/wavernn.cu", None,
              k4_dual_launches, dual_kern[f"B1/sampled{VOC_TEMPERATURE}"]),
        # the main path: 390 frames rendered by PWG through synthesize_vocoder
        # (phase_pwg); the row of a later layer at the cell's longest utterance
        entry("pwg_layer", "cyclevae_tpu_torch/csrc/pwg.cu", None, pwg_launches,
              pwg_kern[f"n{PWG_FRAMES[-1] * 256}/d16/accumulate"]),
    ]}), flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_leftovers()            # also when a phase raised
    sys.exit(rc)
