"""Stage 1: WORLD/SPTK feature extraction per utterance, and the F0 helpers.

A copy of ``cyclevae_tpu/pipeline/features.py`` over the port's own DSP
library (:mod:`cyclevae_tpu_torch.dsp`) and feature store
(:mod:`cyclevae_tpu_torch.utils.store`; reference
src/bin/feature_extract_vc.py).  Per wav: 70 Hz high-pass FIR -> F0 analysis
twice (speaker-bounded range + default range) -> continuous-F0 + 20 Hz
low-pass -> coded aperiodicity + mel-cepstrum -> frame power + speech-frame
extraction -> 8 datasets in the utterance's ``.npz`` + an analysis-synthesis
audit wav.  Fan-out via spawned processes over file splits; the workers run
on the host only.

Feature layout (the central data type):
  feat_org_lf0 = [uv(1), log-continuous-F0-lpf(1), codeap(2), mcep(50)] = 54 d.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
from typing import List, Optional, Tuple

import numpy as np
from scipy.interpolate import interp1d

from ..dsp import sptk, world
from ..utils.config import FeatureConfig
from ..utils.store import write_store
from ..utils.wavio import low_pass_filter, read_wav, write_wav


def convert_continuos_f0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """F0 -> (uv flags, linearly interpolated continuous F0)
    (reference feature_extract_vc.py:199-228)."""
    f0 = np.copy(f0)
    uv = np.float32(f0 != 0)
    if not (f0 != 0).any():
        return uv, f0
    start_f0 = f0[f0 != 0][0]
    end_f0 = f0[f0 != 0][-1]
    start_idx = np.where(f0 == start_f0)[0][0]
    end_idx = np.where(f0 == end_f0)[0][-1]
    f0[:start_idx] = start_f0
    f0[end_idx:] = end_f0
    nz_frames = np.where(f0 != 0)[0]
    f = interp1d(nz_frames, f0[nz_frames])
    cont_f0 = f(np.arange(0, f0.shape[0]))
    return uv, cont_f0


def convert_f0(f0: np.ndarray, f0_mean_src: float, f0_std_src: float,
               f0_mean_trg: float, f0_std_trg: float) -> np.ndarray:
    """Log-Gaussian F0 transform (reference feature_extract_vc.py:116-121)."""
    nonzero = f0 > 0
    cvf0 = np.zeros(len(f0))
    cvf0[nonzero] = np.exp((f0_std_trg / f0_std_src)
                           * (np.log(f0[nonzero]) - f0_mean_src) + f0_mean_trg)
    return cvf0


def convert_linf0(f0: np.ndarray, f0_mean_src: float, f0_std_src: float,
                  f0_mean_trg: float, f0_std_trg: float) -> np.ndarray:
    """Linear-domain F0 transform (reference feature_extract_vc.py:124-129;
    unused by the shipped flow but part of the surface — the stats stage
    records linear-domain F0 mean/std for it, calc_stats_vc.py:126-135)."""
    nonzero = f0 > 0
    cvf0 = np.zeros(len(f0))
    cvf0[nonzero] = (f0_std_trg / f0_std_src) * (f0[nonzero] - f0_mean_src) \
        + f0_mean_trg
    return cvf0


def mod_pow(cvmcep: np.ndarray, mcep: np.ndarray, alpha: float = 0.455,
            irlen: int = 1024, ref_e: np.ndarray = None) -> np.ndarray:
    """Power correction: move converted mcep c0 so frame energy matches the
    original (reference feature_extract_vc.py:131-138).  ``ref_e``: optional
    precomputed mc2e(mcep) — decode_pair reuses the same reference energies
    across its 6 mod_pow calls (stage-6 hot path)."""
    cv_e = sptk.mc2e(cvmcep, alpha=alpha, irlen=irlen)
    r_e = ref_e if ref_e is not None else sptk.mc2e(mcep, alpha=alpha,
                                                    irlen=irlen)
    dpow = np.log(r_e / cv_e) / 2
    mod_cvmcep = np.copy(cvmcep)
    mod_cvmcep[:, 0] += dpow
    return mod_cvmcep


def spc2npow(spectrogram: np.ndarray) -> np.ndarray:
    """Normalized frame power in dB (reference feature_extract_vc.py:153-171)."""
    fftl2 = spectrogram.shape[1] - 1
    fftl = fftl2 * 2
    power = (spectrogram[:, 0] + spectrogram[:, fftl2]
             + 2.0 * np.sum(spectrogram[:, 1:fftl2], axis=1)) / fftl
    meanpow = np.mean(power)
    return 10.0 * np.log10(power / meanpow)


def extfrm(data: np.ndarray, npow: np.ndarray,
           power_threshold: float = -20.0) -> Tuple[np.ndarray, np.ndarray]:
    """Speech-frame extraction by power threshold (reference :141-150)."""
    if data.shape[0] != len(npow):
        raise ValueError("Length of two vectors is different.")
    valid_index = np.where(npow > power_threshold)
    return data[valid_index], valid_index


def analyze(x: np.ndarray, fs: int, minf0: Optional[float] = None,
            maxf0: Optional[float] = None, fperiod: float = 5.0,
            fftl: int = 1024):
    """WORLD-class analysis: (time_axis, f0, envelope, aperiodicity).
    With minf0/maxf0 -> speaker-bounded range (reference analyze_range :96-104);
    without -> default range (analyze :80-93)."""
    f0_floor = minf0 if minf0 is not None else 60.0
    f0_ceil = maxf0 if maxf0 is not None else 700.0
    _f0, time_axis = world.harvest(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                                   frame_period=fperiod)
    f0 = world.stonemask(x, _f0, time_axis, fs)
    sp = world.cheaptrick(x, f0, time_axis, fs, fftl)
    ap = world.d4c(x, f0, time_axis, fs, fftl)
    return time_axis, f0, sp, ap


def extract_one(wav_path: str, store_path: str, anasyn_wav_path: Optional[str],
                cfg: FeatureConfig, minf0: float, maxf0: float,
                pow_threshold: float) -> int:
    """Extract features for one utterance into ``store_path``; returns
    n_frames (reference feature_extract :321-408)."""
    fs, x = read_wav(wav_path, cutoff=cfg.highpass_cutoff)
    if fs != cfg.fs:
        raise ValueError(f"sampling frequency mismatch: {fs} != {cfg.fs}")

    _, f0_range, spc_range, ap_range = analyze(
        x, fs, minf0=minf0, maxf0=maxf0, fperiod=cfg.shiftms, fftl=cfg.fftl)
    write_store(store_path, "/f0_range", f0_range)
    _, f0, spc, ap = analyze(x, fs, fperiod=cfg.shiftms, fftl=cfg.fftl)
    write_store(store_path, "/f0", f0)

    uv, cont_f0 = convert_continuos_f0(np.array(f0))
    uv_range, cont_f0_range = convert_continuos_f0(np.array(f0_range))
    frame_fs = int(1.0 / (cfg.shiftms * 0.001))
    cont_f0_lpf = low_pass_filter(cont_f0, frame_fs, cutoff=cfg.lowpass_cutoff)
    cont_f0_lpf_range = low_pass_filter(cont_f0_range, frame_fs,
                                        cutoff=cfg.lowpass_cutoff)

    codeap_range = world.code_aperiodicity(ap_range, fs)
    mcep = sptk.sp2mc(spc, cfg.mcep_dim, cfg.mcep_alpha)
    mcep_range = sptk.sp2mc(spc_range, cfg.mcep_dim, cfg.mcep_alpha)

    npow = spc2npow(spc)
    npow_range = spc2npow(spc_range)
    mcepspc_range, spcidx_range = extfrm(mcep_range, npow_range,
                                         power_threshold=pow_threshold)

    uv_range_c = np.expand_dims(uv_range, -1)
    cont_f0_lpf_range_c = np.expand_dims(cont_f0_lpf_range, -1)
    if codeap_range.ndim == 1:
        codeap_range = np.expand_dims(codeap_range, -1)

    feat_org_lf0 = np.c_[uv_range_c, np.log(cont_f0_lpf_range_c),
                         codeap_range, mcep_range]
    write_store(store_path, "/feat_org_lf0", feat_org_lf0)
    write_store(store_path, "/mcep_range", mcep_range)
    write_store(store_path, "/npow", npow)
    write_store(store_path, "/npow_range", npow_range)
    write_store(store_path, "/mcepspc_range", mcepspc_range)
    write_store(store_path, "/spcidx_range", spcidx_range)

    if anasyn_wav_path is not None:
        sp_rec = sptk.mc2sp(mcep_range, cfg.mcep_alpha, cfg.fftl)
        wav = world.synthesize(f0, sp_rec, ap_range, fs,
                               frame_period=cfg.shiftms)
        write_wav(anasyn_wav_path, fs, wav)
    return feat_org_lf0.shape[0]


def _worker(wav_list: List[str], storedir: str, wavdir: Optional[str],
            cfg: FeatureConfig, minf0: float, maxf0: float,
            pow_threshold: float, arr):
    n_frames = 0
    for wav_name in wav_list:
        store = os.path.join(storedir,
                             os.path.basename(wav_name).replace(".wav", ".npz"))
        anasyn = (os.path.join(wavdir, os.path.basename(wav_name))
                  if wavdir else None)
        n_frames += extract_one(wav_name, store, anasyn, cfg, minf0, maxf0,
                                pow_threshold)
        logging.info("extracted %s", wav_name)
    with arr.get_lock():
        arr[0] += len(wav_list)
        arr[1] += n_frames


def extract_features(wav_files: List[str], storedir: str,
                     wavdir: Optional[str], cfg: FeatureConfig,
                     minf0: float, maxf0: float, pow_threshold: float,
                     n_jobs: int = 10) -> Tuple[int, int]:
    """Parallel feature extraction (reference mp fan-out :410-427).
    Returns (n_files_processed, n_frames_total)."""
    os.makedirs(storedir, exist_ok=True)
    if wavdir:
        os.makedirs(wavdir, exist_ok=True)
    # no worker without files: each spawned worker pays its imports, and the
    # JAX package's fan-out spawns n_jobs of them even for one file
    n_jobs = max(1, min(n_jobs, len(wav_files)))
    file_lists = [fl.tolist() for fl in np.array_split(wav_files, n_jobs)]
    # spawn, not fork: the recipe's process holds threads (torch's, the
    # decode pools), and fork from a threaded process can deadlock; the
    # workers import the port but never touch CUDA
    ctx = mp.get_context("spawn")
    arr = ctx.Array("d", 2)
    procs = []
    for fl in file_lists:
        p = ctx.Process(target=_worker, args=(fl, storedir, wavdir, cfg, minf0,
                                              maxf0, pow_threshold, arr))
        p.start()
        procs.append(p)
    for p in procs:
        p.join()
        if p.exitcode != 0:
            raise RuntimeError(f"feature extraction worker failed: {p.exitcode}")
    return int(arr[0]), int(arr[1])
