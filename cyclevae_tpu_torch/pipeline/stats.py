"""Stages a/2/3: speaker statistics, joint statistics, converted excitation.

A copy of ``cyclevae_tpu/pipeline/stats.py`` over the port's feature store
(:mod:`cyclevae_tpu_torch.utils.store`), the many-to-many stage 3
(``extract_cv_excitation_mult``) included.
Reference: src/bin/spk_stat.py (stage a: F0/power histograms for conf files),
calc_stats_vc.py (stage 2: per-speaker streaming mean/scale + GV + F0 stats),
calc_stats_vc_joint.py (joint src+trg stats used for model normalization),
feature_cv_extract_vc.py (stage 3: converted excitation /cvuvlogf0fil_ap).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.store import read_store, write_store
from ..utils.wavio import low_pass_filter
from .features import convert_continuos_f0, convert_f0


class StreamingMeanScale:
    """Streaming mean/std over frames (StandardScaler.partial_fit semantics:
    population std; reference calc_stats_vc.py:70,85)."""

    def __init__(self):
        self.n = 0
        self.mean = None
        self.m2 = None

    def partial_fit(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        if self.mean is None:
            self.mean = np.zeros(x.shape[1])
            self.m2 = np.zeros(x.shape[1])
        for_batch_n = x.shape[0]
        batch_mean = x.mean(axis=0)
        batch_m2 = ((x - batch_mean) ** 2).sum(axis=0)
        delta = batch_mean - self.mean
        tot = self.n + for_batch_n
        self.mean = self.mean + delta * for_batch_n / tot
        self.m2 = self.m2 + batch_m2 + delta ** 2 * self.n * for_batch_n / tot
        self.n = tot

    @property
    def scale(self) -> np.ndarray:
        return np.sqrt(self.m2 / self.n)


def spk_stat(feat_files: List[str], out_dir: str, spk: str):
    """Stage a: concatenate /f0 + /npow over a speaker's files; write
    histograms + suggested conf values (reference spk_stat.py:125-147)."""
    os.makedirs(out_dir, exist_ok=True)
    f0s, npows = [], []
    for f in feat_files:
        f0s.append(read_store(f, "/f0"))
        npows.append(read_store(f, "/npow"))
    f0 = np.concatenate(f0s)
    npow = np.concatenate(npows)
    f0v = f0[f0 > 0]
    np.savetxt(os.path.join(out_dir, f"{spk}.f0.txt"), f0v)
    np.savetxt(os.path.join(out_dir, f"{spk}.pow.txt"), npow)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].hist(f0v, bins=200)
        axes[0].set_title(f"{spk} F0 (voiced)")
        axes[1].hist(npow, bins=200)
        axes[1].set_title(f"{spk} frame power (dB)")
        fig.savefig(os.path.join(out_dir, f"{spk}_hist.png"))
        plt.close(fig)
    except Exception as e:  # headless-safe
        logging.warning("histogram plotting skipped: %s", e)
    # suggested analysis bounds (the reference leaves this to a human reading
    # the histogram; provide percentile-based suggestions)
    sugg_min = float(np.percentile(f0v, 0.5)) if len(f0v) else 40.0
    sugg_max = float(np.percentile(f0v, 99.5)) if len(f0v) else 700.0
    sugg_pow = float(np.percentile(npow, 10.0)) if len(npow) else -20.0
    return {"f0_min": sugg_min, "f0_max": sugg_max, "pow_threshold": sugg_pow}


def calc_stats(feat_files: List[str], stats_path: str,
               spkr: Optional[str] = None):
    """Stage 2 per-speaker stats (reference calc_stats_vc.py:70-150)."""
    scaler = StreamingMeanScale()
    var_range = []
    f0s_range = np.empty((0,))
    for filename in feat_files:
        feat = read_store(filename, "/feat_org_lf0")
        scaler.partial_fit(feat)
        if spkr is None or spkr in filename:
            mcep_range = read_store(filename, "/mcep_range")
            var_range.append(np.var(mcep_range, axis=0))
            f0_range = read_store(filename, "/f0_range")
            f0s_range = np.concatenate([f0s_range, f0_range[np.nonzero(f0_range)]])
    write_store(stats_path, "/mean_feat_org_lf0", scaler.mean)
    write_store(stats_path, "/scale_feat_org_lf0", scaler.scale)
    write_store(stats_path, "/gv_range_mean", np.mean(np.array(var_range), axis=0))
    write_store(stats_path, "/gv_range_var", np.var(np.array(var_range), axis=0))
    write_store(stats_path, "/f0_range_mean", np.mean(f0s_range))
    write_store(stats_path, "/f0_range_std", np.std(f0s_range))
    write_store(stats_path, "/lf0_range_mean", np.mean(np.log(f0s_range)))
    write_store(stats_path, "/lf0_range_std", np.std(np.log(f0s_range)))


def calc_stats_joint(feat_files_src: List[str], feat_files_trg: List[str],
                     stats_path: str):
    """Stage 2 joint stats (reference calc_stats_vc_joint.py:80-127)."""
    scaler = StreamingMeanScale()
    for filename in feat_files_src + feat_files_trg:
        scaler.partial_fit(read_store(filename, "/feat_org_lf0"))
    write_store(stats_path, "/mean_feat_org_lf0_jnt", scaler.mean)
    write_store(stats_path, "/scale_feat_org_lf0_jnt", scaler.scale)


def _ap_dims(fs: int) -> Tuple[int, int]:
    """Aperiodicity slice of feat_org_lf0 (reference feature_cv_extract:103-117)."""
    endim = {44100: 7, 22050: 4, 24000: 5, 48000: 8}.get(fs, 4)
    return 2, endim


def extract_cv_excitation(feat_files: List[str], stats_self: str,
                          stats_other: str, fs: int, shiftms: float = 5.0):
    """Stage 3: convert each utterance's F0 to the partner speaker's log-F0
    stats, rebuild continuous F0 + uv, concat with original aperiodicity, and
    write /cvuvlogf0fil_ap back into the same store file
    (reference feature_cv_extract_vc.py:119-148)."""
    lm_self = read_store(stats_self, "/lf0_range_mean")
    ls_self = read_store(stats_self, "/lf0_range_std")
    lm_other = read_store(stats_other, "/lf0_range_mean")
    ls_other = read_store(stats_other, "/lf0_range_std")
    stdim, endim = _ap_dims(fs)
    frame_fs = int(1.0 / (shiftms * 0.001))
    for filename in feat_files:
        ap = read_store(filename, "/feat_org_lf0")[:, stdim:endim]
        f0 = read_store(filename, "/f0_range")
        cvf0 = convert_f0(f0, lm_self, ls_self, lm_other, ls_other)
        cvuv, cont_f0 = convert_continuos_f0(cvf0)
        cvuv = np.expand_dims(cvuv, axis=-1)
        cont_f0_lpf = low_pass_filter(cont_f0, frame_fs, cutoff=20)
        cvlogf0fil = np.expand_dims(np.log(cont_f0_lpf), axis=-1)
        write_store(filename, "/cvuvlogf0fil_ap", np.c_[cvuv, cvlogf0fil, ap])


def extract_cv_excitation_mult(feat_files: List[str], stats_self: str,
                               partner_stats: Dict[str, str], fs: int,
                               shiftms: float = 5.0):
    """Many-to-many stage 3: one converted-excitation dataset PER partner
    speaker, keyed ``/cvuvlogf0fil_ap_<spk>`` (reference dataset.py:114-131
    read contract).  ``partner_stats``: {spk_name: stats file path}."""
    lm_self = read_store(stats_self, "/lf0_range_mean")
    ls_self = read_store(stats_self, "/lf0_range_std")
    stdim, endim = _ap_dims(fs)
    frame_fs = int(1.0 / (shiftms * 0.001))
    for filename in feat_files:
        ap = read_store(filename, "/feat_org_lf0")[:, stdim:endim]
        f0 = read_store(filename, "/f0_range")
        for spk, stats_other in partner_stats.items():
            lm_o = read_store(stats_other, "/lf0_range_mean")
            ls_o = read_store(stats_other, "/lf0_range_std")
            cvf0 = convert_f0(f0, lm_self, ls_self, lm_o, ls_o)
            cvuv, cont_f0 = convert_continuos_f0(cvf0)
            cvuv = np.expand_dims(cvuv, axis=-1)
            cont_f0_lpf = low_pass_filter(cont_f0, frame_fs, cutoff=20)
            cvlogf0fil = np.expand_dims(np.log(cont_f0_lpf), axis=-1)
            write_store(filename, f"/cvuvlogf0fil_ap_{spk}", np.c_[cvuv, cvlogf0fil, ap])
