"""Neural-vocoder synthesis (WaveRNN-class): conditioning and sampling.

PyTorch counterpart of the synthesis half of
``cyclevae_tpu/pipeline/vocoder_stage.py``: ``synthesize_vocoder`` renders
frame features to a waveform through the AR sampler (the CUDA kernel K4 on
the card), ``converted_conditioning`` assembles the conditioning of a
converted utterance.  Training (``sample_clips``, ``run_train_vocoder``) and
the copy-synthesis eval (``eval_copy_synthesis``) need the HDF5 feature store
and the WORLD analysis, which are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.wavernn import WaveRNNConfig, generate_reference, mulaw_decode, upsample_cond
from ..ops.cuda_wavernn import cuda_wavernn_generate
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from ..utils.wavio import low_pass_filter
from .features import convert_continuos_f0


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
    params = tree_map(lambda t: t.to(device), params)
    cond = upsample_cond(params, cfg, torch.as_tensor(feats, device=device)[None])
    if use_pallas:
        idx = cuda_wavernn_generate(params, cfg, cond, seed=seed, temperature=temperature)[0]
    else:
        idx = generate_reference(params, cfg, cond[0], temperature,
                                 generator=torch.Generator(device=device).manual_seed(seed))
    return mulaw_decode(idx, cfg.n_classes).cpu().numpy()


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
    uv, contf0 = convert_continuos_f0(np.array(cvf0))
    cont_lpf = low_pass_filter(contf0, int(1.0 / (shiftms * 0.001)), cutoff=20)
    # degenerate all-unvoiced trajectory: the continuous F0 is 0 everywhere
    # and log() would poison the conditioning with -inf; floor at 1 Hz
    # (uv = 0 already tells the vocoder these frames are unvoiced)
    cont_lpf = np.maximum(cont_lpf, 1.0)
    n_codeap = src_feat.shape[1] - 2 - cvmcep.shape[1]
    return np.c_[uv[:, None], np.log(cont_lpf)[:, None],
                 src_feat[:, 2:2 + n_codeap], cvmcep].astype(np.float32)
