"""Posterior inference over CycleVAE latents: HMC, NUTS and SMC.

PyTorch counterpart of ``cyclevae_tpu/infer`` (the single-device samplers;
the sharded variants are not ported yet).  Random numbers come from a
``Draws`` (``infer.draws``), one ``torch.Generator`` on the chains' device.
"""

from .draws import Draws
from .dual_averaging import DualAveragingState, da_final, da_init, da_update
from .hmc import HMCConfig, hmc_sample, hmc_sample_batch, hmc_sample_chains
from .logjoint import make_utterance_logjoint, make_utterance_logjoint_batched
from .nuts import NUTSConfig, nuts_sample, nuts_sample_chains
from .nuts_batch import nuts_sample_batch
from .smc import SMCConfig, make_decoder_ssm, smc_filter

__all__ = [
    "Draws",
    "make_utterance_logjoint", "make_utterance_logjoint_batched",
    "hmc_sample", "hmc_sample_batch", "hmc_sample_chains", "HMCConfig",
    "nuts_sample", "nuts_sample_chains", "nuts_sample_batch", "NUTSConfig",
    "smc_filter", "make_decoder_ssm", "SMCConfig",
    "DualAveragingState", "da_init", "da_update", "da_final",
]
