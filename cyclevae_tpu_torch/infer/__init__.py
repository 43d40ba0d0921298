"""Posterior inference over CycleVAE latents: HMC, NUTS and SMC.

PyTorch counterpart of ``cyclevae_tpu/infer``: the single-device samplers
and their sharded variants over a ``parallel.Mesh`` of processes.  Random
numbers come from a ``Draws`` (``infer.draws``), one ``torch.Generator`` on
the chains' device.
"""

from .draws import Draws
from .dual_averaging import DualAveragingState, da_final, da_init, da_update
from .hmc import (HMCConfig, hmc_sample, hmc_sample_batch, hmc_sample_chains,
                  hmc_sample_sharded)
from .logjoint import make_utterance_logjoint, make_utterance_logjoint_batched
from .nuts import NUTSConfig, nuts_sample, nuts_sample_chains, nuts_sample_sharded
from .nuts_batch import nuts_sample_batch
from .smc import SMCConfig, make_decoder_ssm, smc_filter, smc_filter_sharded

__all__ = [
    "Draws",
    "make_utterance_logjoint", "make_utterance_logjoint_batched",
    "hmc_sample", "hmc_sample_batch", "hmc_sample_chains", "hmc_sample_sharded", "HMCConfig",
    "nuts_sample", "nuts_sample_chains", "nuts_sample_batch", "nuts_sample_sharded",
    "NUTSConfig",
    "smc_filter", "smc_filter_sharded", "make_decoder_ssm", "SMCConfig",
    "DualAveragingState", "da_init", "da_update", "da_final",
]
