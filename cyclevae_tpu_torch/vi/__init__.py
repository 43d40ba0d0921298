from .checkpoint import latest_checkpoint, load_checkpoint
from .train import CycleVAEConfig, CycleVAEParams, init_cyclevae, params_to

__all__ = [
    "CycleVAEConfig",
    "CycleVAEParams",
    "init_cyclevae",
    "params_to",
    "load_checkpoint",
    "latest_checkpoint",
]
