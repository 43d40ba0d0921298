from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_np_rng,
    restore_train_state,
    save_checkpoint,
)
from .train import (
    CycleVAEConfig,
    CycleVAEParams,
    TrainState,
    cyclic_forward,
    init_cycle_state,
    init_cyclevae,
    make_eval_forward,
    make_optimizer,
    make_train_step,
    params_to,
    segment_loss,
)

__all__ = [
    "CycleVAEConfig",
    "CycleVAEParams",
    "TrainState",
    "cyclic_forward",
    "init_cycle_state",
    "init_cyclevae",
    "make_eval_forward",
    "make_optimizer",
    "make_train_step",
    "params_to",
    "segment_loss",
    "load_checkpoint",
    "latest_checkpoint",
    "restore_np_rng",
    "restore_train_state",
    "save_checkpoint",
]
