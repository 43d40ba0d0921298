"""Data parallelism over ``torch.distributed`` processes: the counterpart of
``cyclevae_tpu/parallel`` (see ``parallel.mesh``).  ``parallel.launch``
starts a module in each process of a group, ``parallel.spawn`` runs a
function in spawned ranks, ``parallel.dryrun`` drives the sharded train
step and samplers once."""

from .mesh import (
    make_mesh,
    make_sharded_train_step,
    shard_batch,
    replicate,
)

__all__ = ["make_mesh", "make_sharded_train_step", "shard_batch", "replicate"]
