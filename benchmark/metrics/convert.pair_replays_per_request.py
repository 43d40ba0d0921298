"""CUDA graph replays of the conversion engine's device phase (the
program's ``codec.pair_replays`` counter, one a replay of a padded length's
graph) per conversion request of the window: whether the request ran as
one replay; 0 where the phase runs directly (a CPU codec).  None from a
program that counts none."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if not hasattr(profiling, "counters"):
        return None
    runs = profiling.counters().get("codec.pair_replays")
    n = w.total("requests")
    return runs / n if runs is not None and n else None
