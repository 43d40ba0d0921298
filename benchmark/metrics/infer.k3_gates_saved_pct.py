"""The share of the window's K3 launches that read the training forward's
gates instead of recomputing them (the program's ``gru_bwd.gates_saved``
and ``gru_bwd.gates_recomputed`` counters, one a launch), in percent.  None
from a program that counts neither."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    saved, recomputed = c.get("gru_bwd.gates_saved", 0), c.get("gru_bwd.gates_recomputed", 0)
    n = saved + recomputed
    return 100.0 * saved / n if n else None
