"""Device microseconds of one step of the dual sampler (a coarse and a fine
sample of one row): the K4 family's time in the trace over the program's
``wavernn.steps`` counter (rows x samples of every launch).  None from a
program that counts no steps."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if w.trace is None or not hasattr(profiling, "counters"):
        return None
    steps = profiling.counters().get("wavernn.steps")
    spent = w.trace.kernel_s.get("K4", 0.0)
    return 1e6 * spent / steps if steps and spent > 0 else None
