"""Batched log-joint evaluations (the program's ``logjoint.evals`` counter,
one a call over all chains) per chain transition of the window.  None from
a program that counts none."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if not hasattr(profiling, "counters"):
        return None
    evals = profiling.counters().get("logjoint.evals")
    n = w.total("transitions")
    return evals / n if evals is not None and n else None
