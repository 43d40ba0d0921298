"""Launches of the PWG layer kernel a request: the program's
``pwg.layer_launches`` counter (one a launch) over the window's requests;
30 where each of the 30 layers is one launch, 0 where the plain layer runs
(the CPU).  None from a program that counts no PWG samples
(``pwg.samples``)."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    n = w.total("requests")
    if "pwg.samples" not in c or not n:
        return None
    return c.get("pwg.layer_launches", 0) / n
