"""Blocking copies from the device to the host (the program's
``device_waits`` counter) per conversion request of the window.  None from
a program that counts none."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if not hasattr(profiling, "counters"):
        return None
    waits = profiling.counters().get("device_waits")
    n = w.total("requests")
    return waits / n if waits is not None and n else None
