"""Milliseconds a conversion request waits on the device: the ``fetch``
spans (the program's blocking copies to the host) under each
``decode.device_decode_pair`` root span, summed; the mean over the window's
requests.  None from a program that records no spans."""

from cyclevae_tpu_torch.utils import profiling

ROOT = "decode.device_decode_pair"


def read(w):
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    roots = {s.id for s in spans if s.name == ROOT and s.parent is None}
    if not roots:
        return None
    waits = sum(s.seconds for s in spans if s.name == "fetch" and s.request in roots)
    return 1e3 * waits / len(roots)
