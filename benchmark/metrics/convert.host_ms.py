"""Host milliseconds of a conversion request: each ``device_decode_pair``
root span (``decode.device_decode_pair``, the program's own clock) less the
``fetch`` spans under it, where the host waits on the device; the mean over
the window's requests, so that stalls count.  None from a program that
records no spans."""

from cyclevae_tpu_torch.utils import profiling

ROOT = "decode.device_decode_pair"


def read(w):
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    roots = {s.id: s.seconds for s in spans if s.name == ROOT and s.parent is None}
    if not roots:
        return None
    waits = sum(s.seconds for s in spans if s.name == "fetch" and s.request in roots)
    return 1e3 * (sum(roots.values()) - waits) / len(roots)
