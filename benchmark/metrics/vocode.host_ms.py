"""Host milliseconds of a vocoded request: the program's top-level spans
(the conversion, the postfilter, the F0 transform, the conditioning, the
rendering), each less the ``fetch`` spans under it, where the host waits on
the device; summed over the window, per request.  None from a program that
records no spans."""

from cyclevae_tpu_torch.utils import profiling


def read(w):
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    roots = {s.id: s.seconds for s in spans if s.parent is None}
    n = w.total("requests")
    if not roots or not n:
        return None
    waits = sum(s.seconds for s in spans if s.name == "fetch" and s.request in roots)
    return 1e3 * (sum(roots.values()) - waits) / n
