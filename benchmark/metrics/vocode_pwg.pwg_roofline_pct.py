"""The PWG layer kernel's share of its roofline: the least time the
window's layer launches need (``work/pwg.py``: 79,360 operations a sample
and layer, x, c and skip moved once) could take at 67 TFLOP/s or 3.35 TB/s,
over the device seconds the trace gives the operations whose names match
``pwg_layer``.  None without a trace, or where no such operation ran."""

import re

from benchmark.harness import peaks

PATTERN = re.compile(r"pwg_layer")


def read(w):
    if w.trace is None:
        return None
    spent = sum(s for name, s in w.trace.device_s_by_name.items() if PATTERN.search(name))
    flops = w.total("PWG.flops")
    if spent <= 0 or flops <= 0:
        return None
    return 100.0 * peaks.bound_s(flops, w.total("PWG.bytes")) / spent
