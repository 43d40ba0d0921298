"""The median of every conversion request of the window, in ms (the
benchmark's own span around the call)."""

import numpy as np


def read(w):
    return float(np.median(w.values("latency_ms")))
