"""The 95th percentile (linear interpolation) of every conversion request
of the window, from call to return with its outputs on the host, in ms."""

import numpy as np


def read(w):
    return float(np.percentile(w.values("latency_ms"), 95))
