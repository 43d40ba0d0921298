"""K3's share of its roofline: the least time its needed work (real frames
or samples only) could take at 67 TFLOP/s or 3.35 TB/s, over the time the
trace gives K3 in the window."""

from benchmark.harness.readers import roofline_pct


def read(w):
    return roofline_pct(w, "K3")
