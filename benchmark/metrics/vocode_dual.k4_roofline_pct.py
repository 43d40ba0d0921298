"""The dual instantiation of K4's share of its roofline: the least time the
samples' needed work (``work/wavernn_dual.py``) could take at 67 TFLOP/s or
3.35 TB/s, over the time the trace gives the K4 family in the window."""

from benchmark.harness.readers import roofline_pct


def read(w):
    return roofline_pct(w, "K4")
