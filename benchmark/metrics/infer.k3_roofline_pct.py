"""K3's share of its roofline: the least time the needed work (L
value-and-gradient evaluations a transition, 8 chains of the utterance's
frames) could take at 67 TFLOP/s or 3.35 TB/s, over the time the trace gives
K3 in the window."""

from benchmark.harness.readers import roofline_pct


def read(w):
    return roofline_pct(w, "K3")
