"""The model FLOPs the window's transitions need (L value-and-gradient
evaluations a transition, each the decoder's forward products and as many
again for the input gradient), per second of the window, over 67 TFLOP/s."""

from benchmark.harness.readers import mfu_pct


def read(w):
    return mfu_pct(w)
