"""The model FLOPs of the real frames and samples the window's completed
units needed (the dual sampler's counted by ``work/wavernn_dual.py``), per
second of the window, over 67 TFLOP/s (float32)."""

from benchmark.harness.readers import mfu_pct


def read(w):
    return mfu_pct(w)
