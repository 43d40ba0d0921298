"""Arithmetic the metric readers share.  Every share counts the work the
traffic needs (``Window.total`` of the counts each unit reports), never the
shape launched or the calls made, over the published float32 peak."""

from __future__ import annotations

from typing import Optional

from . import peaks


def roofline_pct(w, kernel: str) -> Optional[float]:
    """The least time the kernel's needed work could take on the card
    (operations over 67 TFLOP/s or bytes over 3.35 TB/s) over the time the
    trace gives the kernel in the window."""
    if w.trace is None:
        return None
    spent = w.trace.kernel_s.get(kernel, 0.0)
    flops = w.total(f"{kernel}.flops")
    if spent <= 0 or flops <= 0:
        return None
    return 100.0 * peaks.bound_s(flops, w.total(f"{kernel}.bytes")) / spent


def mfu_pct(w) -> Optional[float]:
    """The model FLOPs the window's completed units need, per second of the
    window, over the float32 peak."""
    flops = w.total("model_flops")
    if w.window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / w.window_s / peaks.F32_FLOPS


def device_idle_pct(w) -> Optional[float]:
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
