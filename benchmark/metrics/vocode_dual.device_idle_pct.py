"""The share of the traced window in which no operation ran on the device
(1 - busy / window, busy the union of the device operations' intervals)."""

from benchmark.harness.readers import device_idle_pct


def read(w):
    return device_idle_pct(w)
