"""Real (unpadded) frames of every train step completed in the window, over
the window's seconds (host clock; each step ends in a host copy of its
metrics)."""


def read(w):
    return w.total("frames") / w.window_s
