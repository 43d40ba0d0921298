"""K2 and K3 launches of the window (the kernel wrappers' counters) per
train step."""


def read(w):
    steps = w.total("steps")
    return (w.launches["K2"] + w.launches["K3"]) / steps if steps else None
