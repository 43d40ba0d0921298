"""K2 and K3 launches of the window (the kernel wrappers' counters) per
chain transition."""


def read(w):
    n = w.total("transitions")
    return (w.launches["K2"] + w.launches["K3"]) / n if n else None
