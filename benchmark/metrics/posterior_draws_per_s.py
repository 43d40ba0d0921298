"""Chain transitions completed in the window (counted through the
benchmark's draws: one accept uniform a transition) times the chains, over
the window's seconds (host clock; an utterance ends with its posterior
statistics on the host)."""


def read(w):
    return w.total("draws") / w.window_s
