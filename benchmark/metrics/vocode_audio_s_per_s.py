"""Seconds of audio rendered by every request completed in the window,
over the window's seconds (host clock; a request ends with its waveform
on the host)."""


def read(w):
    return w.total("audio_s") / w.window_s
