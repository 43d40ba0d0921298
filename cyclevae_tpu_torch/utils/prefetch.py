"""Threaded prefetch generator (+ decorator).

A copy of ``cyclevae_tpu/utils/prefetch.py``.  Reference surface:
src/utils/utils.py:162-211 (BackgroundGenerator and the ``@background``
decorator; unused by the shipped binaries but part of the API).  Here it
earns its keep for host-side pipelines: stage-1 file reads and batch
collation can run one step ahead of device dispatch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class BackgroundGenerator:
    """Wrap an iterable so items are produced on a background thread and
    buffered in a bounded queue (``max_prefetch`` items ahead)."""

    _SENTINEL = object()

    def __init__(self, generator: Iterable, max_prefetch: int = 1):
        self.queue: "queue.Queue" = queue.Queue(max_prefetch)
        self._exc = None

        def run():
            try:
                for item in generator:
                    self.queue.put(item)
            except BaseException as e:  # surface worker errors to the consumer
                self._exc = e
            finally:
                self.queue.put(self._SENTINEL)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self.queue.get()
        if item is self._SENTINEL:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


def background(max_prefetch: int = 1):
    """Decorator: make a generator function produce through a prefetch thread."""

    def decorate(fn):
        def wrapped(*args, **kwargs):
            return BackgroundGenerator(fn(*args, **kwargs), max_prefetch)
        return wrapped

    return decorate
