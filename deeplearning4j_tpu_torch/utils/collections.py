"""Background-thread prefetch over any iterable (counterpart of
``deeplearning4j_tpu/utils/collections.py:AsyncIterator``)."""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Iterable, Iterator, List

# seconds ``AsyncIterator`` waits for its producer to end when the consumer
# stops: a producer blocked inside the iterable it reads is left behind
JOIN_TIMEOUT_S = 5.0


class AsyncIterator:
    """Background-thread prefetch over any iterable (reference:
    parallelism/AsyncIterator.java). Each iteration starts one producer
    thread that feeds a queue of at most ``queue_size`` items; an exception
    the producer meets is raised again in the consumer after the items
    before it. A consumer that stops early (its generator closed or
    collected), or :meth:`close`, stops the producer and joins it, waiting at
    most ``JOIN_TIMEOUT_S`` seconds."""

    _SENTINEL = object()

    def __init__(self, base: Iterable, queue_size: int = 8):
        if int(queue_size) < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        self._base = base
        self._size = int(queue_size)
        self._live: "weakref.WeakSet" = weakref.WeakSet()

    def __iter__(self) -> Iterator:
        gen = self._run()
        self._live.add(gen)
        return gen

    def close(self) -> None:
        """Stop and join every producer this object started."""
        for gen in list(self._live):
            gen.close()

    def _run(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self._size)
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._base:
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer, raised there
                err.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True, name="async-iterator")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=JOIN_TIMEOUT_S)
        if err:
            raise err[0]


__all__ = ["AsyncIterator"]
