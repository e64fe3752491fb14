"""Collection utilities (counterpart of
``deeplearning4j_tpu/utils/collections.py``): the reference behaviors with
no stdlib equivalent, all on the host — normalized and arg-max counters
(``Counter``), a two-key counter map (``CounterMap``), a disk-spilling
queue (``DiskBasedQueue``), a round-robin multi-consumer queue
(``MagicQueue``) and background-thread prefetch over any iterable
(``AsyncIterator``)."""

from __future__ import annotations

import collections
import os
import pickle
import queue
import tempfile
import threading
import weakref
from typing import Any, Dict, Hashable, Iterable, Iterator, List, Optional

# seconds ``AsyncIterator`` waits for its producer to end when the consumer
# stops: a producer blocked inside the iterable it reads is left behind
JOIN_TIMEOUT_S = 5.0


class Counter(collections.Counter):
    """berkeley/Counter.java behaviors on top of collections.Counter."""

    def arg_max(self) -> Optional[Hashable]:
        return max(self, key=self.get) if self else None

    def total_count(self) -> float:
        return float(sum(self.values()))

    def normalize(self) -> "Counter":
        total = self.total_count()
        if total > 0:
            for k in self:
                self[k] /= total
        return self

    def keep_top_n(self, n: int) -> "Counter":
        for k, _ in self.most_common()[n:]:
            del self[k]
        return self


class CounterMap:
    """key -> Counter of sub-keys (berkeley/CounterMap.java)."""

    def __init__(self):
        self._map: Dict[Hashable, Counter] = collections.defaultdict(Counter)

    def increment_count(self, key: Hashable, sub: Hashable, amount: float = 1.0):
        self._map[key][sub] += amount

    def get_count(self, key: Hashable, sub: Hashable) -> float:
        return float(self._map.get(key, Counter()).get(sub, 0.0))

    def get_counter(self, key: Hashable) -> Counter:
        return self._map[key]

    def keys(self):
        return self._map.keys()

    def total_count(self) -> float:
        return sum(c.total_count() for c in self._map.values())

    def normalize(self) -> "CounterMap":
        for c in self._map.values():
            c.normalize()
        return self


class DiskBasedQueue:
    """FIFO that spills to disk past a memory bound (reference:
    util/DiskBasedQueue.java: unbounded corpora through bounded RAM)."""

    def __init__(self, memory_items: int = 1024, dir: Optional[str] = None):
        self._mem: collections.deque = collections.deque()
        self._limit = int(memory_items)
        self._dir = dir or tempfile.mkdtemp(prefix="dl4j-queue-")
        self._spill: collections.deque = collections.deque()  # file paths
        self._count = 0
        self._lock = threading.Lock()

    def add(self, item: Any) -> None:
        with self._lock:
            if len(self._mem) < self._limit and not self._spill:
                self._mem.append(item)
            else:
                path = os.path.join(self._dir, f"item_{self._count}.pkl")
                with open(path, "wb") as f:
                    pickle.dump(item, f)
                self._spill.append(path)
            self._count += 1

    def poll(self) -> Any:
        with self._lock:
            if self._mem:
                item = self._mem.popleft()
            elif self._spill:
                path = self._spill.popleft()
                with open(path, "rb") as f:
                    item = pickle.load(f)
                os.unlink(path)
            else:
                raise IndexError("queue empty")
            # refill the memory tier from disk to keep pops cheap
            while self._spill and len(self._mem) < self._limit:
                p = self._spill.popleft()
                with open(p, "rb") as f:
                    self._mem.append(pickle.load(f))
                os.unlink(p)
            return item

    def __len__(self) -> int:
        return len(self._mem) + len(self._spill)

    def is_empty(self) -> bool:
        return len(self) == 0


class MagicQueue:
    """Round-robin multi-consumer queue (reference:
    parallelism/MagicQueue.java): each consumer lane gets its own backlog."""

    def __init__(self, n_lanes: int, capacity: int = 64):
        self._lanes: List[queue.Queue] = [
            queue.Queue(maxsize=capacity) for _ in range(max(1, n_lanes))]
        self._next = 0

    @property
    def n_lanes(self) -> int:
        return len(self._lanes)

    def add(self, item: Any) -> None:
        self._lanes[self._next].put(item)
        self._next = (self._next + 1) % len(self._lanes)

    def poll(self, lane: int, timeout: Optional[float] = None) -> Optional[Any]:
        try:
            return self._lanes[lane].get(block=timeout is not None, timeout=timeout)
        except queue.Empty:
            return None

    def size(self, lane: Optional[int] = None) -> int:
        if lane is not None:
            return self._lanes[lane].qsize()
        return sum(q.qsize() for q in self._lanes)


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


__all__ = ["AsyncIterator", "Counter", "CounterMap", "DiskBasedQueue", "MagicQueue"]
