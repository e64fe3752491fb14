"""Process-wide cache of captured programs (counterpart of
``deeplearning4j_tpu/runtime/compile_manager.py``).

The JAX package compiles each program once per abstract signature and keeps
the executable in one process-wide LRU, shared by training and serving. The
port's counterpart of an executable is a CUDA graph: a captured training
step (``runtime.step_graphs``, kind ``train_step``) or one bucket of the
served forward (``runtime.inference``, kinds ``mln_infer``,
``mln_rnn_step``, ``graph_infer``, ``graph_rnn_step``). On the card an entry
is such a graph and a "compile" is its capture (its warm-up runs included),
counted and timed; on the CPU, which a caller asks for with
``device="cpu"``, an entry is the eager callable of the same bucket, so the
counting holds there too.

- **Canonical keys.** Entries are keyed by hashables and the shapes and
  dtypes of their arrays (:func:`signature`), never by values. A key starts
  with its owner's token (:meth:`CompileManager.new_token`, one per
  ``init()`` of a network), so :meth:`CompileManager.drop_token` retires a
  generation's graphs at once, and the graphs never outlive the params
  they read.
- **Bounded.** One LRU of ``max_entries`` (64, as in the JAX package) for
  every kind; the least recently used entry is dropped first, and an
  entry's ``on_evict`` hook tells its owner (a network's ``StepGraphs``).
- **Measured.** ``dl4jtpu_compiles_total``, ``dl4jtpu_compile_seconds``,
  ``dl4jtpu_compile_cache_hits_total``,
  ``dl4jtpu_compile_cache_evictions_total`` and
  ``dl4jtpu_compile_cache_size`` keep the JAX package's names;
  ``dl4jtpu_executable_hbm_bytes{kind}`` reads the graphs' memory pools
  (``telemetry.memory.executable_memory``: kinds ``reserved`` and
  ``allocated``), summed once per pool, since every graph of one network
  draws on one pool.

- **One capture at a time, and nothing else on the card meanwhile.** A
  capture runs under ``torch.cuda.graph``'s default
  ``capture_error_mode="global"``, where a synchronizing or allocating
  CUDA call from any other thread fails that call or invalidates the
  capture. The rule: every capture (a training step's, ``nn.multilayer``
  ``_capture``; a served bucket's, ``runtime.inference.ServedGraph.
  capture``) holds :func:`capture_lock` exclusively, and every other piece
  of the runtime that issues CUDA work from a thread of its own holds it
  shared for that work: a served dispatch (request copy, replay, host
  copy of the result: ``runtime.inference._dispatch``), a staged window's
  replays and its losses' read (``_start_window``, ``_finish_window``),
  the prefetch ring's copies (``DevicePrefetchIterator.start_copy``), a
  hot swap's copies (``swap_params``), a checkpoint's snapshot, its
  writer's host copy and a rollback's load (``runtime.checkpoint``). A
  thread that holds it shared and must capture gives up its shared hold
  for the capture and takes it back after, so two such threads never
  wait on each other. The lock is taken after a network's
  ``_infer_lock``, never before it. Work that another library's thread
  sends to the card is outside the rule.

What has no counterpart here: XLA's persistent disk cache (a CUDA graph
cannot be saved; every process captures anew), the IR findings family and
the static cost records of the JAX package's admission scan, and
``kernel_select`` (the port has no roofline selection). The
JAX ``stats()`` keys that read them are left out.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Any, Callable, Optional, Tuple

__all__ = ["CaptureLock", "CompileManager", "capture_lock", "get_compile_manager",
           "next_pow2", "signature"]

# capture times span well under a second (a small net on the CPU) to
# seconds (ResNet-50's warm-up run, cuDNN's first choices, the capture)
COMPILE_TIME_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                        60.0, 120.0, 300.0)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the row, time and window bucket
    function, so the set of shapes stays logarithmic in the sizes seen."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _part(x: Any):
    """One part of a key: a tensor or array by its shape and dtype, lists,
    tuples and dicts element by element, anything else as it is."""
    shape = getattr(x, "shape", None)
    if shape is not None and hasattr(x, "dtype"):
        return ("array", tuple(int(d) for d in shape), str(x.dtype))
    if isinstance(x, dict):
        return ("dict", tuple((k, _part(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_part(v) for v in x))
    return x


def signature(*parts) -> Tuple:
    """Canonical cache key from hashables and nested tensors or arrays
    (``None`` stands for an absent mask)."""
    return tuple(_part(p) for p in parts)


class CaptureLock:
    """A shared/exclusive lock for the capture rule (see the module doc):
    :meth:`exclusive` for a capture, :meth:`shared` for other CUDA work.
    Both nest on one thread. A thread that holds it shared and asks for it
    exclusively gives up its shared holds while it waits and captures, and
    has them back when the capture is done. Waiting captures go before new
    shared holders, so a stream of dispatches cannot starve a capture."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers: dict = {}  # thread id -> shared holds
        self._writer = None
        self._depth = 0
        self._waiting = 0
        self.exclusive_total = 0  # captures that took it

    @contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer != me and not self._readers.get(me):
                while self._writer is not None or self._waiting:
                    self._cond.wait()
            self._readers[me] = self._readers.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                n = self._readers[me] - 1
                if n:
                    self._readers[me] = n
                else:
                    del self._readers[me]
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
                held = None
            else:
                held = self._readers.pop(me, 0)
                if held:
                    self._cond.notify_all()
                self._waiting += 1
                while self._writer is not None or self._readers:
                    self._cond.wait()
                self._waiting -= 1
                self._writer, self._depth = me, 1
                self.exclusive_total += 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if self._depth == 0:
                    self._writer = None
                    if held:
                        self._readers[me] = held
                    self._cond.notify_all()


_CAPTURE_LOCK = CaptureLock()


def capture_lock() -> CaptureLock:
    """The process-wide lock of the capture rule (module doc)."""
    return _CAPTURE_LOCK


class _Slot:
    __slots__ = ("value", "on_evict")

    def __init__(self, value, on_evict):
        self.value = value
        self.on_evict = on_evict


class CompileManager:
    """Process-wide LRU of captured programs, with the JAX package's
    counters. ``admit(key, build)`` returns the entry for ``key``, building
    it on a miss (a capture: counted and timed); ``get``/``put`` are the
    parts for owners that keep their own view (``StepGraphs``)."""

    def __init__(self, max_entries: int = 64, registry=None):
        if int(max_entries) < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, _Slot]" = OrderedDict()
        self._token_counter = 0
        # tokens of collected networks, dropped at the next call: a
        # finalizer runs inside the garbage collector, which may fire while
        # this manager iterates its entries
        self._retired: deque = deque()
        self._side_streams: dict = {}  # device index -> the captures' warm-up stream
        if registry is None:
            from ..telemetry.registry import get_registry  # noqa: PLC0415

            registry = get_registry()
        self.compiles = registry.counter(
            "dl4jtpu_compiles_total",
            "programs captured through the compile manager")
        self.compile_time = registry.histogram(
            "dl4jtpu_compile_seconds",
            "wall time of manager-issued captures (warm-up runs included)",
            buckets=COMPILE_TIME_BUCKETS)
        self.cache_hits = registry.counter(
            "dl4jtpu_compile_cache_hits_total",
            "captured programs served from the in-process cache")
        self.evictions = registry.counter(
            "dl4jtpu_compile_cache_evictions_total",
            "captured programs dropped by the LRU bound or owner retirement")
        self.cache_size = registry.gauge(
            "dl4jtpu_compile_cache_size",
            "captured programs currently held by the compile manager")
        self.hbm_bytes = registry.gauge(
            "dl4jtpu_executable_hbm_bytes",
            "bytes of the live captured graphs' memory pools by kind "
            "(reserved/allocated)", labelnames=("kind",))
        self.hbm_total = registry.gauge(
            "dl4jtpu_executable_hbm_total_bytes",
            "reserved bytes of the live captured graphs' memory pools")

    # -------------------------------------------------------------- streams
    def side_stream(self, device):
        """The side stream on which a capture runs its eager warm-up steps:
        one per device for the process. Captures hold the capture lock
        exclusively, so two never use it at once; and a stream made per
        capture would cost cuBLAS a workspace on it, which torch keeps
        until the process exits (a search that captures a step per trial
        would grow the card's memory by one each, up to torch's pool of 32
        streams)."""
        import torch  # noqa: PLC0415

        device = torch.device(device)
        index = device.index if device.index is not None else torch.cuda.current_device()
        with self._lock:
            stream = self._side_streams.get(index)
            if stream is None:
                stream = self._side_streams[index] = torch.cuda.Stream(index)
            return stream

    # -------------------------------------------------------- observability
    @staticmethod
    def _flight():
        from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

        return get_flight_recorder()

    @staticmethod
    def _key_kind(key) -> str:
        """The entry-kind string that follows the owner token (e.g.
        ``mln_infer``)."""
        if isinstance(key, tuple):
            for part in key:
                if isinstance(part, str):
                    return part
        return "aot"

    def _memory_summary(self) -> dict:
        """The live entries' memory, each pool counted once: graphs of one
        network share a pool, so their records repeat its bytes."""
        from ..telemetry.memory import executable_memory, pool_segments  # noqa: PLC0415

        with self._lock:
            values = [s.value for s in self._entries.values()]
        segments = pool_segments()
        out = {"measured_entries": 0, "unavailable_entries": 0, "pools": 0,
               "reserved_bytes": 0, "allocated_bytes": 0, "total_bytes": 0}
        seen = set()
        for value in values:
            rec = executable_memory(value, segments)
            if not rec.get("available"):
                out["unavailable_entries"] += 1
                continue
            out["measured_entries"] += 1
            pool = tuple(rec.get("pool") or ())
            if pool in seen:
                continue
            seen.add(pool)
            out["pools"] += 1
            for kind in ("reserved", "allocated", "total"):
                out[f"{kind}_bytes"] += int(rec.get(f"{kind}_bytes", 0))
        return out

    def _refresh_memory_gauges(self) -> dict:
        mem = self._memory_summary()
        for kind in ("reserved", "allocated"):
            self.hbm_bytes.labels(kind=kind).set(mem[f"{kind}_bytes"])
        self.hbm_total.set(mem["total_bytes"])
        return mem

    # ------------------------------------------------------------- tokens
    def new_token(self) -> Tuple[str, int]:
        """Fresh owner token; prefix keys with it so ``drop_token`` can
        retire every entry built for one network generation."""
        with self._lock:
            self._token_counter += 1
            return ("cm-token", self._token_counter)

    def retire(self, token) -> None:
        """Drop ``token``'s entries at the manager's next call (what a
        collected network's finalizer calls)."""
        self._retired.append(token)

    def _drain(self) -> None:
        while self._retired:
            self.drop_token(self._retired.popleft())

    def drop_token(self, token) -> int:
        """Evict every entry whose key starts with ``token``; returns the
        count (the networks call it on ``init``: new params, new graphs)."""
        if token is None:
            return 0
        with self._lock:
            stale = [k for k in self._entries
                     if isinstance(k, tuple) and k and k[0] == token]
            slots = [self._entries.pop(k) for k in stale]
            if stale:
                self.evictions.inc(len(stale))
            self.cache_size.set(len(self._entries))
        self._evicted(slots)
        if stale:
            try:
                self._flight().record("eviction", cause="drop_token", count=len(stale))
            except Exception:  # observability must not break retirement
                pass
        return len(stale)

    # -------------------------------------------------------------- cache
    @staticmethod
    def _evicted(slots) -> None:
        for slot in slots:
            if slot.on_evict is not None:
                slot.on_evict()

    def get(self, key):
        """The entry for ``key`` (counted as a cache hit and moved to the
        recent end), or None."""
        self._drain()
        with self._lock:
            slot = self._entries.get(key)
            if slot is None:
                return None
            self._entries.move_to_end(key)
            self.cache_hits.inc()
            return slot.value

    def put(self, key, value, on_evict: Optional[Callable[[], None]] = None):
        """Hold ``value`` under ``key`` (an entry already held is kept and
        returned); the least recently used entries beyond ``max_entries``
        are dropped, their ``on_evict`` called."""
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._entries.move_to_end(key)
                return existing.value
            self._entries[key] = _Slot(value, on_evict)
            dropped = []
            while len(self._entries) > self.max_entries:
                dropped.append(self._entries.popitem(last=False)[1])
            if dropped:
                self.evictions.inc(len(dropped))
            self.cache_size.set(len(self._entries))
        self._evicted(dropped)
        if dropped:
            try:
                self._flight().record("eviction", cause="lru", count=len(dropped))
            except Exception:
                pass
        return value

    def discard(self, key) -> bool:
        """Drop ``key`` at its owner's request (counted as an eviction; its
        ``on_evict`` is not called: the owner already let it go)."""
        with self._lock:
            slot = self._entries.pop(key, None)
            if slot is not None:
                self.evictions.inc()
            self.cache_size.set(len(self._entries))
        return slot is not None

    def admit(self, key, build: Callable[[], Any],
              on_evict: Optional[Callable[[], None]] = None):
        """The entry for ``key``; on a miss ``build()`` makes it (on the card
        a capture, on the CPU the eager callable), counted and timed as a
        compile."""
        entry = self.get(key)
        if entry is not None:
            return entry
        t0 = time.perf_counter()
        entry = build()
        seconds = time.perf_counter() - t0
        self.compile_time.observe(seconds)
        self.compiles.inc()
        try:
            self._flight().record("compile", entry=self._key_kind(key),
                                  seconds=round(seconds, 6),
                                  captured=getattr(entry, "graph", None) is not None)
        except Exception:
            pass
        return self.put(key, entry, on_evict)

    def owned(self, token=None) -> list:
        """(kind, entry) of the live entries, least recently used first (of
        ``token``'s only, if given); no hit is counted."""
        self._drain()
        with self._lock:
            items = list(self._entries.items())
        return [(self._key_kind(k), slot.value) for k, slot in items
                if token is None or (isinstance(k, tuple) and k and k[0] == token)]

    def memory_records(self) -> dict:
        """{"<kind>#<i>": the entry's ``telemetry.memory.executable_memory``
        record} for every live entry (the JAX package's labels, what
        ``GET /api/memory`` serves as ``executables``)."""
        from ..telemetry.memory import executable_memory, pool_segments  # noqa: PLC0415

        segments = pool_segments()
        return {f"{kind}#{i}": executable_memory(value, segments)
                for i, (kind, value) in enumerate(self.owned())}

    def kinds(self, token=None) -> list:
        """The kinds of the live entries (of ``token``'s only, if given)."""
        return [kind for kind, _ in self.owned(token)]

    # -------------------------------------------------------------- stats
    def __len__(self) -> int:
        self._drain()
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """Host-side snapshot: the JAX package's keys but those that read
        XLA (``static_cost``, ``kernels``)."""
        self._drain()
        with self._lock:
            size = len(self._entries)
        memory = self._refresh_memory_gauges()
        return {
            "entries": size,
            "max_entries": self.max_entries,
            "compiles_total": self.compiles.value,
            "cache_hits_total": self.cache_hits.value,
            "evictions_total": self.evictions.value,
            "compile_seconds": self.compile_time.summary(),
            "memory": memory,
        }


_GLOBAL: Optional[CompileManager] = None
_GLOBAL_LOCK = threading.Lock()


def get_compile_manager() -> CompileManager:
    """The process-wide manager (both networks' training and serving share
    it)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = CompileManager()
        return _GLOBAL
