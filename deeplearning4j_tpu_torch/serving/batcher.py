"""Dynamic micro-batcher (counterpart of
``deeplearning4j_tpu/serving/batcher.py``): coalesce concurrent requests
under a latency budget.

Requests enqueue from any thread; a dispatcher thread coalesces whatever
arrived within the latency budget (``DL4JTPU_SERVE_MAX_DELAY_MS``, default
2 ms), capped at ``DL4JTPU_SERVE_MAX_BATCH`` rows (default 64), into ONE
row-concatenated dispatch, which the inference path pads to the nearest
power-of-two bucket: every mixed-size burst replays one of a bounded set of
captured graphs.

- The **latency budget** is the longest any request waits for company: the
  first request of a cycle starts the clock, the dispatch fires when the
  budget lapses or the row cap fills. Budget 0 dispatches per request.
- Only **shape-compatible** requests coalesce (same trailing dims and
  dtype); stragglers of another shape stay queued for the next cycle.
- The **row cap** is a hard ceiling: a request that would overshoot it
  waits, so warm-up can cover every bucket live traffic reaches.
- Failures propagate per batch: an exception in the dispatch rejects
  exactly the futures of that batch.
- A sampled request's trace rides into the coalesced dispatch, which
  records one ``serve.batch`` span linking every sampled member (fan-in).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..telemetry.tracing import record_trace_event, use_trace

__all__ = ["MicroBatcher", "MAX_DELAY_ENV", "MAX_BATCH_ENV"]

# env knobs (see docs/serving.md): how long a request may wait for company,
# and the most rows one coalesced dispatch may carry
MAX_DELAY_ENV = "DL4JTPU_SERVE_MAX_DELAY_MS"
MAX_BATCH_ENV = "DL4JTPU_SERVE_MAX_BATCH"
_DEFAULT_DELAY_MS = 2.0
_DEFAULT_MAX_BATCH = 64

_NULL_CM = contextlib.nullcontext()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _Request:
    __slots__ = ("features", "future", "enqueued", "trace")

    def __init__(self, features: np.ndarray, trace=None):
        self.features = features
        self.future: "Future[np.ndarray]" = Future()
        self.enqueued = time.perf_counter()
        self.trace = trace  # Optional[telemetry.tracing.TraceContext]


class MicroBatcher:
    """One model's request queue + dispatcher thread.

    ``dispatch(features)`` receives the row-concatenated batch and returns
    the row-aligned outputs (the inference fast path — bucketing, masking
    and slicing live there, not here).
    """

    def __init__(self, dispatch: Callable[[np.ndarray], np.ndarray], *,
                 max_delay_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 on_batch: Optional[Callable[..., None]] = None,
                 on_request: Optional[Callable[..., None]] = None):
        self._dispatch = dispatch
        self.max_delay_s = (
            _env_float(MAX_DELAY_ENV, _DEFAULT_DELAY_MS)
            if max_delay_ms is None else float(max_delay_ms)) / 1000.0
        self.max_batch = int(
            _env_float(MAX_BATCH_ENV, _DEFAULT_MAX_BATCH)
            if max_batch is None else max_batch)
        self._on_batch = on_batch
        self._on_request = on_request
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: "deque[_Request]" = deque()
        self._in_flight = 0
        self._pending = 0  # submitted, future not yet resolved
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, features, trace=None) -> "Future[np.ndarray]":
        """Enqueue one request ([rows, ...features]); returns a Future of
        the row-aligned output. ``trace`` (a sampled ``TraceContext``)
        rides the request so the coalesced dispatch can link back to it."""
        features = np.asarray(features)
        if features.ndim < 2:
            raise ValueError(
                f"request must be batched ([rows, ...]); got shape "
                f"{features.shape}")
        req = _Request(features, trace=trace)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is stopped")
            self._queue.append(req)
            self._pending += 1
            self._cv.notify()
        return req.future

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def in_flight(self) -> int:
        """Requests currently inside a dispatch (popped off the queue but
        futures not yet resolved)."""
        with self._lock:
            return self._in_flight

    def pending(self) -> int:
        """Requests whose future is not yet resolved — queued, held by the
        collector while it waits for company, or mid-dispatch. This is
        the drain invariant (queue_depth alone misses the held ones)."""
        with self._lock:
            return self._pending

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until every submitted request resolved. The caller is
        responsible for stopping admission first (the batcher itself
        keeps accepting — admission policy lives in the service).
        Returns True when fully drained within the timeout."""
        end = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            with self._lock:
                if not self._pending:
                    return True
            if time.monotonic() >= end:
                return False
            time.sleep(0.005)

    def stop(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5)
        # reject whatever never dispatched
        with self._lock:
            leftover = list(self._queue)
            self._queue.clear()
            self._pending -= len(leftover)
        for req in leftover:
            req.future.set_exception(RuntimeError("batcher stopped"))

    # ---------------------------------------------------------- dispatcher
    @staticmethod
    def _shape_key(features: np.ndarray) -> Tuple:
        return (features.shape[1:], str(features.dtype))

    def _collect(self) -> List[_Request]:
        """Block for the first request, then soak up shape-compatible
        company until the latency budget lapses or the row cap fills."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(timeout=0.1)
            if self._closed and not self._queue:
                return []
            first = self._queue.popleft()
        group = [first]
        rows = int(first.features.shape[0])
        key = self._shape_key(first.features)
        deadline = first.enqueued + self.max_delay_s
        while rows < self.max_batch:
            with self._cv:
                # scan for the next compatible request that still FITS the
                # row cap (the cap bounds the captured bucket — overshoot
                # would dispatch into a bucket warmup never captured);
                # incompatible/oversize ones keep their position
                hit = None
                for i, req in enumerate(self._queue):
                    if (self._shape_key(req.features) == key
                            and rows + int(req.features.shape[0])
                            <= self.max_batch):
                        hit = i
                        break
                if hit is not None:
                    req = self._queue[hit]
                    del self._queue[hit]
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(timeout=remaining)
                    continue
            group.append(req)
            rows += int(req.features.shape[0])
        return group

    def _run(self) -> None:
        while True:
            group = self._collect()
            if not group:
                return
            with self._lock:
                self._in_flight = len(group)
            try:
                self._dispatch_group(group)
            finally:
                with self._lock:
                    self._in_flight = 0
                    self._pending -= len(group)

    def _dispatch_group(self, group: List[_Request]) -> None:
        t0 = time.perf_counter()
        feats = (group[0].features if len(group) == 1 else
                 np.concatenate([r.features for r in group]))
        # ONE dispatch span for the coalesced batch: parented under the
        # first sampled member, with fan-in links to EVERY sampled member's
        # span — the trace shows exactly which strangers a request shared
        # device work with. Installed as current so the inference fast path
        # (infer.dispatch) parents under it.
        traced = [r.trace for r in group
                  if r.trace is not None and r.trace.sampled]
        dispatch_ctx = traced[0].child() if traced else None
        ts_us = time.time() * 1e6
        try:
            with use_trace(dispatch_ctx) if dispatch_ctx is not None \
                    else _NULL_CM:
                out = self._dispatch(feats)
        except Exception as e:  # noqa: BLE001 - reject THIS batch only
            if dispatch_ctx is not None:
                record_trace_event(
                    dispatch_ctx, "serve.batch",
                    duration_s=time.perf_counter() - t0, ts_us=ts_us,
                    error=f"{type(e).__name__}: {e}"[:200],
                    links=[{"trace_id": t.trace_id, "span_id": t.span_id}
                           for t in traced])
            for req in group:
                if not req.future.cancelled():
                    req.future.set_exception(e)
            return
        seconds = time.perf_counter() - t0
        if dispatch_ctx is not None:
            record_trace_event(
                dispatch_ctx, "serve.batch", duration_s=seconds,
                ts_us=ts_us, rows=int(feats.shape[0]),
                requests=len(group), sampled_members=len(traced),
                links=[{"trace_id": t.trace_id, "span_id": t.span_id}
                       for t in traced])
        out = np.asarray(out)
        offset = 0
        done = time.perf_counter()
        for req in group:
            n = int(req.features.shape[0])
            if not req.future.cancelled():
                req.future.set_result(out[offset:offset + n])
            if self._on_request is not None:
                self._on_request(done - req.enqueued, req.trace)
            offset += n
        if self._on_batch is not None:
            self._on_batch(rows=int(feats.shape[0]),
                           requests=len(group), seconds=seconds,
                           queue_depth=self.queue_depth())
