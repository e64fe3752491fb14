"""Host-side spans with Chrome/Perfetto trace export (counterpart of
``deeplearning4j_tpu/telemetry/spans.py``).

A :class:`Span` measures one named host-side region (data load, dispatch,
sync, checkpoint write):

- Entering a span also enters ``torch.profiler.record_function(name)``, so
  when a ``torch.profiler`` capture is active the host span appears in the
  same trace as the CUDA kernels it encloses.
- Closing a span never syncs the device: it records wall-clock enqueue time.
  Under async dispatch a span around an un-synced launch measures dispatch,
  not execution — wrap the sync point (the host fetch) in its own span when
  execution time is what you want.

Completed spans land in a :class:`SpanRecorder` ring buffer and export as
Chrome trace-event JSON (``chrome://tracing`` / Perfetto "trace event"
format): complete events (``ph: "X"``), microsecond timestamps, pid/tid, and
user args. Durations optionally feed a registry histogram
(``dl4jtpu_span_seconds{name=...}``) so span timing is also scrapeable.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from .registry import MetricsRegistry


class SpanRecorder:
    """Bounded collector of completed span events (Chrome trace dicts)."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def add(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self) -> dict:
        """Trace-event-format document (load in Perfetto / chrome://tracing)."""
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "deeplearning4j_tpu_torch.telemetry"},
        }

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(), fh)
        return path


_GLOBAL_RECORDER = SpanRecorder()


def get_recorder() -> SpanRecorder:
    """The process-wide default span recorder."""
    return _GLOBAL_RECORDER


class Span:
    """One named region; context manager or explicit ``start()``/``stop()``."""

    def __init__(self, name: str, recorder: Optional[SpanRecorder] = None,
                 registry: Optional[MetricsRegistry] = None, **args):
        self.name = str(name)
        self.recorder = recorder if recorder is not None else _GLOBAL_RECORDER
        self._registry = registry
        self.args = {k: v for k, v in args.items()}
        self._annotation = None
        self._t0: Optional[float] = None
        self._ts_us: Optional[float] = None
        self.duration_s: Optional[float] = None

    def start(self) -> "Span":
        if self._t0 is not None:
            raise RuntimeError(f"span {self.name!r} already started")
        try:
            import torch  # noqa: PLC0415

            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        except Exception:
            self._annotation = None  # no profiler: a host-only span
        self._ts_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError(f"span {self.name!r} was never started")
        dur = time.perf_counter() - self._t0
        self._t0 = None
        if self._annotation is not None:
            try:
                self._annotation.__exit__(None, None, None)
            finally:
                self._annotation = None
        self.duration_s = dur
        event = {
            "name": self.name,
            "ph": "X",
            "ts": self._ts_us,
            "dur": dur * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if self.args:
            event["args"] = self.args
        self.recorder.add(event)
        if self._registry is not None:
            self._registry.histogram(
                "dl4jtpu_span_seconds", "host span durations",
                labelnames=("name",),
            ).labels(name=self.name).observe(dur)
        return dur

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def span(name: str, recorder: Optional[SpanRecorder] = None,
         registry: Optional[MetricsRegistry] = None, **args) -> Span:
    """``with span("data_load", batch=i): ...`` — the usual entry point."""
    return Span(name, recorder=recorder, registry=registry, **args)
