"""Distributed request tracing (counterpart of
``deeplearning4j_tpu/telemetry/tracing.py``): Dapper-style context
propagation, host code copied over the port's ``registry``, ``spans`` and
``flight_recorder``.

- :class:`TraceContext` — 128-bit ``trace_id``, 64-bit ``span_id``,
  parent pointer, a head-sampling flag and string baggage. It rides the
  ``x-dl4jtpu-trace`` header between processes (the codec is the JAX
  package's, byte for byte) and a thread-local *current context*
  (:func:`current_trace` / :func:`use_trace`) inside a process, so deep
  layers (the inference dispatch) pick it up without signature churn.
- **Head sampling** — decided once at the ingress from
  ``DL4JTPU_TRACE_SAMPLE`` (a float or an ``1/N`` ratio, default 1/256)
  and carried in the context. Interesting requests upgrade post-hoc: an
  admission shed or a latency-budget breach flips ``sampled`` so the
  remaining hops record (a ``trace_upgrade`` flight event marks the partial
  head: hops before the upgrade were never recorded).
- **Bounded recording** — sampled spans land in the per-process
  :class:`TraceRing` (queryable by trace id) and the global
  :class:`~deeplearning4j_tpu_torch.telemetry.spans.SpanRecorder` ring, so
  flight-recorder bundles carry them in their ``spans`` section. Every
  recorded span bumps ``dl4jtpu_trace_spans_total{hop}``.

Span events are Chrome trace-event dicts (``ph: "X"``, µs timestamps)
whose ``args`` carry ``trace_id``/``span_id``/``parent_id``. A coalesced
micro-batch dispatch records ONE span whose ``args.links`` point at every
member request's span (fan-in links). Unsampled requests cost one
thread-local read per hop.
"""

from __future__ import annotations

import random
import threading
import time
import urllib.parse
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .registry import get_registry

__all__ = [
    "TRACE_HEADER",
    "TRACE_SAMPLE_ENV",
    "TraceContext",
    "TraceRing",
    "TraceSpan",
    "current_trace",
    "get_trace_ring",
    "record_trace_event",
    "sample_rate",
    "set_default_baggage",
    "should_sample",
    "trace_span",
    "use_trace",
]

# the one propagation header: "trace_id:span_id:sampled01[;key=value...]"
TRACE_HEADER = "x-dl4jtpu-trace"
# head-sampling rate at the ingress: a float ("0.01") or a ratio ("1/256")
TRACE_SAMPLE_ENV = "DL4JTPU_TRACE_SAMPLE"
_DEFAULT_SAMPLE = 1.0 / 256.0

# process-level baggage merged into every NEW root context (the serving
# side stamps the live checkpoint version here on swap, so traces born
# after a rollout carry the version they were served by)
_DEFAULT_BAGGAGE: Dict[str, str] = {}
_BAGGAGE_LOCK = threading.Lock()


def set_default_baggage(key: str, value: Optional[str]) -> None:
    """Set (or, with None, drop) one process-level baggage entry."""
    with _BAGGAGE_LOCK:
        if value is None:
            _DEFAULT_BAGGAGE.pop(str(key), None)
        else:
            _DEFAULT_BAGGAGE[str(key)] = str(value)


def _default_baggage() -> Dict[str, str]:
    with _BAGGAGE_LOCK:
        return dict(_DEFAULT_BAGGAGE)


def sample_rate() -> float:
    """The configured head-sampling rate (``DL4JTPU_TRACE_SAMPLE``)."""
    import os  # noqa: PLC0415

    raw = os.environ.get(TRACE_SAMPLE_ENV)
    if raw is None or raw == "":
        return _DEFAULT_SAMPLE
    raw = raw.strip()
    try:
        if "/" in raw:
            num, den = raw.split("/", 1)
            return float(num) / float(den)
        return float(raw)
    except (ValueError, ZeroDivisionError):
        return _DEFAULT_SAMPLE


def should_sample(rate: Optional[float] = None) -> bool:
    """One head-sampling decision. Deterministic at the edges: rate >= 1
    always samples, rate <= 0 never does."""
    r = sample_rate() if rate is None else float(rate)
    if r <= 0.0:
        return False
    if r >= 1.0:
        return True
    return random.random() < r


@dataclass
class TraceContext:
    """One request's position in a distributed trace."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    sampled: bool = False
    baggage: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def new(cls, sampled: Optional[bool] = None,
            baggage: Optional[Dict[str, str]] = None) -> "TraceContext":
        """A fresh root context (the ingress mints one per request).
        ``sampled=None`` takes the head-sampling decision here."""
        merged = _default_baggage()
        if baggage:
            merged.update({str(k): str(v) for k, v in baggage.items()})
        return cls(
            trace_id=uuid.uuid4().hex,
            span_id=uuid.uuid4().hex[:16],
            parent_id=None,
            sampled=should_sample() if sampled is None else bool(sampled),
            baggage=merged)

    def child(self) -> "TraceContext":
        """A child context: same trace, new span id, parent = this span."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=uuid.uuid4().hex[:16],
            parent_id=self.span_id,
            sampled=self.sampled,
            baggage=dict(self.baggage))

    # ------------------------------------------------------------- codec
    def to_header(self) -> str:
        parts = [f"{self.trace_id}:{self.span_id}:"
                 f"{1 if self.sampled else 0}"]
        for k in sorted(self.baggage):
            parts.append(f"{urllib.parse.quote(str(k), safe='')}="
                         f"{urllib.parse.quote(str(self.baggage[k]), safe='')}")
        return ";".join(parts)

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """Parse the propagation header; None on anything malformed (a
        garbled header must never fail the request it rode in on)."""
        if not value:
            return None
        try:
            head, *bags = str(value).split(";")
            trace_id, span_id, flag = head.split(":")
            if not trace_id or not span_id:
                return None
            baggage = {}
            for item in bags:
                if not item or "=" not in item:
                    continue
                k, v = item.split("=", 1)
                baggage[urllib.parse.unquote(k)] = urllib.parse.unquote(v)
            return cls(trace_id=trace_id, span_id=span_id, parent_id=None,
                       sampled=flag.strip() == "1", baggage=baggage)
        except (ValueError, AttributeError):
            return None

    def upgrade(self, reason: str) -> bool:
        """Post-hoc sample upgrade (shed / error / latency over budget):
        flip ``sampled`` so the remaining hops record, and mark the
        partial head with a ``trace_upgrade`` flight event. Returns True
        when this call performed the flip."""
        if self.sampled:
            return False
        self.sampled = True
        try:
            from .flight_recorder import get_flight_recorder  # noqa: PLC0415

            get_flight_recorder().record(
                "trace_upgrade", trace_id=self.trace_id,
                span_id=self.span_id, reason=str(reason))
        except Exception:  # observability must never fail the request
            pass
        return True


# ------------------------------------------------------------ thread-local
_TLS = threading.local()


def current_trace() -> Optional[TraceContext]:
    """The thread's active trace context (set by :func:`use_trace` /
    :class:`TraceSpan`), or None."""
    return getattr(_TLS, "ctx", None)


@contextmanager
def use_trace(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the thread's current context for the block."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


# ------------------------------------------------------------------ ring
class TraceRing:
    """Bounded per-process store of sampled span events, queryable by
    trace id."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def add(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                # drop oldest: recent traces are the ones being debugged
                del self._events[0]
                self.dropped += 1
            self._events.append(event)

    def spans_for(self, trace_id: str) -> List[dict]:
        tid = str(trace_id)
        with self._lock:
            return [e for e in self._events
                    if (e.get("args") or {}).get("trace_id") == tid]

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_GLOBAL_RING = TraceRing()


def get_trace_ring() -> TraceRing:
    """The process-wide trace-span ring."""
    return _GLOBAL_RING


def _spans_counter():
    return get_registry().counter(
        "dl4jtpu_trace_spans_total",
        "distributed-trace spans recorded, by hop name",
        labelnames=("hop",))


def _record(event: dict, hop: str) -> None:
    """One recorded span: trace ring + global span ring + counter."""
    _GLOBAL_RING.add(event)
    try:
        from .spans import get_recorder  # noqa: PLC0415

        get_recorder().add(event)
    except Exception:  # pragma: no cover - defensive
        pass
    try:
        _spans_counter().labels(hop=str(hop)).inc()
    except Exception:  # pragma: no cover - defensive
        pass


def record_trace_event(ctx: TraceContext, hop: str, *,
                       duration_s: float = 0.0,
                       ts_us: Optional[float] = None, **args) -> dict:
    """Record one span for ``ctx`` without timing a block — retroactive
    spans (a shed decision, an upgrade marker) and instant annotations."""
    import os  # noqa: PLC0415

    event = {
        "name": str(hop),
        "ph": "X",
        "ts": time.time() * 1e6 if ts_us is None else float(ts_us),
        "dur": max(0.0, float(duration_s)) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": {
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_id": ctx.parent_id,
            **args,
        },
    }
    _record(event, hop)
    return event


class TraceSpan:
    """One traced hop: a context manager that opens a CHILD span of
    ``ctx``, installs it as the thread's current context for the block,
    and records a Chrome-trace event on exit. A None/unsampled parent
    degrades to a no-op (``self.ctx`` stays None)."""

    def __init__(self, ctx: Optional[TraceContext], hop: str,
                 links: Optional[List[dict]] = None, **args):
        self.hop = str(hop)
        self.links = links
        self.args = dict(args)
        self.ctx = (ctx.child() if ctx is not None and ctx.sampled
                    else None)
        self._parent_sampled_from = ctx
        self._ts_us: Optional[float] = None
        self._t0: Optional[float] = None
        self._use = None

    def __enter__(self) -> "TraceSpan":
        if self.ctx is None:
            return self
        self._ts_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        self._use = use_trace(self.ctx)
        self._use.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.ctx is None:
            return
        dur = time.perf_counter() - (self._t0 or time.perf_counter())
        self._use.__exit__(exc_type, exc, tb)
        if exc is not None:
            self.args.setdefault("error", f"{type(exc).__name__}: {exc}"[:200])
        if self.links:
            self.args["links"] = list(self.links)
        record_trace_event(
            self.ctx, self.hop, duration_s=dur, ts_us=self._ts_us,
            **self.args)


def trace_span(ctx: Optional[TraceContext], hop: str,
               links: Optional[List[dict]] = None, **args) -> TraceSpan:
    """``with trace_span(ctx, "serve.request", model=name) as sp: ...`` —
    the usual entry point; ``sp.ctx`` is the child context to propagate
    further down (None when the request is unsampled)."""
    return TraceSpan(ctx, hop, links=links, **args)
