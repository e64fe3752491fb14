"""InferenceService (counterpart of
``deeplearning4j_tpu/serving/service.py``): the multi-model serving front
over the bucketed inference path.

One service owns named models (both networks), two micro-batchers per
model (logits and fused-argmax requests coalesce apart, ``batcher.py``),
a continuous decode stream for recurrent models (``decode.py``), admission
control and the serving metrics, by the JAX package's names:

- ``dl4jtpu_serve_requests_total{model}`` / ``dl4jtpu_serve_rows_total`` /
  ``dl4jtpu_serve_batches_total`` — traffic counters;
- ``dl4jtpu_serve_latency_seconds{model}`` — end-to-end request latency
  (enqueue to result), the Prometheus twin of the exact p50/p99 over a
  bounded ring in :meth:`InferenceService.stats`, with exemplars pointing
  at sampled traces;
- ``dl4jtpu_serve_queue_depth{model}``, ``dl4jtpu_serve_batch_fill_ratio``
  and ``dl4jtpu_serve_request_rows`` — headroom, bucket fill and request
  sizes;
- ``dl4jtpu_serve_swaps_total`` and ``dl4jtpu_serve_shed_total{model,
  reason}``; flight-recorder ``serve_dispatch`` and ``serve_swap`` events.

Every model's graphs live in the process-wide compile manager beside the
training steps, so cold models age out under eviction and hot models stay.
Services are named (``get_service(name)``; ``reset_services()`` between
tests). Admission: a model can carry a queue-depth cap and a latency
budget; a request that would breach either is shed with
:class:`AdmissionError`, and a draining service refuses new traffic with
:class:`ServiceDraining` while in-flight requests finish.

What waits (ROADMAP.md): the JAX ``register`` applies a TUNED.json entry
of ``tune/`` to the batcher and admission knobs; the port reads the
argument, then the service's constructor argument, then the environment,
then the default. The metric-history sampler (``telemetry/history.py``)
and the HTTP endpoints (``ui/``) come with their own items, and
``register(layout=...)`` raises ``NotImplementedError`` until the
parallelism item (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from ..runtime import inference as _inf
from ..runtime.compile_manager import get_compile_manager, next_pow2
from ..telemetry.tracing import current_trace, record_trace_event, trace_span
from .batcher import MicroBatcher
from .decode import DecodeServer

__all__ = ["AdmissionError", "InferenceService", "LATENCY_BUDGET_ENV",
           "MAX_QUEUE_ENV", "ServiceDraining", "get_service",
           "reset_services", "service_names", "set_service"]

# service-wide admission defaults (per-model register() args override):
# how many requests may wait in a model's queues before shedding, and the
# p99 latency (ms, over the recent ring) beyond which new traffic sheds.
# 0 = limit disabled.
MAX_QUEUE_ENV = "DL4JTPU_SERVE_MAX_QUEUE"
LATENCY_BUDGET_ENV = "DL4JTPU_SERVE_LATENCY_BUDGET_MS"

# recompute the admission p99 at most this often — np.percentile over the
# 2048-sample ring per request would cost more than the dispatch
_P99_REFRESH_S = 0.25


class AdmissionError(RuntimeError):
    """Request shed by admission control (an HTTP front answers 429).

    ``retry_after_s`` is the server's backoff hint: roughly how long the
    current queue needs to clear at the configured batch cadence.
    """

    def __init__(self, model: str, reason: str, retry_after_s: float):
        super().__init__(
            f"model {model!r}: request shed ({reason}); "
            f"retry after {retry_after_s:.3f}s")
        self.model = model
        self.reason = reason
        self.retry_after_s = retry_after_s


class ServiceDraining(RuntimeError):
    """Service is draining: no new admissions, in-flight work finishes."""

# request latencies span sub-ms (warm CPU micro-batch) to seconds (cold
# accelerator dispatch) — finer low end than the step-time default buckets
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def _percentile(values, q: float):
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def _env_limit(name: str, kind=float):
    raw = os.environ.get(name)
    if raw is None:
        return None
    try:
        value = kind(float(raw))
    except ValueError:
        return None
    return value if value > 0 else None


class _ModelEntry:
    def __init__(self, name: str, net, batcher: MicroBatcher,
                 argmax_batcher: MicroBatcher,
                 max_queue_depth: Optional[int] = None,
                 latency_budget_ms: Optional[float] = None):
        self.name = name
        self.net = net
        self.batcher = batcher
        self.max_queue_depth = max_queue_depth
        self.latency_budget_ms = latency_budget_ms
        self.shed = 0
        self._p99_cache = (0.0, None)  # (computed_at, value)
        # class-index requests coalesce separately: logits and int32-argmax
        # dispatches can never share a transfer, but argmax traffic still
        # deserves the latency-budget batching (they dispatched direct
        # before)
        self.argmax_batcher = argmax_batcher
        self.decoder: Optional[DecodeServer] = None
        self.lock = threading.Lock()
        self.latencies: "deque[float]" = deque(maxlen=2048)
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.fill_sum = 0.0
        self.last_dispatch: Optional[dict] = None
        self.version: Optional[int] = None  # hot-swap bookkeeping
        self.swapped_at: Optional[float] = None
        self.swaps = 0

    def depth(self) -> int:
        return (self.batcher.queue_depth()
                + self.argmax_batcher.queue_depth())

    def recent_p99(self) -> Optional[float]:
        """p99 over the latency ring, cached for _P99_REFRESH_S — cheap
        enough to consult on every admission decision."""
        now = time.perf_counter()
        at, value = self._p99_cache
        if now - at > _P99_REFRESH_S:
            with self.lock:  # batcher callbacks append concurrently
                ring = list(self.latencies)
            value = _percentile(ring, 99)
            self._p99_cache = (now, value)
        return value

    def stop(self) -> None:
        self.batcher.stop()
        self.argmax_batcher.stop()
        if self.decoder is not None:
            self.decoder.stop()


class InferenceService:
    """Named-model registry + per-model micro-batchers + serving metrics."""

    def __init__(self, registry=None, *,
                 max_delay_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        if registry is None:
            from ..telemetry.registry import get_registry  # noqa: PLC0415

            registry = get_registry()
        self.registry = registry
        self.max_delay_ms = max_delay_ms
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelEntry] = {}
        self._draining = False
        self.requests_total = registry.counter(
            "dl4jtpu_serve_requests_total",
            "inference requests served, by model", labelnames=("model",))
        self.rows_total = registry.counter(
            "dl4jtpu_serve_rows_total",
            "example rows served, by model", labelnames=("model",))
        self.batches_total = registry.counter(
            "dl4jtpu_serve_batches_total",
            "coalesced micro-batch dispatches, by model",
            labelnames=("model",))
        self.latency = registry.histogram(
            "dl4jtpu_serve_latency_seconds",
            "end-to-end request latency (enqueue to result), by model",
            labelnames=("model",), buckets=LATENCY_BUCKETS)
        self.queue_depth = registry.gauge(
            "dl4jtpu_serve_queue_depth",
            "requests waiting in the micro-batch queue, by model",
            labelnames=("model",))
        self.batch_fill = registry.gauge(
            "dl4jtpu_serve_batch_fill_ratio",
            "real rows / pow2 bucket rows of the last dispatch, by model",
            labelnames=("model",))
        # request-size classes: the distribution DL4JTPU_SERVE_MAX_BATCH
        # tuning needs (a cap far above the p99 request size wastes bucket
        # warmup; far below it splits bursts) — pow2 buckets to match the
        # captured bucket family
        self.request_rows = registry.histogram(
            "dl4jtpu_serve_request_rows",
            "rows per inference request, by model",
            labelnames=("model",),
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
        self.swaps_total = registry.counter(
            "dl4jtpu_serve_swaps_total",
            "live hot-swaps of a served model's parameters, by model",
            labelnames=("model",))
        self.shed_total = registry.counter(
            "dl4jtpu_serve_shed_total",
            "requests shed by admission control, by model and reason",
            labelnames=("model", "reason"))

    # ------------------------------------------------------------ registry
    @staticmethod
    def _is_graph(net) -> bool:
        return hasattr(net.conf, "network_inputs")

    def register(self, name: str, net, layout=None, *,
                 max_delay_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 latency_budget_ms: Optional[float] = None,
                 ) -> "InferenceService":
        """Serve ``net`` as ``name``. Graphs must be single-input /
        single-output (the row-concatenating batcher has one features
        tensor per request).

        ``layout`` (a mesh layout in the JAX package) raises
        ``NotImplementedError``: it waits for the parallelism item (ROADMAP
        Queue 1 item 8).

        Per-model knobs (each falls back service-wide when None): the
        batcher pair ``max_delay_ms``/``max_batch`` (this argument, the
        service's constructor argument, the environment, the default), and
        the admission pair ``max_queue_depth`` (shed at this many queued
        requests) / ``latency_budget_ms`` (shed while the ring p99 exceeds
        it): this argument, the environment, else disabled. The JAX
        package's TUNED.json step waits for ``tune/`` (ROADMAP Queue 1 item
        9). Shed requests raise :class:`AdmissionError`."""
        if self._is_graph(net):
            if (len(net.conf.network_inputs) != 1
                    or len(net.conf.network_outputs) != 1):
                raise ValueError(
                    f"model {name!r}: only single-input/single-output "
                    "graphs can be served through the micro-batcher")
        if layout is not None:
            raise NotImplementedError(
                "register(layout=...) is not ported yet: mesh layouts come with "
                "the parallelism item (ROADMAP.md Queue 1 item 8)")
        net.init()
        # the batcher reads the environment and its default where both of
        # these are None
        delay_ms = max_delay_ms if max_delay_ms is not None else self.max_delay_ms
        rows_cap = max_batch if max_batch is not None else self.max_batch
        if max_queue_depth is None:
            max_queue_depth = _env_limit(MAX_QUEUE_ENV, int)
        if latency_budget_ms is None:
            latency_budget_ms = _env_limit(LATENCY_BUDGET_ENV)
        # 0 / negative means "limit disabled" wherever it came from
        if max_queue_depth is not None and int(max_queue_depth) <= 0:
            max_queue_depth = None
        if latency_budget_ms is not None and float(latency_budget_ms) <= 0:
            latency_budget_ms = None
        entry_holder: list = []

        def dispatch(feats: np.ndarray) -> np.ndarray:
            return self._run_model(entry_holder[0], feats, argmax=False)

        def dispatch_argmax(feats: np.ndarray) -> np.ndarray:
            return self._run_model(entry_holder[0], feats, argmax=True)

        batcher = MicroBatcher(
            dispatch,
            max_delay_ms=delay_ms, max_batch=rows_cap,
            on_batch=lambda **kw: self._record_batch(name, **kw),
            on_request=lambda s, t=None: self._record_request(name, s, t))
        argmax_batcher = MicroBatcher(
            dispatch_argmax,
            max_delay_ms=delay_ms, max_batch=rows_cap,
            on_batch=lambda **kw: self._record_batch(name, kind="argmax",
                                                     **kw),
            on_request=lambda s, t=None: self._record_request(name, s, t))
        entry = _ModelEntry(
            name, net, batcher, argmax_batcher,
            max_queue_depth=(None if max_queue_depth is None
                             else int(max_queue_depth)),
            latency_budget_ms=(None if latency_budget_ms is None
                               else float(latency_budget_ms)))
        entry_holder.append(entry)
        with self._lock:
            old = self._models.get(name)
            self._models[name] = entry
        if old is not None:
            old.stop()
        # SLO declaration is env-opt-in (DL4JTPU_SLO_*): fleets that want
        # burn-rate alerting set the knobs; unset, nothing evaluates and
        # existing behavior (tests included) is untouched. Programmatic
        # declaration stays available via get_slo_monitor().declare().
        try:
            from ..telemetry import slo as _slo  # noqa: PLC0415

            if any(os.environ.get(k) for k in (
                    _slo.SLO_LATENCY_BUDGET_ENV,
                    _slo.SLO_LATENCY_TARGET_ENV,
                    _slo.SLO_AVAILABILITY_TARGET_ENV)):
                _slo.get_slo_monitor().declare_from_env(
                    name, latency_budget_ms=entry.latency_budget_ms)
        except Exception:  # observability must never fail registration
            pass
        return self

    def unregister(self, name: str) -> None:
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is not None:
            entry.stop()

    def hot_swap(self, name: str, params=None, *, net=None, state=None,
                 version: Optional[int] = None) -> None:
        """Swap a served model's parameters live — the train→serve handoff.

        The new values are written into the served network's own tensors in
        place (``swap_params``), under the network's serving lock: its
        captured graphs read them at their next replay, so the swap needs no
        new capture, and a dispatch sees either the old params or the new
        ones, never a mix. The network keeps its compile-manager token.

        Pass ``params`` (``init``'s layout: one dict per layer, or vertex
        name to dict; arrays or tensors) and optionally ``state``, or
        ``net`` to copy both from another network of the same
        configuration. ``version`` tags the swap in :meth:`stats` and the
        flight events.
        """
        entry = self._entry(name)
        if params is None:
            if net is None:
                raise ValueError("hot_swap needs params= or net=")
            net.init()
            params = net._params_from_leaves(
                [{k: v.detach() for k, v in d.items()} for d in net._leaves()])
            state = net.state
        with entry.lock:
            entry.net.swap_params(params, state)
            entry.version = version
            entry.swapped_at = time.time()
            entry.swaps += 1
        self.swaps_total.labels(model=name).inc()
        try:
            from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

            get_flight_recorder().record(
                "serve_swap", model=name,
                version=None if version is None else int(version))
        except Exception:  # observability must never fail a swap
            pass

    def models(self):
        with self._lock:
            return sorted(self._models)

    def _entry(self, name: str) -> _ModelEntry:
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{self.models()}")
        return entry

    # ------------------------------------------------------------ dispatch
    def _run_model(self, entry: _ModelEntry, feats: np.ndarray,
                   argmax: bool) -> np.ndarray:
        net = entry.net
        if self._is_graph(net):
            return _inf.graph_output(net, [feats], argmax=argmax)[0]
        return _inf.mln_output(net, feats, argmax=argmax)

    def warmup(self, name: str, example, *, argmax: bool = False,
               max_rows: Optional[int] = None) -> int:
        """Capture ahead for serving: run every pow2 row bucket from 1 up to
        the micro-batcher's row cap through the inference path (plus the
        fused-argmax variants when ``argmax``), so live traffic — whatever
        mix of request sizes the batcher coalesces — makes no capture (a
        network with BatchNormalization keeps exact row counts, so only
        these sizes are warm).
        ``example`` is one request ([rows, ...features]); only its trailing
        shape/dtype matter. Returns the number of buckets warmed."""
        entry = self._entry(name)
        example = np.asarray(example)
        cap = next_pow2(max_rows if max_rows is not None
                        else entry.batcher.max_batch)
        rows, warmed = 1, 0
        while rows <= cap:
            probe = np.zeros((rows,) + example.shape[1:], example.dtype)
            self._run_model(entry, probe, argmax=False)
            if argmax:
                self._run_model(entry, probe, argmax=True)
            warmed += 1
            rows *= 2
        return warmed

    def predict(self, name: str, features, *, argmax: bool = False,
                timeout_s: float = 30.0, trace=None) -> np.ndarray:
        """Serve one request through the model's micro-batcher. ``argmax``
        requests coalesce on their OWN batcher (mixing them with logits
        requests would force two device transfers per batch) and dispatch
        on the fused-argmax graph — only int32 class indices cross
        the device boundary, same as the old direct path.

        ``trace``: an optional :class:`TraceContext` (falls back to the
        thread's current context). A sampled request records a
        ``serve.request`` span wrapping admission and the batched wait,
        and rides into the coalesced dispatch for fan-in linking; a shed
        or over-budget request upgrades an unsampled context post-hoc.

        Raises :class:`ServiceDraining` while the service drains and
        :class:`AdmissionError` when the model's queue-depth cap or
        latency budget would be breached (shed now beats queueing into a
        latency spiral — the caller backs off ``retry_after_s``)."""
        ctx = trace if trace is not None else current_trace()
        if ctx is None or not ctx.sampled:
            return self._predict(name, features, argmax, timeout_s, ctx)
        with trace_span(ctx, "serve.request", model=name,
                        argmax=bool(argmax)) as sp:
            return self._predict(name, features, argmax, timeout_s, sp.ctx)

    def _predict(self, name: str, features, argmax: bool,
                 timeout_s: float, ctx) -> np.ndarray:
        if self._draining:
            raise ServiceDraining(f"service draining; model {name!r} "
                                  "not admitting new requests")
        entry = self._entry(name)
        self._admit(entry, ctx)
        features = np.asarray(features)
        if features.ndim >= 1:
            self.request_rows.labels(model=name).observe(
                int(features.shape[0]))
        batcher = entry.argmax_batcher if argmax else entry.batcher
        fut = batcher.submit(
            features,
            trace=ctx if ctx is not None and ctx.sampled else None)
        self.queue_depth.labels(model=name).set(
            entry.batcher.queue_depth() + entry.argmax_batcher.queue_depth())
        return fut.result(timeout=timeout_s)

    def _admit(self, entry: _ModelEntry, ctx=None) -> None:
        depth = entry.depth()
        if (entry.max_queue_depth is not None
                and depth >= entry.max_queue_depth):
            # backoff hint: cycles needed to clear the queue at the
            # batcher's cadence (delay budget per coalesced dispatch)
            cycles = depth / max(1, entry.batcher.max_batch)
            retry = max(0.05, cycles * max(entry.batcher.max_delay_s,
                                           0.002))
            self._shed(entry, "queue_depth", retry, ctx)
        if entry.latency_budget_ms is not None:
            p99 = entry.recent_p99()
            if p99 is not None and p99 * 1000.0 > entry.latency_budget_ms:
                self._shed(entry, "latency_budget",
                           max(0.05, 2 * entry.latency_budget_ms / 1000.0),
                           ctx)

    def _shed(self, entry: _ModelEntry, reason: str,
              retry_after_s: float, ctx=None) -> None:
        with entry.lock:
            entry.shed += 1
        self.shed_total.labels(model=entry.name, reason=reason).inc()
        tid = None
        if ctx is not None:
            # always-sample on shed: upgrade an unsampled head post-hoc so
            # the 429 the client sees has a trace behind it
            ctx.upgrade(f"shed:{reason}")
            record_trace_event(ctx.child(), "serve.shed",
                               model=entry.name, reason=reason,
                               retry_after_s=round(retry_after_s, 3))
            tid = ctx.trace_id
        try:
            from ..telemetry.slo import get_slo_monitor  # noqa: PLC0415

            mon = get_slo_monitor()
            mon.observe(entry.name, shed=True, trace_id=tid)
            mon.maybe_evaluate()
        except Exception:  # observability must never fail a shed
            pass
        raise AdmissionError(entry.name, reason, round(retry_after_s, 3))

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: stop admitting (predict raises
        :class:`ServiceDraining`), wait for every model's queued AND
        in-flight requests to finish. Returns True when fully drained.
        The service stays registered — callers deregister/stop after."""
        self._draining = True
        with self._lock:
            entries = list(self._models.values())
        deadline = time.perf_counter() + timeout_s
        ok = True
        for e in entries:
            for b in (e.batcher, e.argmax_batcher):
                remaining = deadline - time.perf_counter()
                ok = b.drain(timeout_s=max(0.0, remaining)) and ok
        return ok

    @property
    def draining(self) -> bool:
        return self._draining

    # ----------------------------------------------------------- decode
    def decoder(self, name: str) -> DecodeServer:
        """The model's continuous-decode stream (created on first use)."""
        entry = self._entry(name)
        with entry.lock:
            if entry.decoder is None:
                entry.decoder = DecodeServer(
                    entry.net,
                    max_delay_ms=self.max_delay_ms,
                    on_batch=lambda **kw: self._record_batch(
                        name, kind="decode", **kw),
                    on_request=lambda s, t=None: self._record_request(
                        name, s, t))
            return entry.decoder

    # ------------------------------------------------------------ metrics
    def _record_request(self, name: str, seconds: float,
                        trace=None) -> None:
        entry = self._models.get(name)
        if trace is not None and entry is not None \
                and entry.latency_budget_ms is not None \
                and seconds * 1000.0 > entry.latency_budget_ms:
            # always-sample on latency over budget (post-hoc upgrade)
            trace.upgrade("latency_budget")
        tid = (trace.trace_id
               if trace is not None and trace.sampled else None)
        self.requests_total.labels(model=name).inc()
        # exemplar: tail buckets on /metrics point at a concrete trace
        self.latency.labels(model=name).observe(seconds, exemplar=tid)
        if entry is not None:
            with entry.lock:  # logits/argmax/decode callbacks race here
                entry.requests += 1
                entry.latencies.append(float(seconds))
        try:
            from ..telemetry.slo import get_slo_monitor  # noqa: PLC0415

            mon = get_slo_monitor()
            mon.observe(name, latency_s=float(seconds), trace_id=tid)
            mon.maybe_evaluate()
        except Exception:  # observability must never fail a request
            pass

    def _record_batch(self, name: str, *, rows: int, requests: int,
                      seconds: float, queue_depth: int,
                      bucket_rows: Optional[int] = None,
                      kind: str = "predict") -> None:
        bucket = bucket_rows if bucket_rows is not None else next_pow2(rows)
        fill = rows / bucket if bucket else 0.0
        self.batches_total.labels(model=name).inc()
        self.rows_total.labels(model=name).inc(rows)
        self.queue_depth.labels(model=name).set(queue_depth)
        self.batch_fill.labels(model=name).set(fill)
        entry = self._models.get(name)
        if entry is not None:
            with entry.lock:
                entry.rows += rows
                entry.batches += 1
                entry.fill_sum += fill
                entry.last_dispatch = {
                "kind": kind, "rows": rows, "requests": requests,
                "bucket_rows": bucket, "fill_ratio": round(fill, 4),
                "seconds": round(seconds, 6)}
        try:
            from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

            get_flight_recorder().record(
                "serve_dispatch", model=name, mode=kind, rows=int(rows),
                requests=int(requests), bucket_rows=int(bucket),
                fill_ratio=round(fill, 4), seconds=round(seconds, 6))
        except Exception:  # observability must never fail a request
            pass

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """JSON-ready serving snapshot (the /api/serving payload): per-model
        traffic, exact p50/p99 over the recent-latency ring, batch fill,
        live queue depth, decode stream state, plus the shared compile-cache
        view that explains graph tenancy."""
        with self._lock:
            entries = dict(self._models)
        models = {}
        for name, e in entries.items():
            with e.lock:  # the ring keeps appending while we snapshot
                lats = list(e.latencies)
            models[name] = {
                "layout": None,  # mesh layouts wait for ROADMAP item 8
                "requests_total": e.requests,
                "rows_total": e.rows,
                "batches_total": e.batches,
                "version": e.version,
                "swaps_total": e.swaps,
                "swapped_at": e.swapped_at,
                "queue_depth": (e.batcher.queue_depth()
                                + e.argmax_batcher.queue_depth()),
                "mean_batch_fill_ratio": (
                    round(e.fill_sum / e.batches, 4) if e.batches else None),
                "latency_seconds": {
                    "p50": _percentile(lats, 50),
                    "p99": _percentile(lats, 99),
                    "max": max(lats) if lats else None,
                    "samples": len(lats),
                },
                "last_dispatch": e.last_dispatch,
                "decode_sessions": (
                    e.decoder.sessions() if e.decoder is not None else 0),
                "batcher": {
                    "max_delay_ms": round(e.batcher.max_delay_s * 1000, 3),
                    "max_batch": e.batcher.max_batch,
                },
                "admission": {
                    "max_queue_depth": e.max_queue_depth,
                    "latency_budget_ms": e.latency_budget_ms,
                    "shed_total": e.shed,
                },
            }
        return {
            "models": models,
            "draining": self._draining,
            "compile_cache": get_compile_manager().stats(),
        }

    def stop(self) -> None:
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
        for e in entries:
            e.stop()


# ---------------------------------------------------------------- registry
# Named services replace the old single process-global: a process can host
# independent serving fronts (a worker's own service next to the
# default UI one) and tests reset the whole registry instead of leaking
# models into each other through one shared singleton.
DEFAULT_SERVICE = "default"
_SERVICES: Dict[str, InferenceService] = {}
_SERVICES_LOCK = threading.Lock()


def get_service(name: str = DEFAULT_SERVICE) -> InferenceService:
    """The named serving front-end, created on first use. The no-arg call
    keeps its historic meaning: the process-wide default service (what
    the UI server exposes)."""
    with _SERVICES_LOCK:
        service = _SERVICES.get(name)
        if service is None:
            service = _SERVICES[name] = InferenceService()
        return service


def set_service(service: Optional[InferenceService],
                name: str = DEFAULT_SERVICE) -> None:
    """Install (or, with None, remove) a named service. The no-arg form
    swaps the process-wide default (tests / custom deployments)."""
    with _SERVICES_LOCK:
        if service is None:
            _SERVICES.pop(name, None)
        else:
            _SERVICES[name] = service


def service_names():
    with _SERVICES_LOCK:
        return sorted(_SERVICES)


def reset_services(*, stop: bool = True) -> None:
    """Test hook: clear the whole service registry (stopping batchers by
    default) so multi-service suites start from a clean slate."""
    with _SERVICES_LOCK:
        services = list(_SERVICES.values())
        _SERVICES.clear()
    if stop:
        for service in services:
            try:
                service.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
