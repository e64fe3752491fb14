"""Metric time-series history (counterpart of
``deeplearning4j_tpu/telemetry/history.py``; host-only, no device reads).

- :class:`HistoryStore` — a bounded, multi-resolution in-process
  time-series store. Each series keeps a raw ring plus 1m/5m rollup
  rings (count/sum/min/max/last per bucket), so a query spanning hours
  downsamples instead of truncating. Counters are recorded as
  **derived rates** with Prometheus-style monotonic-reset handling;
  histogram snapshots become interval-quantile series (``name:p50`` /
  ``name:p99``). Timestamps come from a wall-anchored *monotonic*
  clock (never step backward under NTP) and every recording/query
  method takes an explicit injected ``now`` for tests.
- :class:`HistorySampler` — ticks a :class:`MetricsRegistry` snapshot
  into the store on a ``Deadline``-paced thread (``runtime/
  resilience.py``'s ``DeadlinePolicy``). It reads only the host
  registry, never the card, so it is not on any timed path: the
  ``InferenceService`` starts it at construction (``DL4JTPU_HISTORY=0``
  turns it off).
- :class:`Forecast` — Holt linear trend with irregular-interval
  updates (``beta=0`` is a plain EWMA).

Stale-series rule: :meth:`HistoryStore.mark_stale` records an
**explicit gap** point (value ``None``), never a silently flat-lined
last value, counted in ``dl4jtpu_history_stale_series_total``. The next
real sample under the same labels clears the flag and the series
resumes.

Memory is bounded by construction: per-series rings are fixed-length
deques, the series map is LRU-capped (``max_series``), and the
estimated footprint is exported as ``dl4jtpu_history_bytes``.

- :class:`FleetRecordingRules` — the fleet router's autoscaler sensors
  (``RECORDING_RULES``) derived from its ``stats()`` each scrape tick,
  with EWMA/Holt forecasts exported as ``dl4jtpu_forecast_*`` gauges.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry

__all__ = [
    "HISTORY_ENV",
    "HISTORY_INTERVAL_ENV",
    "FORECAST_HORIZONS_S",
    "FORECAST_SENSORS",
    "RECORDING_RULES",
    "Forecast",
    "FleetRecordingRules",
    "HistorySampler",
    "HistoryStore",
    "ensure_default_sampler",
    "get_default_sampler",
    "get_history_store",
    "history_enabled",
    "parse_prometheus_text",
    "set_default_sampler",
    "set_history_store",
]

HISTORY_ENV = "DL4JTPU_HISTORY"               # "0"/"false" disables
HISTORY_INTERVAL_ENV = "DL4JTPU_HISTORY_INTERVAL_S"  # sampler tick, s

# resolution ladder: raw ring + rollup rings (seconds -> ring length).
# Defaults hold ~6 min of raw, 4 h of 1m buckets, 24 h of 5m buckets.
_RAW_LEN = 360
_ROLLUPS: Tuple[Tuple[float, int], ...] = ((60.0, 240), (300.0, 288))
_MAX_SERIES = 512
_MAX_ANNOTATIONS = 256

# footprint model (measured CPython approximations, documented in
# docs/observability.md): a raw point is a (float, float) tuple in a
# deque slot; a rollup bucket is a 6-slot object.
_POINT_BYTES = 120
_BUCKET_BYTES = 240
_SERIES_BYTES = 640        # per-series fixed overhead (dict entry, deques)
_ANNOTATION_BYTES = 512

# the recording-rule series FleetRecordingRules derives — the autoscaler
# sensor suite by name (docs/observability.md has the full table)
RECORDING_RULES: Tuple[str, ...] = (
    "fleet.offered_load",          # requests/s per model (counter->rate)
    "fleet.shed_rate",             # sheds/s per model (counter->rate)
    "fleet.latency_p50_seconds",   # exact, merged worker latency rings
    "fleet.latency_p99_seconds",   # exact, merged worker latency rings
    "fleet.queue_depth",           # summed ready-worker queue depth
    "fleet.workers_ready",         # live, ready worker count
    "worker.queue_depth",          # per {worker,model}
    "worker.boot_ready_seconds",   # spawn->READY_SENTINEL, per worker
    "worker.compiles_since_ready",  # warm-pool signal, per worker
)

# sensors that additionally carry EWMA/Holt forecasts
FORECAST_SENSORS: Tuple[str, ...] = (
    "offered_load", "shed_rate", "latency_p99_seconds", "queue_depth")
FORECAST_HORIZONS_S: Tuple[float, ...] = (60.0, 300.0)

_AGGS = ("mean", "min", "max", "last", "sum")


def history_enabled() -> bool:
    """The ``DL4JTPU_HISTORY`` kill switch (default: enabled)."""
    raw = os.environ.get(HISTORY_ENV, "1").strip().lower()
    return raw not in ("0", "false", "off", "no")


def _interval_from_env(default: float = 1.0) -> float:
    raw = os.environ.get(HISTORY_INTERVAL_ENV)
    if not raw:
        return default
    try:
        return max(0.01, float(raw))
    except ValueError:
        return default


# --------------------------------------------------------------------- store

class _Bucket:
    """One rollup bucket: count/sum/min/max/last over a resolution window."""

    __slots__ = ("start", "count", "sum", "min", "max", "last")

    def __init__(self, start: float, value: float):
        self.start = start
        self.count = 1
        self.sum = value
        self.min = value
        self.max = value
        self.last = value

    def add(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last = value

    def agg(self, how: str) -> float:
        if how == "mean":
            return self.sum / self.count
        if how == "min":
            return self.min
        if how == "max":
            return self.max
        if how == "sum":
            return self.sum
        return self.last


class _Series:
    """One named+labelled series: raw ring + rollup rings + counter state."""

    __slots__ = ("name", "labels", "kind", "raw", "rollups",
                 "last_cum", "last_cum_ts", "resets", "stale", "last_ts")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, raw_len: int,
                 rollups: Tuple[Tuple[float, int], ...]):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.raw: deque = deque(maxlen=raw_len)   # (ts, value|None)
        self.rollups: Dict[float, deque] = {
            res: deque(maxlen=length) for res, length in rollups}
        self.last_cum: Optional[float] = None     # counter rate state
        self.last_cum_ts = 0.0
        self.resets = 0
        self.stale = False
        self.last_ts = 0.0


class HistoryStore:
    """Bounded multi-resolution time-series store with injectable clock."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 raw_len: int = _RAW_LEN,
                 rollups: Tuple[Tuple[float, int], ...] = _ROLLUPS,
                 max_series: int = _MAX_SERIES,
                 max_annotations: int = _MAX_ANNOTATIONS):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.raw_len = int(raw_len)
        self.rollups = tuple((float(r), int(n)) for r, n in rollups)
        self.max_series = int(max_series)
        self.max_annotations = int(max_annotations)
        # wall-anchored monotonic clock: comparable to time.time() (flight
        # events, cross-process splicing) but immune to NTP steps
        self._wall0 = time.time()
        self._mono0 = time.monotonic()
        # record() lands from sampler/scrape threads while query() runs on
        # HTTP handler threads — every structure below is guarded here.
        # Reentrant: compound operations (record_counter, query) hold it
        # across the helper calls that re-acquire it
        self._lock = threading.RLock()
        self._series: Dict[tuple, _Series] = {}
        self._hist_state: Dict[tuple, tuple] = {}  # (ts, bounds, cum counts)
        self._annotations: deque = deque(maxlen=self.max_annotations)
        self.samples_total = 0
        self.evicted_total = 0
        self.stale_marked_total = 0
        self._m_samples = reg.counter(
            "dl4jtpu_history_samples_total",
            "time-series points recorded into the history store")
        self._m_series = reg.gauge(
            "dl4jtpu_history_series",
            "live series held by the history store")
        self._m_bytes = reg.gauge(
            "dl4jtpu_history_bytes",
            "estimated history-store footprint (rings + rollups + "
            "annotations), bounded by construction")
        self._m_stale = reg.counter(
            "dl4jtpu_history_stale_series_total",
            "series marked stale (explicit gap) because their worker's "
            "heartbeat exceeded the stale cutoff")
        self._m_evicted = reg.counter(
            "dl4jtpu_history_evicted_series_total",
            "series evicted (LRU) to hold the max_series bound")
        self._m_annotations = reg.counter(
            "dl4jtpu_history_annotations_total",
            "timeline annotations spliced from flight events, by kind",
            labelnames=("kind",))

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Wall-anchored monotonic timestamp (seconds)."""
        return self._wall0 + (time.monotonic() - self._mono0)

    def _ts(self, now: Optional[float]) -> float:
        return self.now() if now is None else float(now)

    @property
    def byte_budget(self) -> int:
        """The documented worst-case footprint at this configuration."""
        per_series = (self.raw_len * _POINT_BYTES + _SERIES_BYTES
                      + sum(n * _BUCKET_BYTES for _, n in self.rollups))
        return (self.max_series * per_series
                + self.max_annotations * _ANNOTATION_BYTES)

    # ----------------------------------------------------------- recording
    def _key(self, name: str, labels: Optional[dict]) -> tuple:
        lab = tuple(sorted((str(k), str(v))
                           for k, v in (labels or {}).items()))
        return (str(name), lab)

    def _get_series(self, name: str, labels: Optional[dict],
                    kind: str) -> _Series:
        """Find-or-create a series; LRU-evict past max_series."""
        key = self._key(name, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    victim = min(self._series,
                                 key=lambda k: self._series[k].last_ts)
                    del self._series[victim]
                    self.evicted_total += 1
                    self._m_evicted.inc()
                s = _Series(str(name), key[1], kind, self.raw_len,
                            self.rollups)
                self._series[key] = s
            return s

    def _append(self, s: _Series, ts: float, value: float) -> None:
        with self._lock:
            s.raw.append((ts, value))
            s.last_ts = ts
            s.stale = False  # a real sample resumes a stale series
            for res, ring in s.rollups.items():
                start = math.floor(ts / res) * res
                if ring and ring[-1].start == start:
                    ring[-1].add(value)
                elif not ring or ring[-1].start < start:
                    ring.append(_Bucket(start, value))
                # late sample older than the open bucket: raw keeps it
            self.samples_total += 1
            self._m_samples.inc()

    def record_gauge(self, name: str, value: float,
                     labels: Optional[dict] = None,
                     now: Optional[float] = None) -> float:
        """Record one gauge point; returns the recorded value."""
        ts = self._ts(now)
        v = float(value)
        with self._lock:
            s = self._get_series(name, labels, "gauge")
            self._append(s, ts, v)
        return v

    def record_counter(self, name: str, cumulative: float,
                       labels: Optional[dict] = None,
                       now: Optional[float] = None) -> Optional[float]:
        """Record a cumulative counter observation; the stored point is
        the derived per-second RATE. A drop in the cumulative value is a
        monotonic reset (process respawn): the rate is computed from the
        post-reset value alone, Prometheus ``rate()`` convention. The
        first observation is baseline-only and returns None."""
        ts = self._ts(now)
        v = float(cumulative)
        with self._lock:
            s = self._get_series(name, labels, "counter")
            prev, prev_ts = s.last_cum, s.last_cum_ts
            s.last_cum, s.last_cum_ts = v, ts
            if prev is None or ts <= prev_ts:
                s.last_ts = ts
                s.stale = False
                return None
            delta = v - prev
            if delta < 0:  # counter reset
                s.resets += 1
                delta = v
            rate = delta / (ts - prev_ts)
            self._append(s, ts, rate)
        return rate

    def record_histogram(self, name: str, buckets: dict,
                         labels: Optional[dict] = None,
                         now: Optional[float] = None,
                         quantiles: Tuple[float, ...] = (0.5, 0.99),
                         ) -> Dict[str, float]:
        """Turn a cumulative histogram snapshot (``{bound_str: cum_count}``
        with a ``+Inf`` key — the shape ``MetricFamily.summary()`` and the
        Prometheus text buckets produce) into interval-quantile gauge
        points named ``<name>:p50`` / ``<name>:p99``. The first snapshot
        per series is baseline-only."""
        ts = self._ts(now)
        try:
            parsed = sorted((float(b), float(c)) for b, c in buckets.items())
        except (TypeError, ValueError):
            return {}
        bounds = [b for b, _ in parsed]
        cum = [c for _, c in parsed]
        key = self._key(name, labels)
        out: Dict[str, float] = {}
        with self._lock:
            prev = self._hist_state.get(key)
            if len(self._hist_state) >= self.max_series and key not in \
                    self._hist_state:
                victim = min(self._hist_state,
                             key=lambda k: self._hist_state[k][0])
                del self._hist_state[victim]
            self._hist_state[key] = (ts, bounds, cum)
            if prev is None or prev[1] != bounds:
                return {}
            interval = [c - p for c, p in zip(cum, prev[2])]
            if any(x < 0 for x in interval):  # histogram reset (respawn)
                interval = list(cum)
            # de-cumulate into per-bucket counts
            per_bucket = [interval[0]] + [
                interval[i] - interval[i - 1]
                for i in range(1, len(interval))]
            total = interval[-1] if interval else 0.0
            if total <= 0:
                return {}
            for q in quantiles:
                v = _bucket_quantile(bounds, per_bucket, total, q)
                if v is None:
                    continue
                qname = f"{name}:p{int(round(q * 100))}"
                s = self._get_series(qname, labels, "gauge")
                self._append(s, ts, v)
                out[qname] = v
        return out

    # -------------------------------------------------------------- stale
    def mark_stale(self, labels: dict,
                   now: Optional[float] = None) -> int:
        """Mark every series carrying ``labels`` (subset match) stale:
        append one explicit gap point (value None) and count it. Series
        already stale are not re-marked; the next real sample under the
        same labels resumes the series."""
        ts = self._ts(now)
        want = {str(k): str(v) for k, v in labels.items()}
        marked = 0
        with self._lock:
            for s in self._series.values():
                lab = dict(s.labels)
                if s.stale or not all(lab.get(k) == v
                                      for k, v in want.items()):
                    continue
                if not s.raw:
                    continue
                s.raw.append((ts, None))  # the gap — never a flat-line
                s.stale = True
                s.last_ts = ts
                marked += 1
            self.stale_marked_total += marked
        if marked:
            self._m_stale.inc(marked)
        return marked

    # -------------------------------------------------------- annotations
    def annotate(self, kind: str, now: Optional[float] = None,
                 record_flight: bool = True, **payload) -> dict:
        """Splice one timeline annotation (rollout/respawn/swap/slo-burn
        flight events, or anything an operator posts). Rings a
        ``history_annotation`` flight event so the black box shows the
        splice itself."""
        ts = self._ts(now)
        ann = {"ts": ts, "kind": str(kind)}
        for k, v in payload.items():
            ann[str(k)] = v if isinstance(v, (int, float, bool, type(None))) \
                else str(v)[:200]
        with self._lock:
            self._annotations.append(ann)
        self._m_annotations.labels(kind=str(kind)).inc()
        if record_flight:
            try:
                from .flight_recorder import get_flight_recorder  # noqa: PLC0415

                get_flight_recorder().record(
                    "history_annotation", source_kind=str(kind), at=ts)
            except Exception:  # noqa: BLE001 - annotation must never raise
                pass
        return ann

    def annotations(self, start: Optional[float] = None,
                    end: Optional[float] = None) -> List[dict]:
        with self._lock:
            anns = list(self._annotations)
        if start is not None:
            anns = [a for a in anns if a["ts"] >= start]
        if end is not None:
            anns = [a for a in anns if a["ts"] <= end]
        return anns

    # ----------------------------------------------------------- ingestion
    def ingest_snapshot(self, snapshot: dict,
                        extra_labels: Optional[dict] = None,
                        prefix: str = "dl4jtpu_",
                        now: Optional[float] = None) -> int:
        """Ingest a ``MetricsRegistry.snapshot()``: counters become rate
        series, gauges record as-is, histograms become interval-quantile
        series. Returns the number of rows ingested."""
        ts = self._ts(now)
        rows = 0
        for name, fam in snapshot.items():
            if not name.startswith(prefix):
                continue
            kind = fam.get("type")
            for row in fam.get("values", ()):
                labels = dict(row.get("labels") or {})
                if extra_labels:
                    labels.update(extra_labels)
                if kind == "counter":
                    self.record_counter(name, row["value"], labels, now=ts)
                elif kind == "gauge":
                    self.record_gauge(name, row["value"], labels, now=ts)
                elif kind == "histogram":
                    self.record_histogram(name, row.get("buckets") or {},
                                          labels, now=ts)
                else:
                    continue
                rows += 1
        self._update_footprint()
        return rows

    def ingest_prometheus(self, text: str,
                          extra_labels: Optional[dict] = None,
                          prefix: str = "dl4jtpu_",
                          now: Optional[float] = None) -> int:
        """Ingest a Prometheus text exposition (a worker's ``/metrics``).
        Histogram families are reassembled from their ``_bucket`` lines
        into interval-quantile series; ``_count`` records as a rate."""
        ts = self._ts(now)
        types, samples = parse_prometheus_text(text)
        rows = 0
        hist_cum: Dict[tuple, dict] = {}
        for name, labels, value in samples:
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and \
                        types.get(name[: -len(suffix)]) == "histogram":
                    base = name[: -len(suffix)]
                    break
            if not base.startswith(prefix):
                continue
            lab = dict(labels)
            if base != name and name.endswith("_bucket"):
                le = lab.pop("le", None)
                if le is None:
                    continue
                if extra_labels:
                    lab.update(extra_labels)
                hist_cum.setdefault(
                    (base, tuple(sorted(lab.items()))), {})[le] = value
                continue
            if extra_labels:
                lab.update(extra_labels)
            if base != name and name.endswith("_sum"):
                continue  # quantiles + count-rate carry the signal
            if base != name and name.endswith("_count"):
                self.record_counter(f"{base}:count", value, lab, now=ts)
                rows += 1
                continue
            kind = types.get(name, "gauge")
            if kind == "counter":
                self.record_counter(name, value, lab, now=ts)
            else:
                self.record_gauge(name, value, lab, now=ts)
            rows += 1
        for (base, labkey), buckets in hist_cum.items():
            self.record_histogram(base, buckets, dict(labkey), now=ts)
            rows += 1
        self._update_footprint()
        return rows

    # --------------------------------------------------------------- query
    def query(self, select=None, labels: Optional[dict] = None,
              start: Optional[float] = None, end: Optional[float] = None,
              range_s: float = 300.0, step: Optional[float] = None,
              agg: str = "mean", now: Optional[float] = None,
              limit: int = 256) -> dict:
        """Query the store. ``select``: None (all), a name, or a list of
        names; a name ending in ``*`` prefix-matches. ``labels``: subset
        filter. Time range: ``[start, end]`` absolute seconds (default:
        the trailing ``range_s`` window). ``step``: resample into
        fixed-width bins (empty bins are explicit ``None`` gaps) with
        ``agg`` in mean|min|max|last|sum; without ``step`` the source
        resolution's points are returned as-is. The source resolution is
        the raw ring for short ranges/steps and the 1m/5m rollups beyond
        (``mean`` over rollups is the exact sample mean — buckets carry
        count+sum)."""
        if agg not in _AGGS:
            raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
        ts_now = self._ts(now)
        end_ts = ts_now if end is None else float(end)
        start_ts = (end_ts - float(range_s)) if start is None else \
            float(start)
        if step is not None:
            step = float(step)
            if step <= 0:
                raise ValueError(f"step must be > 0, got {step}")
        wanted = None
        if select is not None:
            wanted = [select] if isinstance(select, str) else list(select)
        want_labels = {str(k): str(v)
                       for k, v in (labels or {}).items()}
        span = max(0.0, end_ts - start_ts)
        source = self._pick_source(span, step)
        out_series = []
        with self._lock:
            keys = sorted(self._series)
            for key in keys:
                s = self._series[key]
                if wanted is not None and not _name_matches(s.name, wanted):
                    continue
                lab = dict(s.labels)
                if want_labels and not all(lab.get(k) == v
                                           for k, v in want_labels.items()):
                    continue
                pts = self._collect(s, source, start_ts, end_ts, step, agg)
                out_series.append({
                    "name": s.name, "labels": lab, "kind": s.kind,
                    "stale": s.stale, "resets": s.resets, "points": pts})
                if len(out_series) >= limit:
                    break
        return {
            "now": ts_now, "start": start_ts, "end": end_ts,
            "step": step, "agg": agg, "source": source,
            "series": out_series,
            "annotations": self.annotations(start_ts, end_ts),
        }

    def _pick_source(self, span: float, step: Optional[float]):
        """raw | rollup resolution, by step first, else by span."""
        if step is not None:
            for res, _ in sorted(self.rollups, reverse=True):
                if step >= res:
                    return res
            return "raw"
        smallest = min(res for res, _ in self.rollups)
        if span <= 2 * smallest * 5:  # ~10 min at the default ladder
            return "raw"
        for res, length in sorted(self.rollups):
            if span <= res * length:
                return res
        return max(res for res, _ in self.rollups)

    def _collect(self, s: _Series, source, start: float, end: float,
                 step: Optional[float], agg: str) -> List[list]:
        """Points for one series from the chosen resolution."""
        with self._lock:
            if source == "raw":
                pts = [(ts, v) for ts, v in s.raw if start <= ts <= end]
            else:
                ring = s.rollups.get(source)
                if ring is None:
                    return []
                buckets = [b for b in ring if start <= b.start <= end]
        if source == "raw":
            if step is None:
                return [[ts, v] for ts, v in pts]
            return _resample_points(pts, start, end, step, agg)
        if step is None:
            return [[b.start, b.agg(agg)] for b in buckets]
        return _resample_buckets(buckets, start, end, step, agg)

    def http_query(self, params: dict) -> dict:
        """Map ``GET /api/history`` query-string params onto
        :meth:`query`. Grammar (docs/observability.md):
        ``series=a,b,fleet.*`` · ``worker=`` / ``model=`` label filters ·
        ``start`` / ``end`` absolute or ``range_s`` trailing window ·
        ``step`` · ``agg=mean|min|max|last|sum``."""
        select = None
        if params.get("series"):
            select = [p for p in str(params["series"]).split(",") if p]
        labels = {k: params[k] for k in ("worker", "model")
                  if params.get(k)}

        def _f(key):
            return float(params[key]) if params.get(key) else None

        return self.query(
            select=select, labels=labels or None,
            start=_f("start"), end=_f("end"),
            range_s=_f("range_s") or 300.0,
            step=_f("step"), agg=params.get("agg") or "mean",
            now=_f("now"))

    # --------------------------------------------------------------- stats
    def _update_footprint(self) -> None:
        with self._lock:
            b = self._bytes_locked()
            n = len(self._series)
        self._m_bytes.set(b)
        self._m_series.set(n)

    def _bytes_locked(self) -> int:
        with self._lock:
            pts = sum(len(s.raw) for s in self._series.values())
            buckets = sum(len(r) for s in self._series.values()
                          for r in s.rollups.values())
            return (pts * _POINT_BYTES + buckets * _BUCKET_BYTES
                    + len(self._series) * _SERIES_BYTES
                    + len(self._annotations) * _ANNOTATION_BYTES)

    def bytes_estimate(self) -> int:
        with self._lock:
            return self._bytes_locked()

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def stats(self) -> dict:
        with self._lock:
            n = len(self._series)
            stale = sum(1 for s in self._series.values() if s.stale)
            bytes_now = self._bytes_locked()
            samples = self.samples_total
            evicted = self.evicted_total
            anns = len(self._annotations)
        return {
            "series": n, "stale_series": stale,
            "samples_total": samples, "evicted_total": evicted,
            "annotations": anns, "bytes": bytes_now,
            "byte_budget": self.byte_budget,
            "raw_len": self.raw_len,
            "rollups": [[res, n_] for res, n_ in self.rollups],
            "max_series": self.max_series,
        }

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._hist_state.clear()
            self._annotations.clear()


def _name_matches(name: str, wanted: List[str]) -> bool:
    for w in wanted:
        if w.endswith("*"):
            if name.startswith(w[:-1]):
                return True
        elif name == w:
            return True
    return False


def _resample_points(pts, start: float, end: float, step: float,
                     agg: str) -> List[list]:
    """Raw (ts, value) points into [start + k·step) bins; empty bins (and
    gap points) yield explicit None."""
    n_bins = max(0, int(math.floor((end - start) / step)) + 1)
    n_bins = min(n_bins, 4096)
    out = [[start + i * step, None] for i in range(n_bins)]
    acc: Dict[int, list] = {}
    for ts, v in pts:
        if v is None:
            continue
        i = int((ts - start) // step)
        if 0 <= i < n_bins:
            acc.setdefault(i, []).append(v)
    for i, vals in acc.items():
        if agg == "mean":
            out[i][1] = sum(vals) / len(vals)
        elif agg == "min":
            out[i][1] = min(vals)
        elif agg == "max":
            out[i][1] = max(vals)
        elif agg == "sum":
            out[i][1] = sum(vals)
        else:
            out[i][1] = vals[-1]
    return out


def _resample_buckets(buckets, start: float, end: float, step: float,
                      agg: str) -> List[list]:
    """Rollup buckets into bins. ``mean`` merges by count+sum, so the
    result is the exact sample mean, not a mean-of-means."""
    n_bins = max(0, int(math.floor((end - start) / step)) + 1)
    n_bins = min(n_bins, 4096)
    out = [[start + i * step, None] for i in range(n_bins)]
    acc: Dict[int, list] = {}
    for b in buckets:
        i = int((b.start - start) // step)
        if 0 <= i < n_bins:
            acc.setdefault(i, []).append(b)
    for i, bs in acc.items():
        if agg == "mean":
            out[i][1] = sum(b.sum for b in bs) / sum(b.count for b in bs)
        elif agg == "min":
            out[i][1] = min(b.min for b in bs)
        elif agg == "max":
            out[i][1] = max(b.max for b in bs)
        elif agg == "sum":
            out[i][1] = sum(b.sum for b in bs)
        else:
            out[i][1] = bs[-1].last
    return out


def _bucket_quantile(bounds, per_bucket, total: float,
                     q: float) -> Optional[float]:
    """Prometheus histogram_quantile: linear interpolation inside the
    bucket holding rank q·total; the +Inf bucket clamps to the largest
    finite bound."""
    rank = q * total
    cum = 0.0
    finite = [b for b in bounds if math.isfinite(b)]
    if not finite:
        return None
    for i, b in enumerate(bounds):
        c = per_bucket[i]
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            if not math.isfinite(b):
                return finite[-1]
            lo = bounds[i - 1] if i > 0 and math.isfinite(bounds[i - 1]) \
                else 0.0
            return lo + (b - lo) * ((rank - prev_cum) / c)
    return finite[-1]


# --------------------------------------------------- prometheus text parsing

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (\w+)")


def parse_prometheus_text(text: str):
    """Minimal Prometheus text-format parser. Returns ``(types, samples)``
    where types maps family name -> type and samples is a list of
    ``(name, labels_dict, value)``. Exemplar suffixes are stripped."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                types[m.group(1)] = m.group(2)
            continue
        line = line.split(" # ", 1)[0].rstrip()  # OpenMetrics exemplar
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, _, labelstr, raw = m.groups()
        try:
            value = float(raw)
        except ValueError:
            continue
        if math.isnan(value):
            continue
        labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                  .replace("\\n", "\n")
                  for k, v in _LABEL_PAIR_RE.findall(labelstr or "")}
        samples.append((name, labels, value))
    return types, samples


# -------------------------------------------------------------------- sampler

class HistorySampler:
    """Ticks a registry snapshot into the store on a Deadline-paced
    thread. ``tick(now=...)`` is public so tests drive it with an
    injected clock and no thread."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 store: Optional[HistoryStore] = None, *,
                 interval_s: Optional[float] = None,
                 extra_labels: Optional[dict] = None,
                 prefix: str = "dl4jtpu_",
                 site: str = "telemetry.history.sampler"):
        from ..runtime.resilience import DeadlinePolicy  # noqa: PLC0415

        self.registry = registry if registry is not None else get_registry()
        self.store = store if store is not None else get_history_store()
        self.interval_s = (float(interval_s) if interval_s is not None
                           else _interval_from_env())
        self.extra_labels = dict(extra_labels or {})
        self.prefix = prefix
        self._policy = DeadlinePolicy(site, self.interval_s)
        self._stop = threading.Event()
        self._enabled = threading.Event()
        self._enabled.set()
        self._lock = threading.Lock()
        self.ticks = 0
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: Optional[float] = None) -> int:
        """One sampling pass; returns rows ingested."""
        rows = self.store.ingest_snapshot(
            self.registry.snapshot(), extra_labels=self.extra_labels,
            prefix=self.prefix, now=now)
        with self._lock:
            self.ticks += 1
        return rows

    def _loop(self) -> None:
        while not self._stop.is_set():
            deadline = self._policy.start()
            if self._enabled.is_set():
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - sampling must outlive blips
                    pass
            deadline.wait_event(self._stop)

    def start(self) -> "HistorySampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="dl4jtpu-history-sampler")
            self._thread.start()
        return self

    def pause(self) -> None:
        """Stop ingesting without killing the pacing thread (the bench
        overhead gate toggles this between interleaved trials)."""
        self._enabled.clear()

    def resume(self) -> None:
        self._enabled.set()

    @property
    def paused(self) -> bool:
        return not self._enabled.is_set()

    def stop(self) -> None:
        self._stop.set()

    def stats(self) -> dict:
        with self._lock:
            ticks = self.ticks
        return {"interval_s": self.interval_s, "ticks": ticks,
                "paused": self.paused, "prefix": self.prefix}


# ------------------------------------------------------------------ forecast

class Forecast:
    """Holt linear trend with irregular-interval updates; ``beta=0``
    degenerates to plain EWMA (level only, zero trend)."""

    __slots__ = ("alpha", "beta", "level", "trend", "last_ts", "n")

    def __init__(self, alpha: float = 0.5, beta: float = 0.3):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.level: Optional[float] = None
        self.trend = 0.0
        self.last_ts: Optional[float] = None
        self.n = 0

    def update(self, value: float, ts: float) -> None:
        v = float(value)
        if self.level is None or self.last_ts is None:
            self.level, self.last_ts, self.n = v, float(ts), 1
            return
        dt = float(ts) - self.last_ts
        if dt <= 0:
            return
        prev_level = self.level
        predicted = self.level + self.trend * dt
        self.level = self.alpha * v + (1.0 - self.alpha) * predicted
        if self.beta > 0:
            self.trend = (self.beta * (self.level - prev_level) / dt
                          + (1.0 - self.beta) * self.trend)
        self.last_ts = float(ts)
        self.n += 1

    def forecast(self, horizon_s: float) -> Optional[float]:
        if self.level is None:
            return None
        return self.level + self.trend * float(horizon_s)


class FleetRecordingRules:
    """Derives the autoscaler sensor suite (``RECORDING_RULES``) from a
    router's ``stats()`` payload each scrape tick, and maintains EWMA +
    Holt forecasts per key sensor, exported as ``dl4jtpu_forecast_*``
    gauges with horizon labels (``ewma``, ``trend_per_s``, ``60s``,
    ``300s``). One instance per router; the forecast gauge families are
    declared here."""

    def __init__(self, store: Optional[HistoryStore] = None,
                 registry: Optional[MetricsRegistry] = None, *,
                 alpha: float = 0.5, beta: float = 0.3):
        reg = registry if registry is not None else get_registry()
        self.store = store if store is not None else get_history_store()
        self.alpha = float(alpha)
        self.beta = float(beta)
        # observe_fleet runs on the router's scrape thread; stats()/tests
        # read the forecast table from others
        self._lock = threading.Lock()
        self._forecasts: Dict[tuple, Tuple[Forecast, Forecast]] = {}
        self._fam = {
            "offered_load": reg.gauge(
                "dl4jtpu_forecast_offered_load",
                "EWMA/Holt forecast of per-model offered load "
                "(requests/s), by horizon",
                labelnames=("model", "horizon")),
            "shed_rate": reg.gauge(
                "dl4jtpu_forecast_shed_rate",
                "EWMA/Holt forecast of per-model shed rate (sheds/s), "
                "by horizon",
                labelnames=("model", "horizon")),
            "latency_p99_seconds": reg.gauge(
                "dl4jtpu_forecast_latency_p99_seconds",
                "EWMA/Holt forecast of the exact merged-ring p99 latency, "
                "by horizon",
                labelnames=("model", "horizon")),
            "queue_depth": reg.gauge(
                "dl4jtpu_forecast_queue_depth",
                "EWMA/Holt forecast of summed ready-worker queue depth, "
                "by horizon",
                labelnames=("model", "horizon")),
        }

    def observe_fleet(self, fleet_stats: dict,
                      now: Optional[float] = None) -> Dict[str, float]:
        """One recording-rule pass over a router ``stats()`` payload.
        Returns the sensor values observed this tick (rate sensors are
        absent on their baseline tick)."""
        ts = self.store._ts(now)  # noqa: SLF001 - same-module clock
        model = str(fleet_stats.get("model", "default"))
        lab = {"model": model}
        sensors: Dict[str, Optional[float]] = {}
        sensors["offered_load"] = self.store.record_counter(
            "fleet.offered_load", fleet_stats.get("requests_total", 0),
            lab, now=ts)
        sensors["shed_rate"] = self.store.record_counter(
            "fleet.shed_rate", fleet_stats.get("shed_total", 0),
            lab, now=ts)
        lat = fleet_stats.get("latency_seconds") or {}
        if lat.get("p50") is not None:
            self.store.record_gauge("fleet.latency_p50_seconds",
                                    lat["p50"], lab, now=ts)
        if lat.get("p99") is not None:
            sensors["latency_p99_seconds"] = self.store.record_gauge(
                "fleet.latency_p99_seconds", lat["p99"], lab, now=ts)
        workers = fleet_stats.get("workers") or []
        ready = [w for w in workers if w.get("ready")]
        qd = float(sum(w.get("queue_depth") or 0 for w in ready))
        sensors["queue_depth"] = self.store.record_gauge(
            "fleet.queue_depth", qd, lab, now=ts)
        self.store.record_gauge("fleet.workers_ready", len(ready),
                                lab, now=ts)
        for w in workers:
            wlab = {"model": model, "worker": str(w.get("id"))}
            if w.get("ready"):
                self.store.record_gauge("worker.queue_depth",
                                        w.get("queue_depth") or 0,
                                        wlab, now=ts)
            if w.get("boot_seconds") is not None:
                self.store.record_gauge("worker.boot_ready_seconds",
                                        w["boot_seconds"], wlab, now=ts)
            if w.get("compiles_since_ready") is not None:
                self.store.record_gauge("worker.compiles_since_ready",
                                        w["compiles_since_ready"],
                                        wlab, now=ts)
        self._update_forecasts(sensors, model, ts)
        return {k: v for k, v in sensors.items() if v is not None}

    def _update_forecasts(self, sensors: Dict[str, Optional[float]],
                          model: str, ts: float) -> None:
        for sensor in FORECAST_SENSORS:
            value = sensors.get(sensor)
            if value is None:
                continue
            with self._lock:
                pair = self._forecasts.get((sensor, model))
                if pair is None:
                    pair = (Forecast(self.alpha, 0.0),
                            Forecast(self.alpha, self.beta))
                    self._forecasts[(sensor, model)] = pair
                ewma, holt = pair
                ewma.update(value, ts)
                holt.update(value, ts)
                level, trend = ewma.level, holt.trend
                horizons = {f"{int(h)}s": holt.forecast(h)
                            for h in FORECAST_HORIZONS_S}
            fam = self._fam[sensor]
            fam.labels(model=model, horizon="ewma").set(level)
            fam.labels(model=model, horizon="trend_per_s").set(trend)
            for hname, hval in horizons.items():
                if hval is not None:
                    fam.labels(model=model, horizon=hname).set(hval)

    def forecast_table(self) -> dict:
        """{(sensor, model): {ewma, trend_per_s, <horizon>s...}} for
        stats/debugging."""
        out = {}
        with self._lock:
            for (sensor, model), (ewma, holt) in self._forecasts.items():
                row = {"ewma": ewma.level, "trend_per_s": holt.trend,
                       "samples": holt.n}
                for h in FORECAST_HORIZONS_S:
                    row[f"{int(h)}s"] = holt.forecast(h)
                out[f"{sensor}{{model={model}}}"] = row
        return out


# ------------------------------------------------------------------ globals

_STORE: Optional[HistoryStore] = None
_SAMPLER: Optional[HistorySampler] = None
# reentrant: ensure_default_sampler holds it while HistorySampler's ctor
# re-enters through get_history_store()
_GLOBAL_LOCK = threading.RLock()


def get_history_store() -> HistoryStore:
    """The process-wide history store (what ``/api/history`` serves)."""
    global _STORE
    with _GLOBAL_LOCK:
        if _STORE is None:
            _STORE = HistoryStore()
        return _STORE


def set_history_store(store: Optional[HistoryStore]) -> None:
    """Swap the process-wide store (tests); None resets to lazy
    re-creation."""
    global _STORE
    with _GLOBAL_LOCK:
        _STORE = store


def ensure_default_sampler(interval_s: Optional[float] = None,
                           ) -> Optional[HistorySampler]:
    """Start the process-wide sampler over the default registry (no-op
    when ``DL4JTPU_HISTORY=0``; idempotent). The serving front-end calls
    this on construction so any serving/worker process grows history
    automatically."""
    if not history_enabled():
        return None
    global _SAMPLER
    with _GLOBAL_LOCK:
        if _SAMPLER is None:
            _SAMPLER = HistorySampler(interval_s=interval_s)
            _SAMPLER.start()
        return _SAMPLER


def get_default_sampler() -> Optional[HistorySampler]:
    with _GLOBAL_LOCK:
        return _SAMPLER


def set_default_sampler(sampler: Optional[HistorySampler]) -> None:
    """Swap the process-wide sampler (tests). The old sampler is NOT
    stopped — callers own that."""
    global _SAMPLER
    with _GLOBAL_LOCK:
        _SAMPLER = sampler


# the annotation splice rings its own flight-event kind; registered here
# (the owning module) and listed in flight_recorder.py's inventory table
def _register_kinds() -> None:
    try:
        from .flight_recorder import register_event_kind  # noqa: PLC0415

        register_event_kind("history_annotation")
    except Exception:  # noqa: BLE001 - registration must never block import
        pass


_register_kinds()
