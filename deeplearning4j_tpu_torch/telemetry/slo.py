"""SLO monitor: declared objectives and multi-window burn-rate alerting
(counterpart of ``deeplearning4j_tpu/telemetry/slo.py``; host code over the
port's ``registry``, ``watchdog`` and ``flight_recorder``).

A latency ring and a shed counter say what happened; an SLO says whether
it was *acceptable*. This module evaluates declared objectives over the
serving observations the service produces:

- ``latency`` — the fraction of requests over the per-model latency
  budget must stay under ``1 - latency_target`` (default target 0.99).
- ``availability`` — shed and errored requests must stay under
  ``1 - availability_target`` (default 0.999).

**Burn rate** is the observed bad fraction over the allowed bad fraction:
burn 1.0 spends the error budget exactly at the sustainable pace.
Alerting is **multi-window** (fast 5 min AND slow 1 h must both burn hot),
so one bad micro-batch pages no one while a sustained regression fires
within minutes.

A breach emits a Watchdog :class:`AnomalyEvent` (kind ``slo-burn``), which
the flight recorder auto-dumps; the ``slo_burn`` flight event lists the
offending trace ids. Exported series: ``dl4jtpu_slo_burn_rate{model,
objective}`` (fast-window burn) and ``dl4jtpu_slo_breaches_total{model,
objective}``.

Timestamps are injectable (``observe(..., now=...)`` /
``evaluate(now=...)``) so the burn math is testable on synthetic rings.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import MetricsRegistry, get_registry
from .watchdog import SLO_BURN, Watchdog

__all__ = [
    "SLO_AVAILABILITY_TARGET_ENV",
    "SLO_LATENCY_BUDGET_ENV",
    "SLO_LATENCY_TARGET_ENV",
    "SLOMonitor",
    "get_slo_monitor",
    "set_slo_monitor",
]

# env-declared objectives for services that don't declare programmatically
SLO_LATENCY_BUDGET_ENV = "DL4JTPU_SLO_LATENCY_BUDGET_MS"
SLO_LATENCY_TARGET_ENV = "DL4JTPU_SLO_LATENCY_TARGET"
SLO_AVAILABILITY_TARGET_ENV = "DL4JTPU_SLO_AVAILABILITY_TARGET"

_FAST_WINDOW_S = 300.0    # 5 minutes
_SLOW_WINDOW_S = 3600.0   # 1 hour


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class _Objectives:
    """One model's declared targets."""

    __slots__ = ("latency_budget_ms", "latency_target",
                 "availability_target")

    def __init__(self, latency_budget_ms: Optional[float],
                 latency_target: float, availability_target: float):
        self.latency_budget_ms = latency_budget_ms
        self.latency_target = float(latency_target)
        self.availability_target = float(availability_target)

    def to_dict(self) -> dict:
        return {
            "latency_budget_ms": self.latency_budget_ms,
            "latency_target": self.latency_target,
            "availability_target": self.availability_target,
        }


class SLOMonitor:
    """Declared objectives + timestamped observation rings + burn math."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 watchdog: Optional[Watchdog] = None,
                 fast_window_s: float = _FAST_WINDOW_S,
                 slow_window_s: float = _SLOW_WINDOW_S,
                 fast_burn_threshold: float = 14.4,
                 slow_burn_threshold: float = 6.0,
                 min_breach_interval_s: float = 60.0,
                 ring_size: int = 8192):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        self.min_breach_interval_s = float(min_breach_interval_s)
        self.ring_size = int(ring_size)
        # observation tuples: (ts, latency_s|None, bad_avail, trace_id|None)
        self._rings: Dict[str, deque] = {}
        self._objectives: Dict[str, _Objectives] = {}
        self._last_breach: Dict[tuple, float] = {}
        self._breaches: List[dict] = []
        self._last_eval = 0.0
        # observe() lands from batcher callback threads while evaluate()
        # runs on whichever thread tripped the throttle
        self._lock = threading.Lock()
        self._watchdog = watchdog
        self._m_burn = reg.gauge(
            "dl4jtpu_slo_burn_rate",
            "fast-window SLO burn rate (bad fraction / error budget), "
            "by model and objective",
            labelnames=("model", "objective"))
        self._m_breaches = reg.counter(
            "dl4jtpu_slo_breaches_total",
            "multi-window SLO burn-rate breaches, by model and objective",
            labelnames=("model", "objective"))

    # --------------------------------------------------------- declaration
    def declare(self, model: str, *,
                latency_budget_ms: Optional[float] = None,
                latency_target: float = 0.99,
                availability_target: float = 0.999) -> "SLOMonitor":
        """Declare (or re-declare) a model's objectives. A None latency
        budget disables the latency objective; availability is always
        evaluated."""
        with self._lock:
            self._objectives[str(model)] = _Objectives(
                None if latency_budget_ms is None
                else float(latency_budget_ms),
                latency_target, availability_target)
            self._rings.setdefault(str(model),
                                   deque(maxlen=self.ring_size))
        return self

    def declare_from_env(self, model: str,
                         latency_budget_ms: Optional[float] = None) -> None:
        """Declare from the ``DL4JTPU_SLO_*`` env knobs; an explicit
        ``latency_budget_ms`` (e.g. the admission budget) is the fallback
        when the env doesn't name one."""
        budget = _env_float(SLO_LATENCY_BUDGET_ENV)
        if budget is None:
            budget = latency_budget_ms
        self.declare(
            model,
            latency_budget_ms=budget,
            latency_target=_env_float(SLO_LATENCY_TARGET_ENV) or 0.99,
            availability_target=(
                _env_float(SLO_AVAILABILITY_TARGET_ENV) or 0.999))

    def objectives(self, model: str) -> Optional[dict]:
        with self._lock:
            obj = self._objectives.get(str(model))
        return obj.to_dict() if obj is not None else None

    # -------------------------------------------------------- observations
    def observe(self, model: str, *, latency_s: Optional[float] = None,
                shed: bool = False, error: bool = False,
                trace_id: Optional[str] = None,
                now: Optional[float] = None) -> None:
        """One serving observation: a completed request's latency, or a
        shed/errored request (no latency — it never ran)."""
        ts = time.time() if now is None else float(now)
        with self._lock:
            ring = self._rings.get(str(model))
            if ring is None:
                ring = self._rings[str(model)] = deque(
                    maxlen=self.ring_size)
            ring.append((ts, latency_s, bool(shed or error), trace_id))

    # ---------------------------------------------------------- burn math
    def _window(self, ring, budget_ms: Optional[float],
                window_s: float, now: float):
        """(total, latency_bad, avail_bad, offending trace ids) over the
        trailing window."""
        cutoff = now - window_s
        total = lat_bad = avail_bad = 0
        offending: List[str] = []
        for ts, latency_s, bad_avail, trace_id in ring:
            if ts < cutoff:
                continue
            total += 1
            bad = False
            if bad_avail:
                avail_bad += 1
                bad = True
            if (budget_ms is not None and latency_s is not None
                    and latency_s * 1000.0 > budget_ms):
                lat_bad += 1
                bad = True
            if bad and trace_id is not None:
                offending.append(trace_id)
        return total, lat_bad, avail_bad, offending

    @staticmethod
    def _burn(bad: int, total: int, target: float) -> float:
        if total <= 0:
            return 0.0
        allowed = max(1e-9, 1.0 - float(target))
        return (bad / total) / allowed

    def burn_rates(self, model: str,
                   now: Optional[float] = None) -> Dict[str, dict]:
        """{objective: {fast, slow, offending_traces}} for one model."""
        ts = time.time() if now is None else float(now)
        with self._lock:
            obj = self._objectives.get(str(model))
            ring = list(self._rings.get(str(model)) or ())
        if obj is None:
            return {}
        out: Dict[str, dict] = {}
        for window_name, window_s in (("fast", self.fast_window_s),
                                      ("slow", self.slow_window_s)):
            total, lat_bad, avail_bad, offending = self._window(
                ring, obj.latency_budget_ms, window_s, ts)
            if obj.latency_budget_ms is not None:
                row = out.setdefault("latency", {"offending_traces": []})
                row[window_name] = self._burn(lat_bad, total,
                                              obj.latency_target)
                row[f"{window_name}_total"] = total
            row = out.setdefault("availability", {"offending_traces": []})
            row[window_name] = self._burn(avail_bad, total,
                                          obj.availability_target)
            row[f"{window_name}_total"] = total
            if window_name == "fast":
                for r in out.values():
                    r["offending_traces"] = sorted(set(offending))[-16:]
        return out

    # ---------------------------------------------------------- evaluation
    def _get_watchdog(self) -> Watchdog:
        if self._watchdog is None:
            from .flight_recorder import get_flight_recorder  # noqa: PLC0415

            wd = Watchdog(registry=self.registry)
            wd.add_sink(get_flight_recorder().watchdog_sink)
            self._watchdog = wd
        return self._watchdog

    def maybe_evaluate(self, now: Optional[float] = None,
                       min_interval_s: float = 1.0) -> None:
        """Hot-path hook: evaluate at most every ``min_interval_s`` — one
        monotonic read when throttled."""
        t = time.monotonic()
        with self._lock:
            if t - self._last_eval < min_interval_s:
                return
            self._last_eval = t
        self.evaluate(now=now)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every declared objective; returns the breaches fired
        by THIS call (after per-objective rate limiting)."""
        ts = time.time() if now is None else float(now)
        with self._lock:
            models = sorted(self._objectives)
        fired: List[dict] = []
        for model in models:
            rates = self.burn_rates(model, now=ts)
            for objective, row in rates.items():
                fast, slow = row.get("fast", 0.0), row.get("slow", 0.0)
                self._m_burn.labels(model=model,
                                    objective=objective).set(fast)
                if (fast < self.fast_burn_threshold
                        or slow < self.slow_burn_threshold):
                    continue
                key = (model, objective)
                mono = time.monotonic()
                with self._lock:
                    last = self._last_breach.get(key)
                    if (last is not None and mono - last
                            < self.min_breach_interval_s):
                        continue
                    self._last_breach[key] = mono
                breach = {
                    "model": model, "objective": objective,
                    "fast_burn": round(fast, 4),
                    "slow_burn": round(slow, 4),
                    "offending_traces": row.get("offending_traces", []),
                    "timestamp": ts,
                }
                with self._lock:
                    self._breaches.append(breach)
                    del self._breaches[:-64]
                fired.append(breach)
                self._m_breaches.labels(model=model,
                                        objective=objective).inc()
                try:
                    from .flight_recorder import get_flight_recorder  # noqa: PLC0415

                    get_flight_recorder().record(
                        "slo_burn", model=model, objective=objective,
                        fast_burn=round(fast, 4), slow_burn=round(slow, 4),
                        offending_traces=list(
                            row.get("offending_traces", [])))
                except Exception:  # pragma: no cover - defensive
                    pass
                self._get_watchdog().emit(
                    SLO_BURN, iteration=0, value=fast,
                    threshold=self.fast_burn_threshold,
                    message=(
                        f"SLO burn: model {model!r} {objective} burning "
                        f"{fast:.1f}x fast / {slow:.1f}x slow (thresholds "
                        f"{self.fast_burn_threshold}/"
                        f"{self.slow_burn_threshold}); offending traces: "
                        f"{row.get('offending_traces', [])}"))
        return fired

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The ``GET /api/slo`` payload."""
        with self._lock:
            models = sorted(self._objectives)
            objectives = {m: self._objectives[m].to_dict() for m in models}
            breaches = list(self._breaches)
            samples = {m: len(self._rings.get(m) or ()) for m in models}
        return {
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "thresholds": {"fast_burn": self.fast_burn_threshold,
                           "slow_burn": self.slow_burn_threshold},
            "objectives": objectives,
            "burn": {m: self.burn_rates(m) for m in models},
            "samples": samples,
            "recent_breaches": breaches[-16:],
            "breaches_total": len(breaches),
        }


_GLOBAL: Optional[SLOMonitor] = None
_GLOBAL_LOCK = threading.Lock()


def get_slo_monitor() -> SLOMonitor:
    """The process-wide SLO monitor (serving observes into it; the UI
    server and workers serve its stats)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = SLOMonitor()
        return _GLOBAL


def set_slo_monitor(monitor: Optional[SLOMonitor]) -> None:
    """Swap the process-wide monitor (tests); None resets to lazy
    re-creation."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = monitor
