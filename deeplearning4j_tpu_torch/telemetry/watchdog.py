"""Watchdog: turn fetched step metrics into structured anomaly events
(counterpart of ``deeplearning4j_tpu/telemetry/watchdog.py``, host code, kept
as a copy: the same kinds and thresholds).

Consumes the rows the K-step fetch materializes (loss, grad-norm, non-finite
flag, optional step time) and emits :class:`AnomalyEvent`s for the failure
modes that silently burn device hours in production:

- ``nan-loss``: the non-finite flag fired or the fetched loss is NaN/Inf
  (the reference's training just diverged quietly; here an alertable event).
- ``exploding-grad-norm``: grad norm above ``grad_norm_limit``.
- ``stalled-step-time``: a step took more than ``stall_factor`` times the
  rolling median (or more than ``step_time_limit_s`` absolutely) — the
  hang / input-starvation signature.

Sinks are pluggable callables ``sink(event)``; the default keeps events in
``watchdog.events`` and logs a warning. Every event also increments
``dl4jtpu_anomalies_total{kind=...}`` in the registry, so an alerting stack
can fire off the counter without parsing logs.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .registry import MetricsRegistry, get_registry

logger = logging.getLogger(__name__)

NAN_LOSS = "nan-loss"
EXPLODING_GRAD_NORM = "exploding-grad-norm"
STALLED_STEP_TIME = "stalled-step-time"
# online-learning drift kinds (emitted through Watchdog.emit by the JAX
# package's runtime/online.py; kept so both packages name the same kinds)
LOSS_DRIFT = "loss-drift"
INPUT_SHIFT = "input-shift"
# SLO burn-rate breach (the JAX package's telemetry/slo.py emits it through
# Watchdog.emit; the port's serving side comes later)
SLO_BURN = "slo-burn"


@dataclass(frozen=True)
class AnomalyEvent:
    kind: str           # NAN_LOSS | EXPLODING_GRAD_NORM | STALLED_STEP_TIME
    iteration: int
    value: float        # the offending measurement
    threshold: float    # the limit it crossed
    message: str
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "iteration": self.iteration,
            "value": self.value,
            "threshold": self.threshold,
            "message": self.message,
            "timestamp": self.timestamp,
        }


def logging_sink(event: AnomalyEvent) -> None:
    logger.warning("telemetry watchdog: %s", event.to_dict())


class Watchdog:
    """Anomaly detector over fetched step metrics."""

    def __init__(
        self,
        sinks: Optional[List[Callable[[AnomalyEvent], None]]] = None,
        grad_norm_limit: float = 1e3,
        step_time_limit_s: Optional[float] = None,
        stall_factor: float = 10.0,
        stall_warmup_steps: int = 5,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.sinks = list(sinks) if sinks is not None else [logging_sink]
        self.grad_norm_limit = float(grad_norm_limit)
        self.step_time_limit_s = step_time_limit_s
        self.stall_factor = float(stall_factor)
        self.stall_warmup_steps = int(stall_warmup_steps)
        self.events: List[AnomalyEvent] = []
        self._step_times: List[float] = []
        # guards sinks/events/_step_times: observe() runs on the fetch
        # thread while add_sink()/emit() arrive from serving/online threads
        self._lock = threading.Lock()
        reg = registry if registry is not None else get_registry()
        self._anomalies = reg.counter(
            "dl4jtpu_anomalies_total",
            "watchdog anomaly events by kind",
            labelnames=("kind",),
        )

    def add_sink(self, sink: Callable[[AnomalyEvent], None]) -> None:
        with self._lock:
            self.sinks.append(sink)

    def _emit(self, kind: str, iteration: int, value: float,
              threshold: float, message: str) -> None:
        event = AnomalyEvent(kind=kind, iteration=iteration, value=value,
                             threshold=threshold, message=message)
        with self._lock:
            self.events.append(event)
            sinks = list(self.sinks)
        self._anomalies.labels(kind=kind).inc()
        for sink in sinks:
            try:
                sink(event)
            except Exception:  # a broken sink must never kill the train loop
                logger.exception("telemetry watchdog sink failed")

    def emit(self, kind: str, iteration: int, value: float,
             threshold: float, message: str) -> None:
        """Emit a caller-detected anomaly through the watchdog's sinks and
        counter — the hook the online-learning drift detectors use (their
        signals live in window statistics the per-step ``observe`` path
        never sees)."""
        self._emit(str(kind), int(iteration), float(value), float(threshold),
                   str(message))

    def observe(self, iteration: int, loss: float, grad_norm: float,
                nonfinite: float = 0.0,
                step_time_s: Optional[float] = None) -> None:
        """Check one fetched step row; called by Telemetry at fetch time."""
        if nonfinite > 0 or not math.isfinite(loss):
            self._emit(
                NAN_LOSS, iteration, loss, 0.0,
                f"non-finite loss/gradients at iteration {iteration} "
                f"(loss={loss})",
            )
        elif math.isfinite(grad_norm) and grad_norm > self.grad_norm_limit:
            self._emit(
                EXPLODING_GRAD_NORM, iteration, grad_norm,
                self.grad_norm_limit,
                f"gradient norm {grad_norm:.4g} exceeds limit "
                f"{self.grad_norm_limit:.4g} at iteration {iteration}",
            )
        if step_time_s is None:
            return
        limit = None
        if self.step_time_limit_s is not None:
            limit = float(self.step_time_limit_s)
        else:
            with self._lock:
                if len(self._step_times) >= self.stall_warmup_steps:
                    med = sorted(self._step_times)[
                        len(self._step_times) // 2]
                    limit = med * self.stall_factor
        if limit is not None and step_time_s > limit:
            self._emit(
                STALLED_STEP_TIME, iteration, step_time_s, limit,
                f"step {iteration} took {step_time_s:.4g}s "
                f"(limit {limit:.4g}s)",
            )
        else:
            # stalls don't poison the baseline median
            with self._lock:
                self._step_times.append(float(step_time_s))
                if len(self._step_times) > 256:
                    del self._step_times[0]
