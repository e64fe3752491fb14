"""Telemetry session: the glue between training steps and the registry
(counterpart of ``deeplearning4j_tpu/telemetry/session.py``).

One :class:`Telemetry` object rides a training run. The fit paths hand it
the device-side metrics vector each step (``on_step``) or the whole
``[steps, NUM_SLOTS]`` window buffer of a staged window (``on_staged``); it
fetches to host at most once every ``fetch_every`` steps (ONE ``.cpu()`` of
the stacked pending vectors), records into the registry, and feeds the
watchdog.

The overhead contract:

- ``on_step`` appends a device vector and bumps host-side counters — no
  device read, no sync.
- A fetch happens when K vectors are pending (or at ``flush()``, which the
  fit loops call once at the end of training). ``fetch_count`` is public so
  tests can assert the ceil(steps/K) bound; ``_fetch`` is the seam that
  counts host reads.
- ``on_staged`` is one fetch for the whole window regardless of K: the
  staged loop hands it rows the window's one read has already brought to
  the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import device as device_stats
from .registry import MetricsRegistry, get_registry
from .watchdog import Watchdog


class Telemetry:
    """Per-run recorder: K-step device fetch -> registry + watchdog."""

    # staticmethod indirection so tests can count host fetches: a device
    # tensor comes to the host in one read
    _fetch = staticmethod(lambda t: np.asarray(t.cpu() if hasattr(t, "cpu") else t))

    DEFAULT_FETCH_EVERY = 10

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        fetch_every: Optional[int] = None,
        watchdog: Optional[Watchdog] = None,
        prefix: str = "dl4jtpu_train",
        flight_recorder=None,
        sample_memory: bool = True,
    ):
        from .flight_recorder import get_flight_recorder  # noqa: PLC0415

        self.registry = registry if registry is not None else get_registry()
        # None = the library default (the JAX package's tuned-config store
        # may retarget it; the port has no such store)
        self.fetch_every_explicit = fetch_every is not None
        self.fetch_every = max(1, int(
            self.DEFAULT_FETCH_EVERY if fetch_every is None else fetch_every))
        self.watchdog = watchdog
        # black box: step rows ring into the flight recorder at fetch time,
        # and the recorder rides the watchdog as a sink so an anomaly dumps
        # a post-mortem bundle (telemetry/flight_recorder.py)
        self.flight = (flight_recorder if flight_recorder is not None
                       else get_flight_recorder())
        self.sample_memory = bool(sample_memory)
        if self.watchdog is not None and self.flight is not None:
            if not any(getattr(s, "__self__", None) is self.flight
                       for s in self.watchdog.sinks):
                self.watchdog.add_sink(self.flight.watchdog_sink)
        self.fetch_count = 0
        self._pending: List[Tuple[int, object, Optional[float]]] = []
        self._last_step_t: Optional[float] = None
        r = self.registry
        self.steps = r.counter(f"{prefix}_steps_total",
                               "optimizer steps dispatched")
        self.loss_gauge = r.gauge(f"{prefix}_loss",
                                  "last fetched training loss")
        self.grad_norm_gauge = r.gauge(f"{prefix}_grad_norm",
                                       "last fetched global gradient norm")
        self.grad_norm_hist = r.histogram(
            f"{prefix}_grad_norm_hist", "fetched global gradient norms",
            buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 50.0,
                     100.0, 1000.0),
        )
        self.step_time_hist = r.histogram(
            f"{prefix}_step_time_seconds",
            "per-step wall time (staged dispatches attribute the dispatch "
            "evenly across its steps)",
        )
        self.nonfinite_steps = r.counter(
            f"{prefix}_nonfinite_steps_total",
            "steps whose loss/gradients contained NaN/Inf")
        self.fetches = r.counter(
            f"{prefix}_fetches_total",
            "host fetches of device-side step metrics")

    # ------------------------------------------------------------- per-step
    def on_step(self, iteration: int, mvec,
                step_time_s: Optional[float] = None) -> None:
        """Record one step's DEVICE metrics vector; fetch only at K pending.

        When no explicit ``step_time_s`` is given, the wall-clock delta
        since the previous ``on_step`` stands in — under async dispatch the
        queue's backpressure makes the steady-state inter-dispatch interval
        the honest per-step time (PerformanceListener's convention); the
        first step of a run has no interval and records none.
        """
        import time  # noqa: PLC0415

        now = time.perf_counter()
        if step_time_s is None and self._last_step_t is not None:
            step_time_s = now - self._last_step_t
        self._last_step_t = now
        self.steps.inc()
        if step_time_s is not None:
            self.step_time_hist.observe(step_time_s)
        self._pending.append((int(iteration), mvec, step_time_s))
        if len(self._pending) >= self.fetch_every:
            self.flush()

    def flush(self) -> None:
        """Fetch all pending vectors in ONE host sync and record them."""
        if not self._pending:
            return
        import torch  # noqa: PLC0415

        pending, self._pending = self._pending, []
        rows = self._fetch(torch.stack([m for _, m, _ in pending]))
        self.fetch_count += 1
        self.fetches.inc()
        for (iteration, _, step_time_s), row in zip(pending, rows):
            self._record_row(iteration, row, step_time_s)
        self._sample_memory()

    # -------------------------------------------------------------- staged
    def on_staged(self, first_iteration: int, mvecs,
                  per_step_time_s: Optional[float] = None) -> None:
        """Record a staged dispatch's ``[steps, NUM_SLOTS]`` metrics.

        One fetch for the whole window (the staged loop hands over rows its
        one device read already brought to the host); ``per_step_time_s`` is
        the even per-step share of the window's wall time (callback
        wall-clock deltas measure nothing during the replay of the
        listeners — same convention as ``fit_on_device``'s
        ``staged_step_time``).
        """
        rows = self._fetch(mvecs)
        self.fetch_count += 1
        self.fetches.inc()
        self.steps.inc(len(rows))
        self._last_step_t = None  # wall deltas across a staged window lie
        for j, row in enumerate(rows):
            if per_step_time_s is not None:
                self.step_time_hist.observe(per_step_time_s)
            self._record_row(first_iteration + j, row, per_step_time_s)
        self._sample_memory()

    # ------------------------------------------------------------- shared
    def _sample_memory(self) -> None:
        """Live device-memory gauges + peak watermark, once per fetch (never per
        step); the watermark also rings into the flight recorder."""
        if not self.sample_memory:
            return
        from . import memory as _tmem  # noqa: PLC0415

        _tmem.sample_device_memory(self.registry, flight=self.flight)

    def _record_row(self, iteration: int, row,
                    step_time_s: Optional[float]) -> None:
        loss = float(row[device_stats.LOSS])
        gnorm = float(row[device_stats.GRAD_NORM])
        nonfinite = float(row[device_stats.NONFINITE])
        self.loss_gauge.set(loss)
        self.grad_norm_gauge.set(gnorm)
        if np.isfinite(gnorm):
            self.grad_norm_hist.observe(gnorm)
        if nonfinite > 0:
            self.nonfinite_steps.inc()
        if self.flight is not None:
            # the step's row rings into the black box AT FETCH TIME — the
            # steady-state cost is K dict appends per host sync, not per step
            self.flight.record(
                "step", iteration=int(iteration), loss=loss, grad_norm=gnorm,
                nonfinite=nonfinite,
                step_time_s=(None if step_time_s is None
                             else float(step_time_s)))
        if self.watchdog is not None:
            self.watchdog.observe(iteration, loss, gnorm, nonfinite,
                                  step_time_s)
