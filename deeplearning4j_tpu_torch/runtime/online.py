"""OnlineTrainer: continuous learning over a record stream (counterpart of
``deeplearning4j_tpu/runtime/online.py``, with the same constructor,
``dl4jtpu_online_*`` metrics, checkpoint cadence, swap and rollback
semantics, drift and input-shift detectors and poisoned-span replay).

- **Staged ingest.** Records from any :class:`~..streaming.RecordSource`
  assemble into fixed-row micro-batches (ragged tails pad with masks, ragged
  sequence lengths pad per record to power-of-two time buckets) and group
  into :class:`~..datasets.bucketing.BucketedStager`'s staged windows — one
  ``fit_on_device`` a window, each update a replay of one captured step.
  Masks are ALWAYS made, so a padded tail and a full batch share one
  captured step: warm traffic makes **zero captures** (the compile
  manager's counter is the proof). Window i+1's copy to the card starts
  (``DevicePrefetchIterator.start_copy``: pinned memory, a side stream)
  before window i's replays are queued, and is waited for on the trainer's
  stream just before window i+1's dispatch (``finish_copy``).
- **Its own stream.** On the card the loop runs on a stream of its own, so
  the replays of a window and the served replays of an
  :class:`~..serving.InferenceService` on other threads can overlap. All
  of it follows ``runtime.compile_manager``'s capture rule.
- **Backpressure.** The trainer pulls; when the card falls behind, the
  source's own bound (e.g. ``QueueSource``'s queue) pushes back on the
  producer. Nothing is dropped on the floor.
- **Versioned checkpoints.** A :class:`~.checkpoint.CheckpointStore`
  snapshot rides every ``checkpoint_every_steps`` optimizer steps — taken
  between windows (clones on the trainer's stream, no host sync) and
  written atomically on a background thread.
- **Train→serve live handoff.** The same snapshot hot-swaps into a
  registered service model: its values are copied into the served
  network's tensors under its serving lock, on the trainer's stream after
  the clones, and the service's next replay waits for that copy
  (``swap_params``). The served graphs are reused — no restart, no new
  capture.
- **Drift/anomaly hooks, watchdog-wired.** Window losses feed a NaN check
  and a loss-trend drift detector; host-side feature statistics feed an
  input-distribution-shift detector. Detections emit through the
  :class:`~..telemetry.Watchdog` (``dl4jtpu_anomalies_total{kind}``,
  flight-recorder sink) and — per ``rollback_on``/``pause_on`` policy —
  pause ingestion, roll the live model back to the last good checkpoint in
  place (``load_into``: zero new captures), replay the poisoned span
  through a no-update loss, and dump a flight bundle.

``stage`` and the time buckets come from the argument, then a matching
``TUNED.json`` entry (``tune/store.py``), then the default (``stage=4``,
power-of-two buckets). :meth:`OnlineTrainer.stats` keeps the JAX keys.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .compile_manager import capture_lock

__all__ = ["OnlineTrainer", "get_online_trainers", "clear_online_trainers"]

_TRAINERS: Dict[str, "OnlineTrainer"] = {}
_TRAINERS_LOCK = threading.Lock()


def get_online_trainers() -> Dict[str, "OnlineTrainer"]:
    """Name → trainer map of every started OnlineTrainer in this process
    (what the JAX package's ``GET /api/online`` serves). Stopped trainers stay listed with
    ``alive: false`` until :func:`clear_online_trainers`."""
    with _TRAINERS_LOCK:
        return dict(_TRAINERS)


def clear_online_trainers() -> None:
    with _TRAINERS_LOCK:
        _TRAINERS.clear()


class _Count:
    """A per-trainer counter twinned with its (process-global) registry
    family: the registry accumulates across every trainer for /metrics,
    while ``stats()`` must report THIS trainer's numbers — two trainers in
    one process (or one after another) must not read each other's
    counts."""

    __slots__ = ("n", "_family", "_lock")

    def __init__(self, family):
        self.n = 0
        self._family = family
        # inc() runs on the ingest thread while pause/checkpoint callers
        # bump their own counters from control threads
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.n += int(n)
        self._family.inc(n)


class _ShiftStats:
    """Welford running mean/var over per-batch feature means — the cheap
    host-side input-distribution-shift signal (the arrays are on the host
    anyway, pre-staging)."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def zscore(self, x: float) -> Optional[float]:
        if self.n < 8:
            return None
        var = self.m2 / max(self.n - 1, 1)
        return abs(x - self.mean) / (var ** 0.5 + 1e-9)

    def update(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)


class OnlineTrainer:
    """Continuously train ``net`` from ``source``; checkpoint, serve, survive.

    ``net``: a MultiLayerNetwork or single-input/-output ComputationGraph,
    on the card unless it was built with ``device="cpu"``.
    ``source``: any :class:`~..streaming.RecordSource` (poll() →
    ``(features, label)`` or None). ``batch``: micro-batch rows (ragged
    tails pad up with masks). ``stage``: staged-window batches per
    dispatch. ``linger``: max seconds a partial micro-batch waits for
    company; ``flush_idle``: idle seconds before a partial staged group
    flushes as a pow2-padded window.

    ``checkpoint_store`` + ``checkpoint_every_steps`` give durability;
    ``service`` + ``serve_as`` give the live handoff (a serving clone is
    registered at :meth:`start` and hot-swapped on every checkpoint when
    ``swap_on_checkpoint``).

    ``rollback_on``/``pause_on``: anomaly kinds (see telemetry.watchdog)
    that trigger checkpoint rollback / a hard ingestion pause needing
    :meth:`resume`. NaN windows and loss drift roll back by default;
    input shift is observability-only unless opted in.
    """

    def __init__(self, net, source, *, batch: int = 32,
                 stage: Optional[int] = None,
                 linger: float = 0.25, flush_idle: Optional[float] = None,
                 name: str = "online",
                 checkpoint_store=None, checkpoint_every_steps: int = 0,
                 service=None, serve_as: Optional[str] = None,
                 swap_on_checkpoint: bool = True,
                 watchdog=None, registry=None,
                 drift_window: int = 4, drift_factor: float = 3.0,
                 drift_min_windows: int = 4, shift_zscore: float = 8.0,
                 rollback_on: Tuple[str, ...] = ("nan-loss", "loss-drift"),
                 pause_on: Tuple[str, ...] = (),
                 source_retry_s: float = 0.25,
                 warm_partials: bool = True,
                 time_boundaries=None):
        from ..telemetry import Watchdog, get_registry  # noqa: PLC0415
        from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

        # tuned-config auto-apply (tune/store.py): a matching TUNED.json
        # entry supplies the staging window / bucket boundaries unless the
        # caller chose them explicitly — explicit settings always win
        from ..tune import store as _tuned  # noqa: PLC0415

        tuned = _tuned.auto_apply(net, "online", explicit=[
            knob for knob, user_set in (
                ("stage_window", stage is not None),
                ("bucket_boundaries", time_boundaries is not None),
            ) if user_set])
        if stage is None:
            stage = int(tuned.get("stage_window", 4))
        if time_boundaries is None:
            tb = tuned.get("bucket_boundaries")
            if isinstance(tb, (list, tuple)):
                time_boundaries = tuple(int(t) for t in tb)
        if int(batch) < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if int(stage) < 2:
            raise ValueError(f"stage must be >= 2, got {stage}")
        self.net = net
        self.source = source
        self.batch = int(batch)
        self.stage = int(stage)
        self.linger = float(linger)
        self.flush_idle = (2 * self.linger if flush_idle is None
                           else float(flush_idle))
        self.name = str(name)
        self.store = checkpoint_store
        self.checkpoint_every_steps = int(checkpoint_every_steps)
        self.swap_on_checkpoint = bool(swap_on_checkpoint)
        self.drift_window = int(drift_window)
        self.drift_factor = float(drift_factor)
        self.drift_min_windows = int(drift_min_windows)
        self.shift_zscore = float(shift_zscore)
        self.rollback_on = frozenset(rollback_on)
        self.pause_on = frozenset(pause_on)
        self.source_retry_s = float(source_retry_s)
        self.warm_partials = bool(warm_partials)
        self._warmed_sigs = set()
        self.time_boundaries = time_boundaries
        self._service = service
        self._serve_name = serve_as
        self._serve_net = None
        self.flight = get_flight_recorder()
        self.watchdog = watchdog if watchdog is not None else Watchdog(
            sinks=[], registry=registry)
        if not any(getattr(s, "__self__", None) is self.flight
                   for s in self.watchdog.sinks):
            self.watchdog.add_sink(self.flight.watchdog_sink)

        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._carry = None  # record that didn't fit the last micro-batch
        # cross-thread checkpoint requests: serviced by the ingest loop
        # BETWEEN dispatches so the snapshot is never torn across the
        # params/opt-state assignment of an in-flight window
        self._ckpt_request: Optional[Tuple] = None
        self._ckpt_done = threading.Event()
        self._ckpt_result: Optional[int] = None
        self._source_down = False
        self._last_good_version: Optional[int] = None
        # replay bookkeeping: the source cursor + iteration at the last
        # good checkpoint bound the poisoned span on rollback
        self._last_good_cursor: Optional[int] = None
        self._last_good_iteration = 0
        self._last_replay: Optional[dict] = None
        self.replay_max_records = 2048
        self._steps_since_checkpoint = 0
        self._loss_baseline: Optional[float] = None
        self._loss_var: Optional[float] = None  # EMA of within-window loss variance
        self._baseline_windows = 0
        self._recent_losses: "deque[float]" = deque(maxlen=self.drift_window)
        # the ingest loop appends/clears the loss window while stats()
        # snapshots it from serving threads
        self._window_lock = threading.Lock()
        self._shift = _ShiftStats()
        self._rate: "deque[Tuple[float, int]]" = deque(maxlen=64)
        self._rate_value = 0.0
        self._records_seen = 0
        self._last_anomaly: Optional[dict] = None

        reg = registry if registry is not None else get_registry()
        self._m_records = _Count(reg.counter(
            "dl4jtpu_online_records_total",
            "records consumed by online trainers"))
        self._m_bad = _Count(reg.counter(
            "dl4jtpu_online_bad_records_total",
            "records dropped as malformed/unlabelled"))
        self._m_batches = _Count(reg.counter(
            "dl4jtpu_online_batches_total",
            "micro-batches assembled for staging"))
        self._m_windows = _Count(reg.counter(
            "dl4jtpu_online_windows_total",
            "staged windows dispatched"))
        self._m_steps = _Count(reg.counter(
            "dl4jtpu_online_steps_total",
            "optimizer steps run by online trainers"))
        self._m_source_errors = _Count(reg.counter(
            "dl4jtpu_online_source_errors_total",
            "record-source poll failures (disconnects)"))
        self._m_reconnects = _Count(reg.counter(
            "dl4jtpu_online_reconnects_total",
            "record-source recoveries after a failure"))
        self._m_rollbacks = _Count(reg.counter(
            "dl4jtpu_online_rollbacks_total",
            "checkpoint rollbacks triggered by anomalies"))
        self._m_swaps = _Count(reg.counter(
            "dl4jtpu_online_swaps_total",
            "live model versions hot-swapped into serving"))
        self._m_replays = _Count(reg.counter(
            "dl4jtpu_online_replays_total",
            "poisoned-span replays validated after rollback"))
        self._m_paused = reg.gauge(
            "dl4jtpu_online_paused",
            "1 while ingestion is paused (anomaly policy or pause())")
        self._m_rate = reg.gauge(
            "dl4jtpu_online_ingest_samples_per_sec",
            "recent record ingest rate of the online trainer")

        # typed failure handling for the source poll loop (runtime/
        # resilience.py): deterministic exponential backoff on consecutive
        # failures, a breaker that stops hammering a hard-down broker
        from .resilience import CircuitBreaker, RetryPolicy  # noqa: PLC0415

        self._source_policy = RetryPolicy(
            f"online.source[{self.name}]", base_s=self.source_retry_s,
            cap_s=max(2.0, 8 * self.source_retry_s), jitter=0.25,
            registry=reg)
        self._source_breaker = CircuitBreaker(
            f"online.source[{self.name}].circuit", registry=reg)
        # the window copies' pinned ring and side stream, and the loop's own
        # stream on the card (made at start)
        self._reader = None
        self._stream = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "OnlineTrainer":
        if self._thread is not None and self._thread.is_alive():
            return self
        self.net.init()
        if self._service is not None and self._serve_name is not None:
            self._attach_serving()
        if self.store is not None and self.store.latest() is None:
            # version 1 = the rollback floor: an anomaly in the very first
            # windows still has a good version to return to
            info = self.store.save(self.net)
            self._last_good_version = info.version
        elif self.store is not None and self._last_good_version is None:
            self._last_good_version = self.store.latest().version
        self._last_good_cursor = self._source_cursor()
        self._last_good_iteration = int(self.net.iteration)
        from ..datasets.iterators import DevicePrefetchIterator  # noqa: PLC0415

        self._reader = DevicePrefetchIterator(None, self.net.device)
        if self.net.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.net.device)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"dl4j-online-{self.name}")
        self._thread.start()
        with _TRAINERS_LOCK:
            _TRAINERS[self.name] = self
        self.flight.record("online_start", trainer=self.name,
                           batch=self.batch, stage=self.stage)
        return self

    def stop(self, timeout: float = 30.0, checkpoint: bool = True) -> None:
        """Stop ingestion, join the loop, land the final checkpoint."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self.store is not None:
            try:
                self.store.join()
                if checkpoint:
                    info = self.store.save(self.net)
                    self._last_good_version = info.version
            except Exception:  # a failed final save must not mask _error
                pass
        self.flight.record("online_stop", trainer=self.name)
        self.raise_if_failed()

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def pause(self, reason: str = "manual") -> None:
        if not self._paused.is_set():
            self._paused.set()
            self._m_paused.set(1)
            self.flight.record("online_pause", trainer=self.name,
                               reason=reason)

    def resume(self) -> None:
        if self._paused.is_set():
            self._paused.clear()
            self._m_paused.set(0)
            self.flight.record("online_resume", trainer=self.name)

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------- serving glue
    def _attach_serving(self) -> None:
        """Register a serving CLONE of the training net (same config, device
        and options: its own served graphs) and hand it the current params.
        The trainer never serves its live tensors: the next replayed step
        writes them."""
        from .checkpoint import CheckpointStore  # noqa: PLC0415

        if self._serve_name in self._service.models():
            self._serve_net = None  # caller registered their own model
        else:
            clone = self.net._twin()
            clone.init()
            self._serve_net = clone
            self._service.register(self._serve_name, clone)
        self._hot_swap(CheckpointStore.snapshot(self.net), 0)

    def _hot_swap(self, snapshot, version: int) -> None:
        """``hot_swap`` of ``snapshot``: its copies run on this thread's
        stream, after the clones (``wait_on``); the service's next replay
        waits for them (``swap_params``)."""
        if snapshot.ready is not None:
            snapshot.wait_on(torch.cuda.current_stream(self.net.device))
        self._service.hot_swap(self._serve_name, params=snapshot.params,
                               state=snapshot.state, version=version)

    def _swap(self, snapshot, version: int) -> None:
        self._hot_swap(snapshot, version)
        self._m_swaps.inc()
        self.flight.record("online_swap", trainer=self.name,
                           model=self._serve_name, version=int(version),
                           iteration=int(self.net.iteration))
        try:
            # every trace minted in this process from now on carries the
            # serving checkpoint version in its baggage — a request that
            # straddles a swap is attributable to the version it actually ran
            from ..telemetry.tracing import set_default_baggage  # noqa: PLC0415

            set_default_baggage("checkpoint_version", str(int(version)))
        except Exception:  # observability must never fail a swap
            pass

    # ---------------------------------------------------------- checkpoints
    def checkpoint_now(self, swap: Optional[bool] = None,
                       timeout: float = 60.0) -> int:
        """Snapshot the live model, write it as the next version on the
        background writer, optionally hot-swap serving to the SAME
        snapshot. Returns the version id.

        Safe from any thread: when the ingest loop is live, the request is
        serviced BY the loop between dispatches (a foreign-thread snapshot
        could tear params against opt-state mid-window); from the loop
        itself — or with the loop stopped — it runs inline.
        """
        if self.store is None:
            raise RuntimeError("OnlineTrainer has no checkpoint_store")
        if self.alive and threading.current_thread() is not self._thread:
            self._ckpt_done.clear()
            self._ckpt_request = (swap,)
            if not self._ckpt_done.wait(timeout=timeout):
                raise RuntimeError(
                    f"online checkpoint request not serviced in {timeout}s "
                    "(is the ingest loop wedged?)")
            return int(self._ckpt_result)
        return self._checkpoint_inline(swap)

    def _checkpoint_inline(self, swap: Optional[bool] = None) -> int:
        from .checkpoint import CheckpointStore  # noqa: PLC0415

        snap = CheckpointStore.snapshot(self.net)
        version = self.store.save_async(snap)
        self._steps_since_checkpoint = 0
        self._last_good_version = version
        self._last_good_cursor = self._source_cursor()
        self._last_good_iteration = int(self.net.iteration)
        do_swap = self.swap_on_checkpoint if swap is None else bool(swap)
        if do_swap and self._service is not None \
                and self._serve_name is not None:
            self._swap(snap, version)
        return version

    def _service_ckpt_request(self) -> None:
        req, self._ckpt_request = self._ckpt_request, None
        if req is None:
            return
        try:
            self._ckpt_result = self._checkpoint_inline(req[0])
        finally:
            self._ckpt_done.set()

    def _maybe_checkpoint(self) -> None:
        if (self.store is not None and self.checkpoint_every_steps > 0
                and self._steps_since_checkpoint
                >= self.checkpoint_every_steps):
            self._checkpoint_inline()

    # ------------------------------------------------------------ anomalies
    def _handle_anomaly(self, kind: str, value: float, threshold: float,
                        message: str) -> None:
        self.watchdog.emit(kind, int(self.net.iteration), value, threshold,
                           message)
        self._last_anomaly = {"kind": kind, "value": float(value),
                              "iteration": int(self.net.iteration),
                              "message": message, "ts": time.time()}
        hard_pause = kind in self.pause_on
        if kind in self.rollback_on or hard_pause:
            self.pause(reason=kind)
        rolled = kind in self.rollback_on and self._rollback(kind)
        # the bundle IS the artifact: dump after the rollback so it records
        # both the anomaly and the recovery (rate-limited per reason)
        try:
            self.flight.dump(reason=f"online-{kind}")
        except Exception:  # a failed dump must never kill the loop
            pass
        # the counter is the wait-handle: observers poll rollbacks_total and
        # then read the newest bundle, so it must not advance until the
        # bundle is on disk
        if rolled:
            self._m_rollbacks.inc()
        if not hard_pause:
            self.resume()

    def _rollback(self, reason: str) -> bool:
        if self.store is None:
            self.flight.record("online_rollback_skipped", trainer=self.name,
                               reason=reason, cause="no checkpoint store")
            return False
        try:
            self.store.join()
        except Exception:
            pass  # a failed in-flight write: fall back to what's on disk
        target = self._last_good_version
        latest = self.store.latest()
        if target is None or not any(v.version == target
                                     for v in self.store.versions()):
            target = latest.version if latest is not None else None
        if target is None:
            self.flight.record("online_rollback_skipped", trainer=self.name,
                               reason=reason, cause="no stored versions")
            return False
        rollback_step = int(self.net.iteration)
        rollback_cursor = self._source_cursor()
        # a corrupt target quarantines and falls back to the newest good
        # version rather than wedging the recovery path
        loaded = self.store.load_into(self.net, target, fallback=True)
        # the drifted/poisoned window means must not re-trigger on the
        # restored model; the healthy baseline survives
        with self._window_lock:
            self._recent_losses.clear()
        self.flight.record("online_rollback", trainer=self.name,
                           reason=reason, version=int(loaded),
                           iteration=int(self.net.iteration))
        span = {"start_step": int(self.net.iteration),
                "end_step": rollback_step,
                "start_cursor": self._last_good_cursor,
                "end_cursor": rollback_cursor}
        self.flight.record("online_poisoned_span", trainer=self.name,
                           reason=reason, **span)
        self._replay_span(span, reason)
        return True

    # --------------------------------------------------------------- replay
    def _source_cursor(self) -> Optional[int]:
        """The source's replay cursor, or None when unsupported."""
        fn = getattr(self.source, "replay_cursor", None)
        if not callable(fn):
            return None
        try:
            return int(fn())
        except Exception:
            return None

    def _replay_span(self, span: dict, reason: str) -> None:
        """Re-ingest the poisoned span through a validation-only pass.

        For replayable sources (streaming.ReplayableSource contract) the
        span's records are re-fetched and scored — loss only, no optimizer
        updates — against the same adaptive loss band the drift detector
        uses. The outcome (``clean``/``poisoned``) lands in the flight
        bundle next to the rollback; a poisoned verdict means the span's
        data itself was bad and is dropped for good. Non-replayable
        sources record an explicit ``replay: unsupported`` event and keep
        the pre-replay behavior.
        """
        replay = getattr(self.source, "replay", None)
        if (not callable(replay) or span["start_cursor"] is None
                or span["end_cursor"] is None):
            self._last_replay = {"outcome": "unsupported", "reason": reason,
                                 **span}
            self.flight.record("online_replay_unsupported",
                               trainer=self.name, reason=reason,
                               replay="unsupported", **span)
            return
        try:
            records = list(replay(span["start_cursor"], span["end_cursor"]))
        except Exception as e:  # noqa: BLE001 - replay must not kill recovery
            self._last_replay = {"outcome": "error", "reason": reason,
                                 "error": repr(e), **span}
            self.flight.record("online_replay_error", trainer=self.name,
                               reason=reason, error=repr(e))
            return
        records = records[:self.replay_max_records]
        losses = []
        checked = 0
        buf: list = []
        key = None

        graph = hasattr(self.net.conf, "network_inputs")

        def score(batch):
            # the no-update loss: no optimizer step, no dropout draw
            f = np.stack([b[0] for b in batch])
            l = np.stack([b[1] for b in batch])
            with torch.no_grad(), capture_lock().shared():
                loss = (self.net.loss_fn([f], [l]) if graph
                        else self.net.loss_fn(f, l))
                return float(loss)

        for raw in records:
            rec = self._norm_record(raw)
            if rec is None:
                continue
            k = (rec[0].shape, rec[1].shape)  # exact-shape groups: no padding
            if key is not None and (k != key or len(buf) >= self.batch):
                try:
                    losses.append(score(buf))
                    checked += len(buf)
                except Exception:
                    pass
                buf = []
            key = k
            buf.append(rec)
        if buf:
            try:
                losses.append(score(buf))
                checked += len(buf)
            except Exception:
                pass
        mean = float(np.mean(losses)) if losses else None
        baseline = self._loss_baseline
        sigma = float(np.sqrt(self._loss_var)) if self._loss_var else 0.0
        sigma_floor = (max(self.drift_factor - 1.0, 0.0)
                       / max(self.drift_factor, 1e-6)
                       * max(abs(baseline), 1e-6)) if baseline is not None else 0.0
        limit = (baseline + self.drift_factor * max(sigma, sigma_floor)
                 if baseline is not None else None)
        if mean is None:
            outcome = "empty"
        elif not np.isfinite(mean) or (limit is not None and mean > limit):
            outcome = "poisoned"  # the span's data was bad: drop it for good
        else:
            outcome = "clean"
        self._m_replays.inc()
        self._last_replay = {"outcome": outcome, "reason": reason,
                             "records": len(records), "checked": checked,
                             "mean_loss": mean,
                             "limit": limit, **span}
        self.flight.record("online_replay", trainer=self.name, reason=reason,
                           outcome=outcome, records=len(records),
                           checked=checked, mean_loss=mean, limit=limit,
                           **span)

    def _check_window_health(self, losses: np.ndarray) -> None:
        finite = np.isfinite(losses)
        if not finite.all():
            bad = float(np.asarray(losses)[~finite][0])
            self._handle_anomaly(
                "nan-loss", bad, 0.0,
                f"online window produced non-finite loss at iteration "
                f"{self.net.iteration}")
            return
        mean = float(np.mean(losses))
        with self._window_lock:
            self._recent_losses.append(mean)
            window = list(self._recent_losses)
        baseline = self._loss_baseline
        if baseline is not None and self._baseline_windows \
                >= self.drift_min_windows:
            recent = float(np.mean(window[-3:]))
            # adaptive band: the threshold scales with the EMA of the
            # WITHIN-window loss variance, so benign noise widens the band
            # instead of tripping it, while a between-window trend (drift)
            # cannot widen it and still trips. With degenerate variance
            # (sigma -> 0) the floor reproduces the old static rule
            # exactly: baseline + (f-1)|baseline| == f * baseline.
            sigma = (float(np.sqrt(self._loss_var))
                     if self._loss_var else 0.0)
            sigma_floor = (max(self.drift_factor - 1.0, 0.0)
                           / max(self.drift_factor, 1e-6)
                           * max(abs(baseline), 1e-6))
            limit = baseline + self.drift_factor * max(sigma, sigma_floor)
            if recent > limit:
                self._handle_anomaly(
                    "loss-drift", recent, limit,
                    f"online loss trend {recent:.4g} exceeds the adaptive "
                    f"band {limit:.4g} (baseline {baseline:.4g} + "
                    f"{self.drift_factor} x sigma {max(sigma, sigma_floor):.4g})")
                return
        # healthy window: fold into the baseline + noise-variance EMAs
        wvar = float(np.var(losses))
        self._loss_var = (wvar if self._loss_var is None
                          else 0.9 * self._loss_var + 0.1 * wvar)
        self._loss_baseline = (mean if baseline is None
                               else 0.9 * baseline + 0.1 * mean)
        self._baseline_windows += 1
        self._steps_since_checkpoint += len(losses)
        self._maybe_checkpoint()

    # -------------------------------------------------------------- ingest
    def _poll_source(self):
        if not self._source_breaker.allow():
            # circuit open: stop hammering a hard-down source until the
            # cooldown lets one probe through
            self._stop.wait(min(self.source_retry_s,
                                self._source_breaker.cooldown_remaining()
                                or self.source_retry_s))
            return None
        try:
            rec = self.source.poll(timeout=0.05)
        except Exception as e:  # noqa: BLE001 - disconnects must not kill us
            if not self._source_down:
                self._source_down = True
                self.flight.record("online_source_error", trainer=self.name,
                                   error=f"{type(e).__name__}: {e}"[:200])
            self._m_source_errors.inc()
            self._source_breaker.record_failure()
            self._stop.wait(self._source_policy.record_failure(
                error=e, key=self.name))
            return None
        if self._source_down:
            self._source_down = False
            self._m_reconnects.inc()
            self._source_policy.record_success()
            self._source_breaker.record_success()
            self.flight.record("online_source_reconnect", trainer=self.name)
        return rec

    @staticmethod
    def _norm_record(rec):
        """(features, label) → float32 arrays, or None when untrainable."""
        if not isinstance(rec, (tuple, list)) or len(rec) < 2 \
                or rec[1] is None:
            return None
        f = np.asarray(rec[0], np.float32)
        l = np.asarray(rec[1], np.float32)
        if f.ndim not in (1, 2) or l.ndim not in (1, 2) or f.size == 0:
            return None
        return f, l

    @staticmethod
    def _rec_key(f: np.ndarray, l: np.ndarray):
        """Micro-batch compatibility: trailing dims must match; sequence
        records (2-D [T, C]) may differ in T (padded per record)."""
        fk = f.shape if f.ndim == 1 else ("seq",) + f.shape[1:]
        lk = l.shape if l.ndim == 1 else ("seq",) + l.shape[1:]
        return (fk, lk)

    def _assemble(self):
        """One micro-batch: up to ``batch`` compatible records within the
        linger budget, padded to the canonical staged shape with masks.
        None = idle / stopped / paused (nothing buffered)."""
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        key = None
        deadline = None
        idle_deadline = time.monotonic() + self.flush_idle
        while not self._stop.is_set() and not self._paused.is_set():
            rec = None
            if self._carry is not None:
                rec, self._carry = self._carry, None
            else:
                raw = self._poll_source()
                if raw is not None:
                    rec = self._norm_record(raw)
                    if rec is None:
                        self._m_bad.inc()
                        continue
            now = time.monotonic()
            if rec is not None:
                k = self._rec_key(*rec)
                if buf and k != key:
                    self._carry = rec  # next batch's first record
                    break
                key = k
                buf.append(rec)
                if deadline is None:
                    deadline = now + self.linger
                if len(buf) >= self.batch:
                    break
                continue
            if buf and now >= (deadline or now):
                break
            if not buf and now >= idle_deadline:
                return None
        if not buf:
            return None
        return self._pad_micro_batch(buf)

    def _pad_micro_batch(self, buf):
        """Stack records → one (features, labels, fmask, lmask) micro-batch
        at the canonical shape: ``batch`` rows, pow2 time bucket, masks
        always present — every warm micro-batch shares ONE signature."""
        from ..datasets.bucketing import bucket_length, pad_batch_arrays

        n = len(buf)
        feats = [f for f, _ in buf]
        labs = [l for _, l in buf]
        seq = feats[0].ndim == 2
        fmask = None
        lmask = None
        if seq:
            tb = bucket_length(max(f.shape[0] for f in feats),
                               self.time_boundaries)
            F = np.zeros((n, tb) + feats[0].shape[1:], np.float32)
            fmask = np.zeros((n, tb), np.float32)
            for i, f in enumerate(feats):
                F[i, : f.shape[0]] = f
                fmask[i, : f.shape[0]] = 1.0
            if labs[0].ndim == 2:  # per-step labels [T, K]
                L = np.zeros((n, tb) + labs[0].shape[1:], np.float32)
                lmask = np.zeros((n, tb), np.float32)
                for i, l in enumerate(labs):
                    L[i, : l.shape[0]] = l
                    lmask[i, : l.shape[0]] = 1.0
            else:  # per-sequence labels [K]
                L = np.stack(labs)
                lmask = np.ones((n,), np.float32)
        else:
            tb = None
            F = np.stack(feats)
            L = np.stack(labs)
        pad_rows = self._pad_examples_ok()
        target_b = self.batch if pad_rows else n
        F, L, fmask, lmask = pad_batch_arrays(F, L, fmask, lmask,
                                              target_b, tb)
        if lmask is None:  # full batch: force the mask so one program serves
            lmask = np.ones((target_b,), np.float32)
        if seq and fmask is None:
            fmask = np.ones(F.shape[:2], np.float32)
        self._records_seen += n
        self._m_records.inc(n)
        self._m_batches.inc()
        self._rate.append((time.monotonic(), self._records_seen))
        self._update_rate_gauge()
        # input-distribution shift: per-batch feature mean vs the healthy
        # running stats (host-side — the array is host-resident here anyway)
        m = float(np.mean(F[:n]))
        z = self._shift.zscore(m)
        if z is not None and z > self.shift_zscore:
            self._handle_anomaly(
                "input-shift", z, self.shift_zscore,
                f"feature mean {m:.4g} is {z:.1f} sigma from the healthy "
                f"ingest distribution")
        else:
            self._shift.update(m)
        return F, L, fmask, lmask

    def _pad_examples_ok(self) -> bool:
        fn = getattr(self.net, "_pad_examples_ok", None)
        return bool(fn()) if callable(fn) else True

    def _update_rate_gauge(self) -> None:
        if len(self._rate) >= 2:
            (t0, n0), (t1, n1) = self._rate[0], self._rate[-1]
            if t1 > t0:
                self._rate_value = round((n1 - n0) / (t1 - t0), 1)
                self._m_rate.set(self._rate_value)

    # ------------------------------------------------------------- pipeline
    def _batch_stream(self):
        while not self._stop.is_set() and not self._paused.is_set():
            mb = self._assemble()
            if mb is None:
                return  # idle/stop/pause: let the stager flush its group
            yield mb

    @staticmethod
    def _normalize(mb):
        f, l, fm, lm = mb
        return [f], [l], [fm], [lm]

    def _to_device(self, win):
        """Start ``win``'s copy to the card (pinned ring, side stream); the
        handle goes to :meth:`_dispatch`, which waits for it on this
        thread's stream just before the window's replays."""
        return self._reader.start_copy(win)

    def _warm_window_family(self, win) -> None:
        """Capture ahead for every power-of-two partial-window slot count of
        this window's shape family, the first time the family is seen (a
        traffic gap later flushes a partial staged group as a padded
        window). The shapes go in as meta tensors. A capture that fails
        raises: the trainer is not left on another path."""
        sig = tuple((tuple(a.shape), str(a.dtype))
                    for a in win.features + win.labels)
        if not self.warm_partials or sig in self._warmed_sigs:
            return
        self._warmed_sigs.add(sig)

        def shell(a, k):
            if a is None:
                return None
            dtype = torch.from_numpy(np.zeros(0, np.asarray(a).dtype)).dtype
            return torch.empty((k,) + tuple(a.shape[1:]), dtype=dtype, device="meta")

        fm = None if win.features_masks is None else win.features_masks[0]
        lm = None if win.labels_masks is None else win.labels_masks[0]
        sizes = sorted({min(self.stage, 1 << i)
                        for i in range(self.stage.bit_length() + 1)})
        for k in sizes:
            self.net.warmup(
                shell(win.features[0], k), shell(win.labels[0], k),
                steps=k, features_masks=shell(fm, k),
                labels_masks=shell(lm, k), real_batches=k)

    def _dispatch(self, pending) -> None:
        raw, handle = pending
        self._warm_window_family(raw)
        win = self._reader.finish_copy(handle)
        losses = self.net.fit_on_device(
            win.features[0], win.labels[0], steps=win.n_real,
            features_masks=(None if win.features_masks is None
                            else win.features_masks[0]),
            labels_masks=(None if win.labels_masks is None
                          else win.labels_masks[0]),
            real_batches=win.n_real)
        self._m_windows.inc()
        self._m_steps.inc(len(losses))
        self._check_window_health(np.asarray(losses))
        self._service_ckpt_request()

    def _run(self) -> None:
        from ..datasets.bucketing import BucketedStager

        stager = BucketedStager(self.stage,
                                pad_examples=self._pad_examples_ok(),
                                time_boundaries=self.time_boundaries)
        self._stager = stager
        try:
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    self._loop(stager)
            else:
                self._loop(stager)
        except BaseException as e:  # surfaced on stop()/raise_if_failed()
            self._error = e
            try:
                self.flight.record(
                    "online_loop_error", trainer=self.name,
                    error=f"{type(e).__name__}: {e}"[:300])
                self.flight.dump(reason="online-loop-error")
            except Exception:
                pass
        finally:
            if self._stream is not None:
                # what the loop queued is done before stop() or another
                # thread reads the network on its own stream
                self._stream.synchronize()

    def _loop(self, stager) -> None:
        while not self._stop.is_set():
            self._service_ckpt_request()
            if self._paused.is_set():
                self._stop.wait(0.05)
                continue
            pending = None
            for kind, payload in stager.plan(self._batch_stream(),
                                             self._normalize):
                if kind != "window":  # pragma: no cover - all stageable
                    continue
                staged = (payload, self._to_device(payload))
                if pending is not None:
                    self._dispatch(pending)
                pending = staged
            if pending is not None:
                self._dispatch(pending)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """JSON-ready trainer snapshot (the JAX package's /api/online
        payload; the same keys)."""
        anomalies = {}
        for ev in self.watchdog.events[-256:]:
            anomalies[ev.kind] = anomalies.get(ev.kind, 0) + 1
        with self._window_lock:
            window = list(self._recent_losses)
        out = {
            "name": self.name,
            "alive": self.alive,
            "paused": self.paused,
            "batch": self.batch,
            "stage": self.stage,
            "iteration": int(self.net.iteration),
            "records_total": self._m_records.n,
            "batches_total": self._m_batches.n,
            "windows_total": self._m_windows.n,
            "steps_total": self._m_steps.n,
            "bad_records_total": self._m_bad.n,
            "source_errors_total": self._m_source_errors.n,
            "reconnects_total": self._m_reconnects.n,
            "rollbacks_total": self._m_rollbacks.n,
            "swaps_total": self._m_swaps.n,
            "ingest_samples_per_sec": self._rate_value,
            "loss_baseline": self._loss_baseline,
            "loss_sigma": (None if self._loss_var is None
                           else float(np.sqrt(self._loss_var))),
            "recent_window_losses": [round(x, 6) for x in window],
            "last_anomaly": self._last_anomaly,
            "anomalies": anomalies,
            "replays_total": self._m_replays.n,
            "last_replay": self._last_replay,
            "replay_supported": callable(
                getattr(self.source, "replay", None)),
            "last_good_version": self._last_good_version,
            "checkpoint_every_steps": self.checkpoint_every_steps,
            "serving_model": self._serve_name,
            "checkpoints": (self.store.stats() if self.store is not None
                            else None),
        }
        stager = getattr(self, "_stager", None)
        if stager is not None:
            out["padding"] = stager.padding_stats()
        return out
