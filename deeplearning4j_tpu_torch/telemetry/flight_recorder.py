"""Anomaly flight recorder: a black box for runs that die at 3am
(counterpart of ``deeplearning4j_tpu/telemetry/flight_recorder.py``).

A bounded in-process ring buffer of structured events — step stats (from the
device-side metrics vector, recorded at fetch time), staged windows, memory
watermarks, watchdog anomalies. Steady-state cost is one deque append under
a lock; the ring never grows past ``capacity``.

Registered as a Watchdog sink (``Telemetry`` wires this automatically): on a
nan-loss / exploding-grad-norm / stalled-step anomaly — or an explicit
:meth:`FlightRecorder.dump`, or the crash hook — it writes a self-contained
JSON dump bundle: the last-K events, the most recent memory report, a full
registry snapshot, recent spans, and device/env info. The bundle keeps the
JAX package's schema; its ``compile_cache`` section is the process-wide
compile manager's ``stats()`` (the captured training steps and served
graphs, ``runtime.compile_manager``).

Dump location: ``DL4JTPU_FLIGHT_DIR`` (env) > the recorder's ``dump_dir`` >
the system temp dir. Schema: ``dl4jtpu-flight-v1``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import tempfile
import threading
import time
from typing import List, Optional

from .registry import MetricsRegistry, get_registry
from .watchdog import EXPLODING_GRAD_NORM, NAN_LOSS, SLO_BURN, STALLED_STEP_TIME

logger = logging.getLogger(__name__)

FLIGHT_DIR_ENV = "DL4JTPU_FLIGHT_DIR"
SCHEMA = "dl4jtpu-flight-v1"

# ---------------------------------------------------------------------------
# Event-kind registry. Every kind the ring records is declared here (or via
# register_event_kind by the module that owns it); record() itself stays
# permissive at runtime: an unknown kind rings fine.
_EVENT_KINDS: set = set()
_EVENT_KINDS_LOCK = threading.Lock()


def register_event_kind(kind: str) -> str:
    """Declare a flight-recorder event kind; returns it (idempotent), so
    owners can write ``MY_KIND = register_event_kind("my_kind")``."""
    with _EVENT_KINDS_LOCK:
        _EVENT_KINDS.add(str(kind))
    return str(kind)


def registered_event_kinds() -> frozenset:
    with _EVENT_KINDS_LOCK:
        return frozenset(_EVENT_KINDS)


# kinds this module records
STEP = register_event_kind("step")
COMPILE = register_event_kind("compile")
EVICTION = register_event_kind("eviction")
BUCKET_SHAPE = register_event_kind("bucket_shape")
STAGED_DISPATCH = register_event_kind("staged_dispatch")
MEMORY = register_event_kind("memory")
ANOMALY = register_event_kind("anomaly")
DUMP = register_event_kind("dump")
CRASH = register_event_kind("crash")

# kinds owned by the rest of the JAX package's stack, declared here too so
# both packages know the same schema
for _kind in (
    # runtime/compile_manager.py, telemetry/session.py, analysis
    "ir_finding",
    # nn kernel selection + tuned-config auto-apply
    "kernel_select", "tuned_config_applied",
    # serving/service.py
    "serve_dispatch", "serve_swap",
    # runtime/online.py
    "online_start", "online_stop", "online_pause", "online_resume",
    "online_swap", "online_rollback", "online_rollback_skipped",
    "online_poisoned_span", "online_replay", "online_replay_unsupported",
    "online_replay_error", "online_source_error", "online_source_reconnect",
    "online_loop_error",
    # runtime/resilience.py
    "resilience_retry", "resilience_giveup", "deadline_expired",
    "circuit_closed", "circuit_open", "circuit_half_open",
    # telemetry/tracing.py (post-hoc sample upgrade on shed/error/slow)
    "trace_upgrade",
    # telemetry/slo.py (multi-window burn-rate breach)
    "slo_burn",
    # fleet/router.py (rolling rollout + dead-worker respawn, spliced into
    # merged traces as instant events)
    "fleet_rollout", "fleet_respawn",
    # telemetry/history.py (flight event -> history-timeline annotation
    # splice; rung once per annotation so the black box shows the splice)
    "history_annotation",
):
    register_event_kind(_kind)
del _kind


class FlightRecorder:
    """Bounded event ring + post-mortem dump bundles.

    ``capacity``: ring size (events beyond it drop oldest-first — the
    counter ``dropped`` keeps the total). ``auto_dump_kinds``: anomaly
    kinds that trigger a dump when this recorder is a watchdog sink;
    ``min_dump_interval_s`` rate-limits auto-dumps so a NaN storm writes
    one bundle, not thousands.
    """

    def __init__(self, capacity: int = 4096,
                 dump_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 auto_dump_kinds=(NAN_LOSS, EXPLODING_GRAD_NORM,
                                  STALLED_STEP_TIME, SLO_BURN),
                 min_dump_interval_s: float = 30.0):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.auto_dump_kinds = frozenset(auto_dump_kinds)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.dropped = 0
        self.dumps: List[str] = []
        self._dump_seq = 0  # filename sequence, reserved under _lock
        self.last_memory_report: Optional[dict] = None
        self._lock = threading.Lock()
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        # rate limit is PER REASON: a stall dump must not swallow the
        # nan-loss bundle that follows it — different failure classes each
        # get their post-mortem, while a storm of one kind writes one file
        self._last_dump_t: dict = {}
        reg = registry if registry is not None else get_registry()
        self._registry = reg
        self._events_total = reg.counter(
            "dl4jtpu_flight_events_total",
            "flight-recorder events recorded, by kind",
            labelnames=("kind",))
        self._dumps_total = reg.counter(
            "dl4jtpu_flight_dumps_total",
            "flight-recorder dump bundles written, by reason",
            labelnames=("reason",))

    # ------------------------------------------------------------ recording
    def record(self, kind: str, **payload) -> None:
        """Append one structured event (near-zero cost; never raises)."""
        event = {"ts": time.time(), "kind": str(kind)}
        event.update(payload)
        with self._lock:
            if len(self._events) >= self.capacity:
                self.dropped += 1  # deque maxlen drops the oldest
            self._events.append(event)
        try:
            self._events_total.labels(kind=str(kind)).inc()
        except Exception:  # pragma: no cover - defensive
            pass

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def attach_memory_report(self, report: dict) -> None:
        """Keep the latest :func:`telemetry.memory.memory_report` so dumps
        carry per-layer attribution alongside the raw watermarks."""
        self.last_memory_report = report

    # --------------------------------------------------------- watchdog sink
    def watchdog_sink(self, event) -> None:
        """Watchdog sink: ring the anomaly, auto-dump (rate-limited)."""
        payload = event.to_dict()
        payload["anomaly"] = payload.pop("kind")  # "kind" names the ring slot
        self.record(ANOMALY, **payload)
        if event.kind not in self.auto_dump_kinds:
            return
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_t.get(event.kind)
        if last is not None and now - last < self.min_dump_interval_s:
            return
        try:
            self.dump(reason=event.kind)
        except Exception:  # a broken dump must never kill the train loop
            logger.exception("flight-recorder auto-dump failed")

    # ------------------------------------------------------------- snapshots
    def snapshot(self, last: Optional[int] = None) -> dict:
        """JSON-ready view for the UI (``GET /api/flightrecorder``)."""
        events = self.events
        if last is not None and last >= 0:
            events = events[-last:]
        with self._lock:  # dumps/dropped race concurrent dump()/record()
            dumps = list(self.dumps)
            dropped = self.dropped
        return {
            "capacity": self.capacity,
            "recorded": len(events),
            "dropped": dropped,
            "events": events,
            "dumps": dumps,
        }

    def bundle(self, reason: str = "manual") -> dict:
        """The self-contained post-mortem dict (what :meth:`dump` writes).
        Every section is collected defensively — a broken collector yields
        an ``{"error": ...}`` stanza, never a missing bundle."""
        def guarded(fn):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - post-mortem must survive
                return {"error": f"{type(e).__name__}: {e}"[:300]}

        def compile_cache():
            from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415

            return get_compile_manager().stats()

        def device_env():
            info: dict = {"python": sys.version.split()[0]}
            import torch  # noqa: PLC0415

            info["torch"] = torch.__version__
            info["cuda"] = torch.version.cuda
            info["device_count"] = (torch.cuda.device_count()
                                    if torch.cuda.is_available() else 0)
            info["device_platform"] = ("cuda" if info["device_count"] else "cpu")
            if info["device_count"]:
                info["device_name"] = torch.cuda.get_device_name(0)
            info["env"] = {k: v for k, v in os.environ.items()
                           if k.startswith(("DL4JTPU_", "CUDA_", "TORCH_"))}
            return info

        def spans_tail():
            from .spans import get_recorder  # noqa: PLC0415

            return get_recorder().events[-200:]

        def memory_section():
            from . import memory as _tmem  # noqa: PLC0415

            return {"devices": _tmem.device_memory_stats(),
                    "report": self.last_memory_report}

        return {
            "schema": SCHEMA,
            "reason": str(reason),
            "timestamp": time.time(),
            "pid": os.getpid(),
            "events": self.events,
            "dropped_events": self.dropped,
            "memory": guarded(memory_section),
            "compile_cache": guarded(compile_cache),
            "registry": guarded(self._registry.snapshot),
            "spans": guarded(spans_tail),
            "environment": guarded(device_env),
        }

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> str:
        """Write the bundle as one JSON file; returns its path. Directory:
        explicit ``path`` > ``DL4JTPU_FLIGHT_DIR`` > ``dump_dir`` > the
        system temp dir."""
        bundle = self.bundle(reason)
        if path is None:
            directory = (os.environ.get(FLIGHT_DIR_ENV) or self.dump_dir
                         or tempfile.gettempdir())
            os.makedirs(directory, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in str(reason))[:48]
            # reserve the sequence number atomically — len(self.dumps)
            # would hand two racing dumps the same filename
            with self._lock:
                seq = self._dump_seq
                self._dump_seq += 1
            path = os.path.join(
                directory,
                f"flight_{time.strftime('%Y%m%d-%H%M%S')}_"
                f"{os.getpid()}_{seq}_{safe}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, default=str)
        # publish under the ring lock: snapshot() iterates dumps and
        # watchdog_sink reads _last_dump_t from other threads
        with self._lock:
            self._last_dump_t[str(reason)] = time.monotonic()
            self.dumps.append(path)
        self.record(DUMP, reason=str(reason), path=path)
        try:
            self._dumps_total.labels(reason=str(reason)).inc()
        except Exception:  # pragma: no cover - defensive
            pass
        logger.warning("flight recorder dumped %s (%s)", path, reason)
        return path


_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()
_HOOK_INSTALLED = False


def get_flight_recorder() -> FlightRecorder:
    """The process-wide default recorder (Telemetry sessions record into it
    unless handed their own)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = FlightRecorder()
        return _GLOBAL


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process-wide recorder (soak harnesses / tests want a
    private dump dir); ``None`` resets to lazy re-creation of the
    default."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = recorder


def install_crash_hook(recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    """Dump on an unhandled exception (``sys.excepthook`` wrap) and, at
    interpreter exit, when anomalies were ringed but never dumped — the
    last-ditch artifact for a run that dies outside the watchdog's view.
    Idempotent; returns the hooked recorder."""
    global _HOOK_INSTALLED
    rec = recorder if recorder is not None else get_flight_recorder()
    with _GLOBAL_LOCK:
        if _HOOK_INSTALLED:
            return rec
        _HOOK_INSTALLED = True
    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            rec.record("crash", error=f"{exc_type.__name__}: {exc}"[:300])
            rec.dump(reason="crash")
        except Exception:  # pragma: no cover - never mask the real error
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook

    import atexit  # noqa: PLC0415

    def exit_dump():
        try:
            anomalies = [e for e in rec.events if e["kind"] == ANOMALY]
            if anomalies and not rec.dumps:
                rec.dump(reason="atexit-undumped-anomalies")
        except Exception:  # pragma: no cover
            pass

    atexit.register(exit_dump)
    return rec
