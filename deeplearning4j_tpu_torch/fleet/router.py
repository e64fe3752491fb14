"""Fleet router (counterpart of ``deeplearning4j_tpu/fleet/router.py``):
spawn, supervise and front N serving workers.

The router is deliberately thin — it never imports the model and never
touches the card. It owns three loops:

- **supervision**: each worker is a real OS process
  (``python -m deeplearning4j_tpu_torch.fleet.worker --device <device>``).
  On the card every worker inherits the process environment and shares
  the one card, each with its own context and graph pool; a CPU fleet
  (``device="cpu"``) spawns with ``utils.subproc.forced_cpu_env`` (no
  visible card, torch's threads capped), and a deployment may pass its
  own env. A worker that dies, stops answering ``/healthz``, or
  accepts TCP but never answers within the health ``Deadline`` (hung) is
  killed and respawned — with the shared ``RetryPolicy``'s exponential
  backoff and per-worker deterministic jitter, so workers killed
  together never respawn in lockstep (no thundering herd on the store
  and the card). Respawns are counted by cause in
  ``dl4jtpu_fleet_respawns_total{reason="crash"|"hung"|"unhealthy"}``.
  A respawned worker warm-boots from the bundle and captures every
  bucket before it reports ready, so the zero-captures-after-ready
  guarantee survives churn. A worker that never reports ready has the
  tail of its stderr kept (``boot_error`` in its snapshot).
- **routing**: POST ``/predict`` proxies to the alive, ready,
  not-rolling worker with the least outstanding requests. A worker-side
  admission shed (429) propagates to the client with its Retry-After;
  when EVERY worker is saturated past ``shed_outstanding`` the router
  sheds at the front door without burdening workers further.
- **rollout**: when the CheckpointStore publishes a newer version, the
  router rolls it across the fleet one worker at a time — take the
  worker out of rotation, wait for its outstanding requests to land,
  POST ``/swap``, put it back. No restarts, no captures (hot_swap copies
  the values into the served tensors); clients only ever see version N or
  N+1 responses, never a torn mix.

``/api/fleet`` aggregates per-worker liveness/version/queue depth and
merges the workers' bounded latency rings into EXACT fleet-wide
p50/p99 (rings from dead/stale workers are excluded and counted in
``dl4jtpu_fleet_stale_rings_total``); ``/metrics`` exposes the
router's own ``dl4jtpu_fleet_*`` series. In-process routers register
process-globally (:func:`get_fleet_routers`) so ``ui/server.py`` can
surface them.

**Tracing**: POST
``/predict`` adopts an ``x-dl4jtpu-trace`` header or mints a
head-sampled root context, opens the ``fleet.request`` root span, and
forwards a sibling ``fleet.attempt`` context to each tried worker —
the response always carries ``x-dl4jtpu-trace-id``. ``GET
/api/trace/<trace_id>`` merges the router's spans with every live
worker's into one Chrome-trace document, splicing
rollout/respawn/swap events as instants; ``GET /api/slo`` exposes the
router-level burn rates (objectives are env-opt-in via
``DL4JTPU_SLO_*``).

**History scrape plane**: a fourth loop polls every live worker's ``/metrics`` + ``/api/worker``
each ``scrape_s`` under the ``fleet.router.scrape`` Deadline policy,
ingests the samples into the process :class:`HistoryStore` with
``{worker, model}`` labels, runs the :class:`FleetRecordingRules`
pass (offered load, shed rate, exact p99, queue depth, boot→READY
seconds, capture counts + ``dl4jtpu_forecast_*`` EWMA/Holt signals)
over :meth:`stats`, and splices rollout/respawn/swap/slo-burn flight
events onto the timeline as annotations. Workers past the stale-ring
heartbeat cutoff have their series gap-marked stale, never flat-lined.
``GET /api/history`` serves the query endpoint; ``POST /history
{"enabled": false}`` pauses ingestion fleet-wide. Disable with
``DL4JTPU_HISTORY=0``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from ..runtime.resilience import Deadline, DeadlinePolicy, RetryPolicy
from ..telemetry.tracing import (
    TRACE_HEADER,
    TraceContext,
    get_trace_ring,
    record_trace_event,
    trace_span,
)
from ..utils.subproc import forced_cpu_env
from .worker import READY_SENTINEL

__all__ = ["FleetRouter", "get_fleet_routers", "main"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _flight(kind: str, **payload) -> None:
    """Best-effort flight-recorder event — never raises."""
    try:
        from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

        get_flight_recorder().record(kind, **payload)
    except Exception:  # noqa: BLE001
        pass


def _percentile(values, q: float):
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


class WorkerHandle:
    """Router-side state for one supervised worker process."""

    def __init__(self, wid: int):
        self.wid = wid
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.alive = False
        self.ready = False
        self.rolling = False  # out of rotation for a version swap
        self.version = 0
        self.queue_depth = 0
        self.outstanding = 0
        self.respawns = 0
        self.fail_count = 0  # consecutive failures feeding the backoff
        self.boot_seconds: Optional[float] = None  # spawn -> READY line
        self.boot_error: Optional[str] = None  # stderr tail of a failed boot
        self.stderr = None  # the process's stderr file (a temp file)
        self.down_reason: Optional[str] = None
        self.backoff_s = 0.0
        self.next_spawn_at = 0.0
        self.latency_samples: List[float] = []
        self.last_health: dict = {}
        self.last_seen = 0.0  # monotonic ts of the last healthy probe
        self.lock = threading.Lock()

    def snapshot(self) -> dict:
        return {
            "id": self.wid,
            "pid": self.proc.pid if self.proc else None,
            "port": self.port,
            "alive": self.alive,
            "ready": self.ready,
            "rolling": self.rolling,
            "version": self.version,
            "queue_depth": self.queue_depth,
            "outstanding": self.outstanding,
            "respawns": self.respawns,
            "down_reason": self.down_reason,
            "backoff_s": round(self.backoff_s, 4),
            "boot_seconds": self.boot_seconds,
            "compiles_since_ready":
                self.last_health.get("compiles_since_ready"),
            "bundle_installed": self.last_health.get("bundle_installed"),
            "boot_error": self.boot_error,
        }


class _NoWorker(Exception):
    """No ready worker to route to (not retryable — fail fast)."""


class _WorkerFailed(Exception):
    """A picked worker failed the request (retryable: fail over once)."""


class FleetRouter:
    def __init__(self, store_dir: str, *, model: str = "default",
                 workers: int = 2, port: int = 0,
                 worker_args: Optional[dict] = None,
                 spawn_env: Optional[dict] = None,
                 device: str = "cuda",
                 respawn: bool = True,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 10.0,
                 poll_s: float = 0.5,
                 shed_outstanding: int = 64,
                 boot_timeout_s: float = 120.0,
                 health_timeout_s: float = 5.0,
                 scrape_s: Optional[float] = None,
                 history: Optional[bool] = None,
                 registry=None):
        self.device = str(device)
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if self.device == "cuda":
            import torch  # noqa: PLC0415

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "FleetRouter(device='cuda'): torch.cuda.is_available() is "
                    "false; pass device='cpu' to serve from the CPU")
        if registry is None:
            from ..telemetry import get_registry  # noqa: PLC0415

            registry = get_registry()
        self.registry = registry
        self.store_dir = str(store_dir)
        self.model = model
        self.n_workers = int(workers)
        self.port = int(port)
        self.worker_args = dict(worker_args or {})
        self.spawn_env = spawn_env
        self.respawn = respawn
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.poll_s = float(poll_s)
        self.shed_outstanding = int(shed_outstanding)
        self.boot_timeout_s = float(boot_timeout_s)
        self.health_timeout_s = float(health_timeout_s)

        # shared failure-handling policies (runtime/resilience.py): the
        # respawn backoff is keyed per worker id, so simultaneous deaths
        # respawn staggered — deterministically
        self.respawn_policy = RetryPolicy(
            "fleet.router.respawn", base_s=self.backoff_base_s,
            cap_s=self.backoff_cap_s, jitter=0.5, max_attempts=None,
            registry=registry)
        self.failover_policy = RetryPolicy(
            "fleet.router.failover", max_attempts=2, base_s=0.0, cap_s=0.0,
            jitter=0.0, retry_on=(_WorkerFailed,), registry=registry)
        self.health_deadline = DeadlinePolicy(
            "fleet.router.health", self.health_timeout_s)
        self.boot_deadline = DeadlinePolicy(
            "fleet.router.boot", self.boot_timeout_s)

        # history scrape plane (telemetry/history.py): per-worker
        # /metrics + /api/worker fetches each run under this Deadline so
        # a wedged worker can never stall the scrape tick indefinitely
        from ..telemetry import history as _history  # noqa: PLC0415

        self.scrape_s = (float(scrape_s) if scrape_s is not None
                         else max(self.poll_s, 1.0))
        self.history_enabled = (_history.history_enabled()
                                if history is None else bool(history))
        self.scrape_deadline = DeadlinePolicy(
            "fleet.router.scrape", self.health_timeout_s)
        self.history = _history.get_history_store() \
            if self.history_enabled else None
        self.history_rules = _history.FleetRecordingRules(
            store=self.history, registry=registry) \
            if self.history_enabled else None
        # scrape-thread-private cursor state still gets a lock: the lint
        # (and a future second reader) can't know the thread ownership
        self._history_lock = threading.Lock()
        self._history_paused = threading.Event()
        self._ann_cursor_ts = time.time()

        self.workers: List[WorkerHandle] = [
            WorkerHandle(i) for i in range(self.n_workers)]
        self.target_version = 0
        self.rollouts = 0
        self.requests_total = 0
        self.shed_total = 0
        self.failed_total = 0
        # request counters increment from HTTP handler threads AND the
        # supervisor; every += goes through this lock
        self._stats_lock = threading.Lock()
        self._draining = False
        self._stop = threading.Event()
        self._route_cv = threading.Condition()
        self._httpd = None

        self._m_requests = registry.counter(
            "dl4jtpu_fleet_requests_total",
            "requests routed to fleet workers, by worker")
        self._m_shed = registry.counter(
            "dl4jtpu_fleet_shed_total",
            "requests shed at the router (fleet saturated or worker 429)")
        self._m_respawns = registry.counter(
            "dl4jtpu_fleet_respawns_total",
            "worker processes respawned, by detected cause",
            labelnames=("reason",))
        self._m_rollouts = registry.counter(
            "dl4jtpu_fleet_rollouts_total",
            "rolling version rollouts completed across the fleet")
        self._m_workers_alive = registry.gauge(
            "dl4jtpu_fleet_workers_alive", "live, ready fleet workers")
        self._m_version = registry.gauge(
            "dl4jtpu_fleet_version", "fleet-wide target serving version")
        self._m_stale_rings = registry.counter(
            "dl4jtpu_fleet_stale_rings_total",
            "worker latency rings excluded from fleet percentiles because "
            "the worker's last heartbeat predates the scrape")
        # router-level SLOs are env-opt-in, same contract as the service
        try:
            from ..telemetry import slo as _slo  # noqa: PLC0415

            if any(os.environ.get(k) for k in (
                    _slo.SLO_LATENCY_BUDGET_ENV,
                    _slo.SLO_LATENCY_TARGET_ENV,
                    _slo.SLO_AVAILABILITY_TARGET_ENV)):
                _slo.get_slo_monitor().declare_from_env(
                    self.model, latency_budget_ms=self.worker_args.get(
                        "latency_budget_ms"))
        except Exception:  # noqa: BLE001 - observability never blocks ctor
            pass

    # ------------------------------------------------------------ spawn
    def _spawn_env(self) -> dict:
        env = (dict(self.spawn_env) if self.spawn_env is not None
               else (forced_cpu_env(1) if self.device == "cpu"
                     else dict(os.environ)))
        env["PYTHONPATH"] = (_REPO_ROOT + os.pathsep
                             + env.get("PYTHONPATH", ""))
        return env

    def _worker_cmd(self) -> List[str]:
        cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.fleet.worker",
               "--store", self.store_dir, "--model", self.model,
               "--port", "0", "--no-watch", "--device", self.device]
        flag_map = {"max_delay_ms": "--max-delay-ms",
                    "max_batch": "--max-batch",
                    "max_queue_depth": "--max-queue",
                    "latency_budget_ms": "--latency-budget-ms",
                    "poll_s": "--poll-s"}
        for key, flag in flag_map.items():
            value = self.worker_args.get(key)
            if value is not None:
                cmd += [flag, str(value)]
        if self.worker_args.get("no_bundle"):
            cmd.append("--no-bundle")
        return cmd

    def _spawn(self, handle: WorkerHandle) -> bool:
        spawn_t0 = time.perf_counter()
        if handle.stderr is not None:
            handle.stderr.close()
        handle.stderr = tempfile.TemporaryFile()
        handle.proc = subprocess.Popen(
            self._worker_cmd(), env=self._spawn_env(), cwd=_REPO_ROOT,
            stdout=subprocess.PIPE, stderr=handle.stderr, text=True)
        # watchdog: readline blocks, so a worker hung in boot is killed at
        # the deadline (readline then returns EOF and the spawn fails)
        booted = threading.Event()
        proc = handle.proc
        deadline = self.boot_deadline.start()

        def _watchdog():
            if not deadline.wait_event(booted) and proc.poll() is None:
                proc.kill()

        threading.Thread(target=_watchdog, daemon=True).start()
        line = ""
        while True:
            line = handle.proc.stdout.readline()
            if not line or line.startswith(READY_SENTINEL):
                break
        booted.set()
        if not line.startswith(READY_SENTINEL):
            if handle.proc.poll() is None:
                handle.proc.kill()
            handle.proc.wait()
            handle.stderr.seek(0, os.SEEK_END)
            handle.stderr.seek(max(0, handle.stderr.tell() - 4000))
            handle.boot_error = handle.stderr.read().decode("utf-8", "replace")
            return False
        fields = dict(kv.split("=", 1) for kv in line.split()[1:])
        with handle.lock:
            handle.port = int(fields["port"])
            handle.version = int(fields.get("version", 0))
            handle.alive = True
            handle.ready = True
            handle.backoff_s = 0.0
            handle.fail_count = 0
            handle.down_reason = None
            handle.boot_error = None
            # the warm-pool sizing signal: spawn -> READY_SENTINEL wall
            # seconds, surfaced per worker and recorded by the history
            # recording rules as worker.boot_ready_seconds
            handle.boot_seconds = round(
                time.perf_counter() - spawn_t0, 4)
        # the ready pipe stays open; drain it so the worker never blocks
        threading.Thread(target=handle.proc.stdout.read,
                         daemon=True).start()
        return True

    def start(self) -> "FleetRouter":
        """Spawn every worker (concurrently — boots overlap), start the
        supervisor/rollout loop and the HTTP front."""
        from ..runtime.checkpoint import CheckpointStore  # noqa: PLC0415

        self.store = CheckpointStore(self.store_dir)
        self.target_version = self.store.latest_version()
        threads = [threading.Thread(target=self._spawn, args=(h,))
                   for h in self.workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if not any(h.ready for h in self.workers):
            errors = [h.boot_error for h in self.workers if h.boot_error]
            self.stop()
            raise RuntimeError(
                f"no fleet worker came up within {self.boot_timeout_s}s"
                + (f"; a worker's stderr ends:\n{errors[0]}" if errors else ""))
        self._m_workers_alive.set(
            sum(1 for h in self.workers if h.ready))
        self._m_version.set(self.target_version)
        threading.Thread(target=self._supervise_loop, daemon=True,
                         name="dl4jtpu-fleet-supervisor").start()
        if self.history_enabled:
            from ..telemetry.history import ensure_default_sampler  # noqa: PLC0415

            # the router's own dl4jtpu_fleet_* families grow history too
            ensure_default_sampler()
            threading.Thread(target=self._scrape_loop, daemon=True,
                             name="dl4jtpu-fleet-scrape").start()
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="dl4jtpu-fleet-router-http").start()
        _register_router(self)
        return self

    # -------------------------------------------------------- supervise
    def _health(self, handle: WorkerHandle) -> Tuple[Optional[dict], bool]:
        """Probe a worker's /healthz under the health Deadline. Returns
        ``(health, hung)``: hung=True means the worker accepted TCP but
        never answered inside the deadline — a live-but-wedged process
        (crashed/refused connections report hung=False)."""
        if handle.port is None:
            return None, False
        deadline = self.health_deadline.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{handle.port}/healthz",
                    timeout=max(0.001, deadline.remaining())) as resp:
                return json.loads(resp.read()), False
        except urllib.error.URLError as e:
            hung = isinstance(getattr(e, "reason", None),
                              (socket.timeout, TimeoutError))
            if hung:
                deadline.note_expired()
            return None, hung
        except (socket.timeout, TimeoutError):
            deadline.note_expired()
            return None, True
        except Exception:  # noqa: BLE001 - garbled/partial response
            return None, False

    def _supervise_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            alive = 0
            for handle in self.workers:
                self._check_worker(handle)
                if handle.ready:
                    alive += 1
            self._m_workers_alive.set(alive)
            if not self._draining:
                try:
                    self._maybe_rollout()
                except Exception:  # noqa: BLE001 - retried next tick
                    pass

    def _backoff(self, handle: WorkerHandle) -> None:
        """Schedule the next respawn attempt: shared exponential policy,
        jitter keyed by worker id — simultaneous deaths respawn staggered."""
        handle.fail_count += 1
        handle.backoff_s = self.respawn_policy.record_failure(
            key=f"worker-{handle.wid}", attempt=handle.fail_count)
        handle.next_spawn_at = time.monotonic() + handle.backoff_s

    def _check_worker(self, handle: WorkerHandle) -> None:
        proc = handle.proc
        reason = None
        dead = proc is None or proc.poll() is not None
        if dead:
            reason = "crash"
        else:
            health, hung = self._health(handle)
            if health is None:
                dead = True
                reason = "hung" if hung else "unhealthy"
                if proc.poll() is None:
                    # a hung or garbling process still owns its port; reap
                    # it so the respawn can bind a fresh worker (a live
                    # process left down would never be respawned)
                    proc.kill()
            else:
                with handle.lock:
                    handle.last_health = health
                    handle.version = int(health.get("version") or 0)
                    handle.queue_depth = int(health.get("queue_depth") or 0)
                    handle.latency_samples = list(
                        health.get("latency_samples") or [])
                    handle.last_seen = time.monotonic()
        if dead and handle.alive:
            with handle.lock:
                handle.alive = False
                handle.ready = False
                handle.down_reason = reason
                self._backoff(handle)
        if (dead and self.respawn and not self._draining
                and time.monotonic() >= handle.next_spawn_at):
            cause = handle.down_reason or reason or "crash"
            if self._spawn(handle):
                handle.respawns += 1
                self._m_respawns.labels(reason=cause).inc()
                self.respawn_policy.record_success()
                _flight("fleet_respawn", worker=handle.wid, reason=cause,
                        port=handle.port, version=handle.version)
            else:
                with handle.lock:
                    self._backoff(handle)

    # ---------------------------------------------------------- history
    def _scrape_loop(self) -> None:
        while not self._stop.wait(self.scrape_s):
            if self._history_paused.is_set():
                continue
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - next tick retries
                pass

    def _fetch_worker(self, port: int) -> Tuple[str, dict]:
        """One worker's /metrics text + /api/worker JSON, both fetched
        under the shared ``fleet.router.scrape`` Deadline so a wedged
        worker can't stall the scrape tick."""
        deadline = self.scrape_deadline.start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics",
                timeout=max(0.001, deadline.remaining())) as resp:
            metrics_text = resp.read().decode("utf-8", "replace")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/worker",
                timeout=max(0.001, deadline.remaining())) as resp:
            worker = json.loads(resp.read())
        return metrics_text, worker

    def scrape_once(self, now: Optional[float] = None) -> dict:
        """One scrape tick (public so tests drive it synchronously with an
        injected clock): poll every live worker,
        ingest with ``{worker, model}`` labels, gap-mark workers past
        the stale-heartbeat cutoff, run the recording rules over
        :meth:`stats`, splice flight events as annotations."""
        store = self.history
        if store is None:
            return {}
        stale_cutoff = max(5.0 * self.poll_s, 2.0)
        mono = time.monotonic()
        scraped, stale_marked = 0, 0
        for handle in self.workers:
            with handle.lock:
                fresh = (handle.ready and handle.alive
                         and mono - handle.last_seen <= stale_cutoff)
                port = handle.port
            wlab = {"worker": str(handle.wid), "model": self.model}
            if not fresh or port is None:
                # same rule that excludes stale latency rings from the
                # fleet percentiles: the series gets an explicit gap
                stale_marked += store.mark_stale(wlab, now=now)
                continue
            try:
                metrics_text, worker = self._fetch_worker(port)
            except Exception:  # noqa: BLE001 - worker died mid-scrape
                stale_marked += store.mark_stale(wlab, now=now)
                continue
            store.ingest_prometheus(metrics_text, extra_labels=wlab,
                                    now=now)
            if worker.get("uptime_s") is not None:
                store.record_gauge("worker.uptime_s", worker["uptime_s"],
                                   wlab, now=now)
            scraped += 1
        sensors = self.history_rules.observe_fleet(self.stats(), now=now)
        self._splice_annotations(store)
        return {"scraped": scraped, "stale_marked": stale_marked,
                "sensors": sensors}

    def _splice_annotations(self, store) -> None:
        """Flight events newer than the cursor whose kind belongs on the
        serving timeline become history annotations."""
        try:
            from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

            events = get_flight_recorder().events
        except Exception:  # noqa: BLE001
            return
        kinds = ("fleet_rollout", "fleet_respawn", "serve_swap",
                 "online_swap", "slo_burn")
        with self._history_lock:
            cursor = self._ann_cursor_ts
            picked = [ev for ev in events
                      if ev.get("kind") in kinds
                      and float(ev.get("ts", 0.0)) > cursor]
            if events:
                self._ann_cursor_ts = max(
                    cursor, max(float(e.get("ts", 0.0)) for e in events))
        for ev in picked:
            payload = {k: v for k, v in ev.items()
                       if k not in ("ts", "kind")}
            store.annotate(ev["kind"], now=float(ev["ts"]), **payload)

    def set_history_enabled(self, enabled: bool) -> dict:
        """Fleet-wide ingestion toggle: the router's scrape loop, the
        process sampler, and every live worker's sampler."""
        from ..telemetry.history import get_default_sampler  # noqa: PLC0415

        if enabled:
            self._history_paused.clear()
        else:
            self._history_paused.set()
        sampler = get_default_sampler()
        if sampler is not None:
            if enabled:
                sampler.resume()
            else:
                sampler.pause()
        body = json.dumps({"enabled": bool(enabled)}).encode()
        workers_ok = 0
        for handle in self.workers:
            with handle.lock:
                port = handle.port if handle.ready else None
            if port is None:
                continue
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/history", body,
                    {"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=5).read()
                workers_ok += 1
            except Exception:  # noqa: BLE001 - a dead worker misses the toggle
                pass
        return {"enabled": bool(enabled), "workers": workers_ok}

    # ---------------------------------------------------------- rollout
    def _maybe_rollout(self) -> None:
        latest = self.store.latest_version()
        if latest <= self.target_version:
            return
        self.target_version = latest
        self._m_version.set(latest)
        self.roll_to(latest)
        self.rollouts += 1
        self._m_rollouts.inc()

    def roll_to(self, version: int, *, settle_timeout_s: float = 30.0) -> None:
        """Roll ``version`` across the fleet, one worker at a time: out of
        rotation → outstanding lands → POST /swap → back in rotation. A
        worker that fails the swap is killed (the supervisor respawns it
        warm-booted at the new version) so a rollout always converges."""
        for handle in self.workers:
            if not handle.ready:
                continue  # a respawn boots straight at the latest version
            handle.rolling = True
            try:
                deadline = Deadline(settle_timeout_s)
                while handle.outstanding > 0 and deadline.pace(0.01):
                    pass
                body = json.dumps({"version": int(version)}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{handle.port}/swap", body,
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    swapped = json.loads(resp.read())
                with handle.lock:
                    handle.version = int(swapped["version"])
                _flight("fleet_rollout", worker=handle.wid,
                        version=int(swapped["version"]), port=handle.port)
            except Exception:  # noqa: BLE001 - converge via respawn
                if handle.proc is not None and handle.proc.poll() is None:
                    handle.proc.kill()
            finally:
                handle.rolling = False

    # ------------------------------------------------------------ route
    def _pick(self) -> Optional[WorkerHandle]:
        ready = [h for h in self.workers
                 if h.ready and h.alive and not h.rolling]
        if not ready:
            return None
        return min(ready, key=lambda h: h.outstanding)

    def route_predict(self, payload: dict, trace=None) -> tuple:
        """Returns (http_status, body dict, headers dict). The one
        failover retry on a dead worker routes through the shared
        ``fleet.router.failover`` RetryPolicy (max_attempts=2, no
        backoff — a second worker is tried immediately).

        ``trace`` is the request's root :class:`TraceContext` (minted or
        propagated by the HTTP front). Each routing attempt opens a
        SIBLING ``fleet.attempt`` span under it and forwards its context
        to the picked worker via the ``x-dl4jtpu-trace`` header, so a
        failover shows up as two attempt spans with distinct workers
        under one request. Sheds and errors upgrade the sample decision
        so every degraded request is traced end-to-end from this hop on.
        """
        if self._draining:
            return 503, {"error": "fleet draining"}, {}
        attempt_no = [0]

        def attempt():
            attempt_no[0] += 1
            handle = self._pick()
            if handle is None:
                raise _NoWorker("no ready worker")
            if handle.outstanding >= self.shed_outstanding:
                # least-loaded worker is saturated => whole fleet is
                with self._stats_lock:
                    self.shed_total += 1
                self._m_shed.inc()
                retry = round(max(0.05, 0.01 * handle.outstanding), 3)
                if trace is not None:
                    trace.upgrade("shed:fleet_saturated")
                    record_trace_event(
                        trace.child(), "fleet.shed", worker=handle.wid,
                        reason="fleet_saturated", retry_after_s=retry)
                self._observe_slo(shed=True, trace=trace)
                return (429, {"error": "fleet saturated",
                              "retry_after_s": retry},
                        {"Retry-After": f"{retry:.3f}"})
            with handle.lock:
                handle.outstanding += 1
            # sibling span per attempt: same parent (the fleet.request
            # span), fresh span_id — the worker parents under it
            a_ctx = trace.child() if trace is not None else None
            t0 = time.perf_counter()
            ts_us = time.time() * 1e6
            try:
                body = json.dumps(payload).encode()
                headers_out = {"Content-Type": "application/json"}
                if a_ctx is not None:
                    headers_out[TRACE_HEADER] = a_ctx.to_header()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{handle.port}/predict", body,
                    headers_out)
                with urllib.request.urlopen(req, timeout=60) as resp:
                    out = json.loads(resp.read())
                with self._stats_lock:
                    self.requests_total += 1
                self._m_requests.inc()
                elapsed = time.perf_counter() - t0
                if a_ctx is not None and a_ctx.sampled:
                    record_trace_event(
                        a_ctx, "fleet.attempt", duration_s=elapsed,
                        ts_us=ts_us, worker=handle.wid, port=handle.port,
                        attempt=attempt_no[0], status=200)
                self._observe_slo(latency_s=elapsed, trace=a_ctx)
                return 200, out, {}
            except urllib.error.HTTPError as e:
                detail = {}
                try:
                    detail = json.loads(e.read())
                except Exception:  # noqa: BLE001
                    pass
                if e.code == 429:  # propagate the worker's shed verbatim
                    with self._stats_lock:
                        self.shed_total += 1
                    self._m_shed.inc()
                    headers = {}
                    if e.headers.get("Retry-After"):
                        headers["Retry-After"] = e.headers["Retry-After"]
                    if trace is not None:
                        trace.upgrade("shed:worker")
                        record_trace_event(
                            trace.child(), "fleet.shed", worker=handle.wid,
                            reason="worker_shed", attempt=attempt_no[0])
                    self._observe_slo(shed=True, trace=trace)
                    return 429, detail or {"error": "worker shed"}, headers
                if e.code in (400, 404):
                    return e.code, detail or {"error": str(e)}, {}
                self._trace_attempt_error(a_ctx, handle, attempt_no[0],
                                          t0, ts_us, e)
                raise _WorkerFailed(detail.get("error", str(e))) from e
            except _WorkerFailed:
                raise
            except Exception as e:  # noqa: BLE001 - dead worker: fail over
                with handle.lock:
                    handle.alive = False
                    handle.ready = False
                self._trace_attempt_error(a_ctx, handle, attempt_no[0],
                                          t0, ts_us, e)
                raise _WorkerFailed(str(e)) from e
            finally:
                with handle.lock:
                    handle.outstanding = max(0, handle.outstanding - 1)

        try:
            return self.failover_policy.run(attempt)
        except _NoWorker as e:
            with self._stats_lock:
                self.failed_total += 1
            self._observe_slo(error=True, trace=trace)
            return 503, {"error": f"no worker served the request ({e})"}, {}
        except Exception as e:  # noqa: BLE001 - RetryError wraps the cause
            with self._stats_lock:
                self.failed_total += 1
            self._observe_slo(error=True, trace=trace)
            cause = getattr(e, "last", e)
            return 503, {"error": f"no worker served the request "
                                  f"({cause})"}, {}

    def _trace_attempt_error(self, a_ctx, handle, attempt, t0, ts_us,
                             exc) -> None:
        """Failed attempt span — upgrades the sample decision first so
        the error span (and the failover sibling that follows) records."""
        if a_ctx is None:
            return
        a_ctx.upgrade("error:worker_failed")
        record_trace_event(
            a_ctx, "fleet.attempt", duration_s=time.perf_counter() - t0,
            ts_us=ts_us, worker=handle.wid, port=handle.port,
            attempt=attempt, error=repr(exc)[:200])

    def _observe_slo(self, *, latency_s=None, shed=False, error=False,
                     trace=None) -> None:
        """Feed the router-level SLO monitor (no-op unless the model was
        declared — declaration is env-opt-in in ``__init__``)."""
        try:
            from ..telemetry.slo import get_slo_monitor  # noqa: PLC0415

            mon = get_slo_monitor()
            if mon.objectives(self.model) is None:
                return
            tid = (trace.trace_id
                   if trace is not None and getattr(trace, "sampled", False)
                   else None)
            mon.observe(self.model, latency_s=latency_s, shed=shed,
                        error=error, trace_id=tid)
            mon.maybe_evaluate()
        except Exception:  # noqa: BLE001 - observability never fails routing
            pass

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """The /api/fleet payload: per-worker liveness + merged EXACT
        percentiles over every worker's bounded latency ring.

        A dead worker's handle still holds the ring from its last healthy
        probe; merging it would freeze stale samples into fleet p50/p99
        long after the worker stopped serving. Rings whose last heartbeat
        predates the scrape by more than ~5 poll intervals (or whose
        worker is down) are excluded and counted in
        ``dl4jtpu_fleet_stale_rings_total``."""
        merged: List[float] = []
        stale_cutoff = max(5.0 * self.poll_s, 2.0)
        now = time.monotonic()
        stale_rings = 0
        for handle in self.workers:
            with handle.lock:  # _check_worker swaps the ring concurrently
                fresh = (handle.ready and handle.alive
                         and now - handle.last_seen <= stale_cutoff)
                if fresh:
                    merged.extend(handle.latency_samples)
                elif handle.latency_samples:
                    stale_rings += 1
        if stale_rings:
            self._m_stale_rings.inc(stale_rings)
        return {
            "store": self.store_dir,
            "model": self.model,
            "target_version": self.target_version,
            "rollouts": self.rollouts,
            "requests_total": self.requests_total,
            "shed_total": self.shed_total,
            "failed_total": self.failed_total,
            "draining": self._draining,
            "workers": [h.snapshot() for h in self.workers],
            "latency_seconds": {
                "p50": _percentile(merged, 50),
                "p99": _percentile(merged, 99),
                "samples": len(merged),
            },
        }

    # ------------------------------------------------------------ trace
    def trace_merged(self, trace_id: str) -> dict:
        """The ``GET /api/trace/<trace_id>`` payload: one Chrome/Perfetto
        trace document merging the router's own spans with every live
        worker's spans for the trace, plus rollout/respawn/swap flight
        events inside the covered interval spliced as instant events
        (``ph:"i"``) so an operator sees a request straddling a version
        swap in one timeline."""
        events = list(get_trace_ring().spans_for(trace_id))
        worker_docs = []
        swap_events: List[dict] = []
        for handle in self.workers:
            if not handle.ready or handle.port is None:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{handle.port}/api/trace/"
                        f"{trace_id}", timeout=10) as resp:
                    doc = json.loads(resp.read())
            except Exception:  # noqa: BLE001 - a dead worker loses its spans
                continue
            spans = doc.get("spans") or []
            events.extend(spans)
            swap_events.extend(doc.get("swap_events") or [])
            worker_docs.append({"id": handle.wid, "pid": doc.get("pid"),
                                "port": handle.port,
                                "spans": len(spans)})
        # splice fleet + worker lifecycle flight events that fall inside
        # the trace's covered interval (with a small margin) as instants
        if events:
            lo = min(e.get("ts", 0.0) for e in events)
            hi = max(e.get("ts", 0.0) + e.get("dur", 0.0) for e in events)
            margin_us = 1e6  # 1s either side catches the triggering swap
            try:
                from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

                fleet_events = [
                    e for e in get_flight_recorder().events
                    if e.get("kind") in ("fleet_rollout", "fleet_respawn")]
            except Exception:  # noqa: BLE001
                fleet_events = []
            for ev in fleet_events + swap_events:
                ts_us = float(ev.get("ts", 0.0)) * 1e6
                if lo - margin_us <= ts_us <= hi + margin_us:
                    events.append({
                        "name": ev.get("kind", "event"), "ph": "i",
                        "ts": ts_us, "pid": ev.get("pid", os.getpid()),
                        "tid": 0, "s": "g",
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ts", "kind")}})
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": trace_id,
                "model": self.model,
                "router_pid": os.getpid(),
                "workers": worker_docs,
            },
        }

    # ------------------------------------------------------------ drain
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Fleet-wide graceful drain: stop admitting at the front, drain
        every worker (their in-flight requests finish), reap processes."""
        self._draining = True
        deadline = Deadline(timeout_s)
        ok = True
        for handle in self.workers:
            if not handle.alive or handle.port is None:
                continue
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{handle.port}/drain", b"{}",
                    {"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=10).read()
            except Exception:  # noqa: BLE001
                ok = False
        for handle in self.workers:
            while (handle.alive and handle.port is not None
                   and not deadline.expired):
                health, _ = self._health(handle)
                if health is None or health.get("drained"):
                    break
                deadline.pace(0.05)
        return ok

    def stop(self) -> None:
        self._stop.set()
        self._draining = True
        if self._httpd is not None:
            self._httpd.shutdown()
        for handle in self.workers:
            proc = handle.proc
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for handle in self.workers:
            proc = handle.proc
            if proc is not None:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            if handle.stderr is not None:
                handle.stderr.close()
                handle.stderr = None
        _unregister_router(self)

    # ------------------------------------------------------------- http
    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body, ctype="application/json",
                      headers: Optional[dict] = None) -> None:
                data = (body if isinstance(body, bytes)
                        else json.dumps(body).encode())
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/api/fleet":
                    self._send(200, router.stats())
                elif self.path == "/api/resilience":
                    from ..runtime.resilience import resilience_stats  # noqa: PLC0415
                    self._send(200, resilience_stats())
                elif self.path.startswith("/api/trace/"):
                    trace_id = self.path.rsplit("/", 1)[-1]
                    self._send(200, router.trace_merged(trace_id))
                elif self.path == "/api/slo":
                    from ..telemetry.slo import get_slo_monitor  # noqa: PLC0415
                    self._send(200, get_slo_monitor().stats())
                elif self.path.startswith("/api/history"):
                    if router.history is None:
                        self._send(503, {"error": "history disabled "
                                                  "(DL4JTPU_HISTORY=0)"})
                        return
                    from urllib.parse import parse_qsl, urlparse  # noqa: PLC0415
                    params = dict(parse_qsl(urlparse(self.path).query))
                    try:
                        self._send(200, router.history.http_query(params))
                    except ValueError as e:
                        self._send(400, {"error": str(e)})
                elif self.path == "/metrics":
                    self._send(200,
                               router.registry.prometheus_text().encode(),
                               "text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    self._send(200, {"ready": True,
                                     "draining": router._draining})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON body"})
                    return
                if self.path == "/predict":
                    # the fleet front is where a trace is born: adopt an
                    # incoming context or mint a head-sampled root, open
                    # the fleet.request root span, and always hand the
                    # trace id back so clients can fetch the merged trace
                    ctx = TraceContext.from_header(
                        self.headers.get(TRACE_HEADER))
                    if ctx is None:
                        ctx = TraceContext.new(
                            baggage={"model": router.model})
                    with trace_span(ctx, "fleet.request",
                                    model=router.model) as sp:
                        code, body, headers = router.route_predict(
                            payload, trace=sp.ctx if sp.ctx is not None
                            else ctx)
                    headers = dict(headers or {})
                    headers["x-dl4jtpu-trace-id"] = ctx.trace_id
                    headers["x-dl4jtpu-trace-sampled"] = (
                        "1" if ctx.sampled else "0")
                    self._send(code, body, headers=headers)
                elif self.path == "/rollout":
                    version = payload.get(
                        "version", router.store.latest_version())
                    router.roll_to(int(version))
                    router.target_version = max(router.target_version,
                                                int(version))
                    self._send(200, {"version": int(version)})
                elif self.path == "/drain":
                    ok = router.drain()
                    self._send(200, {"drained": ok})
                elif self.path == "/history":
                    enabled = bool(payload.get("enabled", True))
                    self._send(200, router.set_history_enabled(enabled))
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

        return Handler


# --------------------------------------------------------------- registry
_ROUTERS: List[FleetRouter] = []
_ROUTERS_LOCK = threading.Lock()


def _register_router(router: FleetRouter) -> None:
    with _ROUTERS_LOCK:
        if router not in _ROUTERS:
            _ROUTERS.append(router)


def _unregister_router(router: FleetRouter) -> None:
    with _ROUTERS_LOCK:
        if router in _ROUTERS:
            _ROUTERS.remove(router)


def get_fleet_routers() -> List[FleetRouter]:
    """In-process routers (what ui/server.py's /api/fleet aggregates)."""
    with _ROUTERS_LOCK:
        return list(_ROUTERS)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.fleet.router",
        description="fleet routing front")
    ap.add_argument("--store", required=True)
    ap.add_argument("--model", default="default")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--shed-outstanding", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-delay-ms", type=float, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--latency-budget-ms", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the workers serve (default: cuda)")
    args = ap.parse_args(argv)

    router = FleetRouter(
        args.store, model=args.model, workers=args.workers,
        port=args.port, shed_outstanding=args.shed_outstanding,
        device=args.device,
        worker_args={"max_batch": args.max_batch,
                     "max_delay_ms": args.max_delay_ms,
                     "max_queue_depth": args.max_queue,
                     "latency_budget_ms": args.latency_budget_ms})
    router.start()
    print(f"FLEET_ROUTER_READY port={router.port} "
          f"workers={sum(1 for h in router.workers if h.ready)}",
          flush=True)
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
