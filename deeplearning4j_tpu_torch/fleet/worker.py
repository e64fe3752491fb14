"""Fleet worker (counterpart of ``deeplearning4j_tpu/fleet/worker.py``):
one standalone serving process, warm-booted from a store.

``python -m deeplearning4j_tpu_torch.fleet.worker --store DIR [--model NAME]
[--port P] [--device cuda|cpu] [--watch/--no-watch] ...`` boots an
:class:`~deeplearning4j_tpu_torch.serving.InferenceService` from the latest
:class:`~deeplearning4j_tpu_torch.runtime.checkpoint.CheckpointStore`
version, installs the warm-boot bundle (fleet/artifacts.py) and captures
every warmup bucket BEFORE reporting ready — so the first live request
makes **zero captures**, read from the process-wide compile manager's
``compiles`` counter (on the card a compile is a CUDA-graph capture) whose
since-ready count every ``/healthz`` reports. The worker runs on the card
unless ``--device cpu``; on the card its boot fails loudly when a kernel
library of ``ops/csrc/`` is not built (it builds none and serves no plain
version). Several workers may share one card, each with its own context
and its graphs' own pool.

Lifecycle contract (what the router and the tests rely on):

- stdout emits exactly one ``FLEET_WORKER_READY port=P version=V pid=N``
  line once warm and listening; nothing is served before it.
- ``--watch`` (standalone default) polls the store and ``hot_swap``s new
  versions automatically — values copied into the served tensors, zero
  captures. The router spawns workers with ``--no-watch`` and coordinates
  the rolling rollout itself via POST ``/swap``.
- graceful drain (SIGTERM or POST ``/drain``): stop admitting (503),
  finish every queued + in-flight request, deregister, exit. /healthz
  keeps answering during the drain so supervisors can watch it land.

HTTP endpoints: POST ``/predict`` ``{features, argmax?}`` → ``{output |
classes, version}`` (429 + Retry-After when admission sheds, 503 while
draining/not ready), POST ``/swap`` ``{version?}``, POST ``/drain``,
GET ``/healthz``, GET ``/metrics`` (exemplar-carrying), GET
``/api/worker`` (``/healthz`` plus the service's stats, the kernels'
launches in this process — by their wrappers and by the served graphs'
replays — and on the card the graphs' pool bytes and
``torch.cuda.mem_get_info``), GET ``/api/trace/<trace_id>`` (this
process's spans for one distributed trace), GET ``/api/slo``, GET
``/api/history`` (this process's metric time-series store — the serving
front-end starts a Deadline-paced :class:`HistorySampler` automatically
unless ``DL4JTPU_HISTORY=0``), POST ``/history`` ``{enabled}``
(pause/resume the sampler). POST ``/predict`` honors the
``x-dl4jtpu-trace`` context header.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["FleetWorker", "main"]

READY_SENTINEL = "FLEET_WORKER_READY"


def _captures() -> int:
    """Captures so far in this process (the compile manager's counter)."""
    from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415

    return int(get_compile_manager().compiles.value)


def kernel_launches() -> dict:
    """This process's kernel launches by name: ``wrapper``, what the
    kernels' wrappers counted (eager runs, a bucket's warm-up run and its
    capture), and ``replayed``, what the served graphs launched by replay
    (each live graph's captured launches times its replays)."""
    from .. import ops  # noqa: PLC0415
    from ..runtime import inference as _inf  # noqa: PLC0415
    from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415

    replayed: dict = {}
    for _, graph in get_compile_manager().owned():
        if isinstance(graph, _inf.ServedGraph):
            for name, n in graph.launches.items():
                if n and graph.replays:
                    replayed[name] = replayed.get(name, 0) + n * graph.replays
    return {"wrapper": {k: v for k, v in ops.counters().items() if v},
            "replayed": replayed}


class FleetWorker:
    def __init__(self, store_dir: str, *, model: str = "default",
                 port: int = 0, watch: bool = False,
                 poll_s: float = 0.5,
                 max_delay_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 latency_budget_ms: Optional[float] = None,
                 use_bundle: bool = True, device="cuda"):
        from ..nn.multilayer import resolve_device  # noqa: PLC0415

        self.device = resolve_device(device)  # no card: raises, no fallback
        self.store_dir = str(store_dir)
        self.model = model
        self.port = int(port)
        self.watch = bool(watch)
        self.poll_s = float(poll_s)
        self.max_delay_ms = max_delay_ms
        self.max_batch = max_batch
        self.max_queue_depth = max_queue_depth
        self.latency_budget_ms = latency_budget_ms
        self.use_bundle = use_bundle

        self.ready = False
        self.version = 0
        self.bundle_installed = False
        self.warmed_buckets = 0
        self.compiles_at_ready = 0
        self.requests_total = 0
        self.shed_total = 0
        self.started_at = time.time()
        self.boot_seconds: Optional[float] = None
        # ThreadingHTTPServer runs one thread per request: the request
        # counters increment under this lock, never bare
        self._stats_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._stop = threading.Event()
        self._drained = threading.Event()
        self.store = None
        self.service = None
        self.net = None
        self._loader = None  # spare net swaps load into (pointer-flip safe)
        self._httpd = None
        self._argmax_warm = False
        # optional deterministic fault injection (testing/chaos.py): main()
        # attaches a FaultPlan from DL4JTPU_CHAOS_PLAN; in-process tests
        # set .chaos directly. The /healthz handler is the explicit hook.
        self.chaos = None

        # typed failure handling (runtime/resilience.py) for the two loops
        # that talk to the store: the version watch and the swap itself
        from ..runtime.resilience import RetryPolicy  # noqa: PLC0415

        self._watch_policy = RetryPolicy(
            "fleet.worker.watch", base_s=self.poll_s,
            cap_s=max(4.0, 8 * self.poll_s), jitter=0.25)
        self._swap_policy = RetryPolicy(
            "fleet.worker.swap", max_attempts=3, base_s=0.05, cap_s=1.0)

    # ------------------------------------------------------------- boot
    def boot(self) -> "FleetWorker":
        """Check kernels → restore → install bundle → register → warm →
        read the capture counter → listen. Nothing is admitted before this
        returns."""
        from ..fleet import artifacts  # noqa: PLC0415
        from ..runtime.checkpoint import CheckpointStore  # noqa: PLC0415
        from ..serving import InferenceService, set_service  # noqa: PLC0415

        if self.device.type == "cuda":
            from ..ops import _build  # noqa: PLC0415

            missing = _build.missing()
            if missing:
                raise RuntimeError(
                    f"fleet worker: kernel libraries not built: {missing}; "
                    "build them first (deeplearning4j_tpu_torch.ops._build."
                    "build()) — a worker on the card serves no plain version")
        self.store = CheckpointStore(self.store_dir)

        # the tuned state must precede register()'s auto_apply and warmup
        bundle = (artifacts.load_bundle(self.store)
                  if self.use_bundle else None)
        if bundle is not None:
            artifacts.install_bundle(bundle)
            self.bundle_installed = True

        # verified restore with fallback: a corrupt `latest` is quarantined
        # and the newest good version boots instead (corrupt-latest
        # survival — the bundle's warmup shapes don't depend on version)
        self.net, info = self.store.restore_with_info(device=self.device)
        self.version = int(info.version)
        if bundle is None and self.use_bundle:
            bundle = artifacts.load_bundle(self.store, self.net)
            if bundle is not None:
                artifacts.install_bundle(bundle)
                self.bundle_installed = True

        self.service = InferenceService()
        set_service(self.service, f"fleet-worker:{self.model}")
        self.service.register(
            self.model, self.net,
            max_delay_ms=self.max_delay_ms, max_batch=self.max_batch,
            max_queue_depth=self.max_queue_depth,
            latency_budget_ms=self.latency_budget_ms)

        warmup = dict((bundle or {}).get("warmup") or {})
        if warmup.get("example_shape"):
            shape = tuple(int(d) for d in warmup["example_shape"])
            dtype = np.dtype(warmup.get("example_dtype", "float32"))
            self._argmax_warm = bool(warmup.get("argmax", False))
            # a recurrent example also warms the bundle's other request
            # lengths (a padded length serves through a masked graph)
            lengths = [shape[0]] + [int(t) for t in warmup.get("time_lengths") or ()]
            shapes = ([(t,) + shape[1:] for t in dict.fromkeys(lengths)]
                      if len(shape) == 2 else [shape])
            for one in shapes:
                self.warmed_buckets += self.service.warmup(
                    self.model, np.zeros((1, *one), dtype),
                    argmax=self._argmax_warm,
                    max_rows=warmup.get("max_batch"))

        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True, name="dl4jtpu-fleet-http").start()
        if self.watch:
            threading.Thread(target=self._watch_loop, daemon=True,
                             name="dl4jtpu-fleet-watch").start()
        try:
            # traces minted or continued in this process carry the served
            # model + checkpoint version as baggage
            from ..telemetry.tracing import set_default_baggage  # noqa: PLC0415

            set_default_baggage("model", self.model)
            set_default_baggage("checkpoint_version", str(self.version))
        except Exception:  # noqa: BLE001 - observability never blocks boot
            pass
        self.compiles_at_ready = _captures()
        # process-internal boot->ready seconds (the router additionally
        # measures spawn->READY wall time, which includes interpreter
        # startup; both feed worker.boot_ready_seconds consumers)
        self.boot_seconds = round(time.time() - self.started_at, 4)
        self.ready = True
        return self

    # ------------------------------------------------------------- swap
    def swap_to(self, version: Optional[int] = None) -> int:
        """Hot-swap the served model to ``version`` (default: latest). The
        loader (a second network, restored once) takes the version in
        place (``load_into``); ``hot_swap`` copies its values into the
        served tensors — no restart, no capture."""
        with self._swap_lock:
            target = (self.store.latest_version()
                      if version is None else int(version))
            if target == self.version:
                return self.version
            if self._loader is None:  # lazily built on the first swap
                self._loader = self.store.restore(target, device=self.device)
            else:
                self.store.load_into(self._loader, target)
            self.service.hot_swap(self.model, net=self._loader,
                                  version=target)
            self.version = target
            try:
                from ..telemetry.tracing import set_default_baggage  # noqa: PLC0415

                set_default_baggage("checkpoint_version", str(target))
            except Exception:  # noqa: BLE001
                pass
            return target

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                if self.store.latest_version() > self.version:
                    # the swap itself retries under its own policy (a torn
                    # read of an in-flight version resolves in ms)
                    self._swap_policy.run(self.swap_to, stop=self._stop)
                self._watch_policy.record_success()
            except Exception as e:  # noqa: BLE001 - watch must outlive blips
                self._stop.wait(self._watch_policy.record_failure(
                    error=e, key=f"pid-{os.getpid()}"))

    # ------------------------------------------------------------ drain
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, finish queued + in-flight work, deregister."""
        ok = self.service.drain(timeout_s=timeout_s)
        self.service.unregister(self.model)
        self._drained.set()
        return ok

    def shutdown(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()

    # ------------------------------------------------------------- http
    def healthz(self) -> dict:
        entry_stats = {}
        if self.service is not None:
            try:
                entry_stats = self.service.stats()["models"].get(
                    self.model) or {}
            except Exception:  # noqa: BLE001
                entry_stats = {}
        compiles = _captures()
        lat = entry_stats.get("latency_seconds") or {}
        return {
            "ready": self.ready,
            "draining": (self.service.draining
                         if self.service is not None else False),
            "drained": self._drained.is_set(),
            "model": self.model,
            "version": self.version,
            "pid": os.getpid(),
            "port": self.port,
            "uptime_s": round(time.time() - self.started_at, 3),
            "boot_seconds": self.boot_seconds,
            "bundle_installed": self.bundle_installed,
            "warmed_buckets": self.warmed_buckets,
            "compiles_total": compiles,
            "compiles_since_ready": (compiles - self.compiles_at_ready
                                     if self.ready else None),
            "requests_total": self.requests_total,
            "shed_total": self.shed_total,
            "queue_depth": entry_stats.get("queue_depth", 0),
            "p50_s": lat.get("p50"),
            "p99_s": lat.get("p99"),
            # bounded recent-latency samples: the router merges these
            # rings across workers into EXACT fleet-wide percentiles
            "latency_samples": self._latency_samples(),
        }

    def api_worker(self) -> dict:
        """The ``/api/worker`` payload: ``healthz()``, the service's stats,
        this process's kernel launches and, on the card, the served
        graphs' pool bytes and the card's free and total bytes."""
        body = self.healthz()
        body["service"] = self.service.stats()
        body["kernel_launches"] = kernel_launches()
        body["device"] = str(self.device)
        if self.device.type == "cuda":
            import torch  # noqa: PLC0415

            from ..runtime.compile_manager import capture_lock  # noqa: PLC0415
            from ..telemetry.memory import network_pool_bytes  # noqa: PLC0415

            with capture_lock().shared():  # CUDA calls from an HTTP thread
                free, total = torch.cuda.mem_get_info(self.device)
                body["device_memory"] = {
                    "pool_bytes": network_pool_bytes(self.net),
                    "mem_get_info": [int(free), int(total)],
                    "max_memory_allocated": int(
                        torch.cuda.max_memory_allocated(self.device))}
        return body

    def _latency_samples(self, cap: int = 512):
        try:
            entry = self.service._entry(self.model)  # noqa: SLF001
        except Exception:  # noqa: BLE001
            return []
        samples = list(entry.latencies)[-cap:]
        return [round(s, 6) for s in samples]

    def predict_payload(self, payload: dict, trace=None) -> dict:
        features = np.asarray(payload["features"], np.float32)
        argmax = bool(payload.get("argmax", False))
        version = self.version  # pre-dispatch tag; body proves the params
        out = self.service.predict(self.model, features, argmax=argmax,
                                   trace=trace)
        with self._stats_lock:
            self.requests_total += 1
        key = "classes" if argmax else "output"
        return {key: np.asarray(out).tolist(), "version": version}

    def trace_payload(self, trace_id: str) -> dict:
        """This process's view of one trace: matching spans from the local
        ring plus swap flight events (the router splices those into the
        merged trace as instant events)."""
        from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415
        from ..telemetry.tracing import get_trace_ring  # noqa: PLC0415

        spans = get_trace_ring().spans_for(trace_id)
        swap_events = [e for e in get_flight_recorder().events
                       if e.get("kind") in ("serve_swap", "online_swap")]
        return {"trace_id": trace_id, "pid": os.getpid(),
                "port": self.port, "model": self.model,
                "spans": spans, "swap_events": swap_events}

    def _make_handler(self):
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: logs ride /metrics
                pass

            def _send(self, code: int, body: dict,
                      headers: Optional[dict] = None) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    fault = (worker.chaos.fire("worker.healthz")
                             if worker.chaos is not None else None)
                    if fault is not None and fault["fault"] == "hang-worker":
                        # accepted TCP, never answers: the router's health
                        # Deadline must declare us hung and respawn
                        threading.Event().wait(
                            float(fault.get("seconds", 60.0)))
                        return
                    if fault is not None and fault["fault"] == "partial-http":
                        data = json.dumps(worker.healthz()).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data[:max(1, len(data) // 2)])
                        self.wfile.flush()
                        try:
                            self.connection.close()
                        except Exception:  # noqa: BLE001
                            pass
                        return
                    self._send(200, worker.healthz())
                elif self.path == "/api/resilience":
                    from ..runtime.resilience import resilience_stats  # noqa: PLC0415
                    self._send(200, resilience_stats())
                elif self.path == "/metrics":
                    text = worker.service.registry.prometheus_text()
                    data = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/api/worker":
                    self._send(200, worker.api_worker())
                elif self.path.startswith("/api/trace/"):
                    self._send(200, worker.trace_payload(
                        self.path.rsplit("/", 1)[-1]))
                elif self.path == "/api/slo":
                    from ..telemetry.slo import get_slo_monitor  # noqa: PLC0415
                    self._send(200, get_slo_monitor().stats())
                elif self.path.startswith("/api/history"):
                    from urllib.parse import parse_qsl, urlparse  # noqa: PLC0415

                    from ..telemetry.history import get_history_store  # noqa: PLC0415
                    params = dict(parse_qsl(urlparse(self.path).query))
                    try:
                        self._send(200,
                                   get_history_store().http_query(params))
                    except ValueError as e:
                        self._send(400, {"error": str(e)})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                from ..serving import (AdmissionError,  # noqa: PLC0415
                                       ServiceDraining)

                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON body"})
                    return
                if self.path == "/predict":
                    if not worker.ready:
                        self._send(503, {"error": "not ready"})
                        return
                    from ..telemetry.tracing import (  # noqa: PLC0415
                        TRACE_HEADER, TraceContext, trace_span)

                    ctx = TraceContext.from_header(
                        self.headers.get(TRACE_HEADER))
                    try:
                        if ctx is not None and ctx.sampled:
                            with trace_span(ctx, "worker.predict",
                                            model=worker.model,
                                            version=worker.version,
                                            port=worker.port) as sp:
                                body = worker.predict_payload(
                                    payload, trace=sp.ctx)
                        else:
                            body = worker.predict_payload(payload, trace=ctx)
                        self._send(200, body)
                    except ServiceDraining as e:
                        self._send(503, {"error": str(e),
                                         "draining": True})
                    except AdmissionError as e:
                        with worker._stats_lock:  # noqa: SLF001
                            worker.shed_total += 1
                        self._send(429, {"error": str(e),
                                         "reason": e.reason,
                                         "retry_after_s": e.retry_after_s},
                                   {"Retry-After":
                                    f"{e.retry_after_s:.3f}"})
                    except (KeyError, ValueError) as e:
                        self._send(400, {"error": str(e)})
                    except Exception as e:  # noqa: BLE001
                        self._send(500, {"error": str(e)})
                elif self.path == "/swap":
                    try:
                        version = worker.swap_to(payload.get("version"))
                        self._send(200, {"version": version})
                    except Exception as e:  # noqa: BLE001
                        self._send(500, {"error": str(e)})
                elif self.path == "/drain":
                    threading.Thread(target=worker.drain, daemon=True,
                                     name="dl4jtpu-fleet-drain").start()
                    self._send(200, {"draining": True})
                elif self.path == "/history":
                    from ..telemetry.history import get_default_sampler  # noqa: PLC0415

                    enabled = bool(payload.get("enabled", True))
                    sampler = get_default_sampler()
                    if sampler is not None:
                        if enabled:
                            sampler.resume()
                        else:
                            sampler.pause()
                    self._send(200, {"enabled": enabled,
                                     "sampler": sampler is not None})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

        return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.fleet.worker",
        description="fleet serving worker")
    ap.add_argument("--store", required=True,
                    help="CheckpointStore directory (the version bus)")
    ap.add_argument("--model", default="default")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--watch", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="poll the store and hot_swap new versions "
                         "(the router passes --no-watch and coordinates "
                         "rollouts itself)")
    ap.add_argument("--poll-s", type=float, default=0.5)
    ap.add_argument("--max-delay-ms", type=float, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--latency-budget-ms", type=float, default=None)
    ap.add_argument("--no-bundle", action="store_true",
                    help="skip warm-boot bundle install (cold boot)")
    ap.add_argument("--device", default="cuda",
                    help="where the model serves (default: cuda)")
    args = ap.parse_args(argv)

    worker = FleetWorker(
        args.store, model=args.model, port=args.port, watch=args.watch,
        poll_s=args.poll_s, max_delay_ms=args.max_delay_ms,
        max_batch=args.max_batch, max_queue_depth=args.max_queue,
        latency_budget_ms=args.latency_budget_ms,
        use_bundle=not args.no_bundle, device=args.device)
    if os.environ.get("DL4JTPU_CHAOS_PLAN"):
        from ..testing.chaos import FaultPlan  # noqa: PLC0415
        worker.chaos = FaultPlan.from_env()
    worker.boot()

    done = threading.Event()

    def _term(signum, frame):
        threading.Thread(target=lambda: (worker.drain(), done.set()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    print(f"{READY_SENTINEL} port={worker.port} version={worker.version} "
          f"pid={os.getpid()}", flush=True)
    done.wait()
    worker.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
