"""The port's serving fleet (``fleet/``: bundles, the worker, the router;
``utils/subproc.py``; ``GET /api/fleet``; ``FleetRecordingRules``) against
the JAX package's (the cases of ``tests/test_fleet.py`` where the port has
the surface).

Bundles round-trip, and a bundle written by JAX's ``build_bundle`` for the
same conf loads and installs in the port (its ``xla_cache_dir`` and
``kernel`` blocks ignored). An in-process ``FleetWorker`` on the CPU answers
``/predict`` over HTTP as ``net.output`` does, bit for bit (the JSON floats
round-trip f32 exactly), with zero captures since ready. The router's hung
detection, staggered backoff (equal to JAX's router's, wait for wait) and
the worker's corrupt-latest boot run as in JAX. One real two-worker fleet
runs on the CPU in this tier (workers spawned with ``forced_cpu_env``'s one
thread): a lone probe bit for bit, and during a rollout every answer within
``ROLL_ATOL`` of one version's (the JAX file asks for bits; concurrent
probes coalesce into 2-row buckets, whose CPU products round otherwise in
the last bit). The JAX file's other subprocess cases keep its ``slow``
mark.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.fleet import FleetRouter as JFleetRouter  # noqa: E402
from deeplearning4j_tpu.fleet import build_bundle as jbuild_bundle  # noqa: E402
from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402
from deeplearning4j_tpu.telemetry import history as jhistory  # noqa: E402
from deeplearning4j_tpu.tune import store as jstore  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.fleet import (FleetRouter, FleetWorker, build_bundle,  # noqa: E402
                                            bundle_filename, get_fleet_routers,
                                            install_bundle, load_bundle, save_bundle)
from deeplearning4j_tpu_torch.fleet.worker import READY_SENTINEL  # noqa: E402
from deeplearning4j_tpu_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from deeplearning4j_tpu_torch.serving import (AdmissionError, InferenceService,  # noqa: E402
                                              MicroBatcher, ServiceDraining,
                                              get_service, reset_services,
                                              service_names, set_service)
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import history as phistory  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import tracing as ptracing  # noqa: E402
from deeplearning4j_tpu_torch.tune import store as tuned_store  # noqa: E402
from deeplearning4j_tpu_torch.tune.knobs import get_knob, scoped_env  # noqa: E402
from deeplearning4j_tpu_torch.utils.subproc import forced_cpu_env, free_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROLL_ATOL = 1e-6  # f32 softmax outputs of one version, batched in other row counts


def _conf(pkg, n_in=8, n_out=4, seed=7):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=16, activation="relu"),
                pkg.OutputLayer(n_out=n_out, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(n_in),
        updater=pkg.UpdaterConfig(updater="sgd", learning_rate=1e-2), seed=seed)


def _toy_net(n_in=8, n_out=4, seed=7):
    return pt.MultiLayerNetwork(_conf(pt, n_in, n_out, seed), device="cpu").init()


def _get(url, timeout=15):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _seed_store(tmp_path, versions=1, **bundle_kw):
    """Store + bundle + the net used to build them."""
    net = _toy_net()
    store = CheckpointStore(str(tmp_path / "store"))
    for _ in range(versions):
        store.save(net)
    save_bundle(store, build_bundle(
        net, example=np.zeros((1, 8), np.float32), argmax=True, max_batch=8,
        **bundle_kw))
    return store, net


def _stop_worker(worker):
    worker.shutdown()
    if worker.service is not None:
        worker.service.stop()
    set_service(None, f"fleet-worker:{worker.model}")


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4JTPU_HISTORY", "0")
    monkeypatch.setenv("DL4JTPU_TUNED_PATH", str(tmp_path / "TUNED.json"))
    for name in ("DL4JTPU_SERVE_MAX_DELAY_MS", "DL4JTPU_SERVE_MAX_BATCH",
                 "DL4JTPU_SERVE_MAX_QUEUE", "DL4JTPU_SERVE_LATENCY_BUDGET_MS",
                 "DL4JTPU_INFER", "DL4JTPU_CHAOS_PLAN"):
        monkeypatch.delenv(name, raising=False)
    before = ptracing._default_baggage()
    yield
    # an in-process worker stamps the process-level baggage every new trace
    # context carries (model, checkpoint version); later tests in this
    # process must not see it
    for key in ptracing._default_baggage():
        ptracing.set_default_baggage(key, before.get(key))


# ---------------------------------------------------------------------------
# warm-boot bundle
# ---------------------------------------------------------------------------
class TestWarmBootBundle:
    def test_roundtrip_and_schema(self, tmp_path):
        net = _toy_net()
        store = CheckpointStore(str(tmp_path / "store"))
        store.save(net)
        bundle = build_bundle(net, example=np.zeros((1, 8), np.float32),
                              argmax=True, max_batch=8)
        assert bundle["bundle_version"] == 1
        assert bundle["warmup"] == {"buckets": [1, 2, 4, 8], "max_batch": 8,
                                    "example_shape": [8], "example_dtype": "float32",
                                    "argmax": True}
        assert (bundle["signature"], bundle["backend"], bundle["topology"]) == (
            tuned_store.model_signature(net), "cpu", "d1")
        assert "xla_cache_dir" not in bundle and "kernel" not in bundle
        path = save_bundle(store, bundle)
        assert os.path.basename(path) == bundle_filename(
            bundle["signature"], bundle["backend"], bundle["topology"])
        assert store.latest_version() == 1  # sidecar is invisible to the version scan
        assert load_bundle(store) == bundle
        assert load_bundle(store, net) == bundle
        assert load_bundle(store, signature="nope") is None

    def test_example_derived_from_the_conf(self, tmp_path):
        bundle = build_bundle(_toy_net(n_in=12), max_batch=4)
        assert bundle["warmup"]["example_shape"] == [12]
        assert bundle["warmup"]["example_dtype"] == "float32"
        rnn = pt.MultiLayerNetwork(pt.char_rnn(11, 8, 1), device="cpu")
        with pytest.raises(ValueError, match="example="):
            build_bundle(rnn)
        spec = build_bundle(rnn, example=np.zeros((1, 64, 11), np.float32),
                            time_lengths=(50, 64), max_batch=8)["warmup"]
        assert spec["example_shape"] == [64, 11] and spec["time_lengths"] == [50, 64]
        with pytest.raises(ValueError, match="recurrent"):
            build_bundle(_toy_net(), time_lengths=(3,))

    def test_install_applies_tuned(self, tmp_path):
        net = _toy_net()
        with scoped_env(DL4JTPU_TUNED_PATH=str(tmp_path / "src-TUNED.json")):
            key = tuned_store.key_for(net)
            tuned_store.TunedStore().put(
                key, {"serve_max_batch": 16, "serve_max_queue_depth": 32},
                objective="serve")
            bundle = build_bundle(net, example=np.zeros((1, 8), np.float32))
        assert bundle["tuned"]["key"] == key
        assert bundle["tuned"]["entry"]["config"]["serve_max_batch"] == 16
        with scoped_env(DL4JTPU_TUNED_PATH=str(tmp_path / "dst-TUNED.json")):
            report = install_bundle(bundle)
            assert report["tuned"] is True
            assert report["warmup"] == bundle["warmup"]
            entry = tuned_store.TunedStore().get(key)
            assert entry["config"]["serve_max_queue_depth"] == 32

    def test_stale_bundle_tolerated(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "store"))
        report = install_bundle({
            "bundle_version": 1,
            "tuned": {"key": "k", "entry": {"config": {"no_such_knob": 1}}},
            "warmup": {"buckets": [1]}})
        assert report["tuned"] is False
        with open(store.artifact_path("warmboot-x.cpu.d1.json"), "w") as f:
            json.dump({"bundle_version": 99, "signature": "x"}, f)
        assert load_bundle(store) is None

    def test_jax_written_bundle_loads(self, tmp_path):
        """JAX's ``build_bundle`` of the same conf: the port finds it by the
        signature, installs its tuned slice and warms from its spec; the
        ``xla_cache_dir`` and ``kernel`` blocks are ignored."""
        jnet = dj.MultiLayerNetwork(_conf(dj)).init()
        net = _toy_net()
        with scoped_env(DL4JTPU_TUNED_PATH=str(tmp_path / "jax-TUNED.json")):
            jstore.TunedStore().put(jstore.key_for(jnet), {"serve_max_batch": 4},
                                    objective="serve")
            jbundle = jbuild_bundle(jnet, example=np.zeros((1, 8), np.float32),
                                    argmax=True, max_batch=4)
        assert "kernel" in jbundle and "xla_cache_dir" in jbundle
        store = CheckpointStore(str(tmp_path / "store"))
        store.save(net)
        with open(store.artifact_path(bundle_filename(
                jbundle["signature"], jbundle["backend"], jbundle["topology"])), "w") as f:
            json.dump(jbundle, f)
        assert jbundle["signature"] == tuned_store.model_signature(net)
        assert load_bundle(store, net) == jbundle
        report = install_bundle(jbundle)
        assert report == {"tuned": True, "warmup": jbundle["warmup"]}
        worker = FleetWorker(str(tmp_path / "store"), max_delay_ms=0, device="cpu")
        try:
            worker.boot()
            assert worker.bundle_installed and worker.warmed_buckets == 3  # 1, 2, 4
            assert worker.healthz()["compiles_since_ready"] == 0
        finally:
            _stop_worker(worker)


# ---------------------------------------------------------------------------
# named service registry, admission, drain
# ---------------------------------------------------------------------------
class TestServiceRegistry:
    def test_named_services_are_isolated(self):
        reset_services()
        try:
            default, edge = get_service(), get_service("edge")
            assert default is not edge and get_service() is default
            assert service_names() == ["default", "edge"]
            edge.register("m", _toy_net())
            assert edge.models() == ["m"] and default.models() == []
        finally:
            reset_services()

    def test_set_and_reset(self):
        reset_services()
        try:
            svc = InferenceService(max_delay_ms=0.0)
            set_service(svc, "mine")
            assert get_service("mine") is svc
            set_service(None, "mine")
            assert get_service("mine") is not svc
            before = get_service()
            reset_services()
            assert service_names() == [] and get_service() is not before
        finally:
            reset_services()


class TestAdmission:
    def test_per_model_batcher_knobs_override_service(self):
        svc = InferenceService(max_delay_ms=5.0, max_batch=64)
        try:
            svc.register("a", _toy_net())
            svc.register("b", _toy_net(seed=8), max_delay_ms=0.0, max_batch=8)
            stats = svc.stats()["models"]
            assert stats["a"]["batcher"]["max_batch"] == 64
            assert stats["b"]["batcher"]["max_batch"] == 8
            assert stats["b"]["batcher"]["max_delay_ms"] == 0.0
        finally:
            svc.stop()

    def test_queue_depth_shed(self):
        svc = InferenceService(max_delay_ms=0.0)
        try:
            svc.register("m", _toy_net(), max_queue_depth=1)
            entry = svc._entry("m")
            entry.batcher.queue_depth = lambda: 5  # looks saturated, no race
            with pytest.raises(AdmissionError) as ei:
                svc.predict("m", np.zeros((1, 8), np.float32))
            assert ei.value.reason == "queue_depth" and ei.value.retry_after_s >= 0.05
            assert svc.stats()["models"]["m"]["admission"]["shed_total"] == 1
        finally:
            svc.stop()

    def test_latency_budget_shed(self):
        svc = InferenceService(max_delay_ms=0.0)
        try:
            svc.register("m", _toy_net(), latency_budget_ms=10.0)
            svc._entry("m").latencies.extend([0.5] * 64)  # p99 far over 10ms
            with pytest.raises(AdmissionError) as ei:
                svc.predict("m", np.zeros((1, 8), np.float32))
            assert ei.value.reason == "latency_budget"
        finally:
            svc.stop()

    def test_env_default_applies_when_no_per_model_arg(self):
        with scoped_env(DL4JTPU_SERVE_MAX_QUEUE="7", DL4JTPU_SERVE_LATENCY_BUDGET_MS="125"):
            svc = InferenceService(max_delay_ms=0.0)
            try:
                svc.register("m", _toy_net())
                adm = svc.stats()["models"]["m"]["admission"]
                assert (adm["max_queue_depth"], adm["latency_budget_ms"]) == (7, 125.0)
            finally:
                svc.stop()

    def test_zero_disables(self):
        svc = InferenceService(max_delay_ms=0.0)
        try:
            svc.register("m", _toy_net(), max_queue_depth=0, latency_budget_ms=0.0)
            adm = svc.stats()["models"]["m"]["admission"]
            assert adm["max_queue_depth"] is None and adm["latency_budget_ms"] is None
        finally:
            svc.stop()

    def test_knob_registry_contexts(self):
        for name in ("serve_max_queue_depth", "serve_latency_budget_ms"):
            assert get_knob(name).contexts == ("serve",)


class TestDrain:
    def test_batcher_drain_waits_for_in_flight(self):
        release, dispatched = threading.Event(), threading.Event()

        def slow_dispatch(feats):
            dispatched.set()
            release.wait(5)
            return feats

        b = MicroBatcher(slow_dispatch, max_delay_ms=0.0, max_batch=4)
        try:
            fut = b.submit(np.zeros((1, 2), np.float32))
            assert dispatched.wait(5)
            assert b.in_flight() == 1
            assert b.drain(timeout_s=0.2) is False  # still in flight
            release.set()
            assert b.drain(timeout_s=5.0) is True
            assert fut.result(timeout=5) is not None
        finally:
            b.stop()

    def test_service_drain_completes_in_flight_then_refuses(self):
        svc = InferenceService(max_delay_ms=200.0, max_batch=64)
        try:
            svc.register("m", _toy_net())
            results = []
            threads = [threading.Thread(target=lambda: results.append(
                svc.predict("m", np.random.rand(1, 8).astype(np.float32))))
                for _ in range(4)]
            for t in threads:
                t.start()
            entry = svc._entry("m")
            deadline = time.monotonic() + 5
            while entry.batcher.pending() < 4 and time.monotonic() < deadline:
                time.sleep(0.002)
            assert entry.batcher.pending() == 4
            assert svc.drain(timeout_s=10.0) is True
            for t in threads:
                t.join(timeout=10)
            assert len(results) == 4
            with pytest.raises(ServiceDraining):
                svc.predict("m", np.zeros((1, 8), np.float32))
        finally:
            svc.stop()


# ---------------------------------------------------------------------------
# the port's child-interpreter recipe
# ---------------------------------------------------------------------------
class TestForcedCpuEnv:
    def test_recipe(self):
        base = {"CUDA_VISIBLE_DEVICES": "0", "OMP_NUM_THREADS": "8", "KEEP": "me",
                "XLA_FLAGS": "--foo=1"}
        env = forced_cpu_env(2, base=base)
        assert env["CUDA_VISIBLE_DEVICES"] == ""
        assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == "2"
        assert env["KEEP"] == "me" and env["XLA_FLAGS"] == "--foo=1"  # JAX's recipe not applied
        assert "JAX_PLATFORMS" not in env
        assert base["CUDA_VISIBLE_DEVICES"] == "0"  # input not mutated

    def test_child_sees_no_card_and_one_thread(self):
        port = free_port()
        assert 0 < port < 65536
        code = ("import torch; print(torch.cuda.is_available(), torch.get_num_threads())")
        out = subprocess.run([sys.executable, "-c", code], env=forced_cpu_env(1),
                             capture_output=True, text=True, timeout=120)
        assert out.stdout.split() == ["False", "1"], out.stderr


class TestStoreBus:
    def test_latest_version_and_artifact_path(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        assert store.latest_version() == 0
        store.save(_toy_net())
        assert store.latest_version() == 1
        sidecar = store.artifact_path("warmboot-a.cpu.d1.json")
        assert os.path.dirname(sidecar) == str(tmp_path)
        with pytest.raises(ValueError):
            store.artifact_path("model-v00000002.zip")

    def test_wait_for_version(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        assert store.wait_for_version(1, timeout_s=0.2, poll_s=0.05) is None
        net = _toy_net()
        t = threading.Thread(target=lambda: (time.sleep(0.2), store.save(net)))
        t.start()
        info = store.wait_for_version(1, timeout_s=10.0, poll_s=0.05)
        t.join(timeout=10)
        assert info is not None and info.version == 1


class TestUiEndpoint:
    def test_api_fleet_lists_registered_routers(self, tmp_path):
        from deeplearning4j_tpu_torch.fleet import router as prouter
        from deeplearning4j_tpu_torch.ui.server import UIServer

        assert get_fleet_routers() == []
        ui = UIServer(port=0)
        router = FleetRouter(str(tmp_path), workers=1, device="cpu",
                             registry=MetricsRegistry())
        try:
            assert _get(f"http://127.0.0.1:{ui.port}/api/fleet") == {"routers": []}
            prouter._register_router(router)
            d = _get(f"http://127.0.0.1:{ui.port}/api/fleet")
            assert [r["store"] for r in d["routers"]] == [str(tmp_path)]
            assert d["routers"][0]["workers"][0]["ready"] is False
        finally:
            prouter._unregister_router(router)
            ui.stop()


class TestRecordingRules:
    def test_sensors_and_forecasts_as_jax(self):
        stats = {"model": "m", "requests_total": 0, "shed_total": 0,
                 "latency_seconds": {"p50": 0.01, "p99": 0.05},
                 "workers": [{"id": 0, "ready": True, "queue_depth": 2,
                              "boot_seconds": 3.5, "compiles_since_ready": 0},
                             {"id": 1, "ready": False, "queue_depth": 9}]}
        out = []
        for hist, reg in ((phistory, MetricsRegistry()), (jhistory, JRegistry())):
            rules = hist.FleetRecordingRules(store=hist.HistoryStore(), registry=reg)
            seen = [rules.observe_fleet(stats, now=100.0),
                    rules.observe_fleet(dict(stats, requests_total=50, shed_total=5),
                                        now=110.0)]
            out.append((seen, rules.forecast_table(),
                        sorted(rules.store.series_names())))
        assert out[0] == out[1]
        assert phistory.RECORDING_RULES == jhistory.RECORDING_RULES
        assert out[0][0][1]["offered_load"] == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# the worker in process, and the router's supervision
# ---------------------------------------------------------------------------
class TestInProcessWorker:
    def test_predict_over_http_is_net_output(self, tmp_path):
        store, net = _seed_store(tmp_path)
        rng = np.random.default_rng(5)
        # the references first: this process's net captures too
        xs = [rng.normal(size=(rows, 8)).astype(np.float32) for rows in (1, 3, 8)]
        refs = [(net.output(x), net.predict(x)) for x in xs]
        worker = FleetWorker(str(tmp_path / "store"), max_delay_ms=0, max_batch=8,
                             device="cpu")
        pt.ops.reset_counters()  # the launch counters are the process's
        try:
            worker.boot()
            base = f"http://127.0.0.1:{worker.port}"
            health = _get(base + "/healthz")
            assert health["ready"] and health["bundle_installed"]
            assert health["warmed_buckets"] == 4  # 1, 2, 4, 8
            for x, (out, cls) in zip(xs, refs):
                got = _post(base + "/predict", {"features": x.tolist()})
                assert got["version"] == 1
                np.testing.assert_array_equal(np.asarray(got["output"], np.float32), out)
                got = _post(base + "/predict", {"features": x.tolist(), "argmax": True})
                np.testing.assert_array_equal(got["classes"], cls)
            api = _get(base + "/api/worker")
            assert api["compiles_since_ready"] == 0 and api["device"] == "cpu"
            assert api["kernel_launches"] == {"wrapper": {}, "replayed": {}}
            assert "# TYPE dl4jtpu_serve_requests_total" in urllib.request.urlopen(
                base + "/metrics", timeout=15).read().decode()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/predict", {"nope": 1})
            assert ei.value.code == 400
        finally:
            _stop_worker(worker)

    def test_default_device_without_cuda_raises(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default device is valid here")
        with pytest.raises(RuntimeError):
            FleetWorker(str(tmp_path))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FleetRouter(str(tmp_path))


class TestHungWorkerDetection:
    def test_frozen_healthz_is_hung_not_crash(self, tmp_path):
        import socket

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.listen(8)  # handshake completes in-kernel; nothing ever reads
        dummy = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        router = FleetRouter(str(tmp_path), workers=1, respawn=False, device="cpu",
                             health_timeout_s=0.5, registry=MetricsRegistry())
        handle = router.workers[0]
        handle.proc, handle.port = dummy, sock.getsockname()[1]
        handle.alive = handle.ready = True
        try:
            router._check_worker(handle)
            assert handle.down_reason == "hung", handle.down_reason
            assert not handle.ready
            assert dummy.wait(timeout=10) is not None  # reaped, port freed
            assert router.health_deadline.stats()["expired_total"] >= 1
        finally:
            if dummy.poll() is None:
                dummy.kill()
                dummy.wait(timeout=10)
            sock.close()


    def test_garbled_healthz_is_unhealthy_and_reaped(self, tmp_path):
        """A ``partial-http`` healthz (half its body) marks the worker down
        as "unhealthy", and its live process is reaped so that it can be
        respawned (left alive and down, it never would be)."""
        from deeplearning4j_tpu_torch.testing.chaos import FaultPlan

        _seed_store(tmp_path)
        worker = FleetWorker(str(tmp_path / "store"), max_delay_ms=0, device="cpu")
        worker.chaos = FaultPlan(3, [{"site": "worker.healthz", "fault": "partial-http",
                                      "at": [1]}])
        dummy = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        router = FleetRouter(str(tmp_path / "store"), workers=1, respawn=False,
                             device="cpu", registry=MetricsRegistry())
        try:
            worker.boot()
            handle = router.workers[0]
            handle.proc, handle.port = dummy, worker.port
            handle.alive = handle.ready = True
            router._check_worker(handle)
            assert handle.down_reason == "unhealthy" and not handle.ready
            assert dummy.wait(timeout=10) is not None
            assert [f["fault"] for f in worker.chaos.fired] == ["partial-http"]
        finally:
            if dummy.poll() is None:
                dummy.kill()
                dummy.wait(timeout=10)
            _stop_worker(worker)


class TestRespawnBackoffStagger:
    def test_simultaneous_deaths_backoff_staggered_as_jax(self, tmp_path):
        kw = dict(workers=3, respawn=False, backoff_base_s=0.5, backoff_cap_s=10.0)
        waits = []
        for make in (lambda: FleetRouter(str(tmp_path), device="cpu",
                                         registry=MetricsRegistry(), **kw),
                     lambda: FleetRouter(str(tmp_path), device="cpu",
                                         registry=MetricsRegistry(), **kw),
                     lambda: JFleetRouter(str(tmp_path), registry=JRegistry(), **kw)):
            router = make()
            for handle in router.workers:
                router._backoff(handle)
            waits.append([h.backoff_s for h in router.workers])
        assert len(set(waits[0])) == 3, waits[0]
        assert all(0.5 <= w <= 0.75 for w in waits[0]), waits[0]
        assert waits[0] == waits[1] == waits[2]  # deterministic, and JAX's


class TestWorkerBootIntegrity:
    def test_boot_quarantines_corrupt_latest_serves_previous(self, tmp_path):
        from deeplearning4j_tpu_torch.testing.chaos import truncate_file

        store, net = _seed_store(tmp_path, versions=2)
        truncate_file(store.path(2), keep_frac=0.4)
        worker = FleetWorker(str(tmp_path / "store"), max_delay_ms=0, max_batch=8,
                             use_bundle=False, device="cpu")
        try:
            worker.boot()
            assert worker.ready and worker.version == 1
            assert os.path.exists(store.path(2) + ".quarantine")
            out = worker.predict_payload(
                {"features": np.zeros((2, 8), np.float32).tolist()})
            assert len(out["output"]) == 2
            assert store.save(net).version == 3
            assert worker.swap_to() == 3 and worker.version == 3
        finally:
            _stop_worker(worker)


# ---------------------------------------------------------------------------
# one real two-worker fleet on the CPU
# ---------------------------------------------------------------------------
def test_two_worker_fleet_rolls_out_without_torn_answers(tmp_path):
    """Two worker processes (``forced_cpu_env``: no card, one thread) behind
    a router: every worker boots warm (zero captures since ready), a probe
    answers as ``net.output``, a published version 2 rolls across the fleet
    under client traffic with every answer version 1's or version 2's, a
    killed worker is respawned warm, and the fleet drains."""
    store, net = _seed_store(tmp_path)
    router = FleetRouter(str(tmp_path / "store"), workers=2, poll_s=0.1, device="cpu",
                         worker_args={"max_delay_ms": 0, "max_batch": 8},
                         backoff_base_s=0.05, registry=MetricsRegistry()).start()
    try:
        base = f"http://127.0.0.1:{router.port}"
        assert [h.ready for h in router.workers] == [True, True]
        probe = np.linspace(-1, 1, 8, dtype=np.float32).reshape(1, 8)
        ref1 = np.asarray(_post(base + "/predict", {"features": probe.tolist()})["output"],
                          np.float32)
        np.testing.assert_array_equal(ref1, net.output(probe))
        sampled, errors, stop = [], [], threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    sampled.append(np.asarray(_post(
                        base + "/predict", {"features": probe.tolist()})["output"],
                        np.float32))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        loader = store.restore(1, device="cpu")
        with torch.no_grad():
            for leaf in loader._leaves():
                for p in leaf.values():
                    p.mul_(0.5)
        store.save(loader)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            stats = router.stats()
            if stats["rollouts"] >= 1 and all(w["version"] == 2 for w in stats["workers"]):
                break
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        ref2 = np.asarray(_post(base + "/predict", {"features": probe.tolist()})["output"],
                          np.float32)
        np.testing.assert_array_equal(ref2, loader.output(probe))
        # concurrent probes coalesce into 2-row buckets, whose CPU products
        # round differently in the last bit: an answer is a version's within
        # ROLL_ATOL, and the versions are far apart
        assert np.abs(ref1 - ref2).max() > 1e3 * ROLL_ATOL
        torn = [s for s in sampled if min(np.abs(s - ref1).max(),
                                          np.abs(s - ref2).max()) > ROLL_ATOL]
        assert sampled and not torn, (len(torn), len(sampled))
        time.sleep(0.3)  # one health poll after the last request
        assert all(w["compiles_since_ready"] == 0 and w["bundle_installed"]
                   for w in router.stats()["workers"])
        # kill one worker: it comes back warm, at the served version
        os.kill(router.workers[0].proc.pid, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            snap = router.stats()["workers"][0]
            if snap["ready"] and snap["respawns"] >= 1 and snap["compiles_since_ready"] == 0:
                break
            time.sleep(0.1)
        assert snap["ready"] and snap["respawns"] >= 1 and snap["version"] == 2, snap
        assert snap["compiles_since_ready"] == 0
        assert router.drain(timeout_s=30) is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", {"features": probe.tolist()})
        assert ei.value.code == 503
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# subprocess integration kept slow, as in the JAX file
# ---------------------------------------------------------------------------
@pytest.mark.slow
class TestFleetSubprocess:
    def test_warm_boot_zero_compiles(self, tmp_path):
        _seed_store(tmp_path)
        env = forced_cpu_env(1)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.fleet.worker",
             "--store", str(tmp_path / "store"), "--max-delay-ms", "0",
             "--max-batch", "8", "--device", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            assert line.startswith(READY_SENTINEL), (line, proc.stderr.read())
            port = int(dict(kv.split("=") for kv in line.split()[1:])["port"])
            base = f"http://127.0.0.1:{port}"
            assert len(_post(base + "/predict",
                             {"features": np.random.rand(3, 8).tolist()})["output"]) == 3
            health = _get(base + "/healthz")
            assert health["bundle_installed"] is True and health["warmed_buckets"] == 4
            assert health["compiles_since_ready"] == 0, health
        finally:
            proc.terminate()
            proc.wait(timeout=15)

    def test_kill_respawn_and_shed(self, tmp_path):
        _seed_store(tmp_path)
        router = FleetRouter(str(tmp_path / "store"), workers=2, poll_s=0.2,
                             shed_outstanding=4, device="cpu",
                             worker_args={"max_delay_ms": 0, "max_batch": 8,
                                          "max_queue_depth": 2}).start()
        try:
            base = f"http://127.0.0.1:{router.port}"
            os.kill(router.workers[0].proc.pid, signal.SIGKILL)
            codes, lock = [], threading.Lock()

            def client():
                try:
                    _post(base + "/predict", {"features": np.random.rand(8, 8).tolist()})
                    code = 200
                except urllib.error.HTTPError as e:
                    code = e.code
                    if e.code == 429:
                        assert e.headers.get("Retry-After") is not None
                except Exception:  # noqa: BLE001 - transient failover window
                    code = -1
                with lock:
                    codes.append(code)

            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and 429 not in codes:
                threads = [threading.Thread(target=client) for _ in range(16)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
            assert 200 in codes and 429 in codes, sorted(set(codes))
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                snap = router.stats()["workers"][0]
                if snap["ready"] and snap["respawns"] >= 1:
                    break
                time.sleep(0.2)
            assert snap["ready"] and snap["respawns"] >= 1, snap
        finally:
            router.stop()

    def test_drain_completes_in_flight(self, tmp_path):
        _seed_store(tmp_path)
        router = FleetRouter(str(tmp_path / "store"), workers=2, poll_s=0.2,
                             device="cpu", worker_args={"max_delay_ms": 0,
                                                        "max_batch": 8}).start()
        try:
            base = f"http://127.0.0.1:{router.port}"
            results, errors = [], []

            def client():
                try:
                    results.append(_post(base + "/predict",
                                         {"features": np.random.rand(2, 8).tolist()}))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=client) for _ in range(6)]
            for t in threads:
                t.start()
            time.sleep(0.05)
            assert router.drain(timeout_s=30) is True
            for t in threads:
                t.join(timeout=60)
            assert len(results) + len(errors) == 6 and not errors, errors[:3]
        finally:
            router.stop()

    def test_fleet_chaos_soak(self):
        """``scripts/torch_chaos_soak.py --fleet``: corrupt-latest cold boot,
        hang-worker, partial-http and kill-worker over the port's router."""
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        try:
            import torch_chaos_soak
        finally:
            sys.path.pop(0)
        summary = torch_chaos_soak.run_fleet_soak(device="cpu", deadline_s=60.0)
        assert summary["respawns"] == {"hung": 1, "unhealthy": 1, "crash": 1}
        assert all(w["compiles_since_ready"] == 0 for w in summary["workers"])
