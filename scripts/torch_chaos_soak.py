#!/usr/bin/env python
"""Chaos soak for the PyTorch port's online-learning loop (the port's
counterpart of ``scripts/chaos_soak.py``, with the same ``run_soak`` summary
keys; it imports no JAX).

Runs a :class:`~deeplearning4j_tpu_torch.runtime.online.OnlineTrainer` against a
deliberately hostile stream and asserts the PRODUCTION outcome, not the
happy path: the trainer must end ALIVE, having rolled back to the last good
checkpoint, replayed the poisoned span through a validation-only pass, and
left a flight-recorder bundle — not a stack trace — as the artifact, while
steady-state ingest makes zero new captures (step graphs and served graphs).

All chaos is driven by a seeded
:class:`~deeplearning4j_tpu_torch.testing.chaos.FaultPlan` — the same seed always
yields the same fault sequence (``plan.fired``), so a failing soak can be
replayed exactly:

- **Ragged shapes** — sequence records with lengths drawn from a pool (pow2
  time buckets absorb them) and ragged trailing micro-batches.
- **Source disconnect/reconnect** — a ``source-error`` fault every N polls
  raises ``ConnectionError`` for an outage window; the trainer must back
  off through its retry policy and resume.
- **NaN bursts** — ``nan-burst`` faults at scheduled record indices poison
  features with NaN; the watchdog must pause, roll back, replay the
  poisoned span, dump, resume.
- **Slow consumers** — serving clients that hold the swapped model while
  dripping requests, while checkpoints keep hot-swapping under them.

The stream is wrapped ``ReplayBufferSource(ChaosSource(queue, plan))`` so
the replayed span *includes* the injected NaNs and the validation pass can
actually see the poison.

``--fleet`` runs the fleet scenarios instead (``run_fleet_soak``): two
worker processes behind the port's ``FleetRouter`` over a store whose
newest version the plan corrupts as it lands, so both cold-boot the
previous good version with zero captures; a ``hang-worker`` fault freezes
one worker's ``/healthz`` (detected by the health deadline, respawned with
reason ``hung``), a ``partial-http`` fault sends half a ``/healthz`` body
(reason ``unhealthy``), and a ``kill-worker`` fault, which the soak
delivers as SIGKILL (reason ``crash``); every respawned worker comes back
warm and the fleet answers and drains.

Usage (tests and ``chip_smoke.py`` use the in-process entries)::

    python scripts/torch_chaos_soak.py [--device cpu] [--records 4096]
        [--batch 32] [--stage 4] [--nan-bursts 3] [--no-outages]
        [--seq] [--deadline 300] [--seed 0] [--fleet]

It runs on the card unless ``--device cpu`` is passed.

Exit 0 and a one-line JSON summary on success; exit 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_DIR not in sys.path:
    sys.path.insert(0, REPO_DIR)


def build_plan(records: int, batch: int, warm: int, nan_bursts: int,
               outages: bool, seed: int):
    """The soak's deterministic fault schedule (also used by tests)."""
    from deeplearning4j_tpu_torch.testing.chaos import FaultPlan

    faults = []
    if nan_bursts:
        # Burst start indices over the steady-state stream, offset past the
        # warm phase; each burst poisons two batches' worth of records.
        at = [int(warm + f * records) for f in
              np.linspace(0.2, 0.9, max(nan_bursts, 1))]
        faults.append({"site": "source.record", "fault": "nan-burst",
                       "at": at, "params": {"records": 2 * batch}})
    if outages:
        faults.append({"site": "source.poll", "fault": "source-error",
                       "every": 300, "params": {"polls": 4}})
    return FaultPlan(seed, faults)


def run_soak(records: int = 4096, batch: int = 32, stage: int = 4,
             feature_dim: int = 16, classes: int = 4, hidden: int = 32,
             nan_bursts: int = 3, outages: bool = True, seq: bool = False,
             slow_consumers: int = 2, deadline_s: float = 300.0,
             flight_dir: str | None = None, seed: int = 0,
             device="cuda") -> dict:
    """The in-process soak, on ``device`` (the card unless ``"cpu"``).
    Returns the summary dict; raises AssertionError when the contract is
    violated."""
    from deeplearning4j_tpu_torch.telemetry.flight_recorder import (
        FlightRecorder, set_flight_recorder)

    if flight_dir is None:
        flight_dir = tempfile.mkdtemp(prefix="dl4jtpu_soak_flight_")
    # a private recorder with no rate limit between DIFFERENT reasons and a
    # dedicated dump dir — the bundle path is the soak's artifact
    recorder = FlightRecorder(dump_dir=flight_dir)
    set_flight_recorder(recorder)
    try:
        return _run_soak_inner(
            records, batch, stage, feature_dim, classes, hidden, nan_bursts,
            outages, seq, slow_consumers, deadline_s, flight_dir, seed, device)
    finally:
        set_flight_recorder(None)


def _run_soak_inner(records, batch, stage, feature_dim, classes, hidden,
                    nan_bursts, outages, seq, slow_consumers, deadline_s,
                    flight_dir, seed, device) -> dict:
    from deeplearning4j_tpu_torch import (DenseLayer, GravesLSTM, InputType,
                                          MultiLayerConfiguration,
                                          MultiLayerNetwork, OutputLayer,
                                          RnnOutputLayer, UpdaterConfig)
    from deeplearning4j_tpu_torch.runtime.checkpoint import CheckpointStore
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager
    from deeplearning4j_tpu_torch.runtime.online import OnlineTrainer
    from deeplearning4j_tpu_torch.runtime.resilience import Deadline
    from deeplearning4j_tpu_torch.serving import InferenceService
    from deeplearning4j_tpu_torch.streaming import QueueSource, ReplayBufferSource
    from deeplearning4j_tpu_torch.testing.chaos import ChaosSource
    from deeplearning4j_tpu_torch.telemetry.flight_recorder import (
        get_flight_recorder)

    rng = np.random.default_rng(seed)
    if seq:
        conf = MultiLayerConfiguration(
            layers=[GravesLSTM(n_out=hidden),
                    RnnOutputLayer(n_out=classes, activation="softmax",
                                   loss="mcxent")],
            input_type=InputType.recurrent(feature_dim),
            updater=UpdaterConfig(updater="adam", learning_rate=1e-2),
            seed=seed)
        lengths = (5, 7, 8, 11, 13, 16)  # → pow2 buckets 8 and 16

        def make_record():
            t = int(rng.choice(lengths))
            x = rng.normal(size=(t, feature_dim)).astype(np.float32)
            y = np.eye(classes, dtype=np.float32)[
                rng.integers(0, classes, t)]
            return x, y
    else:
        conf = MultiLayerConfiguration(
            layers=[DenseLayer(n_out=hidden, activation="tanh"),
                    OutputLayer(n_out=classes, activation="softmax",
                                loss="mcxent")],
            input_type=InputType.feed_forward(feature_dim),
            updater=UpdaterConfig(updater="adam", learning_rate=1e-2),
            seed=seed)
        true_w = rng.normal(size=(feature_dim, classes))

        def make_record():
            x = rng.normal(size=feature_dim).astype(np.float32)
            y = np.eye(classes, dtype=np.float32)[int(np.argmax(x @ true_w))]
            return x, y

    warm = max(4 * batch * stage, 256)
    plan = build_plan(records, batch, warm, nan_bursts, outages, seed)
    net = MultiLayerNetwork(conf, device=device).init()
    store = CheckpointStore(
        tempfile.mkdtemp(prefix="dl4jtpu_soak_ckpt_"), retain=4)
    svc = InferenceService(max_delay_ms=0.5)
    queue = QueueSource(maxsize=8192)
    chaos_src = ChaosSource(queue, plan)
    # Replay buffer OUTERMOST: the replayed span must include the NaNs the
    # plan injected, so the validation-only pass can flag it "poisoned".
    source = ReplayBufferSource(chaos_src)
    trainer = OnlineTrainer(
        net, source, batch=batch, stage=stage, linger=0.05,
        name="chaos-soak", checkpoint_store=store,
        checkpoint_every_steps=2 * stage, service=svc, serve_as="soak-live")
    trainer.start()
    cm = get_compile_manager()
    recorder = get_flight_recorder()
    stop_consumers = threading.Event()
    consumer_errors: list = []

    def slow_consumer():
        probe = np.zeros((2, feature_dim), np.float32)
        if seq:
            probe = np.zeros((2, 8, feature_dim), np.float32)
        while not stop_consumers.is_set():
            try:
                svc.predict("soak-live", probe, timeout_s=60)
            except Exception as e:  # noqa: BLE001 - surfaced at the end
                consumer_errors.append(f"{type(e).__name__}: {e}")
            stop_consumers.wait(0.25)  # slow: hold the model, drip requests

    consumers = [threading.Thread(target=slow_consumer, daemon=True)
                 for _ in range(slow_consumers)]

    def wait_for(pred, seconds):
        d = Deadline(seconds)
        while True:
            if pred():
                return True
            if not d.pace(0.05):
                return False

    t_start = time.monotonic()
    for _ in range(warm):
        queue.put(*make_record())
    assert wait_for(lambda: trainer.stats()["records_total"] >= warm,
                    deadline_s / 3), "soak: warm phase never completed"
    # serving buckets compile ahead too: everything past the mark is warm
    probe0 = (np.zeros((1, 8, feature_dim), np.float32) if seq
              else np.zeros((1, feature_dim), np.float32))
    svc.warmup("soak-live", probe0)
    for th in consumers:
        th.start()
    compiles_mark = cm.compiles.value

    # NaN poisoning is plan-scheduled at delivery ("source.record" site),
    # so the producer just streams clean records straight through.
    produced = warm
    n = 0
    while n < records and time.monotonic() - t_start < deadline_s:
        queue.put(*make_record())
        produced += 1
        n += 1
        if n % 512 == 0:
            Deadline(0.05).pace(0.05)  # producer jitter: forces ragged tails
    assert wait_for(
        lambda: (trainer.stats()["records_total"] >= produced
                 or not trainer.alive),
        deadline_s - (time.monotonic() - t_start) + 5), \
        "soak: ingest never drained the stream"
    elapsed = time.monotonic() - t_start
    # quiesce, then final swap under the slow consumers
    final_version = trainer.checkpoint_now(swap=True)
    stop_consumers.set()
    for th in consumers:
        th.join(timeout=10)
    stats = trainer.stats()
    warm_compiles = cm.compiles.value - compiles_mark
    summary = {
        "alive": trainer.alive,
        "records": int(stats["records_total"]),
        "steps": int(stats["steps_total"]),
        "windows": int(stats["windows_total"]),
        "samples_per_sec": round(stats["records_total"] / elapsed, 1),
        "nan_bursts": int(nan_bursts),
        "nan_records": int(chaos_src.nan_records),
        "rollbacks": int(stats["rollbacks_total"]),
        "replays": int(stats["replays_total"]),
        "last_replay": stats["last_replay"],
        "outages": int(chaos_src.outages),
        "reconnects": int(stats["reconnects_total"]),
        "source_errors": int(stats["source_errors_total"]),
        "swaps": int(stats["swaps_total"]),
        "final_version": int(final_version),
        "checkpoint_versions": [v["version"] for v in
                                stats["checkpoints"]["versions"]],
        "warm_compiles": float(warm_compiles),
        "flight_bundles": list(recorder.dumps),
        "consumer_errors": consumer_errors[:5],
        "anomalies": stats["anomalies"],
        "chaos": plan.summary(),
    }
    trainer.stop(checkpoint=False)
    svc.stop()
    # ------------------------------------------------------- the contract
    assert summary["alive"], "trainer died under chaos"
    assert not consumer_errors, f"serving failed under swaps: {consumer_errors[:3]}"
    if nan_bursts:
        assert summary["rollbacks"] >= 1, "NaN bursts produced no rollback"
        assert summary["replays"] >= 1, "rollback ran no poisoned-span replay"
        assert summary["flight_bundles"], "no flight bundle artifact"
    if outages:
        assert summary["reconnects"] >= 1, "outages produced no reconnect"
    assert summary["warm_compiles"] == 0, (
        f"{warm_compiles} captures made by steady-state ingest")
    assert summary["swaps"] >= 1 and summary["final_version"] >= 1
    return summary


def run_fleet_soak(device="cuda", seed: int = 1405,
                   deadline_s: float = 90.0) -> dict:
    """The fleet scenarios (module doc) on ``device``; returns the summary,
    raises AssertionError when the contract is violated."""
    import signal
    import urllib.request

    from deeplearning4j_tpu_torch import (DenseLayer, InputType,
                                          MultiLayerConfiguration,
                                          MultiLayerNetwork, OutputLayer,
                                          UpdaterConfig)
    from deeplearning4j_tpu_torch.fleet import FleetRouter, build_bundle, save_bundle
    from deeplearning4j_tpu_torch.runtime.checkpoint import CheckpointStore
    from deeplearning4j_tpu_torch.runtime.resilience import Deadline
    from deeplearning4j_tpu_torch.telemetry import MetricsRegistry
    from deeplearning4j_tpu_torch.testing.chaos import FaultPlan
    from deeplearning4j_tpu_torch.tune import scoped_env

    def wait_for(pred, what):
        d = Deadline(deadline_s)
        while not pred():
            if not d.pace(0.1):
                raise AssertionError(f"fleet soak: {what} never happened")

    with tempfile.TemporaryDirectory() as work:
        net = MultiLayerNetwork(MultiLayerConfiguration(
            layers=[DenseLayer(n_out=16, activation="relu"),
                    OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
            input_type=InputType.feed_forward(8),
            updater=UpdaterConfig(updater="sgd", learning_rate=1e-2),
            seed=7), device="cpu").init()
        store_dir = os.path.join(work, "store")
        write_plan = FaultPlan(seed, [{"site": "checkpoint.write",
                                       "fault": "corrupt-checkpoint", "at": [2]}])
        store = CheckpointStore(store_dir, chaos=write_plan)
        store.save(net)  # v1, the good version
        save_bundle(store, build_bundle(
            net, example=np.zeros((1, 8), np.float32), argmax=True, max_batch=8))
        store.save(net)  # v2, byte-corrupted by the plan as it lands
        assert [f["fault"] for f in write_plan.fired] == ["corrupt-checkpoint"]

        worker_plan = FaultPlan(seed, [
            {"site": "worker.healthz", "fault": "hang-worker", "at": [3],
             "params": {"seconds": 30}, "marker": os.path.join(work, "hang")},
            {"site": "worker.healthz", "fault": "partial-http", "at": [8],
             "marker": os.path.join(work, "partial")}])
        kill_plan = FaultPlan(seed, [{"site": "soak.kill", "fault": "kill-worker",
                                      "at": [1]}])
        registry = MetricsRegistry()
        with scoped_env(DL4JTPU_CHAOS_PLAN=worker_plan.to_env()):
            router = FleetRouter(store_dir, workers=2, poll_s=0.2,
                                 health_timeout_s=2.0, backoff_base_s=0.1,
                                 device=str(device), registry=registry,
                                 worker_args={"max_delay_ms": 0, "max_batch": 8}).start()
        try:
            respawns = {r: router._m_respawns.labels(reason=r)
                        for r in ("hung", "unhealthy", "crash")}
            for handle in router.workers:
                router._check_worker(handle)
            snaps = router.stats()["workers"]
            boot = {"versions": [w["version"] for w in snaps if w["ready"]],
                    "compiles_since_ready": [w["compiles_since_ready"] for w in snaps
                                             if w["ready"]]}
            assert boot["versions"] and set(boot["versions"]) == {1}, snaps
            assert set(boot["compiles_since_ready"]) == {0}, snaps
            assert os.path.exists(store.path(2) + ".quarantine"), os.listdir(store_dir)
            probe = np.linspace(-1, 1, 8, dtype=np.float32).reshape(1, 8)
            want = net.output(probe)

            def answers() -> bool:
                status, body, _ = router.route_predict({"features": probe.tolist()})
                return status == 200 and float(np.abs(
                    np.asarray(body["output"], np.float32) - want).max()) <= 1e-5

            assert answers()
            wait_for(lambda: respawns["hung"].value >= 1, "hang-worker detection")
            wait_for(lambda: respawns["unhealthy"].value >= 1, "partial-http detection")
            wait_for(lambda: all(w["ready"] for w in router.stats()["workers"]),
                     "respawn after the healthz faults")
            fault = kill_plan.fire("soak.kill")
            assert fault is not None and fault["fault"] == "kill-worker"
            os.kill(router.workers[0].proc.pid, signal.SIGKILL)
            wait_for(lambda: respawns["crash"].value >= 1, "crash respawn")
            wait_for(lambda: all(w["ready"] and w["compiles_since_ready"] == 0
                                 for w in router.stats()["workers"]),
                     "every worker back warm")
            assert answers()
            sites = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/api/resilience", timeout=10).read())["sites"]
            assert sites["fleet.router.health"]["expired_total"] >= 1, sites
            assert router.drain(timeout_s=30)
            return {
                "device": str(device), "boot": boot,
                "respawns": {r: int(c.value) for r, c in respawns.items()},
                "workers": [{k: w[k] for k in ("respawns", "boot_seconds", "version",
                                               "compiles_since_ready")}
                            for w in router.stats()["workers"]],
                "chaos": {"write": write_plan.summary(), "kill": kill_plan.summary()},
            }
        finally:
            router.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_chaos_soak")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--records", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--stage", type=int, default=4)
    ap.add_argument("--nan-bursts", type=int, default=3)
    ap.add_argument("--no-outages", action="store_true")
    ap.add_argument("--seq", action="store_true",
                    help="ragged sequence records (LSTM) instead of rows")
    ap.add_argument("--deadline", type=float, default=300.0)
    ap.add_argument("--flight-dir", default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="FaultPlan seed — same seed, same fault sequence")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet scenarios (hang-worker, partial-http, "
                         "kill-worker) instead of the online soak")
    args = ap.parse_args(argv)
    if args.fleet:
        print(json.dumps(run_fleet_soak(device=args.device, seed=args.seed,
                                        deadline_s=args.deadline)))
        return 0
    summary = run_soak(records=args.records, batch=args.batch,
                       stage=args.stage, nan_bursts=args.nan_bursts,
                       outages=not args.no_outages, seq=args.seq,
                       deadline_s=args.deadline, flight_dir=args.flight_dir,
                       seed=args.seed, device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
