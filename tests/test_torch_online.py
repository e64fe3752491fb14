"""The port's ``OnlineTrainer`` (``runtime/online.py``) against the JAX
package's.

- **Parity.** A small char-RNN (vocab 12, hidden 16, 2 layers, ragged
  records of 5-16 steps, batch 4, stage 2) and a small MLP, with every
  record queued before ``start()``: the port trainer's per-window losses
  and its final params equal JAX's ``fit_on_device`` over JAX's
  ``BucketedStager`` plan of the same micro-batches (padded as the trainer
  pads them), at 1e-5 in f32 (JAX with x64 off).
- **Detectors.** The drift band (adaptive: the EMA of the within-window
  variance, with its floor), the NaN check and the input-shift z-score are
  held against JAX's trainer on the same loss windows and feature means:
  the same baselines, sigmas, anomalies, rollbacks and pauses.
- **The loop.** Padded tails, pause/resume and backpressure, disconnect and
  reconnect through ``ChaosSource``, NaN rollback with its replay and
  bundle (and no new capture), the pause-on policy, and a hot swap that
  the port's ``InferenceService`` serves exactly (CPU), as in JAX's
  ``tests/test_online.py``; a CPU soak through
  ``scripts/torch_chaos_soak.run_soak``.
"""

import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.datasets import bucketing as jbucket  # noqa: E402
from deeplearning4j_tpu.models import char_rnn as jchar_rnn  # noqa: E402
from deeplearning4j_tpu.runtime import checkpoint as jckpt  # noqa: E402
from deeplearning4j_tpu.runtime import online as jonline  # noqa: E402
from deeplearning4j_tpu.streaming import QueueSource as JQueueSource  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402
from deeplearning4j_tpu.telemetry import flight_recorder as jflight  # noqa: E402
from deeplearning4j_tpu.telemetry import tracing as jtracing  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.runtime import CheckpointStore, OnlineTrainer  # noqa: E402
from deeplearning4j_tpu_torch.runtime import online as ponline  # noqa: E402
from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager  # noqa: E402
from deeplearning4j_tpu_torch.serving import InferenceService  # noqa: E402
from deeplearning4j_tpu_torch.streaming import QueueSource, ReplayBufferSource  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.telemetry.flight_recorder import (FlightRecorder,  # noqa: E402
                                                                set_flight_recorder)
from deeplearning4j_tpu_torch.telemetry import tracing as ptracing  # noqa: E402
from deeplearning4j_tpu_torch.testing import ChaosSource, FaultPlan  # noqa: E402

ATOL = RTOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
FEATURES, CLASSES = 12, 4


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_HISTORY", "0")
    monkeypatch.setenv("DL4JTPU_TUNED_PATH", str(tmp_path / "TUNED.json"))
    yield
    ponline.clear_online_trainers()
    jonline.clear_online_trainers()
    # a trainer's swap sets the process-level baggage every new trace
    # context carries; later tests in this process must not see it
    ptracing.set_default_baggage("checkpoint_version", None)
    jtracing.set_default_baggage("checkpoint_version", None)


@pytest.fixture
def flight(tmp_path):
    rec = FlightRecorder(dump_dir=str(tmp_path / "flight"), registry=MetricsRegistry())
    set_flight_recorder(rec)
    jrec = jflight.FlightRecorder(dump_dir=str(tmp_path / "jflight"), registry=JRegistry())
    jflight.set_flight_recorder(jrec)
    yield rec
    set_flight_recorder(None)
    jflight.set_flight_recorder(None)


def _wait(pred, seconds=30.0):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


# ------------------------------------------------------------- parity
VOCAB, HIDDEN = 12, 16
LENGTHS = (5, 7, 8, 11, 13, 16)  # time buckets 8 and 16


def _char_conf(pkg):
    conf = (jchar_rnn if pkg is dj else pt.char_rnn)(VOCAB, HIDDEN, 2)
    conf.backprop_type = "standard"
    return conf


def _mlp_conf(pkg):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=16, activation="tanh"),
                pkg.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(FEATURES), updater=u if pkg is dj else u.to_dict(),
        seed=3)


def _char_records(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.choice(LENGTHS))
        ids = rng.integers(0, VOCAB, t + 1)
        eye = np.eye(VOCAB, dtype=np.float32)
        out.append((eye[ids[:-1]], eye[ids[1:]]))
    return out


def _mlp_records(n, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(FEATURES, CLASSES))
    out = []
    for _ in range(n):
        x = rng.normal(size=FEATURES).astype(np.float32)
        out.append((x, np.eye(CLASSES, dtype=np.float32)[int(np.argmax(x @ w))]))
    return out


def _micro_batches(records, batch):
    """The trainer's micro-batches of records queued before start: runs of
    ``batch`` records, each padded as ``_pad_micro_batch`` pads it, with
    the JAX package's padding helpers."""
    out = []
    for i in range(0, len(records), batch):
        chunk = records[i:i + batch]
        n = len(chunk)
        feats = [f for f, _ in chunk]
        labs = [l for _, l in chunk]
        if feats[0].ndim == 2:
            tb = jbucket.bucket_length(max(f.shape[0] for f in feats), None)
            F = np.zeros((n, tb) + feats[0].shape[1:], np.float32)
            L = np.zeros((n, tb) + labs[0].shape[1:], np.float32)
            fm = np.zeros((n, tb), np.float32)
            lm = np.zeros((n, tb), np.float32)
            for j, (f, l) in enumerate(chunk):
                F[j, :f.shape[0]], fm[j, :f.shape[0]] = f, 1.0
                L[j, :l.shape[0]], lm[j, :l.shape[0]] = l, 1.0
        else:
            tb, F, L, fm, lm = None, np.stack(feats), np.stack(labs), None, None
        F, L, fm, lm = jbucket.pad_batch_arrays(F, L, fm, lm, batch, tb)
        if lm is None:
            lm = np.ones((batch,), np.float32)
        out.append((F, L, fm, lm))
    return out


def _jax_windows(jnet, records, batch, stage):
    stager = jbucket.BucketedStager(stage, pad_examples=True)
    losses = []
    for kind, w in stager.plan(iter(_micro_batches(records, batch)),
                               lambda mb: ([mb[0]], [mb[1]], [mb[2]], [mb[3]])):
        assert kind == "window"
        losses.append(np.asarray(jnet.fit_on_device(
            w.features[0], w.labels[0], steps=w.n_real,
            features_masks=None if w.features_masks is None else w.features_masks[0],
            labels_masks=None if w.labels_masks is None else w.labels_masks[0],
            real_batches=w.n_real)))
    return losses


@pytest.mark.parametrize("kind,n", [("char_rnn", 22), ("mlp", 30)])
def test_window_losses_and_params_match_jax(flight, kind, n):
    batch, stage = 4, 2
    make_conf, records = ((_char_conf, _char_records(n)) if kind == "char_rnn"
                          else (_mlp_conf, _mlp_records(n)))
    with jax.enable_x64(False):
        jnet = dj.MultiLayerNetwork(make_conf(dj)).init()
        jnet.init(params=_f32(jnet.params), force=True)
        pconf = make_conf(pt)
        assert pconf.to_json() == jnet.conf.to_json()
        pnet = pt.load_jax_params(pt.MultiLayerNetwork(pconf, device="cpu"), jnet.params)
        want = _jax_windows(jnet, records, batch, stage)
    got = []
    real = pnet.fit_on_device

    def spy(*a, **kw):
        out = real(*a, **kw)
        got.append(out)
        return out

    pnet.fit_on_device = spy
    source = QueueSource()
    for f, l in records:
        source.put(f, l)
    trainer = OnlineTrainer(pnet, source, batch=batch, stage=stage, linger=0.02,
                            registry=MetricsRegistry(), name=f"parity-{kind}")
    trainer.start()
    steps = sum(len(w) for w in want)
    try:
        assert _wait(lambda: trainer.stats()["steps_total"] >= steps)
    finally:
        trainer.stop(checkpoint=False)
    assert len(got) == len(want) >= 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"window {i}")
    jp = jax.tree_util.tree_leaves(jnet.params)
    pp = [layer[k] for layer in pnet._leaves() for k in sorted(layer)]
    for i, (j, p) in enumerate(zip(jp, pp)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=ATOL, rtol=RTOL,
                                   err_msg=f"param {i}")
    s = trainer.stats()
    assert s["records_total"] == n and s["batches_total"] == -(-n // batch)
    assert pnet.iteration == steps
    assert s["padding"]["windows"] == len(want)


# ---------------------------------------------------------- detectors
def _pair(tmp_path, **kw):
    """A JAX and a port trainer over MLPs of the same conf, each with a
    store holding version 1, not started."""
    out = []
    for pkg, mod, reg, store_cls, queue in (
            (dj, jonline, JRegistry, jckpt.CheckpointStore, JQueueSource),
            (pt, ponline, MetricsRegistry, CheckpointStore, QueueSource)):
        net = (pkg.MultiLayerNetwork(_mlp_conf(pkg)) if pkg is dj else
               pkg.MultiLayerNetwork(_mlp_conf(pkg), device="cpu")).init()
        store = store_cls(str(tmp_path / pkg.__name__), registry=reg())
        tr = mod.OnlineTrainer(net, queue(), batch=4, stage=2, registry=reg(),
                               checkpoint_store=store, name=f"det-{pkg.__name__}", **kw)
        tr._last_good_version = store.save(net).version
        out.append(tr)
    return out


def _detector_view(tr):
    s = tr.stats()
    return (s["loss_baseline"], s["loss_sigma"], s["rollbacks_total"], s["anomalies"],
            s["paused"], s["recent_window_losses"], tr._baseline_windows,
            tr._steps_since_checkpoint)


SCENARIOS = {
    # a lone mild spike does not move the 3-window trend; a jump does
    "drift": [np.full(4, 1.0)] * 4 + [np.full(4, 5.0), np.full(4, 50.0), np.full(4, 1.0)],
    # heavy-tailed noise widens the band instead of tripping it
    "heavy_tail": [np.array([0.0, 0.0, 0.0, 0.02])] * 6 + [np.array([0.0, 0.0, 0.0, 0.2])]
    + [np.array([0.0, 0.0, 0.0, 0.02])] * 4,
    # a slow creep of every example trips the band within bounded windows
    "creep": [1.0 + np.array([-0.01, 0.0, 0.0, 0.01])] * 4
    + [1.4 ** k + np.array([-0.01, 0.0, 0.0, 0.01]) for k in range(1, 12)],
    "nan": [np.full(4, 1.0)] * 3 + [np.array([1.0, np.nan, 1.0, 1.0]), np.full(4, 1.0)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("pause_on", [(), ("loss-drift", "nan-loss")], ids=["auto", "pause_on"])
def test_drift_band_and_nan_check_match_jax(flight, tmp_path, scenario, pause_on):
    jtr, ptr = _pair(tmp_path, drift_factor=3.0, drift_min_windows=3, pause_on=pause_on)
    for losses in SCENARIOS[scenario]:
        for tr in (jtr, ptr):
            tr._check_window_health(np.array(losses, np.float64))
        jv, pv = _detector_view(jtr), _detector_view(ptr)
        assert repr(jv) == repr(pv)
    rollbacks = ptr.stats()["rollbacks_total"]
    assert rollbacks == 0 if scenario == "heavy_tail" else rollbacks >= 1


def test_input_shift_zscores_match_jax(flight, tmp_path):
    jtr, ptr = _pair(tmp_path, shift_zscore=4.0)
    rng = np.random.default_rng(5)
    for i in range(14):
        shift = 50.0 if i >= 12 else 0.0
        buf = [((rng.normal(size=FEATURES) + shift).astype(np.float32),
                np.eye(CLASSES, dtype=np.float32)[0]) for _ in range(3)]
        outs = [tr._pad_micro_batch(list(buf)) for tr in (jtr, ptr)]
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert (jtr._shift.n, jtr._shift.mean, jtr._shift.m2) == \
            (ptr._shift.n, ptr._shift.mean, ptr._shift.m2)
    assert jtr.stats()["anomalies"] == ptr.stats()["anomalies"] == {"input-shift": 2}
    assert ptr.stats()["rollbacks_total"] == 0


def test_constructor_defaults_and_stats_keys_match_jax(flight, tmp_path):
    jtr, ptr = _pair(tmp_path)
    for attr in ("batch", "stage", "linger", "flush_idle", "drift_window", "drift_factor",
                 "drift_min_windows", "shift_zscore", "rollback_on", "pause_on",
                 "source_retry_s", "warm_partials", "replay_max_records"):
        assert getattr(jtr, attr) == getattr(ptr, attr), attr
    default = OnlineTrainer(pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu"), QueueSource(),
                            registry=MetricsRegistry())
    assert default.stage == 4 and default.batch == 32
    assert sorted(jtr.stats()) == sorted(ptr.stats())
    with pytest.raises(ValueError, match="stage"):
        OnlineTrainer(default.net, QueueSource(), stage=1, registry=MetricsRegistry())


def test_online_metric_names_match_jax(flight, tmp_path):
    regs = [JRegistry(), MetricsRegistry()]
    for mod, pkg, reg in ((jonline, dj, regs[0]), (ponline, pt, regs[1])):
        net = (pkg.MultiLayerNetwork(_mlp_conf(pkg)) if pkg is dj
               else pkg.MultiLayerNetwork(_mlp_conf(pkg), device="cpu"))
        mod.OnlineTrainer(net, QueueSource(), stage=2, registry=reg, name="names")
    names = [sorted(n for n in r.snapshot() if n.startswith("dl4jtpu_online")) for r in regs]
    assert names[0] == names[1] and len(names[1]) >= 11


# ------------------------------------------------------------ the loop
def _make(**kw):
    put_rng = np.random.default_rng(0)
    w = put_rng.normal(size=(FEATURES, CLASSES))

    def put(source, n, nan=False):
        for _ in range(n):
            x = put_rng.normal(size=FEATURES).astype(np.float32)
            if nan:
                x[:] = np.nan
            source.put(x, np.eye(CLASSES, dtype=np.float32)[int(np.argmax(x @ w))])

    source = kw.pop("source", None) or QueueSource(maxsize=8192)
    net = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    opts = dict(batch=16, stage=2, linger=0.05, registry=MetricsRegistry())
    opts.update(kw)
    return OnlineTrainer(net, source, **opts), source, put, net


def test_trains_padded_tail_and_makes_no_capture_once_warm(flight):
    trainer, source, put, net = _make(name="t-ingest")
    trainer.start()
    cm = get_compile_manager()
    try:
        put(source, 64)
        assert _wait(lambda: trainer.stats()["steps_total"] >= 4)
        before = cm.compiles.value
        put(source, 41)  # a padded tail: a partial batch and a partial window
        assert _wait(lambda: trainer.stats()["steps_total"] >= 7)
        s = trainer.stats()
        assert s["records_total"] == 105 and s["batches_total"] == 7
        assert net.iteration == 7 and s["alive"] and not s["paused"]
        assert cm.compiles.value == before
        assert ponline.get_online_trainers()["t-ingest"] is trainer
    finally:
        trainer.stop()
    assert not trainer.alive


def test_padded_tail_trains_only_its_real_rows(flight):
    trainer, source, _, net = _make(name="t-mask")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, FEATURES)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 5)]
    ref = float(pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init().score(pt.DataSet(x, y)))
    trainer.start()
    try:
        for i in range(5):
            source.put(x[i], y[i])
        assert _wait(lambda: trainer.stats()["steps_total"] >= 1)
    finally:
        trainer.stop()
    assert trainer.stats()["recent_window_losses"][0] == pytest.approx(ref, rel=1e-5)


def test_pause_resume_and_backpressure(flight):
    trainer, source, put, _ = _make(name="t-pause", source=QueueSource(maxsize=16))
    trainer.start()
    try:
        put(source, 16)
        assert _wait(lambda: trainer.stats()["records_total"] >= 16)
        trainer.pause()
        assert _wait(lambda: trainer.stats()["paused"])
        time.sleep(0.15)
        put(source, 16)  # fills the bounded queue while paused
        with pytest.raises(RuntimeError, match="full"):
            source.put(np.zeros(FEATURES, np.float32), np.zeros(CLASSES, np.float32),
                       timeout=0.05)
        assert trainer.stats()["records_total"] <= 17
        trainer.resume()
        assert _wait(lambda: trainer.stats()["records_total"] >= 32)
    finally:
        trainer.stop()


def test_disconnect_and_reconnect_through_chaos_source(flight):
    queue = QueueSource(maxsize=1024)
    plan = FaultPlan(3, [{"site": "source.poll", "fault": "source-error", "at": [20, 60],
                          "params": {"polls": 3}}])
    chaos = ChaosSource(queue, plan)
    trainer, _, put, _ = _make(name="t-flaky", source=chaos, source_retry_s=0.01)
    trainer.start()
    try:
        queue._q.put((np.zeros(FEATURES, np.float32), None))  # unlabelled: a bad record
        put(queue, 64)
        assert _wait(lambda: trainer.stats()["records_total"] >= 64)
        s = trainer.stats()
        assert chaos.outages == 2 and s["source_errors_total"] == 6
        assert s["reconnects_total"] == 2 and s["bad_records_total"] == 1 and s["alive"]
    finally:
        trainer.stop()


def test_nan_rollback_replays_the_span_and_leaves_a_bundle(flight, tmp_path):
    store = CheckpointStore(str(tmp_path / "ckpt"), registry=MetricsRegistry())
    queue = QueueSource(maxsize=8192)
    trainer, _, put, net = _make(name="t-nan", source=ReplayBufferSource(queue),
                                 checkpoint_store=store, checkpoint_every_steps=4)
    trainer.start()
    cm = get_compile_manager()
    try:
        put(queue, 96)
        assert _wait(lambda: trainer.stats()["steps_total"] >= 6)
        good = trainer.stats()["last_good_version"]
        before = cm.compiles.value
        put(queue, 32, nan=True)
        assert _wait(lambda: trainer.stats()["rollbacks_total"] >= 1)
        assert trainer.alive and good is not None
        s = trainer.stats()
        assert s["replays_total"] >= 1 and s["last_replay"]["outcome"] == "poisoned"
        assert flight.dumps
        kinds = {e["kind"] for e in json.load(open(flight.dumps[-1]))["events"]}
        assert {"anomaly", "online_rollback", "online_replay"} <= kinds
        assert all(torch.isfinite(v).all() for l in net._leaves() for v in l.values())
        steps = s["steps_total"]
        put(queue, 64)
        assert _wait(lambda: trainer.stats()["steps_total"] > steps)
        assert cm.compiles.value == before  # the rollback captured nothing
    finally:
        trainer.stop()


def test_hot_swap_serves_the_version_exactly(flight, tmp_path):
    store = CheckpointStore(str(tmp_path / "ckpt"), registry=MetricsRegistry())
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=0.5)
    trainer, source, put, _ = _make(name="t-swap", checkpoint_store=store, service=svc,
                                    serve_as="live")
    probe = np.random.default_rng(9).normal(size=(3, FEATURES)).astype(np.float32)
    trainer.start()
    cm = get_compile_manager()
    try:
        put(source, 64)
        assert _wait(lambda: trainer.stats()["steps_total"] >= 4)
        served0 = svc.predict("live", probe, timeout_s=30)
        before = cm.compiles.value
        version = trainer.checkpoint_now(swap=True)
        store.join()
        served1 = svc.predict("live", probe, timeout_s=30)
        assert cm.compiles.value == before  # the swap captured nothing
        assert np.abs(served1 - served0).max() > 0
        np.testing.assert_array_equal(served1,
                                      store.restore(version, device="cpu").output(probe))
        assert svc.stats()["models"]["live"]["version"] == version
    finally:
        trainer.stop()
        svc.stop()


def test_cpu_soak(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the soak's store
    spec = importlib.util.spec_from_file_location("torch_chaos_soak",
                                                  ROOT / "scripts" / "torch_chaos_soak.py")
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    summary = soak.run_soak(records=300, batch=8, stage=2, nan_bursts=1, deadline_s=60,
                            flight_dir=str(tmp_path / "flight"), device="cpu")
    assert summary["alive"] and summary["rollbacks"] >= 1 and summary["replays"] >= 1
    assert summary["flight_bundles"] and summary["warm_compiles"] == 0
    assert summary["reconnects"] >= 1 and not summary["consumer_errors"]
    jkeys = ["alive", "records", "steps", "windows", "samples_per_sec", "nan_bursts",
             "nan_records", "rollbacks", "replays", "last_replay", "outages", "reconnects",
             "source_errors", "swaps", "final_version", "checkpoint_versions",
             "warm_compiles", "flight_bundles", "consumer_errors", "anomalies", "chaos"]
    assert list(summary) == jkeys
    assert os.path.isdir(tmp_path / "flight")


def test_capture_lock_excludes_shared_work_and_upgrades():
    """The capture rule's lock: an exclusive hold waits for shared holders
    and keeps new ones out; a thread holding it shared may take it
    exclusively (its shared hold is given up meanwhile, then restored);
    both nest."""
    import threading

    from deeplearning4j_tpu_torch.runtime.compile_manager import CaptureLock

    lock = CaptureLock()
    order, inside, release = [], threading.Event(), threading.Event()

    def reader():
        with lock.shared():
            order.append("reader in")
            inside.set()
            assert release.wait(10)
        order.append("reader out")

    def writer():
        with lock.exclusive():
            order.append("writer in")

    r = threading.Thread(target=reader)
    r.start()
    assert inside.wait(10)
    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.05)
    assert order == ["reader in"]  # the capture waits for the shared holder
    def late_reader():
        with lock.shared():
            order.append("late")

    late = threading.Thread(target=late_reader)
    late.start()
    time.sleep(0.05)
    assert "late" not in order  # a waiting capture goes first
    release.set()
    for t in (r, w, late):
        t.join(10)
        assert not t.is_alive()
    assert order.index("writer in") < order.index("late")
    with lock.shared(), lock.shared():
        with lock.exclusive(), lock.exclusive(), lock.shared():
            assert lock._writer == threading.get_ident()
        assert lock._readers[threading.get_ident()] == 2
    assert lock._writer is None and not lock._readers


def test_capture_lock_stress():
    """More threads than cores take the lock shared and exclusively (some
    upgrading from a shared hold) under a short switch interval for a
    bounded time: no shared holder ever overlaps an exclusive one, nothing
    deadlocks."""
    import os
    import sys
    import threading

    from deeplearning4j_tpu_torch.runtime.compile_manager import CaptureLock

    lock, state, bad = CaptureLock(), {"readers": 0, "writers": 0}, []
    guard = threading.Lock()
    end = time.monotonic() + 1.0

    def enter(kind):
        with guard:
            state[kind] += 1
            if state["writers"] > 1 or (state["writers"] and state["readers"]):
                bad.append(dict(state))

    def leave(kind):
        with guard:
            state[kind] -= 1

    def worker(i):
        while time.monotonic() < end:
            if i % 3 == 0:
                with lock.shared():
                    with lock.exclusive():  # an upgrade: the shared hold is given up
                        enter("writers")
                        leave("writers")
            elif i % 3 == 1:
                with lock.exclusive():
                    enter("writers")
                    leave("writers")
            else:
                with lock.shared():
                    enter("readers")
                    leave("readers")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2 * (os.cpu_count() or 2) + 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert lock._writer is None and not lock._readers and lock.exclusive_total > 0
