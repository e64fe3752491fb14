"""The port's training telemetry (``deeplearning4j_tpu_torch/telemetry/``)
against the JAX package's.

- The registry: the same operations on both packages' ``MetricsRegistry``
  give the same Prometheus text and the same snapshot.
- Spans, the watchdog (the same events, kinds, thresholds and messages for
  the same rows) and the flight recorder (ring, bundles, per-kind dump rate
  limit, crash hook).
- ``Telemetry`` on both networks' fit paths: the rows (loss, grad norm,
  non-finite flag) at 1e-5 of JAX's session on the same weights and
  batches, per batch and staged, with the host reads counted through the
  ``_fetch`` seam: ceil(updates / fetch_every) per batch, one per staged
  window. The grad norm is that of the unscaled gradients (bit for bit the
  same under ``loss_scale=1024``); TBPTT segments report the loss alone.
- ``memory_report``: every integer (per-layer param, grad, optimizer-state
  and activation bytes, activation shapes, the totals, the top consumers,
  the inputs) equal to JAX's for LeNet, a small ``resnet_conf``, the
  char-RNN and a graph, with nothing allocated (a forward on meta tensors).
- ``preflight``: raises under a small ``limit_bytes`` naming the biggest
  consumers, reads ``DL4JTPU_HBM_LIMIT_BYTES`` as JAX does, has no ``"ir"``
  section, and ``layout=`` raises ``NotImplementedError``.
The JAX side builds its nets and runs with x64 off, so that both sides hold
f32 params.
"""

import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
import deeplearning4j_tpu.telemetry as jtel  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.models import resnet as jres  # noqa: E402
from deeplearning4j_tpu.models.char_rnn import char_rnn as jax_char_rnn  # noqa: E402
from deeplearning4j_tpu.models.lenet import lenet_mnist_conf as jax_lenet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
import deeplearning4j_tpu_torch.telemetry as ptel  # noqa: E402
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener)
from deeplearning4j_tpu_torch.telemetry import device as pdev  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import flight_recorder as pflight  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import memory as pmem  # noqa: E402

ROW_TOL = 1e-5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


# ------------------------------------------------------------- registry
def _drive_registry(reg):
    c = reg.counter("t_requests_total", "requests", labelnames=("route",))
    c.labels(route="/a").inc()
    c.labels(route="/b").inc(2.5)
    g = reg.gauge("t_temp", "temperature")
    g.set(3.25)
    g.dec(0.25)
    h = reg.histogram("t_latency_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    h.observe(0.07, exemplar="abc123")
    lh = reg.histogram("t_sizes", "sizes", labelnames=("kind",), buckets=(1, 10))
    lh.labels(kind='q"x').observe(3)
    reg.counter("t_empty_total", "never incremented", labelnames=("x",))
    reg.gauge("t_big", "").set(1e17)
    reg.gauge("t_neg_inf", "").set(-math.inf)
    assert reg.counter("t_requests_total", labelnames=("route",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_temp", labelnames=("x",))
    with pytest.raises(ValueError):
        c.labels(route="/a").inc(-1)
    return reg


def test_registry_text_and_snapshot_equal_jax():
    jreg = _drive_registry(jtel.MetricsRegistry())
    preg = _drive_registry(ptel.MetricsRegistry())
    assert preg.prometheus_text() == jreg.prometheus_text()
    assert preg.snapshot() == jreg.snapshot()
    assert json.dumps(preg.snapshot(), sort_keys=True) == json.dumps(jreg.snapshot(),
                                                                    sort_keys=True)
    assert ptel.get_registry() is ptel.get_registry()
    preg.unregister("t_temp")
    assert preg.get("t_temp") is None
    preg.clear()
    assert preg.prometheus_text() == ""


# ---------------------------------------------------------------- spans
def test_spans_export_chrome_trace_and_time_into_the_registry(tmp_path):
    rec = ptel.SpanRecorder(max_events=2)
    reg = ptel.MetricsRegistry()
    with ptel.span("data_load", recorder=rec, registry=reg, batch=3) as s:
        pass
    assert s.duration_s is not None and s.duration_s >= 0
    sp = ptel.Span("dispatch", recorder=rec).start()
    with pytest.raises(RuntimeError, match="already started"):
        sp.start()
    sp.stop()
    with pytest.raises(RuntimeError, match="never started"):
        sp.stop()
    ptel.span("dropped", recorder=rec).start().stop()
    assert rec.dropped == 1 and [e["name"] for e in rec.events] == ["data_load", "dispatch"]
    ev = rec.events[0]
    assert ev["ph"] == "X" and ev["args"] == {"batch": 3} and ev["dur"] >= 0
    doc = json.load(open(rec.export_chrome_trace(str(tmp_path / "trace.json"))))
    assert doc["traceEvents"] == rec.events and doc["displayTimeUnit"] == "ms"
    assert reg.snapshot()["dl4jtpu_span_seconds"]["values"][0]["labels"] == {
        "name": "data_load"}
    rec.clear()
    assert rec.events == [] and rec.dropped == 0


def test_span_appears_in_a_torch_profiler_trace():
    """The span enters ``torch.profiler.record_function``: its name is an
    event of the profile, around the ops it encloses."""
    rec = ptel.SpanRecorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ptel.span("dl4j_span_probe", recorder=rec):
            torch.ones(4).sum()
    assert "dl4j_span_probe" in {e.key for e in prof.key_averages()}


# -------------------------------------------------------------- watchdog
ROWS = [(1, 0.5, 1.0, 0.0, 0.1), (2, float("nan"), 1.0, 0.0, 0.1),
        (3, 0.4, 5e3, 0.0, 0.1), (4, 0.4, 1.0, 1.0, 0.1), (5, 0.4, 1.0, 0.0, 0.1),
        (6, 0.4, 1.0, 0.0, 0.1), (7, 0.4, 1.0, 0.0, 5.0), (8, 0.4, float("inf"), 0.0, None)]


def _watch(pkg):
    got = []
    reg = pkg.MetricsRegistry()
    wd = pkg.Watchdog(sinks=[got.append], registry=reg, stall_warmup_steps=3)
    for row in ROWS:
        wd.observe(*row)
    wd.emit("loss-drift", 9, 1.5, 1.0, "drift")
    return [(e.kind, e.iteration, e.value, e.threshold, e.message) for e in got], reg


def test_watchdog_events_equal_jax():
    pe, preg = _watch(ptel)
    je, jreg = _watch(jtel)
    assert repr(pe) == repr(je)
    assert [e[0] for e in pe] == ["nan-loss", "exploding-grad-norm", "nan-loss",
                                  "stalled-step-time", "loss-drift"]
    assert preg.prometheus_text() == jreg.prometheus_text()
    assert (ptel.NAN_LOSS, ptel.EXPLODING_GRAD_NORM, ptel.STALLED_STEP_TIME) == (
        jtel.NAN_LOSS, jtel.EXPLODING_GRAD_NORM, jtel.STALLED_STEP_TIME)
    wd = ptel.Watchdog(sinks=[lambda e: 1 / 0], registry=ptel.MetricsRegistry(),
                       step_time_limit_s=0.5)
    wd.observe(1, 0.1, 0.1, 0.0, 1.0)  # a broken sink never kills the loop
    assert wd.events[0].kind == "stalled-step-time" and wd.events[0].threshold == 0.5


# -------------------------------------------------------- flight recorder
def test_flight_recorder_ring_bundle_and_per_kind_rate_limit(tmp_path, monkeypatch):
    monkeypatch.delenv(pflight.FLIGHT_DIR_ENV, raising=False)
    reg = ptel.MetricsRegistry()
    fr = ptel.FlightRecorder(capacity=3, dump_dir=str(tmp_path), registry=reg,
                             min_dump_interval_s=3600)
    for i in range(5):
        fr.record("step", iteration=i, loss=0.1 * i)
    assert len(fr) == 3 and fr.dropped == 2
    assert [e["iteration"] for e in fr.events] == [2, 3, 4]
    wd = ptel.Watchdog(sinks=[fr.watchdog_sink], registry=reg)
    wd.observe(10, float("nan"), 0.0, 1.0)
    wd.observe(11, float("nan"), 0.0, 1.0)  # the same kind within the interval
    wd.observe(12, 0.1, 1e9, 0.0)  # another kind dumps its own bundle
    assert len(fr.dumps) == 2
    bundle = json.load(open(fr.dumps[0]))
    assert bundle["schema"] == pflight.SCHEMA == "dl4jtpu-flight-v1"
    assert bundle["reason"] == "nan-loss"
    assert set(bundle) >= {"events", "memory", "compile_cache", "registry", "spans",
                           "environment", "dropped_events"}
    assert bundle["environment"]["torch"] == torch.__version__
    anomaly = [e for e in bundle["events"] if e["kind"] == "anomaly"][0]
    assert anomaly["anomaly"] == "nan-loss" and anomaly["iteration"] == 10
    assert fr.snapshot(last=1)["events"][0]["kind"] == "dump"
    assert "step" in pflight.registered_event_kinds()
    assert pflight.register_event_kind("custom_kind") == "custom_kind"
    assert pflight.registered_event_kinds() >= jtel.flight_recorder.registered_event_kinds()


def test_crash_hook_dumps_once_and_chains(tmp_path, monkeypatch):
    monkeypatch.setattr(pflight, "_HOOK_INSTALLED", False)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    registered = []
    monkeypatch.setattr("atexit.register", registered.append)
    fr = ptel.FlightRecorder(dump_dir=str(tmp_path), registry=ptel.MetricsRegistry())
    assert ptel.install_crash_hook(fr) is fr
    assert ptel.install_crash_hook(fr) is fr  # idempotent
    sys.excepthook(ValueError, ValueError("boom"), None)
    assert seen == [ValueError] and len(fr.dumps) == 1
    assert json.load(open(fr.dumps[0]))["reason"] == "crash"
    assert len(registered) == 1


# ---------------------------------------------------------- step_stats
def test_step_stats_vector():
    g = [{"W": torch.tensor([[3.0, 0.0]]), "b": torch.tensor([4.0])},
         {"i": torch.tensor([7], dtype=torch.int32)}]
    v = pdev.step_stats(torch.tensor(2.5), g)
    assert v.dtype == torch.float32 and v.shape == (pdev.NUM_SLOTS,)
    assert v.tolist() == [2.5, 5.0, 0.0]
    assert pdev.step_stats(torch.tensor(1.0)).tolist() == [1.0, 0.0, 0.0]
    assert pdev.step_stats(torch.tensor(float("nan")), g)[pdev.NONFINITE] == 1.0
    g[0]["W"][0, 0] = float("inf")
    assert pdev.step_stats(torch.tensor(1.0), g)[pdev.NONFINITE] == 1.0
    bf = [{"W": torch.tensor([3.0, 4.0], dtype=torch.bfloat16)}]
    assert pdev.step_stats(torch.tensor(1.0, dtype=torch.bfloat16), bf).tolist() == [
        1.0, 5.0, 0.0]
    jv = np.asarray(jtel.device.step_stats(jnp.float32(2.5), [{"W": jnp.asarray([[3.0, 0.0]]),
                                                               "b": jnp.asarray([4.0])}]))
    assert pdev.step_stats(torch.tensor(2.5), [{"W": torch.tensor([[3.0, 0.0]]),
                                                "b": torch.tensor([4.0])}]).tolist() == \
        jv.tolist()
    assert (pdev.LOSS, pdev.GRAD_NORM, pdev.NONFINITE, pdev.NUM_SLOTS) == (
        jtel.device.LOSS, jtel.device.GRAD_NORM, jtel.device.NONFINITE, jtel.device.NUM_SLOTS)


# ----------------------------------------------- Telemetry on the fit paths
def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree)


def _mlp(pkg, updater="adam", loss_scale=None):
    u = pkg.UpdaterConfig(updater=updater, learning_rate=1e-2)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=12, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5), updater=u if pkg is dj else u.to_dict(),
        seed=5, loss_scale=loss_scale)


def _graph(pkg):
    u = pkg.UpdaterConfig(updater="lamb", learning_rate=1e-2)
    return (pkg.ComputationGraphConfiguration.builder().seed(6)
            .updater(u if pkg is dj else u.to_dict()).add_inputs("in")
            .add_layer("h", pkg.DenseLayer(n_out=10, activation="relu"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "h")
            .set_outputs("out").set_input_types(pkg.InputType.feed_forward(5)).build())


def _pair(make, graph=False):
    cls_j = dj.ComputationGraph if graph else dj.MultiLayerNetwork
    cls_p = pt.ComputationGraph if graph else pt.MultiLayerNetwork
    with jax.enable_x64(False):
        jnet = cls_j(make(dj)).init()
        jnet.init(params=_f32(jnet.params), force=True)
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jnet.params)
    return jnet, pt.load_jax_params(cls_p(make(pt), device="cpu"), host)


def _batches(n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for _ in range(n)]


class _Reads:
    """Counts a package's ``Telemetry._fetch`` calls and keeps the rows."""

    def __init__(self, monkeypatch, pkg):
        self.calls, self.rows = 0, []
        real = pkg.Telemetry._fetch

        def fetch(a):
            self.calls += 1
            out = np.asarray(real(a), np.float64)
            self.rows.extend(out.tolist())
            return out

        monkeypatch.setattr(pkg.Telemetry, "_fetch", staticmethod(fetch))


def _session(pkg, k):
    reg = pkg.MetricsRegistry()
    return pkg.Telemetry(registry=reg, fetch_every=k,
                         flight_recorder=pkg.FlightRecorder(registry=reg),
                         sample_memory=False)


def _rows_close(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=ROW_TOL, atol=ROW_TOL)


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_per_batch_rows_and_reads_match_jax(graph, monkeypatch):
    make = _graph if graph else _mlp
    jnet, pnet = _pair(make, graph)
    jtel_s, ptel_s = _session(jtel, 3), _session(ptel, 3)
    jreads, preads = _Reads(monkeypatch, jtel), _Reads(monkeypatch, ptel)
    jnet.set_telemetry(jtel_s)
    assert pnet.set_telemetry(ptel_s) is pnet
    data = _batches(7, seed=1)
    with jax.enable_x64(False):
        jnet.fit([JaxDataSet(x, y) for x, y in data])
    pnet.fit([pt.DataSet(x, y) for x, y in data])
    assert preads.calls == jreads.calls == 3 == ptel_s.fetch_count  # ceil(7 / 3)
    _rows_close(preads.rows, jreads.rows)
    assert all(r[2] == 0.0 and r[1] > 0 for r in preads.rows)
    snap = ptel_s.registry.snapshot()
    assert snap["dl4jtpu_train_steps_total"]["values"][0]["value"] == 7
    assert snap["dl4jtpu_train_fetches_total"]["values"][0]["value"] == 3
    assert snap["dl4jtpu_train_loss"]["values"][0]["value"] == pytest.approx(preads.rows[-1][0])
    steps = [e for e in ptel_s.flight.events if e["kind"] == "step"]
    assert [e["iteration"] for e in steps] == list(range(1, 8))


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_staged_rows_and_reads_match_jax(graph, monkeypatch):
    """``fit(stage_on_device=4)`` over 8 batches: two windows, one read
    each (the window's losses and rows together), rows at 1e-5 of JAX's
    scan; the rows' losses equal the losses the listeners see."""
    make = _graph if graph else _mlp
    jnet, pnet = _pair(make, graph)
    jtel_s, ptel_s = _session(jtel, 10), _session(ptel, 10)
    jreads, preads = _Reads(monkeypatch, jtel), _Reads(monkeypatch, ptel)
    jnet.set_telemetry(jtel_s)
    pnet.set_telemetry(ptel_s)
    scores = CollectScoresIterationListener()
    pnet.set_listeners(scores)
    data = _batches(8, seed=2)
    with jax.enable_x64(False):
        jnet.fit([JaxDataSet(x, y) for x, y in data], stage_on_device=4)
    pnet.fit([pt.DataSet(x, y) for x, y in data], stage_on_device=4)
    assert pnet.staged_steps_total == 8
    assert preads.calls == jreads.calls == 2
    _rows_close(preads.rows, jreads.rows)
    assert [r[0] for r in preads.rows] == [s for _, s in scores.scores]
    dispatches = [e for e in ptel_s.flight.events if e["kind"] == "staged_dispatch"]
    assert [(d["net"], d["steps"], d["batch"]) for d in dispatches] == [
        ("graph" if graph else "mln", 4, 8)] * 2


def test_staged_rows_equal_per_batch_rows_bit_for_bit(monkeypatch):
    """On the CPU the staged step is the per-batch step: the same rows."""
    a = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    b = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    reads = _Reads(monkeypatch, ptel)
    a.set_telemetry(_session(ptel, 4))
    b.set_telemetry(_session(ptel, 4))
    data = [pt.DataSet(x, y) for x, y in _batches(4, seed=3)]
    a.fit(data, stage_on_device=4)
    staged = list(reads.rows)
    reads.rows.clear()
    b.fit(data)
    assert staged == reads.rows and reads.calls == 2


def test_a_window_written_into_row_zero_is_caught(monkeypatch):
    """The wrong staged loop of the chip smoke: every step's vector into
    row 0. Its rows' losses no longer equal the window's losses."""
    net = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    net.set_telemetry(_session(ptel, 4))
    reads = _Reads(monkeypatch, ptel)
    monkeypatch.setattr(net, "_stats_rows", lambda rows: [rows[0]] * len(rows))
    xs = np.stack([x for x, _ in _batches(4, seed=4)])
    ys = np.stack([y for _, y in _batches(4, seed=4)])
    losses = net.fit_on_device(xs, ys)
    assert [r[0] for r in reads.rows] != losses.tolist()


def test_grad_norm_is_of_the_unscaled_gradients(monkeypatch):
    """``loss_scale=1024`` (a power of two: the unscale is exact) gives the
    rows of the unscaled run bit for bit; the norm of the scaled gradients
    would read 1024 times it."""
    plain = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    scaled = pt.MultiLayerNetwork(_mlp(pt, loss_scale=1024.0), device="cpu").init()
    reads = _Reads(monkeypatch, ptel)
    data = [pt.DataSet(x, y) for x, y in _batches(3, seed=5)]
    plain.set_telemetry(_session(ptel, 3)).fit(data)
    want = list(reads.rows)
    reads.rows.clear()
    scaled.set_telemetry(_session(ptel, 3)).fit(data)
    assert reads.rows == want
    loss = scaled.loss_fn(*_batches(1, seed=6)[0], train=True)
    grads = scaled._grads(loss, scaled._leaves())
    right = pdev.step_stats(loss, grads)
    wrong = pdev.step_stats(loss, [{k: g * 1024.0 for k, g in d.items()} for d in grads])
    assert float(wrong[1]) == pytest.approx(1024.0 * float(right[1]), rel=1e-6)


def test_tbptt_rows_carry_the_loss_alone(monkeypatch):
    conf = pt.char_rnn(7, 8, 1, tbptt_length=3)
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    reads = _Reads(monkeypatch, ptel)
    net.set_telemetry(_session(ptel, 100))
    rng = np.random.default_rng(7)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 8))]
    net.fit((x, x))
    assert net.iteration == 3 and reads.calls == 1
    assert [r[1:] for r in reads.rows] == [[0.0, 0.0]] * 3


def test_nan_batch_fires_the_watchdog_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv(pflight.FLIGHT_DIR_ENV, str(tmp_path))
    reg = ptel.MetricsRegistry()
    fr = ptel.FlightRecorder(registry=reg)
    wd = ptel.Watchdog(registry=reg, sinks=[], grad_norm_limit=1e6)
    net = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    net.set_telemetry(ptel.Telemetry(registry=reg, fetch_every=2, watchdog=wd,
                                     flight_recorder=fr))
    data = _batches(4, seed=8)
    data[2] = (np.full_like(data[2][0], np.nan), data[2][1])
    net.fit([pt.DataSet(x, y) for x, y in data])
    assert [(e.kind, e.iteration) for e in wd.events][0] == ("nan-loss", 3)
    assert fr.dumps and json.load(open(fr.dumps[0]))["reason"] == "nan-loss"


# ----------------------------------------------------------- memory report
def _jax_report(jnet, batch):
    with jax.enable_x64(False):
        return jnet.memory_report(batch)


def _equal_reports(p, j):
    assert p["model"] == j["model"] and p["dtype"] == j["dtype"] and p["remat"] == j["remat"]
    assert p["inputs"] == j["inputs"]
    assert p["totals"] == j["totals"]
    assert len(p["layers"]) == len(j["layers"])
    for pr, jr in zip(p["layers"], j["layers"]):
        assert pr == jr, (pr, jr)
    assert p["top_consumers"] == j["top_consumers"]
    assert json.dumps(p, sort_keys=True) == json.dumps(j, sort_keys=True)


def _jnet(cls, conf):
    with jax.enable_x64(False):
        net = cls(conf).init()
        net.init(params=_f32(net.params), force=True)
    return net


@pytest.mark.parametrize("batch", [16, "array"])
def test_memory_report_lenet_equals_jax(batch):
    jnet = _jnet(dj.MultiLayerNetwork, jax_lenet())
    pnet = pt.MultiLayerNetwork(pt.lenet_mnist_conf(), device="cpu").init()
    b = 16 if batch == 16 else np.zeros((4, 28, 28, 1), np.float32)
    _equal_reports(pnet.memory_report(b), _jax_report(jnet, b))


def test_memory_report_small_resnet_equals_jax():
    jconf = jres.resnet_conf([1, 1], image_size=(32, 32), num_classes=10)
    jnet = _jnet(dj.ComputationGraph, jconf)
    pnet = pt.ComputationGraph(pt.resnet_conf([1, 1], image_size=(32, 32), num_classes=10),
                               device="cpu").init()
    _equal_reports(pnet.memory_report(8), _jax_report(jnet, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memory_report_char_rnn_equals_jax(dtype):
    """The probe's 16 steps for an int batch, and a [4, 30, V] array."""
    jnet = _jnet(dj.MultiLayerNetwork, jax_char_rnn(11, 16, 2, dtype=dtype))
    pnet = pt.MultiLayerNetwork(pt.char_rnn(11, 16, 2, dtype=dtype), device="cpu").init()
    for b in (8, np.zeros((4, 30, 11), np.float32)):
        _equal_reports(pnet.memory_report(b), _jax_report(jnet, b))


def test_memory_report_graph_and_trained_state_equal_jax():
    """A two-input graph (LSTM, last step, merge) after a few updates: the
    optimizer totals come from the live state."""
    def conf(pkg):
        u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
        return (pkg.ComputationGraphConfiguration.builder().seed(3)
                .updater(u if pkg is dj else u.to_dict()).add_inputs("a", "s")
                .add_layer("d", pkg.DenseLayer(n_out=6, activation="relu"), "a")
                .add_layer("l", pkg.GravesLSTM(n_out=5), "s")
                .add_vertex("last", pkg.LastTimeStepVertex("s"), "l")
                .add_vertex("m", pkg.MergeVertex(), "d", "last")
                .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax",
                                                  loss="mcxent"), "m")
                .set_outputs("out")
                .set_input_types(pkg.InputType.feed_forward(4),
                                 pkg.InputType.recurrent(3)).build())

    jnet = _jnet(dj.ComputationGraph, conf(dj))
    pnet = pt.ComputationGraph(conf(pt), device="cpu").init()
    _equal_reports(pnet.memory_report(5), _jax_report(jnet, 5))
    rng = np.random.default_rng(9)
    xa, xs = rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=(5, 7, 3)).astype(
        np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    pnet.fit(pt.MultiDataSet([xa, xs], [y]))
    report = pnet.memory_report([xa, xs])
    assert report["totals"]["opt_state_bytes"] == sum(
        t.numel() * t.element_size() for t in pnet.updater_state_leaves())
    assert report["totals"]["param_bytes"] == sum(
        p.numel() * p.element_size() for p in pnet.parameters())
    _equal_reports(report, _jax_report(jnet, [xa, xs]))


def test_memory_report_allocates_nothing(monkeypatch):
    """The forward runs on meta tensors only: no tensor with storage is made
    on the net's device for the activations (a spy on the layers' apply)."""
    pnet = pt.MultiLayerNetwork(pt.lenet_mnist_conf(), device="cpu").init()
    seen = []
    for layer in pnet.conf.layers:
        real = type(layer).apply

        def spy(self, params, x, *a, _real=real, **kw):
            seen.append(x.device.type)
            return _real(self, params, x, *a, **kw)

        monkeypatch.setattr(type(layer), "apply", spy)
    pnet.memory_report(64)
    assert seen and set(seen) == {"meta"}
    assert pnet._updater is None and pnet._opt_state is None  # nothing built


# -------------------------------------------------------------- preflight
def test_preflight_raises_under_a_small_limit_and_reads_the_env(monkeypatch):
    pnet = pt.MultiLayerNetwork(pt.lenet_mnist_conf(), device="cpu").init()
    reg = ptel.MetricsRegistry()
    fr = ptel.FlightRecorder(registry=reg)
    with pytest.raises(ptel.MemoryPreflightError, match="biggest consumers") as err:
        pnet.preflight(512, limit_bytes=1 << 20, registry=reg, flight=fr)
    rep = err.value.report
    assert err.value.limit_bytes == 1 << 20 and "ir" not in rep
    assert err.value.projected_bytes == rep["totals"]["projected_peak_bytes"]
    assert rep["preflight"]["fits"] is False and rep["preflight"]["headroom"] == 0.9
    assert fr.last_memory_report is rep
    assert reg.get("dl4jtpu_projected_peak_hbm_bytes").value == err.value.projected_bytes
    ok = pnet.preflight(2, limit_bytes=1 << 34)
    assert ok["preflight"]["fits"] and "ir" not in ok
    monkeypatch.setenv(pmem.HBM_LIMIT_ENV, str(1 << 20))
    with pytest.raises(ptel.MemoryPreflightError, match="env DL4JTPU_HBM_LIMIT_BYTES"):
        pnet.preflight(512)
    jnet = _jnet(dj.MultiLayerNetwork, jax_lenet())
    with jax.enable_x64(False):
        with pytest.raises(jtel.MemoryPreflightError) as jerr:
            jnet.preflight(512)
    assert jerr.value.projected_bytes == pnet.memory_report(512)["totals"][
        "projected_peak_bytes"]
    with pytest.raises(NotImplementedError, match="item 9"):
        pnet.preflight(2, layout=object())


def test_device_memory_stats_empty_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    reg = ptel.MetricsRegistry()
    assert ptel.device_memory_stats(reg) == [] and ptel.sample_device_memory(reg) == []
    assert reg.get("dl4jtpu_device_hbm_bytes") is None
