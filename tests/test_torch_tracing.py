"""The port's request tracing (``telemetry/tracing.py``) and SLO monitor
(``telemetry/slo.py``) against the JAX package's.

The header codec is held byte for byte against JAX's for the same ids and
baggage; sampling at the same rates; the burn math against JAX's
``SLOMonitor`` on the same observations with an injected clock (the burn
rates are ratios of the same integer counts, so they are held exactly);
the inference path's ``infer.dispatch`` span and its capture count on a
warm request.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402
from deeplearning4j_tpu.telemetry import slo as jslo  # noqa: E402
from deeplearning4j_tpu.telemetry import tracing as jtr  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.runtime import compile_manager as pcm  # noqa: E402
from deeplearning4j_tpu_torch.serving import InferenceService  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import slo as pslo  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import tracing as ptr  # noqa: E402
from deeplearning4j_tpu_torch.telemetry.flight_recorder import get_flight_recorder  # noqa: E402

CONTEXTS = [
    dict(trace_id="0123456789abcdef0123456789abcdef", span_id="00000000deadbeef",
         sampled=True, baggage={}),
    dict(trace_id="f" * 32, span_id="1" * 16, sampled=False,
         baggage={"model": "char rnn", "version": "7", "a;b=c": "x/y%z", "é": "ü"}),
]


@pytest.mark.parametrize("ids", CONTEXTS, ids=["plain", "baggage"])
def test_header_bytes_equal_jax_s(ids):
    mine = ptr.TraceContext(**ids)
    theirs = jtr.TraceContext(**ids)
    assert mine.to_header().encode() == theirs.to_header().encode()
    back = ptr.TraceContext.from_header(theirs.to_header())
    jback = jtr.TraceContext.from_header(mine.to_header())
    assert (back.trace_id, back.span_id, back.sampled, back.baggage) == (
        jback.trace_id, jback.span_id, jback.sampled, jback.baggage)
    assert ptr.TRACE_HEADER == jtr.TRACE_HEADER


@pytest.mark.parametrize("raw", [None, "", "garbage", "a:b", ":x:1", "a::1", "a:b:1:2"])
def test_malformed_headers_read_as_none_in_both(raw):
    assert (ptr.TraceContext.from_header(raw) is None) == (
        jtr.TraceContext.from_header(raw) is None)
    assert ptr.TraceContext.from_header(raw) is None


def test_child_and_new_keep_jax_s_shape():
    root = ptr.TraceContext.new(sampled=True, baggage={"m": 1})
    child = root.child()
    assert len(root.trace_id) == 32 and len(root.span_id) == 16
    assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    assert child.span_id != root.span_id and child.baggage == {"m": "1"}
    ptr.set_default_baggage("version", "3")
    try:
        assert ptr.TraceContext.new(sampled=False).baggage == {"version": "3"}
    finally:
        ptr.set_default_baggage("version", None)


@pytest.mark.parametrize("raw", [None, "", "1", "0", "0.25", "1/256", "3/4", "1/0", "junk"])
def test_sample_rate_reads_the_env_as_jax_does(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv(ptr.TRACE_SAMPLE_ENV, raising=False)
    else:
        monkeypatch.setenv(ptr.TRACE_SAMPLE_ENV, raw)
    assert ptr.TRACE_SAMPLE_ENV == jtr.TRACE_SAMPLE_ENV
    assert ptr.sample_rate() == jtr.sample_rate()


def test_sampling_edges_are_deterministic():
    assert all(ptr.should_sample(1.0) for _ in range(50))
    assert not any(ptr.should_sample(0.0) for _ in range(50))
    assert not any(ptr.should_sample(-1.0) for _ in range(50))


def test_upgrade_flips_once_and_rings_the_flight_recorder():
    ctx = ptr.TraceContext.new(sampled=False)
    assert ctx.upgrade("shed:queue_depth") is True
    assert ctx.upgrade("again") is False and ctx.sampled
    events = [e for e in get_flight_recorder().events if e["kind"] == "trace_upgrade"]
    assert events[-1]["trace_id"] == ctx.trace_id and events[-1]["reason"] == "shed:queue_depth"


def test_spans_record_chrome_events_with_links():
    ring = ptr.get_trace_ring()
    root = ptr.TraceContext.new(sampled=True)
    with ptr.trace_span(root, "hop.a", links=[{"trace_id": "t", "span_id": "s"}], k=1) as sp:
        assert ptr.current_trace() is sp.ctx
        ptr.record_trace_event(sp.ctx.child(), "hop.b", duration_s=0.5)
    assert ptr.current_trace() is None
    spans = ring.spans_for(root.trace_id)
    assert [s["name"] for s in spans] == ["hop.b", "hop.a"]
    a = spans[1]
    assert a["ph"] == "X" and a["args"]["k"] == 1 and a["args"]["links"][0]["span_id"] == "s"
    assert a["args"]["parent_id"] == root.span_id and spans[0]["dur"] == 0.5e6
    with ptr.trace_span(ptr.TraceContext.new(sampled=False), "quiet") as sp:
        assert sp.ctx is None


def test_ring_is_bounded():
    ring = ptr.TraceRing(capacity=3)
    for i in range(5):
        ring.add({"args": {"trace_id": "t"}, "i": i})
    assert [e["i"] for e in ring.events] == [2, 3, 4] and ring.dropped == 2


# ----------------------------------------------------------------- SLOs
class _Dog:
    def __init__(self):
        self.emitted = []

    def emit(self, kind, iteration, value, threshold, message):
        self.emitted.append((kind, value, threshold))


def _monitors(**kw):
    mine = pslo.SLOMonitor(registry=MetricsRegistry(), watchdog=_Dog(), **kw)
    theirs = jslo.SLOMonitor(registry=JRegistry(), watchdog=_Dog(), **kw)
    for mon in (mine, theirs):
        mon.declare("m", latency_budget_ms=100.0, latency_target=0.99,
                    availability_target=0.999)
    return mine, theirs


SCENARIOS = {
    # 90 good over the slow window, then a burst of 10 bad in the fast one
    "burst": [dict(latency_s=0.05, now=1000.0 + i * 30.0) for i in range(90)]
    + [dict(latency_s=0.5, trace_id=f"t{i}", now=3900.0 + i) for i in range(10)],
    # a fast-window blip over a healthy hour: no breach
    "blip": [dict(latency_s=0.05, now=100.0 + i * 7.0) for i in range(500)]
    + [dict(latency_s=0.9, now=3595.0 + i) for i in range(5)],
    # 50% over budget for a full hour: a latency breach
    "sustained": [dict(latency_s=0.5 if i % 2 == 0 else 0.05,
                       trace_id=f"t{i}" if i % 2 == 0 else None, now=100.0 + i * 30.0)
                  for i in range(120)],
    # sheds and errors: an availability breach
    "availability": [dict(latency_s=0.01, now=1000.0 + i) for i in range(100)]
    + [dict(shed=i % 2 == 0, error=i % 2 == 1, trace_id=f"s{i}", now=1100.0 + i)
       for i in range(50)],
}
NOW = {"burst": 3910.0, "blip": 3600.0, "sustained": 100.0 + 119 * 30.0,
       "availability": 1150.0}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_burn_rates_and_breaches_equal_jax_s(name):
    mine, theirs = _monitors()
    for obs in SCENARIOS[name]:
        mine.observe("m", **obs)
        theirs.observe("m", **obs)
    now = NOW[name]
    assert mine.burn_rates("m", now=now) == theirs.burn_rates("m", now=now)
    fired, jfired = mine.evaluate(now=now), theirs.evaluate(now=now)
    strip = lambda fs: [{k: v for k, v in f.items() if k != "timestamp"} for f in fs]  # noqa: E731
    assert strip(fired) == strip(jfired)
    assert mine._watchdog.emitted == theirs._watchdog.emitted
    s, js = mine.stats(), theirs.stats()
    assert set(s) == set(js) and s["burn"] == js["burn"] and s["breaches_total"] == js[
        "breaches_total"]
    # rate limited: a second evaluation right away fires nothing
    assert mine.evaluate(now=now) == [] == theirs.evaluate(now=now)


def test_declare_from_env_and_the_global_monitor(monkeypatch):
    monkeypatch.setenv(pslo.SLO_LATENCY_BUDGET_ENV, "40")
    monkeypatch.setenv(pslo.SLO_LATENCY_TARGET_ENV, "0.95")
    mine, theirs = _monitors()
    mine.declare_from_env("x", latency_budget_ms=7.0)
    theirs.declare_from_env("x", latency_budget_ms=7.0)
    assert mine.objectives("x") == theirs.objectives("x") == {
        "latency_budget_ms": 40.0, "latency_target": 0.95, "availability_target": 0.999}
    prev = pslo.get_slo_monitor()
    try:
        pslo.set_slo_monitor(mine)
        assert pslo.get_slo_monitor() is mine
        pslo.set_slo_monitor(None)
        assert pslo.get_slo_monitor() is not mine
    finally:
        pslo.set_slo_monitor(prev)


def test_breach_rings_the_watchdog_sink_and_the_metrics():
    reg = MetricsRegistry()
    mon = pslo.SLOMonitor(registry=reg)
    mon.declare("m", latency_budget_ms=10.0)
    for obs in SCENARIOS["sustained"]:
        mon.observe("m", **obs)
    fired = mon.evaluate(now=NOW["sustained"])
    assert [f["objective"] for f in fired] == ["latency"]
    assert reg.get("dl4jtpu_slo_breaches_total").labels(
        model="m", objective="latency").value == 1
    assert reg.get("dl4jtpu_slo_burn_rate").labels(model="m", objective="latency").value > 14
    assert [e for e in get_flight_recorder().events if e["kind"] == "slo_burn"]


# ------------------------------------------------------ the served path
def _toy_net():
    conf = pt.MultiLayerConfiguration(
        layers=[pt.DenseLayer(n_out=16, activation="relu"),
                pt.OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.feed_forward(8), seed=7)
    return pt.MultiLayerNetwork(conf, device="cpu").init()


def test_traced_request_is_bit_exact_and_makes_no_capture(monkeypatch):
    monkeypatch.delenv("DL4JTPU_INFER", raising=False)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=0.0)
    try:
        svc.register("m", _toy_net())
        probe = np.linspace(-1, 1, 8, dtype=np.float32).reshape(1, 8)
        ref = svc.predict("m", probe)
        cm = pcm.get_compile_manager()
        c0 = cm.compiles.value
        ctx = ptr.TraceContext.new(sampled=True)
        with ptr.use_trace(ctx):
            traced = svc.predict("m", probe)
        assert np.array_equal(ref, traced) and cm.compiles.value == c0
        spans = ptr.get_trace_ring().spans_for(ctx.trace_id)
        dispatch = [s for s in spans if s["name"] == "infer.dispatch"]
        assert len(dispatch) == 1 and dispatch[0]["args"]["compiles"] == 0
        assert dispatch[0]["args"]["cache_hit"] is True
        assert {"serve.request", "serve.batch", "infer.dispatch"} <= {s["name"] for s in spans}
    finally:
        svc.stop()


def test_latency_exemplar_points_at_the_sampled_trace(monkeypatch):
    monkeypatch.delenv("DL4JTPU_INFER", raising=False)
    reg = MetricsRegistry()
    svc = InferenceService(registry=reg, max_delay_ms=0.0)
    try:
        svc.register("m", _toy_net())
        ctx = ptr.TraceContext.new(sampled=True)
        svc.predict("m", np.zeros((1, 8), np.float32), trace=ctx)
        assert f'trace_id="{ctx.trace_id}"' in reg.prometheus_text()
    finally:
        svc.stop()
