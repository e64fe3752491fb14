"""The port's metric history (``telemetry/history.py``) against the JAX
package's, and its hook into the port's ``InferenceService``.

The same ingest sequence, at fixed injected ``now`` (no threads, no
sleeps), goes into a JAX and a port ``HistoryStore``, each over its own
registry: gauges, counters as rates (a reset included), histogram
snapshots as p50/p99 series, stale gaps, annotations, registry snapshots
and Prometheus text; then ``query`` (raw, resampled, every aggregation,
rollup ranges), ``http_query``, ``stats`` and ``parse_prometheus_text``
must return the same values. ``Forecast`` runs the same ramp in both.
The service starts the process-wide sampler, which ``DL4JTPU_HISTORY=0``
turns off.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from deeplearning4j_tpu.telemetry import history as jhist  # noqa: E402
from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JRegistry  # noqa: E402

from deeplearning4j_tpu_torch.serving import InferenceService  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import history as phist  # noqa: E402
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry  # noqa: E402

T0 = 1_700_000_000.0
PAIRS = [(jhist, JRegistry), (phist, MetricsRegistry)]

PROM = (
    "# HELP dl4jtpu_serve_requests_total req\n"
    "# TYPE dl4jtpu_serve_requests_total counter\n"
    'dl4jtpu_serve_requests_total{model="m"} 100\n'
    "# TYPE dl4jtpu_serve_queue_depth gauge\n"
    "dl4jtpu_serve_queue_depth 3\n"
    "# TYPE dl4jtpu_serve_latency_seconds histogram\n"
    'dl4jtpu_serve_latency_seconds_bucket{le="0.1"} 5\n'
    'dl4jtpu_serve_latency_seconds_bucket{le="0.5"} 9\n'
    'dl4jtpu_serve_latency_seconds_bucket{le="+Inf"} 10\n'
    "dl4jtpu_serve_latency_seconds_sum 1.5\n"
    "dl4jtpu_serve_latency_seconds_count 10\n"
    'odd_metric{a="x\\"y",b="1"} NaN\n')


def _drive(mod, reg_cls):
    """One scripted ingest sequence into a fresh store; returns the store
    and every query result along the way."""
    reg = reg_cls()
    st = mod.HistoryStore(reg)
    rng = np.random.default_rng(0)
    out = []
    lab = {"worker": "0", "model": "m"}
    for i in range(400):
        t = T0 + 2.5 * i
        out.append(st.record_gauge("q.depth", float(rng.integers(0, 9)), lab, now=t))
        c = 10.0 * i if i != 200 else 3.0  # a counter reset
        out.append(st.record_counter("req.rate", c, {"model": "m"}, now=t))
        cum = np.cumsum(rng.integers(0, 5, 4)) + 4 * i
        out.append(st.record_histogram(
            "lat", {"0.1": float(cum[0]), "0.5": float(cum[1]), "1.0": float(cum[2]),
                    "+Inf": float(cum[3])}, {"model": "m"}, now=t))
    out.append(st.mark_stale({"worker": "0"}, now=T0 + 1001))
    out.append(st.mark_stale({"worker": "0"}, now=T0 + 1002))
    st.record_gauge("q.depth", 5.0, lab, now=T0 + 1010)
    st.annotate("rollout", now=T0 + 500, record_flight=False, version=2)
    st.annotate("respawn", now=T0 + 1005, record_flight=False)
    src = reg_cls()
    src.counter("dl4jtpu_t_total", "h", labelnames=("model",)).labels(model="m").inc(10)
    src.gauge("dl4jtpu_t_depth", "h").set(3)
    src.histogram("dl4jtpu_t_seconds", "h", buckets=(0.1, 1.0)).observe(0.05)
    out.append(st.ingest_snapshot(src.snapshot(), extra_labels={"worker": "9"}, now=T0 + 1011))
    src.get("dl4jtpu_t_total").labels(model="m").inc(5)
    src.get("dl4jtpu_t_seconds").observe(0.5)
    out.append(st.ingest_snapshot(src.snapshot(), extra_labels={"worker": "9"}, now=T0 + 1013))
    out.append(st.ingest_prometheus(PROM, extra_labels={"worker": "1"}, now=T0 + 1014))
    out.append(st.ingest_prometheus(PROM.replace(" 100", " 160").replace('"} 5', '"} 8'),
                                    extra_labels={"worker": "1"}, now=T0 + 1016))
    now = T0 + 1020
    for kw in ({}, {"select": "q.depth", "range_s": 60},
               {"select": ["req.rate", "lat:*"], "range_s": 3600, "step": 60.0},
               {"select": "lat:p99", "start": T0, "end": T0 + 900, "step": 300.0, "agg": "max"},
               {"labels": {"worker": "9"}, "range_s": 30},
               {"select": "q.*", "range_s": 86400, "step": 600.0, "agg": "last"},
               {"select": "nothing", "range_s": 60}):
        for agg in (("mean", "min", "max", "last", "sum") if "step" in kw and "agg" not in kw
                    else (kw.get("agg", "mean"),)):
            out.append(st.query(now=now, **{**kw, "agg": agg}))
    out.append(st.http_query({"series": "q.*,req.rate", "worker": "0", "range_s": "600",
                              "step": "30", "agg": "max", "now": str(now)}))
    out.append(st.annotations(start=T0, end=T0 + 800))
    out.append(sorted(st.series_names()))
    out.append(st.stats())
    out.append(st.bytes_estimate())
    return st, out


def test_store_ingest_and_queries_match_jax():
    (_, jout), (_, pout) = (_drive(mod, reg) for mod, reg in PAIRS)
    assert len(jout) == len(pout)
    for i, (a, b) in enumerate(zip(jout, pout)):
        assert repr(a) == repr(b), f"step {i}"


def test_query_errors_and_bounds_match_jax():
    for mod, reg in PAIRS:
        st = mod.HistoryStore(reg(), max_series=4)
        for i in range(6):
            st.record_gauge(f"g{i}", 1.0, now=T0 + i)
        assert len(st.series_names()) == 4 and st.stats()["evicted_total"] == 2
        with pytest.raises(ValueError):
            st.query(agg="median", now=T0)
        with pytest.raises(ValueError):
            st.query(step=0.0, now=T0)
        with pytest.raises(ValueError):
            st.http_query({"agg": "p50"})


def test_soak_stays_within_the_byte_budget():
    regs = []
    for mod, reg in PAIRS:
        r = reg()
        st = mod.HistoryStore(r)
        for i in range(200):
            for k in range(60):
                st.record_gauge(f"s{i}", float(k), {"w": str(i % 7)}, now=T0 + k)
        assert st.bytes_estimate() <= st.byte_budget
        st._update_footprint()  # what ingest_* calls
        regs.append((st.bytes_estimate(), st.byte_budget,
                     r.snapshot()["dl4jtpu_history_bytes"]["values"][0]["value"]))
    assert regs[0] == regs[1]


def test_parse_prometheus_text_matches_jax():
    assert repr(jhist.parse_prometheus_text(PROM)) == repr(phist.parse_prometheus_text(PROM))
    reg = MetricsRegistry()
    reg.counter("dl4jtpu_x_total", "h", labelnames=("k",)).labels(k='a"b').inc(2)
    reg.histogram("dl4jtpu_y_seconds", "h", buckets=(0.1, 1.0)).observe(0.3)
    text = reg.prometheus_text()
    assert repr(jhist.parse_prometheus_text(text)) == repr(phist.parse_prometheus_text(text))


def test_forecast_matches_jax():
    outs = []
    for mod, _ in PAIRS:
        ewma, holt = mod.Forecast(0.5, 0.0), mod.Forecast(0.5, 0.3)
        for i, dt in enumerate((1.0, 2.0, 0.5, 3.0, 1.0, 1.0, 0.0, 2.0)):
            t = T0 + 10 * i + dt
            for f in (ewma, holt):
                f.update(3.0 + 0.25 * t - 0.25 * T0, t)
        outs.append([(f.level, f.trend, f.n, f.forecast(60.0)) for f in (ewma, holt)])
    assert outs[0] == outs[1]
    assert phist.Forecast().forecast(10.0) is None


def test_sampler_tick_matches_jax():
    outs = []
    for mod, reg_cls in PAIRS:
        reg = reg_cls()
        reg.counter("dl4jtpu_t_total", "h").inc(10)
        reg.gauge("dl4jtpu_t_depth", "h").set(3)
        st = mod.HistoryStore(reg)
        sampler = mod.HistorySampler(reg, st, interval_s=60.0, site="test.sampler")
        rows = [sampler.tick(now=T0)]
        reg.get("dl4jtpu_t_total").inc(10)
        rows.append(sampler.tick(now=T0 + 2))
        sampler.pause()
        paused = sampler.paused
        sampler.resume()
        outs.append((rows, st.query(select="dl4jtpu_t_*", range_s=60, now=T0 + 2),
                     sampler.stats(), paused, sampler.paused))
    assert repr(outs[0]) == repr(outs[1])
    assert outs[1][1]["series"][0]["points"] == [[T0 + 2, 5.0]] or \
        outs[1][1]["series"][1]["points"] == [[T0 + 2, 5.0]]


@pytest.fixture
def no_default_sampler():
    old = phist.get_default_sampler()
    phist.set_default_sampler(None)
    yield
    s = phist.get_default_sampler()
    if s is not None and s is not old:
        s.stop()
    phist.set_default_sampler(old)


def test_service_starts_the_default_sampler(monkeypatch, no_default_sampler):
    monkeypatch.delenv("DL4JTPU_HISTORY", raising=False)
    monkeypatch.setenv("DL4JTPU_HISTORY_INTERVAL_S", "30")
    svc = InferenceService(registry=MetricsRegistry())
    try:
        sampler = phist.get_default_sampler()
        assert sampler is not None and sampler._thread.is_alive()
        assert sampler.interval_s == 30.0
        InferenceService(registry=MetricsRegistry()).stop()
        assert phist.get_default_sampler() is sampler  # idempotent
        assert phist.ensure_default_sampler() is sampler
    finally:
        svc.stop()


def test_history_off_starts_no_sampler(monkeypatch, no_default_sampler):
    monkeypatch.setenv("DL4JTPU_HISTORY", "0")
    assert phist.history_enabled() is jhist.history_enabled() is False
    svc = InferenceService(registry=MetricsRegistry())
    try:
        assert phist.get_default_sampler() is None
        assert phist.ensure_default_sampler() is None
    finally:
        svc.stop()


def test_event_kind_is_registered():
    from deeplearning4j_tpu_torch.telemetry import flight_recorder

    assert "history_annotation" in flight_recorder.registered_event_kinds()
