"""The port's serving front (``serving/batcher.py``, ``serving/service.py``,
``serving/decode.py``) against the JAX package's (the batcher, service and
decode cases of ``tests/test_serving.py``; its HTTP class waits for the
port's ``ui/``, ROADMAP Queue 1 item 7).

The same config JSON builds a net in each package, the JAX net's f32
weights go to the port (``load_jax_params``), and the same numpy requests
go through both services. JAX's outputs come from its services and from
its unbucketed ``output`` (``DL4JTPU_INFER=legacy``). Tolerances: outputs
against JAX at ``ATOL`` (f32 on both sides, sums in another order); the
port's coalesced results against its own eager ``output`` bit for bit;
decode sessions against each session alone at ``DECODE_ATOL`` (the JAX
test's 1e-6). ``stats()`` keys and the ``dl4jtpu_serve_*`` metric names
are held equal to JAX's.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu import serving as jserving  # noqa: E402
from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import serving  # noqa: E402
from deeplearning4j_tpu_torch.runtime import compile_manager as pcm  # noqa: E402
from deeplearning4j_tpu_torch.runtime import inference as inf  # noqa: E402
from deeplearning4j_tpu_torch.serving import (AdmissionError, DecodeServer,  # noqa: E402
                                              InferenceService, MicroBatcher,
                                              ServiceDraining)
from deeplearning4j_tpu_torch.serving import decode as pdecode  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.telemetry.flight_recorder import get_flight_recorder  # noqa: E402
from deeplearning4j_tpu_torch.telemetry.tracing import (TraceContext, get_trace_ring,  # noqa: E402
                                                        use_trace)

ATOL = 1e-5
DECODE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    monkeypatch.delenv(inf.INFER_ENV, raising=False)
    monkeypatch.setenv("DL4JTPU_HISTORY", "0")
    monkeypatch.setenv("DL4JTPU_TUNED_PATH", str(tmp_path / "TUNED.json"))
    for name in ("DL4JTPU_SERVE_MAX_DELAY_MS", "DL4JTPU_SERVE_MAX_BATCH",
                 "DL4JTPU_SERVE_MAX_QUEUE", "DL4JTPU_SERVE_LATENCY_BUDGET_MS",
                 "DL4JTPU_SLO_LATENCY_BUDGET_MS"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def legacy(monkeypatch):
    def run(fn):
        monkeypatch.setenv(inf.INFER_ENV, "legacy")
        try:
            return fn()
        finally:
            monkeypatch.delenv(inf.INFER_ENV, raising=False)

    return run


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _mlp_conf(pkg, n_in=5, seed=7):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=16, activation="relu"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(n_in), seed=seed)


def _rnn_conf(pkg, n_in=6, seed=3):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.GravesLSTM(n_out=10),
                pkg.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(n_in), seed=seed)


def _pair(conf_fn, **kw):
    jnet = dj.MultiLayerNetwork(conf_fn(dj, **kw)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                device="cpu")
    pt.load_jax_params(pnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, pnet


def _fire(n, fn):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# --------------------------------------------------------------- batcher
def test_batcher_knobs_are_jax_s():
    assert serving.MAX_DELAY_ENV == jserving.MAX_DELAY_ENV
    assert serving.MAX_BATCH_ENV == jserving.MAX_BATCH_ENV
    assert serving.DECODE_SLOTS_ENV == jserving.DECODE_SLOTS_ENV
    assert (serving.LATENCY_BUDGET_ENV, serving.MAX_QUEUE_ENV) == (
        jserving.LATENCY_BUDGET_ENV, jserving.MAX_QUEUE_ENV)
    mine, theirs = MicroBatcher(lambda f: f), jserving.MicroBatcher(lambda f: f)
    try:
        assert (mine.max_delay_s, mine.max_batch) == (theirs.max_delay_s, theirs.max_batch)
    finally:
        mine.stop()
        theirs.stop()


def test_batcher_reads_the_environment(monkeypatch):
    monkeypatch.setenv("DL4JTPU_SERVE_MAX_DELAY_MS", "7")
    monkeypatch.setenv("DL4JTPU_SERVE_MAX_BATCH", "12")
    mb = MicroBatcher(lambda f: f)
    try:
        assert mb.max_delay_s == pytest.approx(0.007) and mb.max_batch == 12
    finally:
        mb.stop()


def test_batcher_coalesces_concurrent_requests():
    calls = []

    def dispatch(feats):
        calls.append(int(feats.shape[0]))
        return feats * 2.0

    mb = MicroBatcher(dispatch, max_delay_ms=50, max_batch=64)
    try:
        futs = [mb.submit(np.full((2, 3), float(i), np.float32)) for i in range(6)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=10), np.full((2, 3), 2.0 * i))
        assert len(calls) < 6 and sum(calls) == 12
    finally:
        mb.stop()


def test_batcher_row_cap_is_a_hard_ceiling():
    calls = []
    mb = MicroBatcher(lambda f: calls.append(int(f.shape[0])) or f, max_delay_ms=50,
                      max_batch=8)
    try:
        for f in [mb.submit(np.zeros((3, 2), np.float32)) for _ in range(5)]:
            f.result(timeout=10)
        assert max(calls) <= 8 and sum(calls) == 15
    finally:
        mb.stop()


def test_batcher_never_mixes_shapes():
    shapes = []
    mb = MicroBatcher(lambda f: shapes.append(f.shape[1:]) or f, max_delay_ms=30,
                      max_batch=64)
    try:
        for f in [mb.submit(np.zeros((1, d), np.float32)) for d in (3, 4, 3, 4, 3)]:
            f.result(timeout=10)
        assert set(shapes) == {(3,), (4,)}
    finally:
        mb.stop()


def test_batcher_error_rejects_only_its_batch():
    def dispatch(feats):
        if feats.shape[0] == 1:
            raise RuntimeError("boom")
        return feats

    mb = MicroBatcher(dispatch, max_delay_ms=0, max_batch=64)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            mb.submit(np.zeros((1, 2), np.float32)).result(timeout=10)
        assert mb.submit(np.zeros((2, 2), np.float32)).result(timeout=10).shape == (2, 2)
    finally:
        mb.stop()


def test_batcher_drain_and_stop():
    gate = threading.Event()
    mb = MicroBatcher(lambda f: gate.wait(10) and f, max_delay_ms=0, max_batch=4)
    fut = mb.submit(np.zeros((1, 2), np.float32))
    assert mb.drain(timeout_s=0.05) is False and mb.pending() == 1
    gate.set()
    assert mb.drain(timeout_s=10) is True and fut.result(timeout=10).shape == (1, 2)
    mb.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit(np.zeros((1, 2), np.float32))


def test_batcher_fan_in_links_every_member():
    mb = MicroBatcher(lambda f: f, max_delay_ms=500.0, max_batch=3)
    try:
        root = TraceContext.new(sampled=True)
        members = [root.child() for _ in range(3)]
        for f in [mb.submit(np.full((1, 2), i, np.float32), trace=m)
                  for i, m in enumerate(members)]:
            f.result(timeout=10)
    finally:
        mb.stop()
    spans = [s for s in get_trace_ring().spans_for(root.trace_id) if s["name"] == "serve.batch"]
    assert len(spans) == 1 and spans[0]["args"]["requests"] == 3
    assert {l["span_id"] for l in spans[0]["args"]["links"]} == {m.span_id for m in members}


# --------------------------------------------------------------- service
def test_coalesced_output_matches_jax_and_eager(rng, legacy):
    jnet, pnet = _pair(_mlp_conf)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=20)
    jsvc = jserving.InferenceService(registry=JRegistry(), max_delay_ms=20)
    try:
        svc.register("m", pnet)
        jsvc.register("m", jnet)
        xs = [rng.normal(size=(1 + i % 3, 5)).astype(np.float32) for i in range(10)]
        got, theirs = {}, {}

        def client(i):
            got[i] = svc.predict("m", xs[i], timeout_s=30)
            theirs[i] = jsvc.predict("m", xs[i], timeout_s=30)

        _fire(len(xs), client)
        assert svc.stats()["models"]["m"]["batches_total"] < len(xs)
        for i, x in enumerate(xs):
            np.testing.assert_allclose(got[i], np.asarray(theirs[i]), atol=ATOL)
            np.testing.assert_allclose(got[i], np.asarray(legacy(lambda: jnet.output(x))),
                                       atol=ATOL)
            np.testing.assert_array_equal(got[i], legacy(lambda: pnet.output(x)))
    finally:
        svc.stop()
        jsvc.stop()


def test_no_capture_after_warmup(rng):
    _, pnet = _pair(_mlp_conf, seed=13)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=5, max_batch=16)
    cm = pcm.get_compile_manager()
    try:
        svc.register("m", pnet)
        assert svc.warmup("m", np.zeros((1, 5), np.float32), argmax=True) == 5
        before = cm.compiles.value
        _fire(16, lambda i: svc.predict("m", rng.normal(size=(1 + i % 5, 5)).astype(
            np.float32), argmax=bool(i % 2)))
        assert cm.compiles.value - before == 0
    finally:
        svc.stop()


def test_stats_keys_and_metric_names_are_jax_s(rng):
    jnet, pnet = _pair(_mlp_conf, seed=17)
    reg, jreg = MetricsRegistry(), JRegistry()
    svc = InferenceService(registry=reg, max_delay_ms=1)
    jsvc = jserving.InferenceService(registry=jreg, max_delay_ms=1)
    try:
        svc.register("m", pnet)
        jsvc.register("m", jnet)
        for _ in range(4):
            x = rng.normal(size=(2, 5)).astype(np.float32)
            svc.predict("m", x)
            jsvc.predict("m", x)
        stats, jstats = svc.stats(), jsvc.stats()
        assert set(stats) == set(jstats)
        m, jm = stats["models"]["m"], jstats["models"]["m"]
        assert set(m) == set(jm)
        for k in ("latency_seconds", "batcher", "admission"):
            assert set(m[k]) == set(jm[k])
        assert m["requests_total"] == jm["requests_total"] == 4
        assert m["rows_total"] == jm["rows_total"] == 8
        assert 0 < m["mean_batch_fill_ratio"] <= 1.0
        assert m["latency_seconds"]["p50"] is not None and m["latency_seconds"]["p99"] is not None
        assert reg.get("dl4jtpu_serve_requests_total").labels(model="m").value == 4
        assert reg.get("dl4jtpu_serve_latency_seconds").labels(model="m").count == 4

        def serve_names(r):
            return {line.split(" ")[2] for line in r.prometheus_text().splitlines()
                    if line.startswith("# TYPE") and "dl4jtpu_serve_" in line}

        assert serve_names(reg) == serve_names(jreg)
    finally:
        svc.stop()
        jsvc.stop()


def test_serve_dispatch_flight_events(rng):
    _, pnet = _pair(_mlp_conf, seed=19)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=1)
    try:
        svc.register("m", pnet)
        svc.predict("m", rng.normal(size=(2, 5)).astype(np.float32))
        serve = [e for e in get_flight_recorder().snapshot(512)["events"]
                 if e["kind"] == "serve_dispatch"]
        assert serve and serve[-1]["model"] == "m" and serve[-1]["rows"] >= 2
    finally:
        svc.stop()


def test_argmax_requests_coalesce_on_their_own_batcher(rng, legacy):
    jnet, pnet = _pair(_mlp_conf, seed=23)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=25)
    try:
        svc.register("m", pnet)
        svc.warmup("m", np.zeros((1, 5), np.float32), argmax=True)
        xs = [rng.normal(size=(2, 5)).astype(np.float32) for _ in range(8)]
        outs = [None] * len(xs)

        def client(i):
            outs[i] = svc.predict("m", xs[i], argmax=True)

        _fire(len(xs), client)
        stats = svc.stats()["models"]["m"]
        assert stats["batches_total"] < len(xs)
        assert stats["last_dispatch"]["kind"] == "argmax"
        for x, out in zip(xs, outs):
            assert out.dtype == np.int32
            np.testing.assert_array_equal(
                out, np.asarray(legacy(lambda: jnet.output(x))).argmax(-1))
    finally:
        svc.stop()


def test_request_rows_histogram(rng):
    _, pnet = _pair(_mlp_conf, seed=29)
    reg = MetricsRegistry()
    svc = InferenceService(registry=reg, max_delay_ms=1)
    try:
        svc.register("m", pnet)
        for rows in (1, 2, 2, 5):
            svc.predict("m", rng.normal(size=(rows, 5)).astype(np.float32))
        svc.predict("m", rng.normal(size=(3, 5)).astype(np.float32), argmax=True)
        child = reg.get("dl4jtpu_serve_request_rows").labels(model="m")
        assert child.count == 5 and child.summary()["sum"] == 13
    finally:
        svc.stop()


def test_hot_swap_changes_outputs_without_a_capture(rng, legacy):
    """The train-to-serve handoff: the swap writes the new params into the
    served network in place; its entries serve them with no new entry."""
    _, net_a = _pair(_mlp_conf, seed=31)
    jnet_b, net_b = _pair(_mlp_conf, seed=37)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=1)
    cm = pcm.get_compile_manager()
    try:
        svc.register("m", net_a)
        svc.warmup("m", np.zeros((1, 5), np.float32))
        x = rng.normal(size=(3, 5)).astype(np.float32)
        out_a = svc.predict("m", x)
        before = cm.compiles.value
        svc.hot_swap("m", net=net_b, version=7)
        out_b = svc.predict("m", x)
        assert cm.compiles.value - before == 0
        assert np.abs(out_b - out_a).max() > 0
        np.testing.assert_allclose(out_b, np.asarray(legacy(lambda: jnet_b.output(x))),
                                   atol=ATOL)
        np.testing.assert_array_equal(out_b, legacy(lambda: net_b.output(x)))
        stats = svc.stats()["models"]["m"]
        assert stats["version"] == 7 and stats["swaps_total"] == 1
        events = [e for e in get_flight_recorder().events if e["kind"] == "serve_swap"]
        assert events and events[-1]["version"] == 7
        svc.hot_swap("m", params=jax.tree_util.tree_map(np.asarray, jnet_b.params))
        with pytest.raises(ValueError, match="shape"):
            svc.hot_swap("m", params=[{"W": np.zeros((2, 2)), "b": np.zeros(16)},
                                      {"W": np.zeros((16, 3)), "b": np.zeros(3)}])
        with pytest.raises(ValueError):
            svc.hot_swap("m")
    finally:
        svc.stop()


def test_models_share_the_lru(rng):
    _, a = _pair(_mlp_conf, seed=23)
    _, b = _pair(_mlp_conf, n_in=9, seed=29)
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=1)
    cm = pcm.get_compile_manager()
    try:
        svc.register("a", a)
        svc.register("b", b)
        svc.predict("a", rng.normal(size=(2, 5)).astype(np.float32))
        svc.predict("b", rng.normal(size=(2, 9)).astype(np.float32))
        assert cm.kinds(a._cm_token) == ["mln_infer"] == cm.kinds(b._cm_token)
        assert svc.stats()["compile_cache"]["entries"] == len(cm)
    finally:
        svc.stop()


def test_graph_models_serve_and_must_be_single_io(rng, legacy):
    conf = (dj.ComputationGraphConfiguration.builder().add_inputs("in")
            .add_layer("out", dj.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "in")
            .set_outputs("out").set_input_types(dj.InputType.feed_forward(4)).build())
    jnet = dj.ComputationGraph(conf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(conf.to_json()),
                               device="cpu")
    pt.load_jax_params(pnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    two = (pt.ComputationGraphConfiguration.builder().add_inputs("a", "b")
           .add_vertex("m", pt.MergeVertex(), "a", "b")
           .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "m")
           .set_outputs("out")
           .set_input_types(pt.InputType.feed_forward(2), pt.InputType.feed_forward(2)).build())
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=1)
    try:
        svc.register("g", pnet)
        x = rng.normal(size=(3, 4)).astype(np.float32)
        want = legacy(lambda: jnet.output(x))
        want = np.asarray(want[0] if isinstance(want, (list, tuple)) else want)
        np.testing.assert_allclose(svc.predict("g", x), want, atol=ATOL)
        with pytest.raises(ValueError, match="single-input"):
            svc.register("two", pt.ComputationGraph(two, device="cpu"))
    finally:
        svc.stop()


def test_admission_sheds_and_drain_refuses(rng):
    _, pnet = _pair(_mlp_conf, seed=41)
    reg = MetricsRegistry()
    svc = InferenceService(registry=reg, max_delay_ms=0)
    try:
        svc.register("m", pnet, max_queue_depth=1)
        entry = svc._entry("m")
        entry.batcher.queue_depth = lambda: 5  # look saturated
        ctx = TraceContext.new(sampled=False)
        with use_trace(ctx), pytest.raises(AdmissionError) as exc:
            svc.predict("m", np.zeros((1, 5), np.float32))
        assert exc.value.reason == "queue_depth" and exc.value.retry_after_s > 0
        assert ctx.sampled is True  # the shed upgraded the trace
        sheds = [s for s in get_trace_ring().spans_for(ctx.trace_id) if s["name"] == "serve.shed"]
        assert len(sheds) == 1
        assert reg.get("dl4jtpu_serve_shed_total").labels(
            model="m", reason="queue_depth").value == 1
        assert svc.stats()["models"]["m"]["admission"]["shed_total"] == 1
        assert svc.drain(timeout_s=5) is True and svc.draining
        with pytest.raises(ServiceDraining):
            svc.predict("m", np.zeros((1, 5), np.float32))
    finally:
        svc.stop()


def test_admission_knobs_from_the_environment(monkeypatch):
    _, pnet = _pair(_mlp_conf, seed=43)
    monkeypatch.setenv("DL4JTPU_SERVE_MAX_QUEUE", "9")
    monkeypatch.setenv("DL4JTPU_SERVE_LATENCY_BUDGET_MS", "250")
    monkeypatch.setenv("DL4JTPU_SERVE_MAX_BATCH", "32")
    svc = InferenceService(registry=MetricsRegistry(), max_delay_ms=3)
    try:
        svc.register("m", pnet)
        m = svc.stats()["models"]["m"]
        assert m["admission"]["max_queue_depth"] == 9
        assert m["admission"]["latency_budget_ms"] == 250.0
        assert m["batcher"] == {"max_delay_ms": 3.0, "max_batch": 32}
        svc.register("n", pnet, max_queue_depth=0, max_batch=4)  # 0 disables
        n = svc.stats()["models"]["n"]
        assert n["admission"]["max_queue_depth"] is None and n["batcher"]["max_batch"] == 4
        with pytest.raises(NotImplementedError, match="item 8"):
            svc.register("l", pnet, layout=object())
    finally:
        svc.stop()


def test_named_service_registry():
    serving.reset_services()
    try:
        default = serving.get_service()
        assert serving.get_service() is default
        edge = serving.get_service("edge")
        assert edge is not default and serving.service_names() == ["default", "edge"]
        mine = InferenceService(registry=MetricsRegistry())
        serving.set_service(mine, "edge")
        assert serving.get_service("edge") is mine
        serving.set_service(None, "edge")
        assert serving.service_names() == ["default"]
    finally:
        serving.reset_services()
    assert serving.service_names() == []
    with pytest.raises(KeyError):
        InferenceService(registry=MetricsRegistry()).predict("nope", np.zeros((1, 2)))


# ---------------------------------------------------------------- decode
def _solo(pnet, steps):
    solo = pt.MultiLayerNetwork(pnet.conf, device="cpu").init(
        params=[{k: v.detach().clone() for k, v in d.items()} for d in pnet._leaves()])
    solo.rnn_clear_previous_state()
    return [solo.rnn_time_step(s[None, :])[0] for s in steps]


def test_interleaved_sessions_match_solo_runs(rng, legacy):
    jnet, pnet = _pair(_rnn_conf, seed=31)
    batches, requests = [], []
    dec = DecodeServer(pnet, capacity=4, max_delay_ms=30,
                       on_batch=lambda **kw: batches.append(kw),
                       on_request=lambda s, t=None: requests.append(s))
    try:
        s1, s2 = dec.open(), dec.open()
        steps = {s1: [rng.normal(size=(6,)).astype(np.float32) for _ in range(4)],
                 s2: [rng.normal(size=(6,)).astype(np.float32) for _ in range(4)]}
        outs = {s1: [], s2: []}

        def run(i):
            sid = (s1, s2)[i]
            for s in steps[sid]:
                outs[sid].append(dec.step(sid, s, timeout_s=30))

        _fire(2, run)
    finally:
        dec.stop()
    assert len(requests) == 8 and sum(b["rows"] for b in batches) == 8
    assert all(b["bucket_rows"] == 4 for b in batches)
    assert set(pcm.get_compile_manager().kinds(pnet._cm_token)) == {"mln_rnn_step"}
    for sid in (s1, s2):
        for got, want in zip(outs[sid], legacy(lambda: _solo(pnet, steps[sid]))):
            np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_ATOL)

        def jax_solo():
            jnet.rnn_clear_previous_state()
            return [np.asarray(jnet.rnn_time_step(s[None, :]))[0] for s in steps[sid]]

        for got, want in zip(outs[sid], legacy(jax_solo)):
            np.testing.assert_allclose(got, want, atol=ATOL)


def test_slot_reuse_resets_state(rng):
    _, pnet = _pair(_rnn_conf, seed=37)
    dec = DecodeServer(pnet, capacity=2, max_delay_ms=0)
    try:
        x = rng.normal(size=(6,)).astype(np.float32)
        s1 = dec.open()
        first = dec.step(s1, x, timeout_s=30)
        dec.step(s1, x, timeout_s=30)  # the state moves on
        dec.close(s1)
        s2 = dec.open()  # the same slot, zeroed in the graph's buffers
        np.testing.assert_allclose(dec.step(s2, x, timeout_s=30), first, rtol=0,
                                   atol=DECODE_ATOL)
    finally:
        dec.stop()


def test_a_reset_that_rebinds_the_state_is_caught(rng, monkeypatch):
    """The wrong version: the slot reset zeroes a copy and rebinds the
    net's state to it (the JAX package's host round trip); the tick goes on
    from the graph's buffers, so the reused slot starts from the old
    session's state."""
    _, pnet = _pair(_rnn_conf, seed=38)

    def rebinding_reset(self, slot):
        with self._net_lock:
            if self.net._rnn_state is None:
                return
            fresh = tuple({k: v.clone() for k, v in d.items()} for d in self.net._rnn_state)
            for t in pdecode._state_tensors(fresh):
                t[slot].zero_()
            self.net._rnn_state = fresh

    monkeypatch.setattr(DecodeServer, "_reset_slot", rebinding_reset)
    dec = DecodeServer(pnet, capacity=2, max_delay_ms=0)
    try:
        x = rng.normal(size=(6,)).astype(np.float32)
        s1 = dec.open()
        first = dec.step(s1, x, timeout_s=30)
        dec.step(s1, x, timeout_s=30)
        dec.close(s1)
        s2 = dec.open()
        assert np.abs(dec.step(s2, x, timeout_s=30) - first).max() > 1e-4
    finally:
        dec.stop()


def test_capacity_exhaustion_raises():
    _, pnet = _pair(_rnn_conf, seed=41)
    dec = DecodeServer(pnet, capacity=1, max_delay_ms=0)
    try:
        dec.open()
        with pytest.raises(RuntimeError, match="slots"):
            dec.open()
    finally:
        dec.stop()


def test_decode_traces_one_lineage_per_session(rng):
    _, pnet = _pair(_rnn_conf, seed=43)
    dec = DecodeServer(pnet, capacity=2, max_delay_ms=0)
    try:
        root = TraceContext.new(sampled=True)
        sid = dec.open(trace=root)
        for _ in range(3):
            dec.step(sid, rng.normal(size=(6,)).astype(np.float32), timeout_s=30)
    finally:
        dec.stop()
    spans = get_trace_ring().spans_for(root.trace_id)
    names = [s["name"] for s in spans]
    assert names.count("decode.open") == 1 and names.count("decode.tick") == 3
    session = next(s for s in spans if s["name"] == "decode.open")["args"]["span_id"]
    assert all(s["args"]["parent_id"] == session for s in spans if s["name"] == "decode.tick")


def test_service_decoder_records_decode_batches(rng):
    _, pnet = _pair(_rnn_conf, seed=47)
    reg = MetricsRegistry()
    svc = InferenceService(registry=reg, max_delay_ms=0)
    try:
        svc.register("r", pnet)
        dec = svc.decoder("r")
        assert svc.decoder("r") is dec
        sid = dec.open()
        for _ in range(3):
            dec.step(sid, rng.normal(size=(6,)).astype(np.float32), timeout_s=30)
        m = svc.stats()["models"]["r"]
        assert m["decode_sessions"] == 1 and m["requests_total"] == 3
        assert m["last_dispatch"]["kind"] == "decode"
    finally:
        svc.stop()
