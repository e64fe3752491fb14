"""The port's streaming tier (``streaming/``) against the JAX package's.

Each check feeds the same record stream (numpy, from a seed) to both
packages and compares what comes out: the sources' deliveries and replay
spans, ``StreamingPipeline``'s micro-batches, its ``TrainRoute`` and
``ServeRoute`` on nets with the same weights (served outputs and params
after the updates at 1e-5, f32 on both sides, JAX with x64 off), the
device-prefetch flag (on the CPU: torch tensors handed to the routes), the
embedded broker's partitions, offsets, polls, seeks and commits, the gated
``KafkaSource`` and the loopback socket transport, each package's sink
feeding the other's source (one wire format).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu import streaming as jst  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import streaming as pst  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402

ATOL = 1e-5
PAIRS = [(jst, JRegistry), (pst, MetricsRegistry)]


@pytest.fixture(autouse=True)
def jax_legacy(monkeypatch):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)


def _records(n, seed=0, f=5, c=3, unlabelled_at=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=f).astype(np.float32)
        y = None if i in unlabelled_at else np.eye(c, dtype=np.float32)[int(rng.integers(c))]
        out.append((x, y))
    return out


class Collect:
    def __init__(self):
        self.batches = []

    def on_batch(self, features, labels):
        self.batches.append((features, labels))


def _wait(pred, seconds=15.0):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _pump(mod, reg, records, batch, **kw):
    src = mod.QueueSource()
    for x, y in records:
        src.put(x, y)
    route = Collect()
    pipe = mod.StreamingPipeline(src, [route], batch=batch, linger=0.05, registry=reg(), **kw)
    with pipe:
        _wait(lambda: sum(len(f) for f, _ in route.batches) >= len(records))
    return route.batches, pipe


def test_pipeline_micro_batches_match_jax():
    """Records queued before start, a labelled/unlabelled boundary and a
    short tail: the same micro-batches, in the same order."""
    records = _records(21, unlabelled_at=(9, 10))
    (jb, _), (pb, _) = (_pump(mod, reg, records, batch=4) for mod, reg in PAIRS)
    assert [(f.shape, l is None) for f, l in jb] == [(f.shape, l is None) for f, l in pb]
    for (jf, jl), (pf, pl) in zip(jb, pb):
        np.testing.assert_array_equal(pf, jf)
        if pl is not None:
            np.testing.assert_array_equal(pl, jl)
    assert sum(l is None for _, l in pb) == 1


def test_device_prefetch_hands_routes_tensors():
    records = _records(8)
    batches, pipe = _pump(pst, MetricsRegistry, records, batch=4, device_prefetch=True,
                          device="cpu")
    assert len(batches) == 2
    feats, labels = batches[0]
    assert isinstance(feats, torch.Tensor) and isinstance(labels, torch.Tensor)
    np.testing.assert_array_equal(feats.numpy(), np.stack([r[0] for r in records[:4]]))
    assert pipe._m_staged.value == 2


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _conf(pkg):
    u = pkg.UpdaterConfig(updater="sgd", learning_rate=0.1)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=8, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5), updater=u if pkg is dj else u.to_dict(),
        seed=3)


def test_train_and_serve_routes_match_jax():
    """The port's pipeline trains and serves each micro-batch as JAX's
    routes do on the same batches: served outputs and the params after
    three updates at 1e-5."""
    records = _records(24, seed=1)
    with jax.enable_x64(False):
        jnet = dj.MultiLayerNetwork(_conf(dj)).init()
        jnet.init(params=_f32(jnet.params), force=True)
        pnet = pt.load_jax_params(pt.MultiLayerNetwork(_conf(pt), device="cpu"), jnet.params)
        served = []
        src = pst.QueueSource()
        for x, y in records:
            src.put(x, y)
        train = pst.TrainRoute(pnet)
        pipe = pst.StreamingPipeline(
            src, [pst.ServeRoute(pnet, lambda x, y: served.append(y)), train], batch=8,
            linger=0.05, registry=MetricsRegistry())
        with pipe:
            assert _wait(lambda: train.batches_seen == 3)
        jserved = []
        jroutes = [jst.ServeRoute(jnet, lambda x, y: jserved.append(np.asarray(y))),
                   jst.TrainRoute(jnet)]
        for i in range(3):
            f = np.stack([r[0] for r in records[8 * i:8 * i + 8]])
            l = np.stack([r[1] for r in records[8 * i:8 * i + 8]])
            for route in jroutes:
                route.on_batch(f, l)
    assert len(served) == len(jserved) == 3
    for got, want in zip(served, jserved):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    jp = jax.tree_util.tree_leaves(jnet.params)
    pp = [layer[k] for layer in pnet._leaves() for k in sorted(layer)]
    for j, p in zip(jp, pp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=ATOL, rtol=ATOL)
    assert pnet.iteration == 3


def test_linger_flushes_a_short_batch_and_stop_drains():
    batches, _ = _pump(pst, MetricsRegistry, _records(5), batch=64)
    assert [f.shape[0] for f, _ in batches] == [5]


def test_replay_buffer_spans_match_jax():
    records = _records(12, seed=4)
    spans = []
    for mod, _ in PAIRS:
        q = mod.QueueSource()
        for x, y in records:
            q.put(x, y)
        src = mod.ReplayBufferSource(q, capacity=8)
        got = [src.poll(timeout=0.0) for _ in range(14)]
        assert sum(r is not None for r in got) == 12
        spans.append((src.replay_cursor(),
                      [[r[0].tolist() for r in src.replay(a, b)]
                       for a, b in ((0, 12), (3, 7), (10, 12), (12, 12))]))
    assert spans[0] == spans[1]
    assert spans[1][0] == 12 and len(spans[1][1][0]) == 8  # capacity: the oldest aged out


def test_embedded_broker_offsets_polls_and_commits_match_jax():
    trails = []
    for mod, _ in PAIRS:
        broker = mod.EmbeddedKafkaBroker(num_partitions=3)
        prod = mod.EmbeddedKafkaProducer(broker)
        trail = [(r.partition, r.offset) for r in
                 [prod.send("t", f"v{i}".encode(), key=b"k" if i % 3 == 0 else None)
                  for i in range(11)]]
        cons = mod.EmbeddedKafkaConsumer("t", broker=broker, group_id="g")
        for _ in range(3):
            batch = cons.poll(timeout_ms=0, max_records=4)
            trail.append(sorted((tp.partition, r.offset, r.value) for tp, rs in batch.items()
                                for r in rs))
        tps = cons.assignment()
        cons.commit()
        trail.append([(cons.position(tp), cons.committed(tp).offset) for tp in tps])
        cons.seek(tps[1], 1)
        trail.append(sorted((tp.partition, r.offset) for tp, rs in
                            cons.poll(timeout_ms=0, max_records=100).items() for r in rs))
        cons.seek_to_beginning(tps[0])
        trail.append(cons.position(tps[0]))
        trail.append([broker.end_offset(tp) for tp in broker.partitions_for("t")])
        cons.close()
        trails.append(trail)
    assert trails[0] == trails[1]


def test_kafka_source_gated_and_over_the_embedded_broker():
    def deser(raw):
        return np.frombuffer(raw, np.float32).copy(), None

    out = []
    for mod, _ in PAIRS:
        try:
            import kafka  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError, match="kafka"):
                mod.KafkaSource("topic", deserializer=deser)
        broker = mod.EmbeddedKafkaBroker(num_partitions=2)
        prod = mod.EmbeddedKafkaProducer(broker)
        for x, _ in _records(5, seed=2):
            prod.send("topic", x.tobytes())
        src = mod.KafkaSource("topic", deser, consumer_factory=lambda topic, **kw:
                              mod.EmbeddedKafkaConsumer(topic, broker=broker, **kw))
        got = [src.poll(timeout=0.0) for _ in range(6)]
        out.append([None if r is None else r[0].tolist() for r in got])
        src.close()
    assert out[0] == out[1]
    assert out[1][-1] is None and all(r is not None for r in out[1][:5])


@pytest.mark.parametrize("sink_pkg,source_pkg", [(pst, pst), (jst, pst), (pst, jst)],
                         ids=["port_to_port", "jax_sink_to_port", "port_sink_to_jax"])
def test_socket_transport_crosses_the_loopback(sink_pkg, source_pkg):
    """Labelled and unlabelled records cross a loopback TCP socket with
    shapes and values intact; either package's sink feeds either's
    source."""
    records = [(np.arange(6, dtype=np.float32).reshape(2, 3), np.ones(3, np.float32)),
               (np.full((4,), 7.0, np.float32), None)] + _records(3, seed=5)
    source = source_pkg.SocketRecordSource()
    try:
        sink_pkg.serve_records(source.host, source.port, records)
        got = []
        end = time.monotonic() + 10
        while len(got) < len(records) and time.monotonic() < end:
            rec = source.poll(timeout=0.05)
            if rec is not None:
                got.append(rec)
        assert len(got) == len(records)
        for (f, l), (gf, gl) in zip(records, got):
            np.testing.assert_array_equal(gf, f)
            assert (gl is None) == (l is None)
            if l is not None:
                np.testing.assert_array_equal(gl, l)
    finally:
        source.close()


def test_socket_source_close_returns_with_an_idle_producer():
    source = pst.SocketRecordSource()
    sink = pst.SocketRecordSink(source.host, source.port)
    try:
        sink.put(np.ones(2, np.float32))
        assert _wait(lambda: source.poll(timeout=0.05) is not None, 5)
        t0 = time.monotonic()
        source.close()
        assert time.monotonic() - t0 < 2.0
    finally:
        sink.close()
