"""The PyTorch port's recurrent ComputationGraph against the JAX package:
graph TBPTT, ``rnn_time_step`` and ``DecodeServer`` over a graph (the
counterpart of ``tests/test_graph.py``'s ``TestGraphRecurrent``).

The same conf JSON builds each graph in both packages, the JAX graph's
params go to the port (``load_jax_params``) and the same numpy inputs, made
from a seed, go through both. Training compares every update's loss and the
params after it (a listener snapshots both), with the JAX side under x64
off (Adam's bias corrections, as ``test_torch_adam.py`` explains).
Streaming holds the port to the JAX package's legacy stream
(``DL4JTPU_INFER=legacy``). Tolerances: f32 1e-5 (sums in another order),
params relative to their size; bf16 losses 2e-2 relative and params 2e-3
(the packages round bf16 at other places), as
``test_torch_char_rnn_training.py`` holds them.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import MultiDataSet as JaxMultiDataSet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402

ATOL = RTOL = 1e-5
BF16_LOSS_RTOL, BF16_PARAM_ATOL = 2e-2, 2e-3
V, H, B = 8, 16, 4


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _host(tree):
    return {n: {k: np.asarray(v, np.float32) for k, v in p.items()} for n, p in tree.items()}


class Snapshots:
    """Listener on either package's graph: each update's loss and the
    params after it, as host f32 arrays by vertex name."""

    def __init__(self):
        self.losses, self.params = [], []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))
        self.params.append(pt.params_to_numpy(model) if isinstance(model, pt.ComputationGraph)
                           else _host(model.params))


def char_graph_conf(T=20, back=None, dtype="float32", updater="adam", lr=0.05):
    """TestGraphRecurrent's graph: in -> GravesLSTM -> RnnOutputLayer,
    TBPTT(5)."""
    return (dj.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .set_input_types(dj.InputType.recurrent(V, T))
            .add_layer("lstm", dj.GravesLSTM(n_out=H, activation="tanh"), "in")
            .add_layer("out", dj.RnnOutputLayer(n_out=V, activation="softmax",
                                                loss="mcxent"), "lstm")
            .set_outputs("out")
            .updater(dj.UpdaterConfig(updater=updater, learning_rate=lr))
            .tbptt(5, back)
            .dtype(dtype)
            .seed(3)
            .build())


def char_data(T=20, batch=B, seed=0):
    """TestGraphRecurrent's data: one-hot next-char sequences of a cycle."""
    rng = np.random.default_rng(seed)
    seq = np.tile(np.arange(V), 10)
    x = np.zeros((batch, T, V), np.float32)
    y = np.zeros((batch, T, V), np.float32)
    for b in range(batch):
        s = rng.integers(0, V)
        ids = seq[s:s + T + 1]
        x[b, np.arange(T), ids[:-1]] = 1
        y[b, np.arange(T), ids[1:]] = 1
    return x, y


def pair(jconf, state=False):
    """(JAX graph, port graph on the CPU) with the JAX graph's f32 params
    (and f32 layer state) in both, a Snapshots listener on each."""
    jnet = dj.ComputationGraph(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jconf.to_json()),
                               device="cpu")
    pt.load_jax_params(pnet, _host(jnet.params), _host(jnet.state) if state else None)
    for net in (jnet, pnet):
        net.set_listeners(Snapshots())
    return jnet, pnet


def assert_same_training(jnet, pnet, updates, dtype="float32"):
    js, ps = jnet.listeners[0], pnet.listeners[0]
    assert len(js.losses) == len(ps.losses) == updates == jnet.iteration == pnet.iteration
    if dtype == "float32":
        np.testing.assert_allclose(ps.losses, js.losses, rtol=RTOL, atol=ATOL, err_msg="losses")
    else:
        np.testing.assert_allclose(ps.losses, js.losses, rtol=BF16_LOSS_RTOL, err_msg="losses")
    for i, (jp, pp) in enumerate(zip(js.params, ps.params)):
        assert set(jp) == set(pp)
        for name in jp:
            for k, want in jp[name].items():
                scale = max(float(np.abs(want).max()), 1.0)
                atol = ATOL * scale if dtype == "float32" else BF16_PARAM_ATOL
                np.testing.assert_allclose(pp[name][k], want, rtol=0, atol=atol,
                                           err_msg=f"update {i + 1}: {name} {k}")


# ------------------------------------------------------------------ TBPTT
# TestGraphRecurrent's Adam in f32; SGD in bf16, where Adam turns a gradient
# near 0 whose sign the two packages' bf16 roundings disagree on into a
# whole step of lr apart
TBPTT_UPDATERS = {"float32": ("adam", 0.05), "bfloat16": ("sgd", 0.1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,updates", [(20, 4), (13, 3)], ids=["T20_four", "T13_five_five_three"])
def test_tbptt_updates_per_segment_match_jax(T, updates, dtype):
    """T=20 with segments of 5 gives 4 updates; T=13 gives 5, 5 and a
    3-step tail. Each update's loss and the params after it match JAX's
    graph (f32 master params in both dtypes)."""
    updater, lr = TBPTT_UPDATERS[dtype]
    jnet, pnet = pair(char_graph_conf(T=T, dtype=dtype, updater=updater, lr=lr))
    x, y = char_data(T=T)
    with jax.enable_x64(False):
        jnet.fit(JaxDataSet(x, y))
    pnet.fit(pt.DataSet(x, y))
    assert_same_training(jnet, pnet, updates, dtype)
    for p in pnet.vertex_params.values():
        assert all(v.dtype == torch.float32 for v in p.values())


def test_tbptt_trains_and_streams_like_the_full_forward():
    """TestGraphRecurrent's first case on the port: 4 updates a batch, the
    score halves over 30 more batches, then one step at a time through
    ``rnn_time_step`` equals ``output``; ``fit`` never leaves h/c in the
    streaming state."""
    _, net = pair(char_graph_conf())
    x, y = char_data()
    net.fit(pt.DataSet(x, y))
    assert net.iteration == 4
    assert net.rnn_get_previous_state("lstm") is None
    first = net.score(pt.DataSet(x, y))
    for _ in range(30):
        net.fit(pt.DataSet(x, y))
    assert net.score(pt.DataSet(x, y)) < first * 0.5
    full = net.output(x)
    net.rnn_clear_previous_state()
    for t in range(x.shape[1]):
        np.testing.assert_allclose(net.rnn_time_step(x[:, t]), full[:, t], rtol=1e-5,
                                   atol=1e-6)
    assert set(net.rnn_get_previous_state("lstm")) == {"h", "c"}
    assert net.rnn_get_previous_state("out") is None
    net.fit(pt.DataSet(x, y))  # training leaves the stream where it was
    assert net.rnn_get_previous_state("lstm") is not None
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state("lstm") is None


def test_tbptt_back_length_prefix_labels_carry_no_gradient():
    """tbptt_back_length 2 < 5: garbage labels on each segment's first 3
    steps leave the params bit for bit the same; the run matches JAX's."""
    x, y = char_data(T=10, seed=3)
    garbage = y.copy()
    rng = np.random.default_rng(5)
    for t in (0, 1, 2, 5, 6, 7):
        garbage[:, t] = np.eye(V, dtype=np.float32)[rng.integers(0, V, size=B)]

    def train(labels):
        jnet, pnet = pair(char_graph_conf(T=10, back=2))
        with jax.enable_x64(False):
            jnet.fit(JaxDataSet(x, labels))
        pnet.fit(pt.DataSet(x, labels))
        assert_same_training(jnet, pnet, 2)
        return pt.params_to_numpy(pnet)

    pa, pb = train(y), train(garbage)
    for name in pa:
        for k in pa[name]:
            np.testing.assert_array_equal(pa[name][k], pb[name][k])


def test_tbptt_needs_one_shared_length():
    jconf = char_graph_conf(T=None)
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jconf.to_json()),
                               device="cpu")
    x, _ = char_data(T=10)
    y, _ = char_data(T=8)
    jnet = dj.ComputationGraph(jconf).init()
    with pytest.raises(ValueError, match="one shared sequence length") as jerr:
        jnet.fit(JaxDataSet(x, y))
    with pytest.raises(ValueError, match="one shared sequence length") as perr:
        pnet.fit(pt.DataSet(x, y))
    assert str(perr.value) == str(jerr.value)


F_S, F_A, T2 = 5, 3, 12


def branch_conf(dtype="float32"):
    """Two GravesLSTMs on one masked sequence input, merged with a
    BatchNormalization of a dense input repeated over time, then a per-step
    head: TBPTT(5) threads both LSTMs' h/c and the BN state segment to
    segment (the dense input goes whole into every segment)."""
    return (dj.ComputationGraphConfiguration.builder()
            .add_inputs("s", "a")
            .set_input_types(dj.InputType.recurrent(F_S, T2), dj.InputType.feed_forward(F_A))
            .add_layer("lstm1", dj.GravesLSTM(n_out=6, activation="tanh"), "s")
            .add_layer("lstm2", dj.GravesLSTM(n_out=4, activation="softsign"), "s")
            .add_layer("bn", dj.BatchNormalization(), "a")
            .add_vertex("dup", dj.DuplicateToTimeSeriesVertex(ts_input="s"), "bn")
            .add_vertex("merge", dj.MergeVertex(), "lstm1", "lstm2", "dup")
            .add_layer("out", dj.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "merge")
            .set_outputs("out")
            .updater(dj.UpdaterConfig(updater="adam", learning_rate=0.02))
            .tbptt(5)
            .dtype(dtype)
            .seed(4)
            .build())


def branch_data(seed):
    """A mask with leading, interior and trailing zeros and an all-zero row;
    the labels mask is the features mask."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(B, T2, F_S)).astype(np.float32)
    a = (3.0 + 2.0 * rng.normal(size=(B, F_A))).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T2))]
    m = np.ones((B, T2), np.float32)
    m[0, :3] = 0.0
    m[1, 4:8] = 0.0
    m[2, 9:] = 0.0
    m[3] = 0.0
    return [s, a], [y], [m, None], [m]


def test_two_branch_masked_graph_with_bn_matches_jax():
    jnet, pnet = pair(branch_conf(), state=True)
    for seed in (1, 2):
        xs, ys, fms, lms = branch_data(seed)
        with jax.enable_x64(False):
            jnet.fit(JaxMultiDataSet(features=xs, labels=ys, features_masks=fms,
                                     labels_masks=lms))
        pnet.fit(pt.MultiDataSet(features=xs, labels=ys, features_masks=fms, labels_masks=lms))
    assert_same_training(jnet, pnet, 6)
    jstate, pstate = _host(jnet.state), pt.state_to_numpy(pnet)
    assert set(pstate["bn"]) == {"mean", "var"}
    for k, want in jstate["bn"].items():
        np.testing.assert_allclose(pstate["bn"][k], want, rtol=RTOL, atol=ATOL, err_msg=k)


def test_bidirectional_vertex_has_no_tbptt_or_stream():
    jconf = char_graph_conf(T=10)
    jconf.vertices["lstm"] = dj.LayerVertex(layer=dj.GravesBidirectionalLSTM(n_out=H))
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jconf.to_json()),
                               device="cpu")
    x, y = char_data(T=10)
    with pytest.raises(NotImplementedError, match="Bidirectional"):
        pnet.fit(pt.DataSet(x, y))
    with pytest.raises(NotImplementedError, match="Bidirectional"):
        pnet.rnn_time_step(x)


# -------------------------------------------------------------- streaming
def _jax_masks(kw):
    def conv(v):
        if isinstance(v, dict):
            return {n: None if m is None else jnp.asarray(m) for n, m in v.items()}
        if isinstance(v, list):
            return [None if m is None else jnp.asarray(m) for m in v]
        return jnp.asarray(v)

    return {k: conv(v) for k, v in kw.items()}


def _assert_same_stream(jnet, pnet, calls, recurrent):
    for args, kw in calls:
        want = jnet.rnn_time_step(*[jnp.asarray(x) for x in args], **_jax_masks(kw))
        got = pnet.rnn_time_step(*args, **kw)
        assert not isinstance(got, list) and got.shape == np.shape(want)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
        for name in recurrent:
            for k, v in jnet.rnn_get_previous_state(name).items():
                np.testing.assert_allclose(pnet.rnn_get_previous_state(name)[k].numpy(),
                                           np.asarray(v), rtol=RTOL, atol=ATOL)


def test_rnn_time_step_matches_jax_legacy_stream():
    """2-D (one step) and 3-D calls, a masked bucket (masked steps hold
    h/c), then a new batch size, which restarts from zeros."""
    jnet, pnet = pair(char_graph_conf(T=None))
    x, _ = char_data(T=16, seed=6)
    padded, mask, _ = pt.pad_to_bucket(x[:, 7:12], (8,))
    mask[1, 3:] = 0.0
    _assert_same_stream(jnet, pnet, [
        ((x[:, 0],), {}), ((x[:, 1],), {}), ((x[:, 2:7],), {}),
        ((padded,), {"features_masks": mask}),
        ((x[:, 12],), {"features_masks": [mask[:, :1]]}),
        ((x[:2, :3],), {}),
    ], ["lstm"])
    assert pnet.rnn_get_previous_state("lstm")["h"].shape == (2, H)


def test_rnn_time_step_of_two_inputs_matches_jax():
    """The two-branch graph (BN on its running state): masks as a list
    aligned with the inputs and as a dict by input name."""
    jnet, pnet = pair(branch_conf(), state=True)
    xs, _, fms, _ = branch_data(7)
    s, a = xs
    _assert_same_stream(jnet, pnet, [
        ((s[:, :4], a), {}),
        ((s[:, 4:9], a), {"features_masks": [fms[0][:, 4:9], None]}),
        ((s[:, 9:], a), {"features_masks": {"s": fms[0][:, 9:]}}),
    ], ["lstm1", "lstm2"])
    assert pnet.rnn_get_previous_state("bn") is None


def test_rnn_time_step_masks_of_the_wrong_length_raise_as_jax():
    jnet, pnet = pair(branch_conf())
    xs, _, fms, _ = branch_data(8)
    with pytest.raises(ValueError) as jerr:
        jnet.rnn_time_step(*xs, features_masks=[fms[0]])
    with pytest.raises(ValueError) as perr:
        pnet.rnn_time_step(*xs, features_masks=[fms[0]])
    assert str(perr.value) == str(jerr.value)


def test_a_padded_bucket_leaves_the_state_of_the_exact_call():
    _, pnet = pair(char_graph_conf(T=None))
    x, _ = char_data(T=6, seed=4)
    exact = pnet.rnn_time_step(x)
    h_exact = pnet.rnn_get_previous_state("lstm")["h"].clone()
    padded, mask, t = pt.pad_to_bucket(x, (8,))
    pnet.rnn_clear_previous_state()
    out = pnet.rnn_time_step(padded, features_masks=mask)
    np.testing.assert_allclose(out[:, :t], exact, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(pnet.rnn_get_previous_state("lstm")["h"], h_exact)


# ------------------------------------------------------- DecodeServer
def decode(server, first, chars, out, key):
    sid = server.open()
    tok, rows = first, []
    try:
        for _ in range(chars):
            row = server.step(sid, np.eye(V, dtype=np.float32)[tok])
            rows.append(row)
            tok = int(np.argmax(row))
    finally:
        server.close(sid)
    out[key] = np.stack(rows)


def serve(net, sessions=4, chars=6):
    server = pt.DecodeServer(net, capacity=4, max_delay_ms=5.0)
    out = {}
    threads = [threading.Thread(target=decode, args=(server, s, chars, out, s))
               for s in range(sessions)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        server.stop()
    assert len(out) == sessions
    return out


def alone(net, first, chars):
    net.rnn_clear_previous_state()
    tok, rows = first, []
    for _ in range(chars):
        row = net.rnn_time_step(np.eye(V, dtype=np.float32)[[tok]])[0]
        rows.append(row)
        tok = int(np.argmax(row))
    return np.stack(rows)


def mln_twin(gnet):
    """The MultiLayerNetwork of the same layers and weights."""
    conf = pt.MultiLayerConfiguration(
        layers=[pt.GravesLSTM(n_in=V, n_out=H, activation="tanh"),
                pt.RnnOutputLayer(n_in=H, n_out=V, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.recurrent(V))
    p = pt.params_to_numpy(gnet)
    return pt.load_jax_params(pt.MultiLayerNetwork(conf, device="cpu"), [p["lstm"], p["out"]])


def test_decode_server_over_a_graph():
    """Sessions served together equal each alone and the MLN server's from
    the same weights; a session in a reused slot starts from zeros."""
    _, gnet = pair(char_graph_conf(T=None))
    together = serve(gnet)
    by_mln = serve(mln_twin(gnet))
    for s, rows in together.items():
        np.testing.assert_allclose(rows, alone(gnet, s, 6), rtol=0, atol=1e-6)
        np.testing.assert_allclose(rows, by_mln[s], rtol=0, atol=1e-6)
    server = pt.DecodeServer(gnet, capacity=2, max_delay_ms=1.0)
    try:
        out = {}
        decode(server, 3, 4, out, "first")  # slot 0 streams, then frees
        decode(server, 5, 4, out, "reused")  # slot 0 again, zeroed on open
    finally:
        server.stop()
    np.testing.assert_allclose(out["reused"], alone(gnet, 5, 4), rtol=0, atol=1e-6)
