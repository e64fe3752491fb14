"""The PyTorch port's bucketed stager (``datasets/bucketing.py``) against the
JAX package's (``tests/test_bucketing_staged.py`` for the port).

The stager is host numpy in both packages, so the port's is held array for
array, exactly: the padding primitives, and every event of ``plan`` (kind,
real batch count, each stacked array and mask, dtypes and shapes) over the
same ragged streams, with bucketing on and off and with row padding off for
BatchNormalization models. The ragged epochs then train through
``fit(stage_on_device=K)`` in both packages from the same params, the JAX
side with x64 off: losses, params and updater leaves at 1e-5 absolute and
relative (f32 on both sides, sums in other orders, a few updates); for
sequences at 5e-5, as the JAX test holds its own staged against its plain
fit. Every staged step of those epochs goes through the staged loop
(``staged_steps_total``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets import bucketing as jb  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets import bucketing as pb  # noqa: E402
from deeplearning4j_tpu_torch.datasets import ListDataSetIterator  # noqa: E402

ATOL = RTOL = 1e-5
SEQ_ATOL = 5e-5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _same_arrays(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert isinstance(got, np.ndarray), what
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_lists(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        _same_arrays(g, w, f"{what}[{i}]")


def _same_plan(port_events, jax_events):
    assert [k for k, _ in port_events] == [k for k, _ in jax_events]
    for i, ((kind, p), (_, j)) in enumerate(zip(port_events, jax_events)):
        if kind == "batch":
            assert p is j or (p.features is j.features), f"event {i}"
            continue
        assert p.n_real == j.n_real, f"event {i}"
        _same_lists(p.features, j.features, f"event {i} features")
        _same_lists(p.labels, j.labels, f"event {i} labels")
        _same_lists(p.features_masks, j.features_masks, f"event {i} features masks")
        _same_lists(p.labels_masks, j.labels_masks, f"event {i} labels masks")


def _norm(ds):
    return ([ds.features], [ds.labels], [ds.features_mask], [ds.labels_mask])


def _dense_stream(n_full=7, b=8, tail=5, seed=0):
    rng = np.random.default_rng(seed)

    def mk(rows):
        return jit_.DataSet(rng.normal(size=(rows, 5)).astype(np.float32),
                            np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])

    return [mk(b) for _ in range(n_full)] + [mk(tail)]


def _seq_stream(seed=3, masked=False):
    """Ragged time lengths, a ragged tail batch, an oversize batch, and
    (``masked``) masks that already exist."""
    rng = np.random.default_rng(seed)
    out = []
    for b, t in [(6, 7), (6, 7), (6, 5), (6, 5), (4, 5), (8, 9), (3, 16), (6, 3)]:
        x = rng.normal(size=(b, t, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t))]
        m = None
        if masked:
            m = (rng.random((b, t)) > 0.25).astype(np.float32)
            m[:, 0] = 1.0
        out.append(jit_.DataSet(x, y, features_mask=m, labels_mask=m))
    return out


STREAMS = {"dense": _dense_stream, "dense_oversize": lambda: _dense_stream(b=4, tail=8),
           "seq": _seq_stream, "seq_masked": lambda: _seq_stream(masked=True)}


# --------------------------------------------------------- the primitives
@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 9, 1000])
def test_bucket_length_and_next_pow2(t):
    assert pb.bucket_length(t) == jb.bucket_length(t)
    assert pb.next_pow2(t) == jb.next_pow2(t)
    assert pb.bucket_length(t, (4, 16, 2048)) == jb.bucket_length(t, (4, 16, 2048))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        pb.bucket_length(t + 5000, (4, 16))


@pytest.mark.parametrize("case", ["dense_rows", "no_padding", "seq_rows_time", "seq_mask"])
def test_pad_batch_arrays_is_jax_s(case):
    rng = np.random.default_rng(1)
    m = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    args = {"dense_rows": (rng.normal(size=(3, 5)).astype(np.float32),
                           np.ones((3, 2), np.float32), None, None, 8),
            "no_padding": (np.ones((4, 5)), np.ones((4, 2)), None, None, 4),
            "seq_rows_time": (rng.normal(size=(2, 5, 4)).astype(np.float32),
                              np.ones((2, 5, 3), np.float32), None, None, 4, 8),
            "seq_mask": (np.ones((2, 5, 4), np.float32), np.ones((2, 5, 3), np.float32),
                         m, m, 3, 8)}[case]
    for g, w in zip(pb.pad_batch_arrays(*args), jb.pad_batch_arrays(*args)):
        _same_arrays(g, w, case)


@pytest.mark.parametrize("case", ["rows", "seq", "seq_mask"])
def test_pad_inference_batch_is_jax_s(case):
    rng = np.random.default_rng(2)
    args = {"rows": (rng.normal(size=(3, 5)).astype(np.float32), None, 8),
            "seq": (rng.normal(size=(2, 5, 4)).astype(np.float32), None, 4, 8),
            "seq_mask": (rng.normal(size=(2, 5, 4)).astype(np.float32),
                         np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1]], np.float32), 2, 8)}[case]
    for g, w in zip(pb.pad_inference_batch(*args), jb.pad_inference_batch(*args)):
        _same_arrays(g, w, case)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("mode", ["bucketing", "legacy", "no_row_padding"])
def test_plan_is_the_jax_stager_s(stream, stage, mode):
    kw = {"bucketing": {}, "legacy": {"bucketing": False},
          "no_row_padding": {"pad_examples": False}}[mode]
    items = STREAMS[stream]()
    port = pb.BucketedStager(stage, **kw)
    jx = jb.BucketedStager(stage, **kw)
    _same_plan(list(port.plan(items, _norm)), list(jx.plan(items, _norm)))
    assert port.padding_stats() == jx.padding_stats()


def test_plan_with_time_boundaries_and_vetoes():
    items = _seq_stream(seed=5)
    kw = {"time_boundaries": (8, 16)}
    veto = lambda ds: ds.features.shape[1] != 9  # noqa: E731
    port = list(pb.BucketedStager(3, **kw).plan(items, _norm, veto))
    jx = list(jb.BucketedStager(3, **kw).plan(items, _norm, veto))
    _same_plan(port, jx)
    assert ("batch", items[5]) in port


def test_stage_below_two_raises():
    with pytest.raises(ValueError, match="stage must be >= 2"):
        pb.BucketedStager(1)


def test_batchnorm_model_skips_row_padding():
    """A BN model's ragged tail stages as its own exact-size window, not
    padded into the group before it."""
    items = _dense_stream(n_full=4, tail=5, seed=4)
    events = list(pb.BucketedStager(2, pad_examples=False).plan(
        items, lambda ds: ([ds.features], [ds.labels], [None], [None])))
    assert [(k, w.n_real) for k, w in events] == [("window", 2), ("window", 2), ("window", 1)]
    assert events[-1][1].features[0].shape == (1, 5, 5)
    net = pt.MultiLayerNetwork(pt.MultiLayerConfiguration(
        layers=[pt.DenseLayer(n_out=4), pt.BatchNormalization(),
                pt.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.feed_forward(5)), device="cpu")
    assert not net._pad_examples_ok()


# ------------------------------------------ ragged epochs against JAX fit
def _mlp_conf(pkg, seed=41, bn=False):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    layers = [pkg.DenseLayer(n_out=16, activation="relu")]
    if bn:
        layers.append(pkg.BatchNormalization())
    layers.append(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
    return pkg.MultiLayerConfiguration(layers=layers, input_type=pkg.InputType.feed_forward(5),
                                       updater=u if pkg is dj else u.to_dict(), seed=seed)


def _rnn_conf(pkg, seed=11):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.GravesLSTM(n_out=8, activation="tanh"),
                pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(4), updater=u if pkg is dj else u.to_dict(),
        seed=seed)


def _graph_conf(pkg, recurrent=False, seed=43):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    layer = (pkg.GravesLSTM(n_out=8, activation="tanh") if recurrent
             else pkg.DenseLayer(n_out=12, activation="tanh"))
    out = (pkg.RnnOutputLayer if recurrent else pkg.OutputLayer)(
        n_out=3, activation="softmax", loss="mcxent")
    return (pkg.ComputationGraphConfiguration.builder().seed(seed)
            .updater(u if pkg is dj else u.to_dict()).add_inputs("in")
            .add_layer("h", layer, "in").add_layer("out", out, "h").set_outputs("out")
            .set_input_types(pkg.InputType.recurrent(4) if recurrent
                             else pkg.InputType.feed_forward(5))
            .build())


def _pair(make, graph=False):
    jcls, pcls = ((dj.ComputationGraph, pt.ComputationGraph) if graph
                  else (dj.MultiLayerNetwork, pt.MultiLayerNetwork))
    jnet = jcls(make(dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    params = jnet.params
    if graph:
        params = {n: {k: np.asarray(v, np.float32) for k, v in p.items()}
                  for n, p in params.items()}
    pnet = pt.load_jax_params(pcls(make(pt), device="cpu"), params, state=jnet.state)
    return jnet, pnet


def _port_batches(items):
    return [pt.DataSet(ds.features, ds.labels, ds.features_mask, ds.labels_mask)
            for ds in items]


def _held(pnet, jnet, atol):
    for name, a, b in (("params", pt.params_to_numpy(pnet), jnet.params),
                       ("state", pt.state_to_numpy(pnet), jnet.state)):
        la = [np.asarray(v) for v in jax.tree_util.tree_leaves(a)]
        lb = [np.asarray(v, np.float32) for v in jax.tree_util.tree_leaves(b)]
        assert len(la) == len(lb), name
        for i, (x, y) in enumerate(zip(la, lb)):
            np.testing.assert_allclose(x, y, atol=atol, rtol=RTOL, err_msg=f"{name} {i}")
    jo = jax.tree_util.tree_leaves(jnet.opt_state)
    po = pnet.updater_state_leaves()
    for i, (j, p) in enumerate(zip(jo, po)):
        np.testing.assert_allclose(np.asarray(p, np.float64), np.asarray(j, np.float64),
                                   atol=atol, rtol=RTOL, err_msg=f"updater leaf {i}")


CASES = {
    # name: (make, graph, stream, stage, epochs, atol)
    "mln_dense_ragged": (_mlp_conf, False, _dense_stream, 3, 3, ATOL),
    "mln_batchnorm_ragged": (lambda pkg: _mlp_conf(pkg, seed=2, bn=True), False,
                             lambda: _dense_stream(n_full=4, tail=5, seed=4), 2, 1, ATOL),
    "mln_sequences_ragged": (_rnn_conf, False, _seq_stream, 2, 2, SEQ_ATOL),
    "mln_sequences_premasked": (lambda pkg: _rnn_conf(pkg, seed=5), False,
                                lambda: _seq_stream(seed=8, masked=True), 3, 2, SEQ_ATOL),
    "graph_dense_ragged": (_graph_conf, True,
                           lambda: _dense_stream(n_full=4, tail=3, seed=9), 2, 2, ATOL),
    "graph_sequences_ragged": (lambda pkg: _graph_conf(pkg, recurrent=True, seed=6), True,
                               lambda: _seq_stream(seed=12), 2, 2, SEQ_ATOL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_epochs_train_staged_as_jax_does(case):
    make, graph, stream, stage, epochs, atol = CASES[case]
    items = stream()
    with jax.enable_x64(False):
        jnet, pnet = _pair(make, graph)
        jnet.fit(jit_.ListDataSetIterator(list(items)), epochs=epochs, stage_on_device=stage)
        pnet.fit(ListDataSetIterator(_port_batches(items)), epochs=epochs,
                 stage_on_device=stage)
    assert pnet.iteration == jnet.iteration
    assert pnet.staged_steps_total == jnet.staged_steps_total == pnet.iteration
    _held(pnet, jnet, atol)
