"""The PyTorch port's ComputationGraph against the JAX package (the
counterpart of ``tests/test_graph.py``).

The same conf JSON builds each graph in both packages and the JAX graph's
params go to the port (``load_jax_params``, a dict keyed by vertex name);
the same numpy inputs, made from a seed, go through both. Every vertex kind
and every input preprocessor is held against its JAX counterpart, forward
and gradient (a seeded cotangent through ``jax.vjp`` and ``backward``). A
small DAG with a dense input and an LSTM input (Merge, ElementWise, Subset,
LastTimeStep with the sequence's mask, two classification heads and a
regression head) is served, trained under SGD, Nesterov and Adam, and
evaluated; checkpoints go both ways. The JAX side runs its unbucketed
inference (``DL4JTPU_INFER=legacy``). Tolerance: 1e-5 in f32 (sums in
another order), on values and on params relative to their size; bf16 at
the AlexNet tests' 3e-2. Adam runs the JAX side with x64 off, as
``test_torch_adam.py`` explains.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.nn.conf import preprocessors as jpre  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import preprocessors as ppre  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import vertices as pvert  # noqa: E402

ATOL = RTOL = 1e-5
B, T, F_A, F_S, H = 6, 7, 6, 5, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """torch's intra-op threads capped at one for this module: its tensors
    are small, and under several test workers the threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    # conftest enables x64: init_params yields float64; cast for f32 parity
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _host(params):
    return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params.items()}


class Recorder:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _dag(updater="sgd", lr=0.1, dtype="float32", seed=3):
    """a (ff) -> dense ---------------------------------+
    s (rnn) -> LSTM -> LastTimeStep(s's mask) -> dense -+-> merge -> subset
    -> elementwise max with the dense of a; three heads: two softmax
    classifiers, one on the merge and one on the max, and an mse head on the
    subset."""
    return (dj.ComputationGraphConfiguration.builder()
            .add_inputs("a", "s")
            .set_input_types(dj.InputType.feed_forward(F_A), dj.InputType.recurrent(F_S, T))
            .add_layer("da", dj.DenseLayer(n_out=H, activation="tanh"), "a")
            .add_layer("lstm", dj.GravesLSTM(n_out=H, activation="tanh"), "s")
            .add_vertex("last", dj.LastTimeStepVertex(mask_input="s"), "lstm")
            .add_layer("ds", dj.DenseLayer(n_out=H, activation="sigmoid"), "last")
            .add_vertex("merge", dj.MergeVertex(), "da", "ds")
            .add_vertex("sub", dj.SubsetVertex(from_idx=2, to_idx=2 + H - 1), "merge")
            .add_vertex("max", dj.ElementWiseVertex(op="max"), "sub", "da")
            .add_layer("cls", dj.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "merge")
            .add_layer("cls2", dj.OutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                       "max")
            .add_layer("reg", dj.OutputLayer(n_out=2, activation="identity", loss="mse"),
                       "sub")
            .set_outputs("cls", "cls2", "reg")
            .updater(dj.UpdaterConfig(updater=updater, learning_rate=lr))
            .dtype(dtype)
            .seed(seed)
            .build())


def _data(seed, b=B):
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(b, F_A)).astype(np.float32)
    xs = rng.normal(size=(b, T, F_S)).astype(np.float32)
    lengths = rng.integers(1, T + 1, b)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    y1 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
    y2 = np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)]
    y3 = rng.normal(size=(b, 2)).astype(np.float32)
    return [xa, xs], [y1, y2, y3], [None, mask]


def _mds(pkg, seed, b=B):
    xs, ys, masks = _data(seed, b)
    return pkg.MultiDataSet(features=xs, labels=ys, features_masks=masks)


def _pair(jconf):
    jnet = dj.ComputationGraph(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jconf.to_json()),
                               device="cpu")
    pt.load_jax_params(pnet, _host(jnet.params))
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    return jnet, pnet


def _assert_params_close(jparams, pnet, rtol=RTOL, atol=ATOL):
    mine = pt.params_to_numpy(pnet)
    assert set(mine) == set(jparams)
    for name, jp in jparams.items():
        assert set(mine[name]) == set(jp), name
        for k in jp:
            want = np.asarray(jp[k], np.float32)
            np.testing.assert_allclose(mine[name][k], want, rtol=rtol,
                                       atol=atol * max(float(np.abs(want).max()), 1.0),
                                       err_msg=f"{name} {k}")


def _assert_same_training(jnet, pnet):
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(jl) == len(pl) and jnet.iteration == pnet.iteration
    np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=RTOL, err_msg="losses")
    _assert_params_close(jnet.params, pnet)


# ------------------------------------------------------------------ conf
def test_conf_json_order_and_types_match_both_ways():
    jconf = _dag()
    pconf = pt.ComputationGraphConfiguration.from_json(jconf.to_json())
    assert pconf.to_json() == jconf.to_json()
    assert dj.ComputationGraphConfiguration.from_json(pconf.to_json()).to_dict() == \
        jconf.to_dict()
    assert pconf.topological_order() == jconf.topological_order()
    mine, theirs = pconf.vertex_input_types(), jconf.vertex_input_types()
    assert list(mine) == list(theirs)
    for name in theirs:
        assert [t.to_dict() for t in mine[name]] == [t.to_dict() for t in theirs[name]], name
    assert [t.to_dict() for t in pconf.output_types()] == \
        [t.to_dict() for t in jconf.output_types()]


def test_port_builder_writes_the_jax_builders_json():
    """The same graph built by each package's GraphBuilder: one JSON string,
    the updater given as an UpdaterConfig or as its dict."""
    def build(pkg, updater):
        return (pkg.ComputationGraphConfiguration.builder()
                .add_inputs("in", "seq")
                .set_input_types(pkg.InputType.feed_forward(4), pkg.InputType.recurrent(3, 5))
                .add_layer("d", pkg.DenseLayer(n_out=6, activation="relu"), "in",
                           preprocessor=None)
                .add_vertex("dup", pkg.DuplicateToTimeSeriesVertex(ts_input="seq"), "d")
                .add_vertex("rs", pkg.ReshapeVertex(shape=(2, 3)), "d")
                .add_layer("out", pkg.OutputLayer(n_out=2, activation="softmax"), "d")
                .set_outputs("out")
                .updater(updater)
                .seed(9).dtype("bfloat16").tbptt(4, 2).remat().params_dtype("bfloat16")
                .build())

    jconf = build(dj, dj.UpdaterConfig(updater="adam", learning_rate=3e-3))
    assert build(pt, pt.UpdaterConfig(updater="adam", learning_rate=3e-3)).to_json() == \
        jconf.to_json()
    assert build(pt, {"updater": "adam", "learning_rate": 3e-3}).to_json() == jconf.to_json()
    assert jconf.vertex_inputs["dup"] == ["d", "seq"]


def _cyclic(pkg):
    return (pkg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .set_input_types(pkg.InputType.feed_forward(4))
            .add_layer("a", pkg.DenseLayer(n_out=4), "b")
            .add_layer("b", pkg.DenseLayer(n_out=4), "a")
            .add_layer("out", pkg.OutputLayer(n_out=2), "b")
            .set_outputs("out"))


def _missing_input(pkg):
    return (pkg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .set_input_types(pkg.InputType.feed_forward(4))
            .add_layer("out", pkg.OutputLayer(n_out=2), "nowhere")
            .set_outputs("out"))


@pytest.mark.parametrize("make,match", [
    (_cyclic, "cycle"), (_missing_input, "neither a vertex nor a network input"),
    (lambda pkg: pkg.ComputationGraphConfiguration.builder().set_outputs("x"), "no network inputs"),
    (lambda pkg: _cyclic(pkg).set_outputs("nope"), "is not a vertex"),
], ids=["cycle", "missing_input", "no_inputs", "unknown_output"])
def test_invalid_graphs_raise_as_in_jax(make, match):
    for pkg in (dj, pt):
        with pytest.raises(ValueError, match=match):
            make(pkg).build()


def test_duplicate_names_and_shape_mismatch_raise():
    for pkg in (dj, pt):
        b = pkg.ComputationGraphConfiguration.builder().add_inputs("in")
        with pytest.raises(ValueError, match="Duplicate"):
            b.add_vertex("in", pkg.ScaleVertex())
        b = (pkg.ComputationGraphConfiguration.builder()
             .add_inputs("in")
             .set_input_types(pkg.InputType.feed_forward(6))
             .add_layer("d1", pkg.DenseLayer(n_out=8), "in")
             .add_layer("d2", pkg.DenseLayer(n_out=1), "in")
             .add_vertex("add", pkg.ElementWiseVertex(op="add"), "d1", "d2")
             .add_layer("out", pkg.OutputLayer(n_out=2), "add")
             .set_outputs("out"))
        with pytest.raises(ValueError, match="identical shapes"):
            b.build()


# ------------------------------------------------------- vertices, each
def _arr(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _vertex_cases():
    rng = np.random.default_rng(5)
    a, b, c = _arr(rng, 3, 4), _arr(rng, 3, 4), _arr(rng, 3, 4)
    seq, img = _arr(rng, 3, 5, 4), _arr(rng, 3, 2, 2, 4)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)
    fit = dj.InputType
    cases = [(f"elementwise_{op}", dj.ElementWiseVertex(op=op), [a, b, c] if op != "subtract"
              else [a, b], None, [fit.feed_forward(4)] * (3 if op != "subtract" else 2))
             for op in ("add", "subtract", "product", "average", "max")]
    cases += [
        ("merge_ff", dj.MergeVertex(), [a, _arr(rng, 3, 2)], None,
         [fit.feed_forward(4), fit.feed_forward(2)]),
        ("merge_rnn", dj.MergeVertex(), [seq, _arr(rng, 3, 5, 3)], None,
         [fit.recurrent(4, 5), fit.recurrent(3, 5)]),
        ("merge_cnn", dj.MergeVertex(), [img, _arr(rng, 3, 2, 2, 3)], None,
         [fit.convolutional(2, 2, 4), fit.convolutional(2, 2, 3)]),
        ("subset", dj.SubsetVertex(from_idx=1, to_idx=2), [seq], None, [fit.recurrent(4, 5)]),
        ("stack", dj.StackVertex(), [a, b], None, [fit.feed_forward(4)] * 2),
        ("unstack", dj.UnstackVertex(from_idx=1, stack_size=3), [_arr(rng, 6, 4)], None,
         [fit.feed_forward(4)]),
        ("scale", dj.ScaleVertex(scale_factor=2.5), [a], None, [fit.feed_forward(4)]),
        ("shift", dj.ShiftVertex(shift=-1.5), [img], None, [fit.convolutional(2, 2, 4)]),
        ("l2", dj.L2Vertex(), [img, _arr(rng, 3, 2, 2, 4)], None,
         [fit.convolutional(2, 2, 4)] * 2),
        ("l2normalize", dj.L2NormalizeVertex(), [seq], None, [fit.recurrent(4, 5)]),
        ("preprocessor", dj.PreprocessorVertex(
            preprocessor=jpre.CnnToFeedForwardPreProcessor(2, 2, 4)), [img], None,
         [fit.convolutional(2, 2, 4)]),
        ("last_time_step_masked", dj.LastTimeStepVertex(mask_input="s"), [seq], {"s": mask},
         [fit.recurrent(4, 5)]),
        ("last_time_step", dj.LastTimeStepVertex(), [seq], None, [fit.recurrent(4, 5)]),
        ("duplicate_to_time_series", dj.DuplicateToTimeSeriesVertex(ts_input="s"),
         [a, _arr(rng, 3, 6, 2)], None, [fit.feed_forward(4), fit.recurrent(2, 6)]),
        ("reshape", dj.ReshapeVertex(shape=(2, 2, 3)), [_arr(rng, 3, 12)], None,
         [fit.feed_forward(12)]),
    ]
    return cases


VERTEX_CASES = _vertex_cases()


def _jax_vjp(fn, inputs, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_vjp(fn, inputs, cot):
    tens = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = fn(*tens)
    out.backward(torch.tensor(cot))
    # an input read only for its shape (DuplicateToTimeSeries) has no grad
    return out.detach().numpy(), [np.zeros_like(x) if t.grad is None else t.grad.numpy()
                                  for x, t in zip(inputs, tens)]


@pytest.mark.parametrize("name,jvertex,inputs,masks,types", VERTEX_CASES,
                         ids=[c[0] for c in VERTEX_CASES])
def test_vertex_matches_jax_forward_and_gradient(name, jvertex, inputs, masks, types):
    pvertex = pvert.vertex_from_dict(json.loads(json.dumps(jvertex.to_dict())))
    assert pvertex.to_dict() == jvertex.to_dict()
    assert pvertex.get_output_type(*types).to_dict() == jvertex.get_output_type(*types).to_dict()
    jm = None if masks is None else {k: jnp.asarray(v) for k, v in masks.items()}
    pm = None if masks is None else {k: torch.tensor(v) for k, v in masks.items()}

    def jfn(*xs):
        return jvertex.apply({}, list(xs), {}, masks=jm)[0]

    def pfn(*xs):
        return pvertex.apply({}, list(xs), {}, masks=pm)[0]

    want = np.asarray(jfn(*[jnp.asarray(x) for x in inputs]))
    cot = np.random.default_rng(7).normal(size=want.shape).astype(np.float32)
    jout, jgrads = _jax_vjp(jfn, inputs, cot)
    pout, pgrads = _port_vjp(pfn, inputs, cot)
    assert pout.shape == jout.shape
    np.testing.assert_allclose(pout, jout, rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(pgrads, jgrads)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"d input {i}")
    if name == "last_time_step_masked":  # each row's last live step: 2, 4, 0
        np.testing.assert_array_equal(pout, inputs[0][[0, 1, 2], [2, 4, 0]])


def test_layer_vertex_with_preprocessor_matches_jax():
    """A LayerVertex runs its preprocessor first: an LSTM over images read
    row by row (CnnToRnn), its params from the JAX vertex."""
    jv = dj.LayerVertex(layer=dj.GravesLSTM(n_out=5, activation="tanh"),
                        preprocessor=jpre.CnnToRnnPreProcessor())
    it = dj.InputType.convolutional(3, 4, 2)
    params = _f32(jv.init_params(jax.random.PRNGKey(0), it))
    pv = pvert.vertex_from_dict(json.loads(json.dumps(jv.to_dict())))
    assert pv.get_output_type(it).to_dict() == jv.get_output_type(it).to_dict()
    x = _arr(np.random.default_rng(1), 2, 3, 4, 2)
    pp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    want = np.asarray(jv.apply(params, [jnp.asarray(x)], {})[0])
    got, _ = pv.apply(pp, [torch.tensor(x)], {})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ preprocessors
def _preprocessor_cases():
    rng = np.random.default_rng(11)
    it = dj.InputType
    return [
        ("cnn_to_ff", jpre.CnnToFeedForwardPreProcessor(3, 2, 4), _arr(rng, 2, 3, 2, 4),
         it.convolutional(3, 2, 4)),
        ("ff_to_cnn", jpre.FeedForwardToCnnPreProcessor(3, 2, 4), _arr(rng, 2, 24),
         it.feed_forward(24)),
        ("rnn_to_ff", jpre.RnnToFeedForwardPreProcessor(), _arr(rng, 2, 5, 3),
         it.recurrent(3, 5)),
        ("ff_to_rnn", jpre.FeedForwardToRnnPreProcessor(timesteps=5), _arr(rng, 10, 3),
         it.feed_forward(3)),
        ("cnn_to_rnn", jpre.CnnToRnnPreProcessor(), _arr(rng, 2, 3, 2, 4),
         it.convolutional(3, 2, 4)),
        ("rnn_to_cnn", jpre.RnnToCnnPreProcessor(2, 2, 3), _arr(rng, 2, 5, 12),
         it.recurrent(12, 5)),
        ("composable", jpre.ComposableInputPreProcessor(children=[
            jpre.RnnToFeedForwardPreProcessor(), jpre.FeedForwardToCnnPreProcessor(2, 3, 2)]),
         _arr(rng, 2, 5, 12), it.recurrent(12, 5)),
    ]


PREPROCESSOR_CASES = _preprocessor_cases()


@pytest.mark.parametrize("name,jpp,x,it", PREPROCESSOR_CASES,
                         ids=[c[0] for c in PREPROCESSOR_CASES])
def test_preprocessor_matches_jax(name, jpp, x, it):
    ppp = ppre.preprocessor_from_dict(json.loads(json.dumps(jpp.to_dict())))
    assert ppp.to_dict() == jpp.to_dict()
    assert jpre.preprocessor_from_dict(ppp.to_dict()).to_dict() == jpp.to_dict()
    assert ppp.get_output_type(it).to_dict() == jpp.get_output_type(it).to_dict()
    want = np.asarray(jpp.apply(jnp.asarray(x)))
    cot = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    jout, (jg,) = _jax_vjp(jpp.apply, [x], cot)
    pout, (pg,) = _port_vjp(ppp.apply, [x], cot)
    np.testing.assert_array_equal(pout, jout)
    np.testing.assert_array_equal(pg, jg)


def test_unknown_vertex_and_preprocessor_raise():
    with pytest.raises(ValueError, match="Unknown vertex type"):
        pvert.vertex_from_dict({"@type": "NoSuchVertex"})
    with pytest.raises(ValueError, match="Unknown preprocessor"):
        ppre.preprocessor_from_dict({"@type": "NoSuchPreProcessor"})


# ----------------------------------------------------------- the DAG
def test_params_leaves_and_summary_match_jax():
    """Vertex by vertex the same keys and shapes; the leaves in
    jax.tree_util's order (sorted vertex name, then key); the same param
    count and summary table."""
    jnet, pnet = _pair(_dag())
    jleaves = jax.tree_util.tree_leaves(jnet.params)
    pleaves = [l[k] for l in pnet._leaves() for k in sorted(l)]
    assert len(jleaves) == len(pleaves)
    for j, p in zip(jleaves, pleaves):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(j))
    assert pnet.num_params() == jnet.num_params()
    assert pnet.summary() == jnet.summary()


def test_seeded_init_draws_in_topological_order():
    """No JAX bits: the port draws each vertex's params from one generator
    seeded by conf.seed, in topological order, so the same seed gives the
    same params and another seed others."""
    conf = pt.ComputationGraphConfiguration.from_json(_dag().to_json())
    a = pt.params_to_numpy(pt.ComputationGraph(conf, device="cpu").init())
    b = pt.params_to_numpy(pt.ComputationGraph(conf, device="cpu").init())
    gen = torch.Generator().manual_seed(conf.seed)
    vit = conf.vertex_input_types()
    drawn = {n: conf.vertices[n].init_params(gen, *vit[n]) for n in conf.topological_order()}
    for name in a:
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k])
            np.testing.assert_array_equal(a[name][k], drawn[name][k].numpy())
    conf.seed = 4
    c = pt.params_to_numpy(pt.ComputationGraph(conf, device="cpu").init())
    assert np.abs(c["da"]["W"] - a["da"]["W"]).max() > 0


def test_output_and_predict_match_jax():
    jnet, pnet = _pair(_dag())
    xs, _, masks = _data(seed=20)
    jm = {"a": None, "s": jnp.asarray(masks[1])}
    want = [np.asarray(o) for o in jnet.output(*xs, masks=jm)]
    got = pnet.output(*xs, masks={"a": None, "s": masks[1]})
    assert isinstance(got, list) and len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for g, w in zip(pnet.predict(list(xs), masks={"s": masks[1]}),
                    jnet.predict(*xs, masks=jm)):
        np.testing.assert_array_equal(g, np.asarray(w))
    # without the mask the LSTM and LastTimeStep see every step: other outputs
    unmasked = pnet.output(*xs)
    assert np.abs(unmasked[0] - got[0]).max() > 1e-3
    np.testing.assert_allclose(unmasked[0], np.asarray(jnet.output(*xs)[0]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "adam"])
def test_fit_trajectory_matches_jax(updater):
    """Four updates over two masked batches, twice each: per-update losses
    (three heads summed) and every param after them."""
    lr = 1e-2 if updater == "adam" else 0.1
    with jax.enable_x64(updater != "adam"):
        jnet, pnet = _pair(_dag(updater, lr))
        batches = [(_mds(dj, s), _mds(pt, s)) for s in (30, 31)]
        for _ in range(2):
            for jb, pb in batches:
                jnet.fit(jb)
                pnet.fit(pb)
        _assert_same_training(jnet, pnet)
        losses = pnet.listeners[0].losses
        assert len(losses) == 4 and np.isfinite(losses).all()
        jl = jax.tree_util.tree_leaves(jnet.opt_state)
        pl = pnet.updater_state_leaves()
        assert len(jl) == len(pl)
        for j, p in zip(jl, pl):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
        mds = _mds(pt, 32)
        assert pnet.score(mds) == pytest.approx(float(jnet.score(_mds(dj, 32))), rel=RTOL)


def test_fit_takes_every_input_form():
    """A MultiDataSet, a DataSet and an (x, y) pair of a one-input,
    one-output graph, and an iterator of them: one update per batch, the
    same steps from each form."""
    conf = (pt.ComputationGraphConfiguration.builder()
            .add_inputs("in").set_input_types(pt.InputType.feed_forward(4))
            .add_layer("d", pt.DenseLayer(n_out=5, activation="tanh"), "in")
            .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax"), "d")
            .set_outputs("out").build())
    rng = np.random.default_rng(3)
    x, y = _arr(rng, 8, 4), np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    runs = []
    for data in ((x, y), pt.DataSet(x, y), pt.MultiDataSet([x], [y]),
                 [(x, y), pt.DataSet(x, y)]):
        net = pt.ComputationGraph(conf, device="cpu").init()
        net.fit(data)
        runs.append((net.iteration, pt.params_to_numpy(net)))
    assert [r[0] for r in runs] == [1, 1, 1, 2]
    for _, p in runs[1:3]:
        for name in p:
            for k in p[name]:
                np.testing.assert_array_equal(p[name][k], runs[0][1][name][k])
    ev = pt.ComputationGraph(conf, device="cpu").init().evaluate((x, y))
    assert isinstance(ev, pt.Evaluation)


def test_evaluate_matches_jax_over_the_classification_heads():
    jnet, pnet = _pair(_dag())
    for net, pkg in ((jnet, dj), (pnet, pt)):
        net.fit(_mds(pkg, 40))
    mine, theirs = pnet.evaluate(_mds(pt, 41, b=12)), jnet.evaluate(_mds(dj, 41, b=12))
    assert isinstance(mine, dict) and list(mine) == list(theirs) == ["cls", "cls2"]
    for name in theirs:
        np.testing.assert_array_equal(mine[name].confusion.matrix,
                                      theirs[name].confusion.matrix)
        assert mine[name].accuracy() == pytest.approx(theirs[name].accuracy(), abs=1e-12)


def test_evaluate_refuses_a_graph_of_regression_heads():
    conf = (pt.ComputationGraphConfiguration.builder()
            .add_inputs("in").set_input_types(pt.InputType.feed_forward(4))
            .add_layer("r1", pt.OutputLayer(n_out=1, activation="identity", loss="mse"), "in")
            .add_layer("r2", pt.OutputLayer(n_out=2, activation="identity", loss="mse"), "in")
            .set_outputs("r1", "r2").build())
    net = pt.ComputationGraph(conf, device="cpu")
    rng = np.random.default_rng(0)
    mds = pt.MultiDataSet([_arr(rng, 3, 4)], [_arr(rng, 3, 1), _arr(rng, 3, 2)])
    with pytest.raises(ValueError, match="no classification output heads"):
        net.evaluate(mds)


def test_dropout_layer_trains_and_serves_without_it():
    """DropoutLayer drops in fit only, from the graph's generator: output
    is deterministic, and a dropout update differs from one without."""
    def conf(rate):
        return (pt.ComputationGraphConfiguration.builder()
                .add_inputs("in").set_input_types(pt.InputType.feed_forward(6))
                .add_layer("d", pt.DenseLayer(n_out=16, activation="relu"), "in")
                .add_layer("drop", pt.DropoutLayer(dropout=rate), "d")
                .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax"), "drop")
                .set_outputs("out").build())
    rng = np.random.default_rng(4)
    x, y = _arr(rng, 10, 6), np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    trained = {}
    for rate in (0.0, 0.5):
        net = pt.ComputationGraph(conf(rate), device="cpu").init()
        np.testing.assert_array_equal(net.output(x), net.output(x))
        np.testing.assert_array_equal(net.output(x), pt.ComputationGraph(
            conf(0.0), device="cpu").init().output(x))
        net.fit((x, y))
        trained[rate] = pt.params_to_numpy(net)
    assert np.abs(trained[0.0]["out"]["W"] - trained[0.5]["out"]["W"]).max() > 0


def test_bf16_output_is_close_to_jax():
    """bf16 compute with f32 master params, held at the AlexNet tests'
    3e-2 (the packages round bf16 at other places)."""
    jnet, pnet = _pair(_dag(dtype="bfloat16"))
    xs, _, masks = _data(seed=50)
    want = jnet.output(*xs, masks={"s": jnp.asarray(masks[1])})
    got = pnet.output(*xs, masks={"s": masks[1]})
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=3e-2)


def test_later_entry_points_raise():
    """``analyze_ir`` is still to come; ``memory_report``, ``preflight``
    and ``set_telemetry`` are ported (tests/test_torch_telemetry.py holds
    them against JAX) and answer."""
    net = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(_dag().to_json()),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="analyze_ir"):
        net.analyze_ir()
    xs, _, _ = _data(seed=51)
    report = net.memory_report([x[:2] for x in xs])
    assert report["model"] == "ComputationGraph" and report["totals"]["param_bytes"] > 0
    assert net.preflight([x[:2] for x in xs])["preflight"]["checked"] in (True, False)
    assert net.set_telemetry(None) is net and net.telemetry is None
    # TBPTT and rnn_time_step are ported (tests/test_torch_graph_recurrent.py):
    # one update per time segment of the 3-D input
    tbptt = _dag()
    tbptt.backprop_type = "tbptt"
    net = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(tbptt.to_json()),
                              device="cpu")
    net.fit(_mds(pt, 1))
    assert net.iteration == -(-T // tbptt.tbptt_fwd_length)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = pt.ComputationGraphConfiguration.from_json(_dag().to_json())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.ComputationGraph(conf)


# --------------------------------------------------------- checkpoints
def _same_next_update(jnet, pnet, seed):
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    jnet.fit(_mds(dj, seed))
    pnet.fit(_mds(pt, seed))
    _assert_same_training(jnet, pnet)


def test_checkpoints_move_both_ways(tmp_path):
    """A JAX zip restores in the port with each tensor in its vertex (the
    leaves in sorted vertex-name order) and the Nesterov trace, and resumes
    to the same next update; a port zip restores in the JAX package; port to
    port resumes exactly."""
    jnet, _ = _pair(_dag("nesterovs"))
    jnet.fit(_mds(dj, 60))
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.restore_model(path, device="cpu")
    assert isinstance(pnet, pt.ComputationGraph) and pnet.iteration == 1
    mine = pt.params_to_numpy(pnet)
    for name, p in jnet.params.items():
        for k, v in p.items():
            np.testing.assert_array_equal(mine[name][k], np.asarray(v, np.float32))
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    assert len(jleaves) == len(pnet.updater_state_leaves())
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    _same_next_update(jnet, pnet, 61)

    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    assert type(jback).__name__ == "ComputationGraph" and jback.iteration == 2
    again = pt.restore_model(path, device="cpu")
    assert pt.load_jax_model_zip(path, device="cpu").iteration == 2
    _same_next_update(jback, pnet, 62)
    again.fit(_mds(pt, 62))
    theirs = pt.params_to_numpy(pnet)
    for name, p in pt.params_to_numpy(again).items():
        for k in p:
            np.testing.assert_array_equal(p[k], theirs[name][k])


def test_load_jax_params_checks_vertices_keys_and_shapes():
    jnet, pnet = _pair(_dag())
    host = _host(jnet.params)
    with pytest.raises(ValueError, match="does not have"):
        pt.load_jax_params(pnet, {**host, "ghost": {}})
    bad = dict(host, da={"W": host["da"]["W"]})
    with pytest.raises(ValueError, match="keys"):
        pt.load_jax_params(pnet, bad)
    bad = dict(host, da={"W": host["da"]["W"].T, "b": host["da"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        pt.load_jax_params(pnet, bad)


# ---------------------------------------------- MultiLayerNetwork's preprocessors
def _mln_with_preprocessors(updater="nesterovs"):
    """Images flattened into a dense layer (CnnToFeedForward), fed to an
    LSTM as [B, T, F] (FeedForwardToRnn), read per step by a dense layer
    (RnnToFeedForward) and back into a per-step output layer."""
    return dj.MultiLayerConfiguration(
        layers=[dj.ConvolutionLayer(n_out=3, kernel=(2, 2), activation="relu"),
                dj.DenseLayer(n_out=4, activation="tanh"),
                dj.GravesLSTM(n_out=5, activation="tanh"),
                dj.DenseLayer(n_out=6, activation="sigmoid"),
                dj.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=dj.InputType.convolutional(4, 4, 2),
        preprocessors={1: jpre.CnnToFeedForwardPreProcessor(3, 3, 3),
                       2: jpre.FeedForwardToRnnPreProcessor(timesteps=2),
                       3: jpre.RnnToFeedForwardPreProcessor(),
                       4: jpre.FeedForwardToRnnPreProcessor(timesteps=2)},
        updater=dj.UpdaterConfig(updater=updater, learning_rate=0.1), seed=5)


def test_multilayer_preprocessors_match_jax():
    jconf = _mln_with_preprocessors()
    pconf = pt.MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.to_json() == jconf.to_json()
    assert [t.to_dict() for t in pconf.layer_input_types()] == \
        [t.to_dict() for t in jconf.layer_input_types()]
    jnet = dj.MultiLayerNetwork(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(pconf, device="cpu")
    pt.load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    rng = np.random.default_rng(8)
    x = _arr(rng, 6, 4, 4, 2)  # 6 images: 3 sequences of 2 steps
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 2))]
    want = np.asarray(jnet.output(x))
    got = pnet.output(x)
    assert got.shape == want.shape == (3, 2, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
        for _ in range(2):
            net.fit((x, y))
    np.testing.assert_allclose(pnet.listeners[0].losses, jnet.listeners[0].losses,
                               rtol=RTOL, atol=ATOL)
    for i, (jp, pp) in enumerate(zip(jnet.params, pt.params_to_numpy(pnet))):
        for k in jp:
            want = np.asarray(jp[k], np.float32)
            np.testing.assert_allclose(pp[k], want, rtol=RTOL,
                                       atol=ATOL * max(float(np.abs(want).max()), 1.0),
                                       err_msg=f"layer {i} {k}")
