"""The PyTorch port's GoogLeNet (a ComputationGraph) against the JAX
package.

``googlenet_conf`` builds the same JSON in both packages. Served:
``googlenet_conf(64, 64, n_classes=10, dropout=0.0)`` over images of scale
40 (LRN's window sums weigh on its output there), under either leg of the
JAX LRN, ``ops.set_helpers_enabled(True)`` (the Pallas kernels in interpret
mode) or ``False`` (the XLA window sum), a spy on its ``fused_lrn`` proving
the leg; f32 probabilities at 1e-5. Trained: ``googlenet_conf(112, 112,
n_classes=4, dropout=0.0, aux_heads=True)``, three Nesterov updates at the
conf's lr 1e-2 of one batch of 2 images of scale 10, the three heads'
losses summed. Checkpoints go both ways with every tensor in its vertex,
though many 1x1 convolutions share a shape. The structure test builds the
full-width conf without running it.

Training tolerance. Losses at 1e-5 relative. The params are held by their
change: each tensor's distance from the JAX package's params after the
updates, over the norm of JAX's change from the seed params. A deep stack
of ReLU convolutions trained at lr 1e-2 amplifies f32 rounding, so the
test also runs the JAX package in float64: on this batch JAX's own f32 run
ends up 0.39% of the change from it (``i3a_5x5r``'s W), and so does the
port, which sits 5.8e-6 of the change from JAX's f32 run. The port must
stay within 2% of JAX's f32 run (five times that f32 drift) and no farther
from the float64 run than 1.5 times JAX's f32 run is. A wrong merge order
or a missing LRN term moves a change by its whole size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu import ops as jops  # noqa: E402
from deeplearning4j_tpu.models import googlenet_conf as jax_googlenet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402

ATOL = RTOL = 1e-5
LEGS = {"pallas": True, "xla": False}
CHANGE_REL = 2e-2  # see the module docstring
F64_DRIFT = 1.5  # the port's distance from the float64 run, over JAX f32's
INCEPTIONS = ["i3a", "i3b", "i4a", "i4b", "i4c", "i4d", "i4e", "i5a", "i5b"]


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    """The JAX package's unbucketed inference and its own kernel choice,
    cleared around each test; a count of its fused LRN calls."""
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    calls = []
    real = jops.fused_lrn

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jops, "fused_lrn", spy)
    yield calls
    jops.set_helpers_enabled(None)
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _host(params):
    return {n: {k: np.asarray(v, np.float32) for k, v in p.items()} for n, p in params.items()}


class Recorder:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _pair(jconf, leg="xla"):
    jops.set_helpers_enabled(LEGS[leg])
    jnet = dj.ComputationGraph(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jconf.to_json()),
                               device="cpu")
    pt.load_jax_params(pnet, _host(jnet.params))
    return jnet, pnet


def _images(seed, b, side, classes, scale):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(b, side, side, 3))).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]


# ------------------------------------------------------------- structure
def test_full_width_structure_without_running_it():
    """9 inception merges of 4 inputs each, the conf's widths (1000 classes
    at 224x224), the LRN layers' inputs at [56, 56, 64] and [56, 56, 192],
    the same JSON, order, params and leaves as the JAX conf; built only."""
    for aux in (False, True):
        jconf = jax_googlenet(aux_heads=aux)
        pconf = pt.googlenet_conf(aux_heads=aux)
        assert pconf.to_json() == jconf.to_json()
        assert pt.ComputationGraphConfiguration.from_json(jconf.to_json()).to_json() == \
            jconf.to_json()
        assert pconf.topological_order() == jconf.topological_order()
        merges = {n: pconf.vertex_inputs[n] for n, v in pconf.vertices.items()
                  if isinstance(v, pt.MergeVertex)}
        assert list(merges) == INCEPTIONS
        assert all(len(ins) == 4 for ins in merges.values())
        assert [t.to_dict() for t in pconf.output_types()] == \
            [{"kind": "ff", "size": 1000}] * (3 if aux else 1)
        vit = pconf.vertex_input_types()
        assert [str(vit[n][0]) for n in ("stem_lrn1", "stem_lrn2")] == \
            ["cnn(56x56x64)", "cnn(56x56x192)"]
        assert [str(vit[n][0]) for n in ("i5b_1x1", "avgpool", "out")] == \
            ["cnn(7x7x832)", "cnn(7x7x1024)", "ff(1024)"]
        assert pconf.network_outputs == (["out", "aux1", "aux2"] if aux else ["out"])
        assert {n: [t.to_dict() for t in ts] for n, ts in vit.items()} == \
            {n: [t.to_dict() for t in ts] for n, ts in jconf.vertex_input_types().items()}


def test_params_and_leaf_order_match_jax():
    """Every vertex's keys and shapes, the leaf count and order
    (jax.tree_util: sorted vertex name), and the param count."""
    jconf = jax_googlenet(112, 112, n_classes=4, aux_heads=True)
    jnet = dj.ComputationGraph(jconf).init()
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jconf.to_json()),
                               device="cpu").init()
    shapes = {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in jnet.params.items()}
    assert {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in pnet.vertex_params.items()} == shapes
    jleaves = [tuple(l.shape) for l in jax.tree_util.tree_leaves(jnet.params)]
    assert [tuple(l[k].shape) for l in pnet._leaves() for k in sorted(l)] == jleaves
    assert pnet.num_params() == jnet.num_params()
    assert pnet.summary() == jnet.summary()


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_output_and_predict_match_jax(leg, jax_env, monkeypatch):
    """Probabilities and classes under the JAX leg, and the port's two LRN
    calls a forward, each on a contiguous NHWC input (what the kernels
    take on the card)."""
    jnet, pnet = _pair(jax_googlenet(64, 64, n_classes=10, dropout=0.0), leg)
    x, _ = _images(1, 3, 64, 10, 40.0)
    want = np.asarray(jnet.output(x))
    assert (len(jax_env) > 0) == (leg == "pallas")
    seen = []
    real = ops.lrn

    def spy(t, *args, **kwargs):
        seen.append((tuple(t.shape), t.is_contiguous()))
        return real(t, *args, **kwargs)

    monkeypatch.setattr(ops, "lrn", spy)
    got = pnet.output(x)
    # the 3 rows are served in the 4-row bucket
    assert seen == [((4, 16, 16, 64), True), ((4, 16, 16, 192), True)]
    assert got.shape == want.shape == (3, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(pnet.predict(x), np.asarray(jnet.predict(x)))


def test_merge_order_and_lrn_shape_the_output():
    """Inputs where the net's structure shows: with two branches of a
    merge swapped (the next convolution reads them in other channels) or
    the LRN layers left out, the output moves by far more than the
    tolerance."""
    jconf = jax_googlenet(64, 64, n_classes=10, dropout=0.0)
    _, pnet = _pair(jconf)
    x, _ = _images(1, 3, 64, 10, 40.0)
    right = pnet.output(x)
    conf = pt.ComputationGraphConfiguration.from_json(jconf.to_json())
    ins = conf.vertex_inputs["i3a"]
    ins[1], ins[3] = ins[3], ins[1]  # 128 and 32 channels: same total
    swapped = pt.load_jax_params(pt.ComputationGraph(conf, device="cpu"),
                                 pt.params_to_numpy(pnet))
    # the next module's 1x1 convolutions read the merged channels in order
    assert float(np.abs(swapped.output(x) - right).max()) > 1e-3
    conf = pt.ComputationGraphConfiguration.from_json(jconf.to_json())
    for name in ("stem_lrn1", "stem_lrn2"):
        conf.vertices[name].layer.alpha = 0.0
    without = pt.load_jax_params(pt.ComputationGraph(conf, device="cpu"),
                                 pt.params_to_numpy(pnet))
    assert float(np.abs(without.output(x) - right).max()) > 1e-3


# -------------------------------------------------------------- training
def _change_readings(pparams, jparams, seed):
    return {f"{n}.{k}": float(np.linalg.norm(pparams[n][k] - np.asarray(v, np.float32))
                              / np.linalg.norm(np.asarray(v, np.float32) - seed[n][k]))
            for n, p in jparams.items() for k, v in p.items()}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_aux_head_training_matches_jax(leg, jax_env):
    """Three Nesterov updates of one batch of 2 images through all three
    heads: per-update losses (the three summed) and each param's change."""
    jconf = jax_googlenet(112, 112, n_classes=4, dropout=0.0, aux_heads=True)
    jnet, pnet = _pair(jconf, leg)
    seed = _host(jnet.params)
    x, _ = _images(2, 2, 112, 4, 10.0)
    rng = np.random.default_rng(3)
    ys = [np.eye(4, dtype=np.float32)[rng.integers(0, 4, 2)] for _ in range(3)]
    assert pnet.score(pt.MultiDataSet([x], ys)) == pytest.approx(
        float(jnet.score(dj.MultiDataSet([x], ys))), rel=RTOL)
    for net, pkg in ((jnet, dj), (pnet, pt)):
        net.set_listeners(Recorder())
        for _ in range(3):
            net.fit(pkg.MultiDataSet([x], ys))
    assert (len(jax_env) > 0) == (leg == "pallas")
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(pl) == 3 and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=RTOL, err_msg="losses")
    readings = _change_readings(pt.params_to_numpy(pnet), jnet.params, seed)
    worst = max(readings, key=readings.get)
    assert readings[worst] <= CHANGE_REL, (worst, readings[worst])
    if leg == "xla":
        # the float64 leg: the same training exactly enough to see f32's
        # drift; the port is no farther from it than JAX's f32 run is
        j64 = dj.ComputationGraph(jconf).init()
        j64.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), seed),
                 force=True)
        for _ in range(3):
            j64.fit(dj.MultiDataSet([x.astype(np.float64)], [y.astype(np.float64) for y in ys]))
        ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), j64.params)
        port = max(_change_readings(pt.params_to_numpy(pnet), ref, seed).values())
        jax32 = max(_change_readings(_host(jnet.params), ref, seed).values())
        assert port <= F64_DRIFT * jax32, (port, jax32)


def test_evaluate_scores_each_head_as_jax_does():
    jconf = jax_googlenet(112, 112, n_classes=4, dropout=0.0, aux_heads=True)
    jnet, pnet = _pair(jconf)
    x, _ = _images(4, 5, 112, 4, 10.0)
    rng = np.random.default_rng(5)
    ys = [np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)] for _ in range(3)]
    mine = pnet.evaluate(pt.MultiDataSet([x], ys))
    theirs = jnet.evaluate(dj.MultiDataSet([x], ys))
    assert list(mine) == list(theirs) == ["out", "aux1", "aux2"]
    for name in theirs:
        np.testing.assert_array_equal(mine[name].confusion.matrix,
                                      theirs[name].confusion.matrix)


def test_conf_dropout_trains_and_serves_without_it():
    """The conf's dropout 0.4 (DropoutLayer before the head) acts in fit
    only: output is deterministic and the same as with dropout 0, and an
    update with it differs from one without."""
    x, y = _images(6, 2, 64, 10, 40.0)
    trained, served = {}, {}
    for rate in (0.0, 0.4):
        jnet, pnet = _pair(jax_googlenet(64, 64, n_classes=10, dropout=rate))
        served[rate] = pnet.output(x)
        np.testing.assert_array_equal(served[rate], pnet.output(x))
        pnet.fit((x, y))
        trained[rate] = pt.params_to_numpy(pnet)
    np.testing.assert_array_equal(served[0.0], served[0.4])
    assert np.abs(trained[0.0]["out"]["W"] - trained[0.4]["out"]["W"]).max() > 0


# ------------------------------------------------------------ checkpoints
def test_checkpoints_move_both_ways_with_each_tensor_in_its_vertex(tmp_path):
    """A JAX zip of GoogLeNet restores in the port tensor for tensor (the
    leaves in sorted vertex-name order: the 1x1 convolutions of a shape are
    many, a wrong order loads them into the wrong vertices unnoticed), with
    its Nesterov trace; the port's zip restores in the JAX package the same
    way; the next update agrees."""
    jnet, _ = _pair(jax_googlenet(64, 64, n_classes=10, dropout=0.0))
    x, y = _images(7, 2, 64, 10, 40.0)
    jnet.fit((x, y))
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.restore_model(path, device="cpu")
    mine = pt.params_to_numpy(pnet)
    for name, p in jnet.params.items():
        for k, v in p.items():
            np.testing.assert_array_equal(mine[name][k], np.asarray(v, np.float32),
                                          err_msg=f"{name} {k}")
    for jl, pl in zip(jax.tree_util.tree_leaves(jnet.opt_state),
                      pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    for name, p in jback.params.items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(v, np.float32), mine[name][k],
                                          err_msg=f"{name} {k}")
    for net in (jback, pnet):
        net.set_listeners(Recorder())
        net.fit((x, y))
    np.testing.assert_allclose(pnet.listeners[0].losses, jback.listeners[0].losses,
                               rtol=RTOL)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graph_launches_the_kernels_and_matches_cpu(cuda_device):
    """On the card: 2 LRN forwards per output(); 2 + 2 LRN launches and one
    softmax-xent forward and backward per head per update."""
    conf = pt.googlenet_conf(112, 112, n_classes=4, dropout=0.0, aux_heads=True)
    cpu = pt.ComputationGraph(conf, device="cpu").init()
    card = pt.ComputationGraph(conf).init(params=pt.params_to_numpy(cpu))
    x, y = _images(8, 2, 112, 4, 10.0)
    ops.reset_counters()
    got = card.output(x)
    assert (ops.counters()["lrn_fwd"], ops.counters()["lrn_bwd"]) == (2, 0)
    for g, w in zip(got, cpu.output(x)):
        np.testing.assert_allclose(g, w, atol=1e-4)
    ops.reset_counters()
    mds = pt.MultiDataSet([x], [y, y, y])
    card.fit(mds)
    cpu.fit(mds)
    counts = ops.counters()
    assert (counts["lrn_fwd"], counts["lrn_bwd"], counts["softmax_xent_fwd"],
            counts["softmax_xent_bwd"]) == (2, 2, 3, 3)
    assert card.score() == pytest.approx(cpu.score(), rel=1e-4)
