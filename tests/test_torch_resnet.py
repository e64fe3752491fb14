"""The PyTorch port's ResNet (a ComputationGraph with BatchNormalization)
against the JAX package.

``resnet_conf`` builds the same JSON in both packages. The full-width
ResNet-50 and its family are built without running: 174 vertices and the
counts of its params, leaves and layer-state leaves.
Small confs run: ``resnet_conf([1, 1], image_size=(32, 32),
num_classes=10)`` (two bottleneck stages, projections in both) and its
basic-block twin. Served with a layer state that is not the initial one
(so eval-mode BN is held), f32 probabilities at 1e-5. Trained: three SGD
updates at the conf's lr 0.1 of one batch of 4 images, losses, params and
the running stats after each at 1e-5 (f32 on both sides, sums in another
order: these shallow stacks do not amplify the rounding), the JAX side with
x64 off (under the tests' x64 some of its scalars are float64, which moved
the eval-mode score after the updates by 1.1e-5). A residual add
that drops its shortcut (chip_smoke.py's wrong version) moves the output
by far more. Checkpoints go both ways with every param and state tensor in
its vertex (many BNs share a shape), and training resumes exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.models import resnet as jres  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402

ATOL = RTOL = 1e-5
SMALL = {"bottleneck": True, "basic": False}


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
    # conftest enables x64: params and state come as float64; cast for f32
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _host(tree):
    return {n: {k: np.asarray(v, np.float32) for k, v in p.items()} for n, p in tree.items()}


def _random_state(jnet, seed):
    """A layer state that is not the initial one: running means N(0, 0.5),
    variances U(0.5, 2), as f32 in the JAX layout."""
    rng = np.random.default_rng(seed)
    return {n: {"mean": jnp.asarray(rng.normal(0.0, 0.5, s["mean"].shape), jnp.float32),
                "var": jnp.asarray(rng.uniform(0.5, 2.0, s["var"].shape), jnp.float32)}
            if s else {} for n, s in jnet.state.items()}


def _pair(bottleneck, state_seed=None):
    jconf = jres.resnet_conf([1, 1], bottleneck=bottleneck, image_size=(32, 32),
                             num_classes=10)
    jnet = dj.ComputationGraph(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state) if state_seed is None else _random_state(jnet, state_seed)
    pconf = pt.resnet_conf([1, 1], bottleneck=bottleneck, image_size=(32, 32), num_classes=10)
    assert pconf.to_json() == jconf.to_json()
    pnet = pt.load_jax_params(pt.ComputationGraph(pconf, device="cpu"), _host(jnet.params),
                              state=jnet.state)
    return jnet, pnet


def _images(seed, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]


def _assert_tree_close(mine, theirs, what, **tol):
    assert set(mine) == set(theirs), what
    for n, p in theirs.items():
        assert set(mine[n]) == set(p), (what, n)
        for k, v in p.items():
            np.testing.assert_allclose(mine[n][k], np.asarray(v, np.float32),
                                       err_msg=f"{what} {n} {k}", **tol)


# ------------------------------------------------------------- structure
def test_full_width_structure_without_running_it():
    """ResNet-50's structure: 174 vertices (53 convolutions, 53
    BNs, 49 relus, 16 adds, a pool, a global pool, the head), 25,557,032
    params in 161 leaves, 106 state leaves of 53,120 elements, the same
    JSON, order and vertex input types as JAX; the rest of the family's
    JSON too."""
    jconf, pconf = jres.resnet50_conf(), pt.resnet50_conf()
    assert pconf.to_json() == jconf.to_json()
    assert pt.ComputationGraphConfiguration.from_json(jconf.to_json()).to_json() == \
        jconf.to_json()
    assert pconf.topological_order() == jconf.topological_order()
    kinds = {}
    for v in pconf.vertices.values():
        name = type(getattr(v, "layer", None) or v).__name__
        kinds[name] = kinds.get(name, 0) + 1
    assert kinds == {"ConvolutionLayer": 53, "BatchNormalization": 53, "ActivationLayer": 49,
                     "ElementWiseVertex": 16, "SubsamplingLayer": 1,
                     "GlobalPoolingLayer": 1, "OutputLayer": 1}
    assert {n: [t.to_dict() for t in ts] for n, ts in pconf.vertex_input_types().items()} == \
        {n: [t.to_dict() for t in ts] for n, ts in jconf.vertex_input_types().items()}
    net = pt.ComputationGraph(pconf, device="cpu").init()
    assert net.num_params() == 25_557_032
    assert sum(len(p) for p in net._leaves()) == 161
    leaves = net.state_leaves()
    assert len(leaves) == 106 and sum(t.numel() for t in leaves) == 53_120
    for name in ("resnet18_conf", "resnet34_conf", "resnet101_conf", "resnet152_conf"):
        assert getattr(pt, name)().to_json() == getattr(jres, name)().to_json(), name


@pytest.mark.parametrize("block", sorted(SMALL))
def test_params_state_leaves_and_summary_match_jax(block):
    """Every vertex's param and state keys and shapes, the leaf orders
    (sorted vertex name, then key: BN's "beta" before "gamma", "mean"
    before "var"), the param count and the summary table."""
    jnet, pnet = _pair(SMALL[block])
    assert [tuple(l.shape) for l in jax.tree_util.tree_leaves(jnet.params)] == \
        [tuple(l[k].shape) for l in pnet._leaves() for k in sorted(l)]
    assert [tuple(l.shape) for l in jax.tree_util.tree_leaves(jnet.state)] == \
        [tuple(t.shape) for t in pnet.state_leaves()]
    assert pnet.num_params() == jnet.num_params()
    assert pnet.summary() == jnet.summary()


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("block", sorted(SMALL))
def test_output_and_predict_match_jax_on_a_loaded_state(block):
    jnet, pnet = _pair(SMALL[block], state_seed=3)
    x, _ = _images(1, 5)
    want = np.asarray(jnet.output(x))
    got = pnet.output(x)
    assert got.shape == want.shape == (5, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(pnet.predict(x), np.asarray(jnet.predict(x)))
    # the running stats matter: the initial state gives another output
    fresh = pt.load_jax_params(pt.ComputationGraph(pnet.conf, device="cpu"),
                               pt.params_to_numpy(pnet))
    assert float(np.abs(fresh.output(x) - got).max()) > 1e-3


def test_a_dropped_shortcut_is_caught():
    """chip_smoke.py's wrong ElementWiseVertex (an add that keeps only the
    branch) moves the output by far more than the tolerance."""
    jnet, pnet = _pair(True, state_seed=4)
    x, _ = _images(2, 3)
    want = np.asarray(jnet.output(x))
    undo = chip_smoke.resnet_fault("shortcut_dropped")
    try:
        wrong = pnet.output(x)
    finally:
        undo()
    assert float(np.abs(wrong - want).max()) > 1e3 * ATOL
    np.testing.assert_allclose(pnet.output(x), want, atol=ATOL, rtol=RTOL)


# -------------------------------------------------------------- training
@pytest.mark.parametrize("block", sorted(SMALL))
def test_sgd_training_matches_jax(block):
    """Three SGD updates at lr 0.1 of one batch of 4: the losses, every
    param and every running stat after each, then the eval-mode output,
    score and evaluate."""
    with jax.enable_x64(False):  # JAX in f32 throughout, as the port
        _sgd_training_matches_jax(block)


def _sgd_training_matches_jax(block):
    jnet, pnet = _pair(SMALL[block])
    x, y = _images(3)
    for _ in range(3):
        jnet.fit((x, y))
        pnet.fit((x, y))
        assert pnet.score() == pytest.approx(float(jnet.score()), rel=RTOL)
        _assert_tree_close(pt.params_to_numpy(pnet), jnet.params, "params", atol=ATOL,
                           rtol=RTOL)
        _assert_tree_close(pt.state_to_numpy(pnet), jnet.state, "state", atol=ATOL,
                           rtol=RTOL)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)), atol=ATOL,
                               rtol=RTOL)
    assert pnet.score(pt.DataSet(x, y)) == pytest.approx(float(jnet.score(dj.DataSet(x, y))),
                                                          rel=RTOL)
    np.testing.assert_array_equal(pnet.evaluate((x, y)).confusion.matrix,
                                  jnet.evaluate((x, y)).confusion.matrix)


def test_clone_copies_params_state_and_updater_and_trains_apart():
    _, pnet = _pair(True)
    x, y = _images(5)
    pnet.fit((x, y))
    twin = pnet.clone()
    assert twin is not pnet and twin.iteration == pnet.iteration == 1
    np.testing.assert_array_equal(twin.output(x), pnet.output(x))
    for a, b in zip(twin.state_leaves() + twin.updater_state_leaves(),
                    pnet.state_leaves() + pnet.updater_state_leaves()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    twin.fit((x, y))
    pnet.fit((x, y))
    _assert_tree_close(pt.params_to_numpy(twin), pt.params_to_numpy(pnet), "params", rtol=0,
                       atol=0)
    _assert_tree_close(pt.state_to_numpy(twin), pt.state_to_numpy(pnet), "state", rtol=0,
                       atol=0)
    params, state = pt.params_to_numpy(pnet), pt.state_to_numpy(pnet)
    twin.fit((x, y))  # leaves the original's tensors as they were
    _assert_tree_close(pt.params_to_numpy(pnet), params, "params", rtol=0, atol=0)
    _assert_tree_close(pt.state_to_numpy(pnet), state, "state", rtol=0, atol=0)


# ------------------------------------------------------------ checkpoints
def test_checkpoints_move_both_ways_with_their_state(tmp_path):
    """A JAX zip of a trained ResNet restores in the port with every param
    and running stat in its vertex and its SGD state; the port's zip of it
    restores in the JAX package the same way; the next update agrees, state
    included, and the port's own restore resumes exactly."""
    jnet, _ = _pair(True)
    x, y = _images(6)
    jnet.fit((x, y))
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.load_jax_model_zip(path, device="cpu")
    _assert_tree_close(pt.params_to_numpy(pnet), jnet.params, "params", rtol=0, atol=0)
    _assert_tree_close(pt.state_to_numpy(pnet), jnet.state, "state", rtol=0, atol=0)
    assert pnet.iteration == jnet.iteration == 1
    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    _assert_tree_close(_host(jback.params), pt.params_to_numpy(pnet), "params", rtol=0, atol=0)
    _assert_tree_close(_host(jback.state), pt.state_to_numpy(pnet), "state", rtol=0, atol=0)
    again = pt.restore_model(path, device="cpu")
    for net in (jback, pnet, again):
        net.fit((x, y))
    assert pnet.score() == pytest.approx(float(jback.score()), rel=RTOL)
    _assert_tree_close(pt.state_to_numpy(pnet), jback.state, "state", atol=ATOL, rtol=RTOL)
    _assert_tree_close(pt.params_to_numpy(again), pt.params_to_numpy(pnet), "params", rtol=0,
                       atol=0)
    _assert_tree_close(pt.state_to_numpy(again), pt.state_to_numpy(pnet), "state", rtol=0,
                       atol=0)


def test_a_zip_with_the_wrong_state_raises(tmp_path):
    _, pnet = _pair(True)
    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    with pytest.raises(ValueError, match="state leaves"):
        pnet.set_state_leaves(pnet.state_leaves()[:-1])
    with pytest.raises(ValueError, match="shape"):
        pnet.set_state_leaves([np.zeros(3, np.float32)] * len(pnet.state_leaves()))
    with pytest.raises(ValueError, match="vertices the graph does not have"):
        pt.load_jax_state(pnet, {"no_such_vertex": {"mean": np.zeros(3)}})


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_resnet_launches_the_head_kernels_and_matches_cpu(cuda_device):
    """On the card: no hand-kernel launch per output(); one softmax-xent
    forward and backward per update; losses, state and output as the
    CPU's."""
    conf = pt.resnet_conf([1, 1], image_size=(32, 32), num_classes=10)
    cpu = pt.ComputationGraph(conf, device="cpu").init()
    card = pt.ComputationGraph(conf).init(params=pt.params_to_numpy(cpu))
    x, y = _images(7)
    ops.reset_counters()
    np.testing.assert_allclose(card.output(x), cpu.output(x), atol=1e-4)
    assert not any(ops.counters().values())
    card.fit((x, y))
    cpu.fit((x, y))
    counts = ops.counters()
    assert (counts["softmax_xent_fwd"], counts["softmax_xent_bwd"]) == (1, 1)
    assert card.score() == pytest.approx(cpu.score(), rel=1e-4)
    _assert_tree_close(pt.state_to_numpy(card), pt.state_to_numpy(cpu), "state", atol=1e-4,
                       rtol=1e-4)
