"""The PyTorch port's AlexNet against the JAX package.

Two nets: ``alexnet_conf(64, 64, n_classes=4)`` itself (full widths, the
smallest input it takes), and an AlexNet-shaped conf with narrow widths in
the same layer order (convs of 8, 12, 16, 16 and 12 filters with AlexNet's
kernels, strides and Same mode, both LRNs, the three overlapping max pools,
dense 32, 32 and 5 classes) over 96x96x3 images, so that the last pool
leaves 2x2x12 for the dense layer to flatten in (h, w, c) order. The same
conf JSON builds each net in both packages, the JAX net's params go to the
port through ``load_jax_params``, and the same numpy images (scale 40, so
that LRN's window sums weigh on its output) go through both. The JAX side
runs either leg of its LRN: ``ops.set_helpers_enabled(True)`` (the Pallas
kernels in interpret mode) or ``False`` (the XLA window sum), under
``DL4JTPU_INFER=legacy`` and a temporary kernel calibration file; a spy on
its ``fused_lrn`` proves the leg. f32 outputs, per-update losses and params
are compared at 1e-5 (sums in another order; the params relative to their
size). Training runs with dropout 0, since the packages draw other random
bits. Tests marked ``cuda`` run the port on the card and skip where there is
none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu import ops as jops  # noqa: E402
from deeplearning4j_tpu.models import alexnet_conf as jax_alexnet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402

ATOL = RTOL = 1e-5  # f32 on both sides; sums in another order
B, SIDE, CLASSES, SCALE = 4, 96, 5, 40.0
LEGS = {"pallas": True, "xla": False}
LR = 1e-2  # alexnet_conf's
LAYERS = ["ConvolutionLayer", "LocalResponseNormalization", "SubsamplingLayer"] * 2 + [
    "ConvolutionLayer"] * 3 + ["SubsamplingLayer", "DenseLayer", "DenseLayer", "OutputLayer"]


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


def _narrow_conf(updater="nesterovs", dtype="float32", dropout=0.0):
    def conv(n_out, k, s=1):
        return dj.ConvolutionLayer(n_out=n_out, kernel=(k, k), stride=(s, s),
                                   convolution_mode="same", activation="relu")

    def pool():
        return dj.SubsamplingLayer(pooling_type="max", kernel=(3, 3), stride=(2, 2))

    return dj.MultiLayerConfiguration(
        layers=[conv(8, 11, 4), dj.LocalResponseNormalization(), pool(),
                conv(12, 5), dj.LocalResponseNormalization(), pool(),
                conv(16, 3), conv(16, 3), conv(12, 3), pool(),
                dj.DenseLayer(n_out=32, activation="relu", dropout=dropout),
                dj.DenseLayer(n_out=32, activation="relu", dropout=dropout),
                dj.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent")],
        input_type=dj.InputType.convolutional(SIDE, SIDE, 3),
        updater=dj.UpdaterConfig(updater=updater, learning_rate=LR), dtype=dtype, seed=7)


def _f32(tree):
    # conftest enables x64: init_params yields float64; cast for f32 parity
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


class Recorder:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _pair(jconf, leg="xla"):
    """(JAX net with its LRN leg forced, port net on the CPU): the same conf
    JSON and the JAX net's params as f32, a loss recorder on each."""
    jops.set_helpers_enabled(LEGS[leg])
    jnet = dj.MultiLayerNetwork(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jconf.to_json()),
                                device="cpu")
    pt.load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    return jnet, pnet


def _images(seed, b=B, side=SIDE, classes=CLASSES):
    rng = np.random.default_rng(seed)
    x = (SCALE * rng.normal(size=(b, side, side, 3))).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]
    return x, y


def _assert_params_close(jparams, pnet):
    for i, (jp, pp) in enumerate(zip(jparams, pt.params_to_numpy(pnet))):
        assert set(jp) == set(pp)
        for k in jp:
            want = np.asarray(jp[k], np.float32)
            np.testing.assert_allclose(pp[k], want, rtol=RTOL,
                                       atol=ATOL * max(float(np.abs(want).max()), 1.0),
                                       err_msg=f"layer {i} {k}")


def _assert_same_training(jnet, pnet):
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(jl) == len(pl) and jnet.iteration == pnet.iteration
    np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=RTOL, err_msg="losses")
    _assert_params_close(jnet.params, pnet)


# ------------------------------------------------------------------ conf
def test_conf_json_round_trips_both_ways():
    jconf = jax_alexnet()
    assert pt.alexnet_conf().to_json() == jconf.to_json()
    pconf = pt.MultiLayerConfiguration.from_json(jconf.to_json())
    assert [type(l).__name__ for l in pconf.layers] == LAYERS
    assert dj.MultiLayerConfiguration.from_json(pconf.to_json()).to_dict() == jconf.to_dict()
    narrow = pt.MultiLayerConfiguration.from_json(_narrow_conf().to_json())
    assert narrow.to_json() == _narrow_conf().to_json()
    net = pt.MultiLayerNetwork(narrow, device="cpu").init()
    keys = [sorted(p) for p in net.layer_params]
    assert keys == [["W", "b"], [], [], ["W", "b"], [], []] + [["W", "b"]] * 3 + [[]] + [
        ["W", "b"]] * 3
    assert tuple(net.layer_params[10]["W"].shape) == (2 * 2 * 12, 32)
    full = pt.MultiLayerNetwork(pt.alexnet_conf(), device="cpu")
    assert [str(t) for t in full.conf.layer_input_types()][10] == str(
        pt.InputType.convolutional(6, 6, 256))
    its = pt.alexnet_conf(64, 64, n_classes=4).layer_input_types()
    assert (its[10].height, its[10].width) == (1, 1)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("net", ["narrow", "alexnet_64"])
def test_output_and_predict_match_jax(net, leg, jax_env):
    jconf = _narrow_conf() if net == "narrow" else jax_alexnet(64, 64, n_classes=4)
    jnet, pnet = _pair(jconf, leg)
    x, _ = _images(seed=1, side=SIDE if net == "narrow" else 64)
    want = np.asarray(jnet.output(x))
    assert (len(jax_env) > 0) == (leg == "pallas")  # the JAX leg that ran
    got = pnet.output(x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(pnet.predict(x), np.asarray(jnet.predict(x)))


def test_lrn_shapes_its_output():
    """The images' scale makes LRN's window sums matter: without the LRN
    layers the narrow net's output moves by far more than the tolerance."""
    jconf = _narrow_conf()
    _, pnet = _pair(jconf)
    x, _ = _images(seed=1)
    plain = pt.MultiLayerConfiguration.from_json(jconf.to_json())
    kept = [type(l).__name__ != "LocalResponseNormalization" for l in plain.layers]
    plain.layers = [l for l, k in zip(plain.layers, kept) if k]
    without = pt.MultiLayerNetwork(plain, device="cpu")
    pt.load_jax_params(without, [p for p, k in zip(pt.params_to_numpy(pnet), kept) if k])
    assert float(np.abs(without.output(x) - pnet.output(x)).max()) > 1e-2


# -------------------------------------------------------------- training
@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("updater", ["nesterovs", "sgd"])
def test_fit_matches_jax(updater, leg, jax_env):
    """Three updates over three batches, dropout 0: per-update losses and
    the params after each epoch."""
    jnet, pnet = _pair(_narrow_conf(updater), leg)
    batches = [_images(seed=s) for s in (2, 3, 4)]
    for x, y in batches:
        jnet.fit((x, y))
        pnet.fit((x, y))
    assert (len(jax_env) > 0) == (leg == "pallas")
    _assert_same_training(jnet, pnet)
    losses = pnet.listeners[0].losses
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_alexnet_conf_trains_as_jax_does():
    """alexnet_conf(64, 64, 4) itself with dropout 0: Nesterov at lr 1e-2,
    two updates."""
    jnet, pnet = _pair(jax_alexnet(64, 64, n_classes=4, dropout=0.0))
    for seed in (5, 6):
        x, y = _images(seed, side=64, classes=4)
        jnet.fit((x, y))
        pnet.fit((x, y))
    _assert_same_training(jnet, pnet)
    x, y = _images(7, side=64, classes=4)
    ds = pt.DataSet(x, y)
    assert pnet.score(ds) == pytest.approx(float(jnet.score(dj.DataSet(x, y))), rel=RTOL)


def test_dropout_trains_and_serves_without_it():
    """The conf's dropout acts in fit only: output is deterministic, and a
    dropout-0.5 update differs from a dropout-0 one."""
    x, y = _images(seed=8)
    nets = {}
    for rate in (0.0, 0.5):
        jnet, pnet = _pair(_narrow_conf(dropout=rate))
        first = pnet.output(x)
        np.testing.assert_array_equal(first, pnet.output(x))
        pnet.fit((x, y))
        nets[rate] = pt.params_to_numpy(pnet)
    assert np.abs(nets[0.0][11]["W"] - nets[0.5][11]["W"]).max() > 0


def test_evaluate_matches_jax():
    jnet, pnet = _pair(_narrow_conf())
    x, y = _images(seed=9, b=12)
    for net in (jnet, pnet):
        net.fit((x[:4], y[:4]))
    mine, theirs = pnet.evaluate(pt.DataSet(x, y)), jnet.evaluate(dj.DataSet(x, y))
    np.testing.assert_array_equal(mine.confusion.matrix, theirs.confusion.matrix)
    assert mine.accuracy() == pytest.approx(theirs.accuracy(), abs=1e-12)


def _same_next_update(jnet, pnet, batch):
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    jnet.fit(batch)
    pnet.fit(batch)
    _assert_same_training(jnet, pnet)


def test_checkpoints_move_both_ways(tmp_path):
    """A JAX zip resumes in the port and a port zip in the JAX package, the
    layers without params included, each with its Nesterov trace, to the
    same next update; port to port is exact."""
    jnet, pnet = _pair(_narrow_conf())
    jnet.fit(_images(seed=10))
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.restore_model(path, device="cpu")
    assert [sorted(p) for p in pnet.layer_params][1:3] == [[], []]
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    assert len(jleaves) == len(pnet.updater_state_leaves()) == 16 + 1  # traces, count
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    _same_next_update(jnet, pnet, _images(seed=11))

    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    assert jback.iteration == pnet.iteration == 2
    again = pt.restore_model(path, device="cpu")
    _same_next_update(jback, pnet, _images(seed=12))
    again.fit(_images(seed=12))
    for a, b in zip(pt.params_to_numpy(again), pt.params_to_numpy(pnet)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_bf16_output_is_close_to_jax():
    """bf16 compute with f32 master params. The two packages round bf16 at
    other places (XLA on the CPU may keep a fused chain in f32; torch rounds
    each op), so the probabilities are held at 3e-2, where a dropped LRN
    (test_lrn_shapes_its_output) or a wrong flatten order reads far more."""
    jnet, pnet = _pair(_narrow_conf(dtype="bfloat16"))
    x, _ = _images(seed=13)
    got = pnet.output(x)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jnet.output(x), np.float32), atol=3e-2)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_net_launches_the_kernels_and_matches_cpu(cuda_device):
    conf = pt.MultiLayerConfiguration.from_json(_narrow_conf().to_json())
    cpu = pt.MultiLayerNetwork(conf, device="cpu").init()
    card = pt.MultiLayerNetwork(conf).init(params=pt.params_to_numpy(cpu))
    x, y = _images(seed=14)
    ops.reset_counters()
    got = card.output(x)
    assert (ops.counters()["lrn_fwd"], ops.counters()["lrn_bwd"]) == (2, 0)
    np.testing.assert_allclose(got, cpu.output(x), atol=1e-4)
    ops.reset_counters()
    card.fit((x, y))
    cpu.fit((x, y))
    counts = ops.counters()
    assert (counts["lrn_fwd"], counts["lrn_bwd"], counts["softmax_xent_fwd"],
            counts["softmax_xent_bwd"]) == (2, 2, 1, 1)
    for a, b in zip(pt.params_to_numpy(card), pt.params_to_numpy(cpu)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4)
