"""The PyTorch port's transfer learning (``FrozenLayer``,
``FineTuneConfiguration``, ``TransferLearning.Builder`` and
``GraphBuilder``) against the JAX package: the cases of
tests/test_earlystopping_transfer.py's TestTransferLearning and
TestTransferLearningGraph.

Both packages train the base net from the same weights (the JAX side in
f32 with x64 off); the port's base net is then loaded with JAX's trained
params and state, both do the same surgery, and the port's built net is
loaded with the JAX built net's params, since new and replaced layers are
drawn from each package's own generator. After training the built nets,
frozen params (and frozen BatchNormalization statistics) must be bit for
bit what they were, under SGD and Adam, per batch and in the staged loop;
the trained params are held against JAX's at 1e-5 (SGD), or at 1e-5 but
for one element in 10,000 within a tenth of an Adam step (Adam, as
``test_torch_lenet_mlp.py`` explains).
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.nn.layers.frozen import FrozenLayer as JFrozen  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jser  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402

ATOL = 1e-5
ADAM_OUTLIERS = 1e-4


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _updater(pkg, name, lr):
    u = pkg.UpdaterConfig(updater=name, learning_rate=lr)
    return u if pkg is dj else u.to_dict()


def _mln_conf(pkg, updater="sgd", lr=0.1, seed=3):
    """tests/test_earlystopping_transfer.py's ``_net``."""
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=16, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(4), updater=_updater(pkg, updater, lr),
        seed=seed)


def _data(n=64, seed=0, classes=3):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(42).normal(size=(4, classes))
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[(x @ w).argmax(-1)]


def _pair(jconf, pconf, cls):
    """A JAX net (f32 params) and the port's on the CPU from its weights."""
    jnet = getattr(dj, cls)(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    pnet = getattr(pt, cls)(pconf, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    return jnet, pt.load_jax_params(pnet, jnet.params, state=jnet.state)


def _carried(jnet, pnet):
    """The port's net loaded with the JAX net's params and state (the same
    net but for each package's draw of new layers)."""
    return pt.load_jax_params(pnet, jnet.params, state=jnet.state)


def _flat(params):
    if isinstance(params, dict):
        return {(n, k): np.asarray(v, np.float32) for n, p in params.items() for k, v in p.items()}
    return {(i, k): np.asarray(v, np.float32) for i, p in enumerate(params) for k, v in p.items()}


def _params_close(pnet, jnet, adam_lr=None):
    got, want = _flat(pt.params_to_numpy(pnet)), _flat(jnet.params)
    assert set(got) == set(want)
    total = outliers = 0
    for key in want:
        diff = np.abs(got[key] - want[key])
        tol = ATOL + ATOL * np.abs(want[key])
        if adam_lr is None:
            assert (diff <= tol).all(), (key, diff.max())
        else:
            assert diff.max() <= adam_lr / 10, (key, diff.max())
            outliers += int((diff > tol).sum())
            total += diff.size
    assert outliers <= ADAM_OUTLIERS * max(total, 1)


def _frozen_unchanged(before, net, frozen):
    after = _flat(pt.params_to_numpy(net))
    for key, v in before.items():
        if key[0] in frozen:
            np.testing.assert_array_equal(after[key], v)


# ------------------------------------------------------ MultiLayerNetwork
@pytest.mark.parametrize("updater,lr", [("sgd", 0.5), ("adam", 1e-2)])
def test_freeze_feature_extractor(updater, lr):
    x, y = _data()
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mln_conf(dj, updater, lr), _mln_conf(pt, updater, lr),
                           "MultiLayerNetwork")
        jnet.fit((x, y))
        pnet.fit((x, y))
        _params_close(pnet, jnet, lr if updater == "adam" else None)
        _carried(jnet, pnet)
        jtl = dj.TransferLearning.Builder(jnet).set_feature_extractor(0).build()
        ptl = pt.TransferLearning.Builder(pnet).set_feature_extractor(0).build()
        assert isinstance(ptl.conf.layers[0], pt.FrozenLayer)
        assert isinstance(ptl.conf.layers[0].layer, pt.DenseLayer)
        assert ptl.conf.to_json() == jtl.conf.to_json()
        assert ptl._opt_state is None and ptl.iteration == 0
        before = _flat(pt.params_to_numpy(ptl))
        jtl.fit((x, y), epochs=3)
        ptl.fit((x, y), epochs=3)
        _frozen_unchanged(before, ptl, {0})
        assert not np.allclose(pt.params_to_numpy(ptl)[1]["W"], before[(1, "W")])
        _params_close(ptl, jtl, lr if updater == "adam" else None)
        # the staged loop too
        before = _flat(pt.params_to_numpy(ptl))
        ptl.fit([(x[:32], y[:32]), (x[32:], y[32:])] * 2, stage_on_device=4)
        assert ptl.staged_steps_total == 4
        _frozen_unchanged(before, ptl, {0})


def test_nout_replace():
    x, y = _data()
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mln_conf(dj), _mln_conf(pt), "MultiLayerNetwork")
        jtl = dj.TransferLearning.Builder(jnet).n_out_replace(0, 32).build()
        ptl = pt.TransferLearning.Builder(pnet).n_out_replace(0, 32).build()
        shapes = [tuple(p["W"].shape) for p in pt.params_to_numpy(ptl)]
        assert shapes == [(4, 32), (32, 3)]
        assert ptl.conf.to_json() == jtl.conf.to_json()
        _carried(jtl, ptl)
        jtl.fit((x, y))
        ptl.fit((x, y))
        _params_close(ptl, jtl)


def test_remove_and_add_output_layer():
    x, y = _data()
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mln_conf(dj), _mln_conf(pt), "MultiLayerNetwork")
        jnet.fit((x, y))
        pnet.fit((x, y))
        _carried(jnet, pnet)
        w0 = pt.params_to_numpy(pnet)[0]["W"]
        builds = [pkg.TransferLearning.Builder(net).remove_output_layer().add_layer(
            pkg.OutputLayer(n_in=16, n_out=5, activation="softmax", loss="mcxent")).build()
            for pkg, net in ((dj, jnet), (pt, pnet))]
        jtl, ptl = builds
        assert pt.params_to_numpy(ptl)[1]["W"].shape == (16, 5)
        np.testing.assert_array_equal(pt.params_to_numpy(ptl)[0]["W"], w0)  # kept
        _carried(jtl, ptl)
        np.testing.assert_allclose(ptl.output(x), np.asarray(jtl.output(x)), atol=ATOL)
        assert ptl.output(x).shape == (64, 5)


@pytest.mark.parametrize("form", ["config", "dict", "name"])
def test_fine_tune_updater_override(form):
    x, y = _data()
    cfg = dj.UpdaterConfig(updater="adam", learning_rate=1e-3)
    given = {"config": pt.UpdaterConfig(updater="adam", learning_rate=1e-3),
             "dict": pt.UpdaterConfig(updater="adam", learning_rate=1e-3).to_dict(),
             "name": "adam"}[form]
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mln_conf(dj), _mln_conf(pt), "MultiLayerNetwork")
        ptl = pt.TransferLearning.Builder(pnet).fine_tune_configuration(
            pt.FineTuneConfiguration(updater=given, seed=7)).build()
        assert ptl.conf.updater["updater"] == "adam" and ptl.conf.seed == 7
        if form == "name":
            return
        jtl = dj.TransferLearning.Builder(jnet).fine_tune_configuration(
            dj.FineTuneConfiguration(updater=cfg, seed=7)).build()
        assert ptl.conf.to_json() == jtl.conf.to_json()
        jtl.fit((x, y))
        ptl.fit((x, y))
        _params_close(ptl, jtl, 1e-3)


def test_frozen_json_and_zips_round_trip_with_jax(tmp_path):
    x, _ = _data()
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mln_conf(dj), _mln_conf(pt), "MultiLayerNetwork")
        jtl = dj.TransferLearning.Builder(jnet).set_feature_extractor(0).build()
        ptl = pt.TransferLearning.Builder(pnet).set_feature_extractor(0).build()
        conf2 = pt.MultiLayerConfiguration.from_json(jtl.conf.to_json())
        assert isinstance(conf2.layers[0], pt.FrozenLayer)
        assert isinstance(conf2.layers[0].layer, pt.DenseLayer)
        assert json.loads(conf2.to_json()) == json.loads(jtl.conf.to_json())
        assert pt.MultiLayerNetwork(conf2, device="cpu").init().output(x).shape == (64, 3)
        jser.write_model(jtl, str(tmp_path / "jax.zip"))
        back = pt.load_jax_model_zip(str(tmp_path / "jax.zip"), device="cpu")
        assert isinstance(back.conf.layers[0], pt.FrozenLayer)
        np.testing.assert_allclose(back.output(x), np.asarray(jtl.output(x)), atol=ATOL)
        pt.write_model(ptl, str(tmp_path / "port.zip"))
        jback = jser.restore_model(str(tmp_path / "port.zip"))
        assert isinstance(jback.conf.layers[0], JFrozen)
        np.testing.assert_allclose(np.asarray(jback.output(x)), ptl.output(x), atol=ATOL)


def test_frozen_layer_runs_its_layer_in_inference_mode():
    """Dropout off and BatchNormalization on its running statistics, its
    state returned as it was; no regularization; no gradient."""
    bn = pt.FrozenLayer(layer=pt.BatchNormalization())
    it = pt.InputType.feed_forward(5)
    p = {k: torch.nn.Parameter(v) for k, v in bn.init_params(torch.Generator(), it).items()}
    state = {"mean": torch.full((5,), 2.0), "var": torch.full((5,), 4.0)}
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
    out, new = bn.apply(p, x, state, train=True)
    assert new is state
    torch.testing.assert_close(out, (x - 2.0) / torch.sqrt(torch.tensor(4.0 + bn.layer.eps)))
    assert out.grad_fn is None
    drop = pt.FrozenLayer(layer=pt.DenseLayer(n_in=5, n_out=5, dropout=0.5, l2=0.1))
    dp = drop.init_params(torch.Generator().manual_seed(1), it)
    a, _ = drop.apply(dp, x, {}, train=True, generator=torch.Generator().manual_seed(2))
    b, _ = drop.layer.apply(dp, x, {}, train=False)
    torch.testing.assert_close(a, b)
    assert float(drop.regularization_loss(dp)) == 0.0
    assert float(drop.layer.regularization_loss(dp)) > 0.0
    assert not drop.is_output_layer and pt.FrozenLayer(layer=pt.OutputLayer()).is_output_layer


# -------------------------------------------------------- ComputationGraph
def _graph_conf(pkg, bn=False):
    b = (pkg.ComputationGraphConfiguration.builder().add_inputs("in")
         .set_input_types(pkg.InputType.feed_forward(4))
         .add_layer("d1", pkg.DenseLayer(n_out=16, activation="tanh"), "in"))
    if bn:
        b = (b.add_layer("bn", pkg.BatchNormalization(), "d1")
             .add_layer("d2", pkg.DenseLayer(n_out=8, activation="tanh"), "bn"))
    else:
        b = b.add_layer("d2", pkg.DenseLayer(n_out=8, activation="tanh"), "d1")
    return (b.add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                        "d2")
            .set_outputs("out").updater(pkg.UpdaterConfig(updater="adam", learning_rate=2e-2))
            .build())


def _trained_graphs(bn=False, epochs=5):
    """TestTransferLearningGraph._trained_graph in both packages, the port's
    then loaded with JAX's trained params and state."""
    rng = np.random.default_rng(12345)
    x = (rng.normal(size=(64, 4)) * (3 if bn else 1) + (1 if bn else 0)).astype(np.float32)
    w = np.random.default_rng(9).normal(size=(4, 3))
    y = np.eye(3, dtype=np.float32)[(x @ w).argmax(-1)]
    jnet, pnet = _pair(_graph_conf(dj, bn), _graph_conf(pt, bn), "ComputationGraph")
    jnet.fit((x, y), epochs=epochs)
    pnet.fit((x, y), epochs=epochs)
    _params_close(pnet, jnet, 2e-2)
    return jnet, _carried(jnet, pnet), x, y, rng


@pytest.mark.parametrize("updater,lr", [("sgd", 0.1), ("adam", 1e-2)])
def test_freeze_subgraph_and_replace_output_vertex(updater, lr):
    with jax.enable_x64(False):
        jnet, pnet, x, y, rng = _trained_graphs()
        builds = [
            pkg.TransferLearning.GraphBuilder(net)
            .fine_tune_configuration(pkg.FineTuneConfiguration(
                updater=pkg.UpdaterConfig(updater=updater, learning_rate=lr)))
            .set_feature_extractor("d2")  # freezes d2 AND its ancestor d1
            .remove_vertex_and_connections("out")
            .add_layer("new_out", pkg.OutputLayer(n_out=5, activation="softmax",
                                                  loss="mcxent"), "d2")
            .set_outputs("new_out").build()
            for pkg, net in ((dj, jnet), (pt, pnet))]
        jtl, ptl = builds
        for name in ("d1", "d2"):
            assert isinstance(ptl.conf.vertices[name].layer, pt.FrozenLayer)
        assert ptl.conf.to_json() == jtl.conf.to_json()
        d1 = pt.params_to_numpy(pnet)["d1"]["W"]
        np.testing.assert_array_equal(pt.params_to_numpy(ptl)["d1"]["W"], d1)
        assert pt.params_to_numpy(ptl)["new_out"]["W"].shape == (8, 5)
        _carried(jtl, ptl)
        before = _flat(pt.params_to_numpy(ptl))
        y5 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=64)]
        jtl.fit((x, y5), epochs=5)
        ptl.fit((x, y5), epochs=5)
        _frozen_unchanged(before, ptl, {"d1", "d2"})
        _params_close(ptl, jtl, lr if updater == "adam" else None)
        assert ptl.output(x).shape == (64, 5)
        before = _flat(pt.params_to_numpy(ptl))
        ptl.fit([(x[:32], y5[:32]), (x[32:], y5[32:])], stage_on_device=2)
        assert ptl.staged_steps_total == 2
        _frozen_unchanged(before, ptl, {"d1", "d2"})


def test_n_out_replace_reinitializes_consumers():
    with jax.enable_x64(False):
        jnet, pnet, x, y, _ = _trained_graphs()
        jtl = dj.TransferLearning.GraphBuilder(jnet).n_out_replace("d2", 12).build()
        ptl = pt.TransferLearning.GraphBuilder(pnet).n_out_replace("d2", 12).build()
        got = pt.params_to_numpy(ptl)
        assert got["d2"]["W"].shape == (16, 12) and got["out"]["W"].shape == (12, 3)
        np.testing.assert_array_equal(got["d1"]["W"], pt.params_to_numpy(pnet)["d1"]["W"])
        assert not np.array_equal(got["d2"]["W"][:, :8], pt.params_to_numpy(pnet)["d2"]["W"])
        _carried(jtl, ptl)
        jtl.fit((x, y), epochs=2)
        ptl.fit((x, y), epochs=2)
        _params_close(ptl, jtl, 2e-2)


def test_n_out_replace_refuses_a_vertex_consumer():
    conf = (pt.ComputationGraphConfiguration.builder().add_inputs("in")
            .set_input_types(pt.InputType.feed_forward(4))
            .add_layer("d1", pt.DenseLayer(n_out=8), "in")
            .add_vertex("s", pt.ScaleVertex(scale_factor=2.0), "d1")
            .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax"), "s")
            .set_outputs("out").build())
    net = pt.ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="not a layer vertex"):
        pt.TransferLearning.GraphBuilder(net).n_out_replace("d1", 4)
    with pytest.raises(ValueError, match="not a layer vertex"):
        pt.TransferLearning.GraphBuilder(net).n_out_replace("s", 4)


def test_remove_vertex_keep_connections_rewires_by_name():
    with jax.enable_x64(False):
        jnet, pnet, x, _, _ = _trained_graphs(epochs=1)
        builds = [pkg.TransferLearning.GraphBuilder(net)
                  .remove_vertex_keep_connections("out")
                  .add_layer("out", pkg.OutputLayer(n_out=7, activation="softmax",
                                                    loss="mcxent")).build()
                  for pkg, net in ((dj, jnet), (pt, pnet))]
        jtl, ptl = builds
        assert ptl.conf.to_json() == jtl.conf.to_json()
        assert pt.params_to_numpy(ptl)["out"]["W"].shape == (8, 7)
        _carried(jtl, ptl)
        np.testing.assert_allclose(ptl.output(x), np.asarray(jtl.output(x)), atol=ATOL)


@pytest.mark.parametrize("surgery,match", [
    (lambda b: b.remove_vertex_and_connections("d2"), "not re-wired"),
    (lambda b: b.set_outputs("no_such_vertex"), "not vertices"),
])
def test_bad_surgery_is_rejected_at_build(surgery, match):
    with jax.enable_x64(False):
        jnet, pnet, _, _, _ = _trained_graphs(epochs=1)
    for pkg, net in ((dj, jnet), (pt, pnet)):
        with pytest.raises(ValueError, match=match):
            surgery(pkg.TransferLearning.GraphBuilder(net)).build()
    with pytest.raises(ValueError, match="Unknown vertices"):
        pt.TransferLearning.GraphBuilder(pnet).set_feature_extractor("nope")
    with pytest.raises(ValueError, match="needs inputs"):
        pt.TransferLearning.GraphBuilder(pnet).add_layer("h", pt.OutputLayer(n_out=2))


def test_surgery_preserves_batchnorm_running_stats_and_frozen_bn_keeps_them():
    """BN's running mean and variance ride along with the frozen params, a
    frozen BN normalizes with them, and training leaves them bit for bit,
    per batch and staged."""
    with jax.enable_x64(False):
        jnet, pnet, x, y, rng = _trained_graphs(bn=True, epochs=10)
        mean = pt.state_to_numpy(pnet)["bn"]["mean"]
        assert np.abs(mean).max() > 0.05
        builds = [pkg.TransferLearning.GraphBuilder(net).set_feature_extractor("bn")
                  .remove_vertex_and_connections("out")
                  .add_layer("head", pkg.OutputLayer(n_out=2, activation="softmax",
                                                     loss="mcxent"), "d2")
                  .set_outputs("head").build()
                  for pkg, net in ((dj, jnet), (pt, pnet))]
        jtl, ptl = builds
        np.testing.assert_array_equal(pt.state_to_numpy(ptl)["bn"]["mean"], mean)
        _carried(jtl, ptl)
        state = pt.state_to_numpy(ptl)["bn"]
        y2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=64)]
        jtl.fit((x, y2), epochs=3)
        ptl.fit((x, y2), epochs=3)
        ptl.fit([(x[:32], y2[:32]), (x[32:], y2[32:])], stage_on_device=2)
        for k in ("mean", "var"):
            np.testing.assert_array_equal(pt.state_to_numpy(ptl)["bn"][k], state[k])
            np.testing.assert_array_equal(np.asarray(jtl.state["bn"][k]), state[k])
        _frozen_unchanged(_flat(pt.params_to_numpy(pnet)), ptl, {"d1", "bn"})
        out = ptl.output(x)
        assert np.isfinite(out).all() and not math.isnan(ptl.score())
