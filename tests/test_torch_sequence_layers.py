"""The PyTorch port's sequence layers against the JAX package:
``LastTimeStepLayer``, ``RnnEmbeddingLayer``, ``Convolution1DLayer`` and
``ZeroPaddingLayer``, alone and in networks.

Each layer is built from the JAX layer's JSON, given the same numpy params
and input, and held to the JAX layer's output and its gradients in x and
the params (JAX's VJP against autograd, one seeded upstream gradient) at
1e-5 (f32 on both sides; sums in another order). A sequence classifier
(ids -> RnnEmbedding -> Convolution1D -> GravesLSTM -> last step -> softmax)
is served and trained with Adam on both networks against JAX (x64 off on
the JAX side, as ``test_torch_adam.py`` explains); integer id batches stay
integer through the staged loop and the prefetcher; and zips of a graph
and a MultiLayerNetwork holding the new layers (with a
``MixtureOfExpertsLayer``) go both ways between the packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import DevicePrefetchIterator  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import recurrent as prec  # noqa: E402

ATOL = RTOL = 1e-5
B, T, V, E, H = 3, 7, 9, 6, 5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def port_layer(jlayer, it):
    """The port's layer from the JAX layer's JSON."""
    conf = dj.MultiLayerConfiguration(layers=[jlayer], input_type=it)
    return pt.MultiLayerConfiguration.from_json(conf.to_json()).layers[0]


def vjp_both(jlayer, player, params, x, seed, mask=None, diff_x=True):
    """(out, dx or None, dparams) of each package for one upstream
    gradient."""
    jmask = None if mask is None else jnp.asarray(mask)

    def jf(xx, pp):
        return jlayer.apply(pp, xx, {}, mask=jmask)[0]

    jx = jnp.asarray(x)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if diff_x:
        jout, vjp = jax.vjp(jf, jx, jp)
    else:
        jout, vjp = jax.vjp(lambda pp: jf(jx, pp), jp)
    g = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    grads = vjp(jnp.asarray(g))
    jdx, jdp = grads if diff_x else (None, grads[0])
    tx = torch.tensor(x, requires_grad=diff_x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = player.apply(tp, tx, {}, mask=None if mask is None else torch.tensor(mask))
    out.backward(torch.from_numpy(g))
    return ((np.asarray(jout), None if jdx is None else np.asarray(jdx),
             {k: np.asarray(v) for k, v in jdp.items()}),
            (out.detach().numpy(), tx.grad.numpy() if diff_x else None,
             {k: v.grad.numpy() for k, v in tp.items()}))


def assert_same(want, got):
    (wo, wdx, wdp), (go, gdx, gdp) = want, got
    assert go.shape == wo.shape
    np.testing.assert_allclose(go, wo, atol=ATOL, rtol=RTOL, err_msg="out")
    if wdx is not None:
        np.testing.assert_allclose(gdx, wdx, atol=ATOL, rtol=RTOL, err_msg="dx")
    assert set(gdp) == set(wdp)
    for k in wdp:
        np.testing.assert_allclose(gdp[k], wdp[k], atol=ATOL, rtol=RTOL, err_msg=k)


# --------------------------------------------------------- LastTimeStep
LAST_MASKS = {
    "no_mask": None,
    "contiguous": [[1, 1, 1, 0, 0, 0, 0], [1] * 7, [1, 0, 0, 0, 0, 0, 0]],
    "with_gaps": [[1, 0, 1, 1, 0, 1, 0], [0, 1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 1]],
    "all_zero_row": [[0] * 7, [1, 1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0, 1]],
}


@pytest.mark.parametrize("case", sorted(LAST_MASKS))
def test_last_time_step_layer_matches_jax(case):
    """The last nonzero step of each row (step 0 for an all-zero row), or
    the last step without a mask: out and dx."""
    it = dj.InputType.recurrent(E, T)
    jlayer = dj.LastTimeStepLayer()
    player = port_layer(jlayer, it)
    assert player.get_output_type(it).to_dict() == jlayer.get_output_type(it).to_dict()
    x = np.random.default_rng(1).normal(size=(B, T, E)).astype(np.float32)
    mask = None if LAST_MASKS[case] is None else np.asarray(LAST_MASKS[case], np.float32)
    want, got = vjp_both(jlayer, player, {}, x, seed=2, mask=mask)
    assert_same(want, got)
    if case == "with_gaps":
        np.testing.assert_array_equal(got[0], x[[0, 1, 2], [5, 1, 6]])


# ---------------------------------------------------------- RnnEmbedding
@pytest.mark.parametrize("ids", ["int_bt", "float_bt1"])
def test_rnn_embedding_matches_jax(ids):
    """Integer ids [B, T] and floating ids [B, T, 1]: the rows of W through
    the activation, and dW."""
    it = dj.InputType.recurrent(1, T)
    jlayer = dj.RnnEmbeddingLayer(n_in=V, n_out=E, activation="tanh")
    player = port_layer(jlayer, it)
    assert player.get_output_type(it).to_dict() == jlayer.get_output_type(it).to_dict()
    params = {k: np.asarray(v, np.float32)
              for k, v in jlayer.init_params(jax.random.PRNGKey(0), it).items()}
    assert {k: tuple(v.shape) for k, v in player.init_params(torch.Generator(), it).items()} == {
        k: v.shape for k, v in params.items()}
    idx = np.random.default_rng(3).integers(0, V, (B, T))
    x = idx if ids == "int_bt" else idx[..., None].astype(np.float32)
    want, got = vjp_both(jlayer, player, params, x, seed=4, diff_x=False)
    assert_same(want, got)
    np.testing.assert_allclose(got[0][0, 1], np.tanh(params["W"][idx[0, 1]]), rtol=1e-6)


# ---------------------------------------------------------- Convolution1D
CONV1D_CASES = {
    # name: (layer kwargs, T)
    "same_k3": (dict(n_out=4, kernel=3), 7),
    "same_k4_stride2": (dict(n_out=4, kernel=4, stride=2), 7),
    "same_k2_even_t": (dict(n_out=3, kernel=2), 8),
    "truncate": (dict(n_out=4, kernel=3, convolution_mode="truncate"), 9),
    "truncate_stride2_padded": (dict(n_out=3, kernel=3, stride=2, padding=1,
                                     convolution_mode="truncate"), 7),
    "no_bias_tanh": (dict(n_out=4, kernel=5, has_bias=False, activation="tanh"), 7),
}


@pytest.mark.parametrize("case", sorted(CONV1D_CASES))
def test_convolution1d_layer_matches_jax(case):
    kw, t = CONV1D_CASES[case]
    it = dj.InputType.recurrent(E, t)
    jlayer = dj.Convolution1DLayer(**kw)
    player = port_layer(jlayer, it)
    params = {k: np.asarray(v, np.float32) + 0.05
              for k, v in jlayer.init_params(jax.random.PRNGKey(1), it).items()}
    assert {k: tuple(v.shape) for k, v in player.init_params(torch.Generator(), it).items()} == {
        k: v.shape for k, v in params.items()}
    x = np.random.default_rng(5).normal(size=(B, t, E)).astype(np.float32)
    want, got = vjp_both(jlayer, player, params, x, seed=6)
    want_type = jlayer.get_output_type(it)
    assert player.get_output_type(it).to_dict() == want_type.to_dict()
    assert got[0].shape == (B, want_type.timesteps, kw["n_out"])
    assert_same(want, got)


def test_zero_padding_layer_matches_jax():
    """test_cnn.py's pads (top 1, bottom 2, left 3, right 0): out, dx and the
    output type."""
    it = dj.InputType.convolutional(8, 8, 2)
    jlayer = dj.ZeroPaddingLayer(pad_top=1, pad_bottom=2, pad_left=3, pad_right=0)
    player = port_layer(jlayer, it)
    assert player.get_output_type(it).example_shape() == (11, 11, 2)
    assert player.init_params(torch.Generator(), it) == {}
    x = np.random.default_rng(7).normal(size=(B, 8, 8, 2)).astype(np.float32)
    want, got = vjp_both(jlayer, player, {}, x, seed=8)
    assert_same(want, got)


# ------------------------------------------------------- in networks
def seq_layers(last):
    return [dj.RnnEmbeddingLayer(n_in=V, n_out=E, activation="identity"),
            dj.Convolution1DLayer(n_out=E, kernel=3, activation="relu"),
            dj.GravesLSTM(n_out=H, activation="tanh"), last,
            dj.OutputLayer(n_out=V, activation="softmax", loss="mcxent")]


def seq_mln_conf():
    return dj.MultiLayerConfiguration(
        layers=seq_layers(dj.LastTimeStepLayer()), input_type=dj.InputType.recurrent(1, T),
        updater=dj.UpdaterConfig(updater="adam", learning_rate=0.02), seed=5)


def seq_graph_conf(moe=False):
    """ids -> RnnEmbedding -> Convolution1D [-> MixtureOfExperts] ->
    GravesLSTM -> LastTimeStepVertex (the ids' mask) -> softmax."""
    emb, conv, lstm, _, out = seq_layers(None)
    b = (dj.ComputationGraphConfiguration.builder()
         .add_inputs("ids")
         .set_input_types(dj.InputType.recurrent(1, T))
         .add_layer("emb", emb, "ids")
         .add_layer("conv", conv, "emb"))
    prev = "conv"
    if moe:
        b = b.add_layer("moe", dj.MixtureOfExpertsLayer(n_out=E, n_experts=3, hidden=8,
                                                        capacity_factor=2.0), "conv")
        prev = "moe"
    return (b.add_layer("lstm", lstm, prev)
            .add_vertex("last", dj.LastTimeStepVertex(mask_input="ids"), "lstm")
            .add_layer("out", out, "last")
            .set_outputs("out")
            .updater(dj.UpdaterConfig(updater="adam", learning_rate=0.02))
            .seed(6)
            .build())


def seq_batches(n, seed, t=T):
    """Integer ids [B, t], ragged masks (one with a gap), the next id's
    one-hot as the label."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (B, t))
        mask = (np.arange(t)[None, :] < rng.integers(2, t + 1, B)[:, None]).astype(np.float32)
        mask[0, 1] = 0.0
        y = np.eye(V, dtype=np.float32)[rng.integers(0, V, B)]
        out.append((ids, y, mask))
    return out


def jax_f32(net):
    net.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), net.params),
             force=True)
    return net


def port_net(jnet, device="cpu"):
    if isinstance(jnet, dj.ComputationGraph):
        pnet = pt.ComputationGraph(
            pt.ComputationGraphConfiguration.from_json(jnet.conf.to_json()), device=device)
        host = {n: {k: np.asarray(v) for k, v in p.items()} for n, p in jnet.params.items()}
    else:
        pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                    device=device)
        host = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    return pt.load_jax_params(pnet, host)


def assert_params_close(jnet, pnet, exact=False):
    mine = pt.params_to_numpy(pnet)
    theirs = jnet.params
    pairs = (((n, mine[n], theirs[n]) for n in theirs) if isinstance(theirs, dict)
             else ((i, m, t) for i, (m, t) in enumerate(zip(mine, theirs))))
    for where, m, t in pairs:
        assert set(m) == set(t), where
        for k in t:
            want = np.asarray(t[k], np.float32)
            if exact:
                np.testing.assert_array_equal(m[k], want, err_msg=f"{where} {k}")
            else:
                np.testing.assert_allclose(m[k], want, rtol=RTOL,
                                           atol=ATOL * max(float(np.abs(want).max()), 1.0),
                                           err_msg=f"{where} {k}")


def masked_output(net, ids, mask):
    if isinstance(net, (dj.ComputationGraph, pt.ComputationGraph)):
        return net.output(ids, masks={"ids": mask})
    return net.output(ids, features_mask=mask)


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_sequence_classifier_serves_and_trains_like_jax(kind):
    """output() on masked integer ids, then three Adam updates: losses and
    params."""
    jnet = jax_f32((dj.MultiLayerNetwork(seq_mln_conf()) if kind == "multilayer"
                    else dj.ComputationGraph(seq_graph_conf())).init())
    pnet = port_net(jnet)
    ids, _, mask = seq_batches(1, 11)[0]
    want = masked_output(jnet, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(masked_output(pnet, ids, mask), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    jl, pl = [], []
    for ids, y, mask in seq_batches(3, 12):
        with jax.enable_x64(False):
            jnet.fit(JaxDataSet(jnp.asarray(ids), y, mask, None))
        jl.append(float(jnet.score()))
        pnet.fit(pt.DataSet(ids, y, mask, None))
        pl.append(pnet.score())
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert pnet.iteration == jnet.iteration == 3
    assert_params_close(jnet, pnet)


def test_integer_ids_stay_integer_through_the_stager_and_the_prefetcher(monkeypatch):
    """fit(stage_on_device=2) (on the CPU the staged loop, bit for bit the
    per-batch fit) and the device prefetcher hand the embedding integer
    ids. The stager takes a sequence as 3-D, so the ids are [B, T, 1], and
    pads time to a power of two, which Convolution1D's window would see
    (padded ids are id 0), so T is 8."""
    seen = []
    real = prec.RnnEmbeddingLayer.apply

    def spy(self, params, x, state, **kw):
        seen.append(x.dtype)
        return real(self, params, x, state, **kw)

    monkeypatch.setattr(prec.RnnEmbeddingLayer, "apply", spy)
    jnet = jax_f32(dj.ComputationGraph(seq_graph_conf()).init())
    batches = [pt.DataSet(ids[..., None], y, mask, None)
               for ids, y, mask in seq_batches(4, 13, t=8)]
    staged, eager = port_net(jnet), port_net(jnet)
    staged.fit(pt.ListDataSetIterator(batches), stage_on_device=2)
    for ds in batches:
        eager.fit(ds)
    assert seen and all(dt == torch.int64 for dt in seen)
    assert staged.iteration == eager.iteration == 4
    mine, theirs = pt.params_to_numpy(staged), pt.params_to_numpy(eager)
    for name in mine:
        for k in mine[name]:
            np.testing.assert_array_equal(mine[name][k], theirs[name][k])
    fetched = list(DevicePrefetchIterator(pt.ListDataSetIterator(batches), "cpu"))
    assert [ds.features.dtype for ds in fetched] == [torch.int64] * 4


# ----------------------------------------------------------------- zips
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_zips_of_the_new_layers_move_both_ways(kind, tmp_path):
    """A JAX zip after one Adam update restores in the port (params and Adam
    state exactly) and takes the next update as JAX does; the port's zip
    restores in the JAX package exactly."""
    if kind == "multilayer":
        conf = seq_mln_conf()
        conf.layers.insert(2, dj.MixtureOfExpertsLayer(n_out=E, n_experts=3, hidden=8,
                                                       top_k=2, capacity_factor=2.0))
        jnet = dj.MultiLayerNetwork(conf).init()
    else:
        jnet = dj.ComputationGraph(seq_graph_conf(moe=True)).init()
    jax_f32(jnet)
    (ids, y, mask), (ids2, y2, mask2) = seq_batches(2, 14)
    with jax.enable_x64(False):
        jnet.fit(JaxDataSet(jnp.asarray(ids), y, mask, None))
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.restore_model(path, device="cpu")
    assert pnet.iteration == 1
    assert_params_close(jnet, pnet, exact=True)
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    assert len(jleaves) == len(pnet.updater_state_leaves())
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(np.asarray(pl), np.asarray(jl))
    with jax.enable_x64(False):
        jnet.fit(JaxDataSet(jnp.asarray(ids2), y2, mask2, None))
    pnet.fit(pt.DataSet(ids2, y2, mask2, None))
    assert_params_close(jnet, pnet)

    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    assert jback.iteration == 2
    assert_params_close(jback, pnet, exact=True)
    want = masked_output(jback, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(masked_output(pnet, ids, mask), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
