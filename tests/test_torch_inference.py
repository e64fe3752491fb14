"""The port's bucketed inference path and its compile manager against the
JAX package (the cases of ``tests/test_inference_fastpath.py``).

The same config JSON builds a net in each package and the JAX net's f32
weights go to the port (``load_jax_params``). The JAX side runs its
unbucketed ``output`` (``DL4JTPU_INFER=legacy``): the reference's own
bucketed parity fails there (ROADMAP Queue 3). The port runs its default,
bucketed path, where on the CPU each bucket's entry in the compile manager
is the eager forward of the padded shape.

Tolerances: against JAX, ``ATOL`` (f32 on both sides, sums in another
order). Against the port's own eager path (``DL4JTPU_INFER=legacy``) the
bucketed result is bit for bit: torch's CPU kernels give every real row
and step the same bits whether or not padding surrounds it, at these
shapes. Tests marked ``cuda`` replay the captured graphs on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import compile_manager as jcm  # noqa: E402
from deeplearning4j_tpu.telemetry.memory import executable_memory as j_executable_memory  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.runtime import compile_manager as pcm  # noqa: E402
from deeplearning4j_tpu_torch.runtime import inference as inf  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.telemetry.memory import executable_memory  # noqa: E402

ATOL = 1e-5  # f32 on both sides; sums in another order


@pytest.fixture
def legacy(monkeypatch):
    """Run a callable with ``DL4JTPU_INFER=legacy`` (both packages read it)."""

    def run(fn):
        monkeypatch.setenv(inf.INFER_ENV, "legacy")
        try:
            return fn()
        finally:
            monkeypatch.delenv(inf.INFER_ENV, raising=False)

    return run


@pytest.fixture(autouse=True)
def bucketed(monkeypatch):
    monkeypatch.delenv(inf.INFER_ENV, raising=False)


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _dense_conf(pkg, n_in=5, seed=7):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=16, activation="relu"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(n_in), seed=seed)


def _rnn_conf(pkg, n_in=6, seed=3):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.GravesLSTM(n_out=12),
                pkg.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(n_in), seed=seed)


def _bn_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=8, activation="relu"), pkg.BatchNormalization(),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5), seed=11)


def _graph_conf(pkg, n_in=4):
    return (pkg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .add_layer("h", pkg.DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "h")
            .set_outputs("out")
            .set_input_types(pkg.InputType.feed_forward(n_in))
            .build())


def _rnn_graph_conf(pkg, n_in=6):
    return (pkg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .add_layer("lstm", pkg.GravesLSTM(n_out=10), "in")
            .add_layer("out", pkg.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                       "lstm")
            .set_outputs("out")
            .set_input_types(pkg.InputType.recurrent(n_in))
            .build())


def _mln_pair(conf_fn, **kw):
    jnet = dj.MultiLayerNetwork(conf_fn(dj, **kw)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                device="cpu")
    pt.load_jax_params(pnet, _host(jnet.params), state=_host(jnet.state))
    return jnet, pnet


def _graph_pair(conf_fn):
    jnet = dj.ComputationGraph(conf_fn(dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.ComputationGraph(pt.ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
                               device="cpu")
    pt.load_jax_params(pnet, _host(jnet.params))
    return jnet, pnet


def _one(out):
    """A single-output JAX graph's result (an array, or a list of one)."""
    return np.asarray(out[0] if isinstance(out, (list, tuple)) else out)


def _captures():
    return pcm.get_compile_manager().compiles.value


# ----------------------------------------------------------- bucketed parity
def test_dense_padded_rows(rng, legacy):
    jnet, pnet = _mln_pair(_dense_conf)
    x = rng.normal(size=(7, 5)).astype(np.float32)  # bucket: 8 rows
    got = pnet.output(x)
    assert got.shape == (7, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(legacy(lambda: jnet.output(x))), atol=ATOL)
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))
    assert pcm.get_compile_manager().kinds(pnet._cm_token) == ["mln_infer"]


def test_dense_each_row_alone(rng, legacy):
    """The batched bucket gives every row what JAX gives it alone (the
    serving coalescing contract, held against the unbucketed reference)."""
    jnet, pnet = _mln_pair(_dense_conf)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    got = pnet.output(x)
    for i in range(x.shape[0]):
        row = np.asarray(legacy(lambda: jnet.output(x[i:i + 1])))
        np.testing.assert_allclose(got[i:i + 1], row, atol=ATOL)


def test_recurrent_ragged_time(rng, legacy):
    jnet, pnet = _mln_pair(_rnn_conf)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)  # T=7 -> bucket 8, masked
    got = pnet.output(x)
    assert got.shape == (3, 7, 4)
    np.testing.assert_allclose(got, np.asarray(legacy(lambda: jnet.output(x))), atol=ATOL)
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))


def test_graph_padded_rows(rng, legacy):
    jnet, pnet = _graph_pair(_graph_conf)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    got = pnet.output(x)
    np.testing.assert_allclose(got, _one(legacy(lambda: jnet.output(x))), atol=ATOL)
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))
    assert pcm.get_compile_manager().kinds(pnet._cm_token) == ["graph_infer"]


def test_batchnorm_keeps_exact_rows(rng, legacy):
    """BN couples the rows through batch statistics in training, and the
    port keeps JAX's rule in serving too: no row padding, one entry per
    distinct row count."""
    jnet, pnet = _mln_pair(_bn_conf)
    assert not pnet._pad_examples_ok() and not jnet._pad_examples_ok()
    before = _captures()
    for rows in (7, 5):
        x = rng.normal(size=(rows, 5)).astype(np.float32)
        got = pnet.output(x)
        np.testing.assert_allclose(got, np.asarray(legacy(lambda: jnet.output(x))), atol=ATOL)
        np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))
    assert _captures() - before == 2  # 7 and 5 rows, no bucket of 8


def test_features_mask_passes_through(rng, legacy):
    """A caller's mask is extended over the padded steps; the real region
    is JAX's."""
    jnet, pnet = _mln_pair(_rnn_conf)
    x = rng.normal(size=(3, 6, 6)).astype(np.float32)  # T=6 -> bucket 8
    mask = np.ones((3, 6), np.float32)
    mask[1, 4:] = 0.0
    got = pnet.output(x, features_mask=mask)
    want = np.asarray(legacy(lambda: jnet.output(x, features_mask=jnp.asarray(mask))))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x, features_mask=mask)))


# ------------------------------------------------------------ zero captures
def test_mixed_row_counts_reuse_one_bucket(rng):
    _, pnet = _mln_pair(_dense_conf, seed=19)
    pnet.output(rng.normal(size=(8, 5)).astype(np.float32))
    before = _captures()
    for rows in (5, 6, 7, 8, 5, 7):
        assert pnet.output(rng.normal(size=(rows, 5)).astype(np.float32)).shape == (rows, 3)
    assert _captures() - before == 0


def test_f64_input_takes_the_f32_entry(rng):
    jnet, pnet = _mln_pair(_dense_conf, seed=23)
    x32 = rng.normal(size=(4, 5)).astype(np.float32)
    ref = pnet.output(x32)
    before = _captures()
    out64 = pnet.output(x32.astype(np.float64))
    assert _captures() - before == 0
    np.testing.assert_array_equal(out64, ref)
    assert inf.canonicalize_input(x32.astype(np.float64)).dtype == torch.float32
    np.testing.assert_allclose(out64, np.asarray(jnet.output(x32.astype(np.float64))),
                               atol=ATOL)


def test_feed_forward_casts_at_the_boundary(rng):
    _, pnet = _mln_pair(_dense_conf, seed=29)
    x32 = rng.normal(size=(4, 5)).astype(np.float32)
    acts_o = pnet.feed_forward(x32.astype(np.float64))
    acts_c = pnet.feed_forward(x32)
    assert all(a.dtype == np.float32 for a in acts_o)
    for a, b in zip(acts_c, acts_o):
        np.testing.assert_array_equal(a, b)


def test_time_buckets_bound_the_entries(rng):
    _, pnet = _mln_pair(_rnn_conf, seed=31)
    pnet.output(rng.normal(size=(2, 7, 6)).astype(np.float32))  # bucket 8, masked
    before = _captures()
    for t in (5, 6, 7, 7):
        pnet.output(rng.normal(size=(2, t, 6)).astype(np.float32))
    assert _captures() - before == 0
    # a power-of-two length runs unmasked: its own entry, as the eager path
    pnet.output(rng.normal(size=(2, 8, 6)).astype(np.float32))
    assert _captures() - before == 1


# ------------------------------------------------------------- fused argmax
def test_predict_returns_int32_indices(rng, legacy):
    jnet, pnet = _mln_pair(_dense_conf, seed=37)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    pred = pnet.predict(x)
    assert pred.dtype == np.int32 and pred.shape == (6,)
    np.testing.assert_array_equal(pred, np.asarray(legacy(lambda: jnet.output(x))).argmax(-1))
    argmax_entries = [g for g in inf.served_graphs(pnet) if g.outputs[0].dtype == torch.int32]
    assert len(argmax_entries) == 1


def test_predict_recurrent_cuts_the_time_padding(rng, legacy):
    jnet, pnet = _mln_pair(_rnn_conf, seed=41)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)  # T=5 -> bucket 8
    pred = pnet.predict(x)
    assert pred.shape == (2, 5)
    np.testing.assert_array_equal(pred, np.asarray(legacy(lambda: jnet.output(x))).argmax(-1))


def test_graph_predict(rng, legacy):
    jnet, pnet = _graph_pair(_graph_conf)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pnet.predict(x), _one(legacy(lambda: jnet.output(x))).argmax(-1))


# --------------------------------------------------------------- streaming
def _stream(net, x):
    net.rnn_clear_previous_state()
    return [np.asarray(net.rnn_time_step(x[:, :3])),  # T=3 -> bucket 4
            np.asarray(net.rnn_time_step(x[:, 3, :])),  # one step
            np.asarray(net.rnn_time_step(x[:, 4:]))]  # T=3 tail


def test_state_carries_across_bucketed_steps(rng, legacy):
    jnet, pnet = _mln_pair(_rnn_conf, seed=47)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    got = _stream(pnet, x)
    want = legacy(lambda: _stream(jnet, x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    twin = pt.MultiLayerNetwork(pnet.conf, device="cpu").init(
        params=[{k: v.detach().clone() for k, v in d.items()} for d in pnet._leaves()])
    for g, w in zip(got, legacy(lambda: _stream(twin, x))):
        np.testing.assert_array_equal(g, w)
    # the buffers hold the state after the real steps: the same as the
    # eager stream's
    for layer in (0,):
        for k in ("h", "c"):
            np.testing.assert_array_equal(pnet.rnn_get_previous_state(layer)[k].numpy(),
                                          twin.rnn_get_previous_state(layer)[k].numpy())


def test_padded_steps_need_the_extended_mask(rng, monkeypatch):
    """The wrong version: the time axis padded with no mask, so the padded
    (zero) steps move h/c; the state after the call differs."""
    _, pnet = _mln_pair(_rnn_conf, seed=48)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    pnet.rnn_time_step(x)
    right = pnet.rnn_get_previous_state(0)["h"].numpy()
    pnet.rnn_clear_previous_state()
    monkeypatch.setattr(inf, "_mask_for", lambda mask, *a: None)
    pnet.init(force=True)
    pnet.rnn_time_step(x)
    wrong = pnet.rnn_get_previous_state(0)["h"].numpy()
    assert np.abs(wrong - right).max() > 1e-3


def test_single_steps_reuse_one_entry(rng):
    _, pnet = _mln_pair(_rnn_conf, seed=53)
    pnet.rnn_clear_previous_state()
    pnet.rnn_time_step(rng.normal(size=(2, 6)).astype(np.float32))
    before = _captures()
    for _ in range(5):
        pnet.rnn_time_step(rng.normal(size=(2, 6)).astype(np.float32))
    assert _captures() - before == 0


def test_set_previous_state_writes_into_the_buffers(rng):
    _, pnet = _mln_pair(_rnn_conf, seed=57)
    x = rng.normal(size=(2, 4, 6)).astype(np.float32)
    pnet.rnn_time_step(x)
    bufs = pnet._rnn_state
    h = torch.full((2, 12), 0.25)
    pnet.rnn_set_previous_state(0, {"h": h, "c": torch.zeros(2, 12)})
    assert pnet._rnn_state is bufs and torch.equal(bufs[0]["h"], h)
    snap = pnet.rnn_get_previous_state(0)
    pnet.rnn_time_step(x)
    assert torch.equal(snap["h"], h)  # a copy: the next step does not move it


def test_graph_stream_matches_jax(rng, legacy):
    jnet, pnet = _graph_pair(_rnn_graph_conf)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    got = _stream(pnet, x)

    def jax_stream():
        jnet.rnn_clear_previous_state()
        return [_one(jnet.rnn_time_step(x[:, :3])), _one(jnet.rnn_time_step(x[:, 3, :])),
                _one(jnet.rnn_time_step(x[:, 4:]))]

    for g, w in zip(got, legacy(jax_stream)):
        np.testing.assert_allclose(g, w, atol=ATOL)
    assert set(pcm.get_compile_manager().kinds(pnet._cm_token)) == {"graph_rnn_step"}


# ---------------------------------------------------- the params it reads
def test_update_and_swap_reach_the_entries(rng, legacy):
    """After a fit (in-place update) and a swap_params, the served output
    is the eager path's on the new params, with no new entry."""
    jnet, pnet = _mln_pair(_dense_conf, seed=61)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    before_out = pnet.output(x)
    n = _captures()
    pnet.fit((x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]))
    after = pnet.output(x)
    assert np.abs(after - before_out).max() > 0
    np.testing.assert_array_equal(after, legacy(lambda: pnet.output(x)))
    pnet.swap_params(_host(jnet.params))
    np.testing.assert_array_equal(pnet.output(x), before_out)
    assert _captures() - n == 0


def test_bf16_casts_refresh_in_place(rng, legacy):
    _, pnet = _mln_pair(_dense_conf, seed=67)
    conf = pt.MultiLayerConfiguration.from_json(pnet.conf.to_json())
    conf.dtype = "bfloat16"
    bnet = pt.MultiLayerNetwork(conf, device="cpu").init(
        params=[{k: v.detach().clone() for k, v in d.items()} for d in pnet._leaves()])
    x = rng.normal(size=(4, 5)).astype(np.float32)
    bnet.output(x)
    bufs = bnet._param_buffers
    bnet.fit((x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]))
    got = bnet.output(x)
    assert bnet._param_buffers is bufs and bufs[0]["W"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got, legacy(lambda: bnet.output(x)))


def test_batchnorm_state_refreshes_after_fit(rng, legacy):
    _, pnet = _mln_pair(_bn_conf)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    pnet.output(x)
    served = pnet._served_state()
    pnet.fit((x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]))
    got = pnet.output(x)
    assert pnet._served_state() is served
    np.testing.assert_array_equal(served[1]["mean"].numpy(), pnet.state[1]["mean"].numpy())
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))


def test_batchnorm_state_refreshes_after_several_updates(rng, legacy):
    # each update rebinds the state to fresh tensors, which may take the ids
    # of the freed ones of two updates back: the served copy must follow
    _, pnet = _mln_pair(_bn_conf)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    pnet.output(x)
    for _ in range(4):
        pnet.fit((x, y))
    got = pnet.output(x)
    np.testing.assert_array_equal(pnet._served_state()[1]["var"].numpy(),
                                  pnet.state[1]["var"].numpy())
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))
    # a write that no tensor's id or version shows reaches the served copy too
    pnet.state[1]["var"].data.mul_(4.0)
    np.testing.assert_array_equal(pnet.output(x), legacy(lambda: pnet.output(x)))



def _moe_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.MixtureOfExpertsLayer(n_out=8, n_experts=4, hidden=16, top_k=1,
                                          capacity_factor=1.0, residual=True),
                pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(8), seed=3)


def test_moe_requests_keep_their_rows_and_steps(rng, legacy):
    """Expert capacity counts every token of the batch, so a MoE network's
    requests are not padded (padding 3 rows to 4 moves its outputs by
    about 0.1 here): each shape has its own entry, equal to JAX's
    unbucketed output and bit for bit to the port's eager one."""
    jnet, pnet = _mln_pair(_moe_conf)
    for shape in ((3, 4, 8), (4, 3, 8)):
        x = rng.normal(size=shape).astype(np.float32)
        got = pnet.output(x)
        np.testing.assert_allclose(got, np.asarray(legacy(lambda: jnet.output(x))), atol=ATOL)
        np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))
    shapes = [tuple(g.inputs[0].shape) for g in inf.served_graphs(pnet)]
    assert shapes == [(3, 4, 8), (4, 3, 8)] and inf._pads(pnet) == (False, False)


def _conv1d_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.GravesLSTM(n_out=6), pkg.Convolution1DLayer(n_out=6, kernel=3),
                pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(4), seed=3)


def test_conv1d_requests_keep_their_steps(rng, legacy):
    """A convolution over time after the LSTM would read the padded steps
    (where the masked LSTM holds h) at the last real steps, where the eager
    forward reads zeros: such a network pads rows but not time."""
    jnet, pnet = _mln_pair(_conv1d_conf)
    x = rng.normal(size=(3, 7, 4)).astype(np.float32)
    got = pnet.output(x)
    np.testing.assert_allclose(got, np.asarray(legacy(lambda: jnet.output(x))), atol=ATOL)
    np.testing.assert_array_equal(got, legacy(lambda: pnet.output(x)))
    assert [tuple(g.inputs[0].shape) for g in inf.served_graphs(pnet)] == [(4, 7, 4)]

# --------------------------------------------------------- the manager
def test_init_force_drops_the_entries(rng):
    _, pnet = _mln_pair(_dense_conf, seed=71)
    cm = pcm.get_compile_manager()
    pnet.output(rng.normal(size=(4, 5)).astype(np.float32))
    token = pnet._cm_token
    assert "mln_infer" in cm.kinds(token)
    pnet.init(force=True)
    assert cm.kinds(token) == [] and pnet._cm_token != token


def test_training_steps_share_the_lru(rng):
    _, pnet = _mln_pair(_dense_conf, seed=73)
    xs = rng.normal(size=(2, 4, 5)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 4))]
    before = _captures()
    pnet.fit_on_device(xs, ys)
    pnet.fit_on_device(xs, ys)
    assert pcm.get_compile_manager().kinds(pnet._cm_token) == ["train_step"]
    assert _captures() - before == 1


def test_collected_network_drops_its_token(rng):
    import gc

    cm = pcm.get_compile_manager()
    _, pnet = _mln_pair(_dense_conf, seed=79)
    pnet.output(rng.normal(size=(4, 5)).astype(np.float32))
    token = pnet._cm_token
    del pnet
    gc.collect()
    assert token in cm._retired or cm.kinds(token) == []
    assert cm.kinds(token) == [] and not cm._retired  # dropped at the next call


def test_lru_bound_evictions_and_stats_keys():
    reg = MetricsRegistry()
    cm = pcm.CompileManager(max_entries=2, registry=reg)
    tok = cm.new_token()
    dropped = []
    for i in range(3):
        cm.admit((tok, "mln_infer", i), lambda: object(), on_evict=lambda i=i: dropped.append(i))
    assert len(cm) == 2 and dropped == [0] and cm.evictions.value == 1
    assert cm.get((tok, "mln_infer", 2)) is not None and cm.cache_hits.value == 1
    assert cm.drop_token(tok) == 2 and len(cm) == 0
    jstats = jcm.CompileManager(max_entries=2, registry=dj.telemetry.MetricsRegistry()).stats()
    want = set(jstats) - {"static_cost", "kernels"}  # XLA's admission records
    assert set(cm.stats()) == want
    assert cm.max_entries == 2 and pcm.CompileManager().max_entries == \
        jcm.CompileManager(registry=dj.telemetry.MetricsRegistry()).max_entries
    names = {m.split(" ")[2] for m in reg.prometheus_text().splitlines()
             if m.startswith("# TYPE")}
    assert {"dl4jtpu_compiles_total", "dl4jtpu_compile_seconds",
            "dl4jtpu_compile_cache_hits_total", "dl4jtpu_compile_cache_evictions_total",
            "dl4jtpu_compile_cache_size", "dl4jtpu_executable_hbm_bytes",
            "dl4jtpu_executable_hbm_total_bytes"} <= names


def test_executable_memory_unavailable_shape_is_jax_s(rng):
    """Where a pool cannot be read (an eager entry on the CPU), the record
    keeps the JAX package's unavailable shape."""
    _, pnet = _mln_pair(_dense_conf, seed=83)
    pnet.output(rng.normal(size=(4, 5)).astype(np.float32))
    rec = executable_memory(inf.served_graphs(pnet)[0])

    class NoAnalysis:
        def memory_analysis(self):
            return None

    jrec = j_executable_memory(NoAnalysis())
    assert set(rec) == set(jrec) == {"available", "reason"} and rec["available"] is False
    assert pcm.get_compile_manager().stats()["memory"]["measured_entries"] == 0


def test_next_pow2_and_bucket_plan_match_jax():
    from deeplearning4j_tpu.runtime import inference as jinf

    for n in range(0, 70):
        assert pcm.next_pow2(n) == jcm.next_pow2(n)
    for b, t, pad in ((7, None, True), (7, 5, True), (7, 5, False), (1, 1, True)):
        assert inf._bucket_plan(b, t, pad) == jinf._bucket_plan(b, t, pad)


def test_legacy_knob(rng, monkeypatch):
    _, pnet = _mln_pair(_dense_conf, seed=89)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    fast = pnet.output(x)
    for value in ("legacy", "0", "off"):
        monkeypatch.setenv(inf.INFER_ENV, value)
        assert not inf.fast_path_enabled()
        np.testing.assert_array_equal(pnet.output(x), fast)
    monkeypatch.delenv(inf.INFER_ENV)
    assert inf.fast_path_enabled()


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the served graphs are captured there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_graph_matches_eager_on_the_card(cuda_device, rng, legacy):
    _, pnet = _mln_pair(_rnn_conf, seed=97)
    net = pt.MultiLayerNetwork(pnet.conf).init(
        params=[{k: v.detach().clone() for k, v in d.items()} for d in pnet._leaves()])
    x = rng.normal(size=(4, 8, 6)).astype(np.float32)
    first, second = net.output(x), net.output(x)
    graphs = inf.served_graphs(net)
    assert len(graphs) == 1 and graphs[0].graph is not None and graphs[0].replays == 2
    np.testing.assert_array_equal(first, legacy(lambda: net.output(x)))
    np.testing.assert_array_equal(second, first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_and_host_requests_share_a_graph(cuda_device, rng, legacy, dtype):
    """A card tensor is cast and copied on the card, a host array crosses as
    f32 and is rounded there: one graph, the same bits, the eager path's."""
    conf = pt.MultiLayerConfiguration.from_json(_mln_pair(_rnn_conf, seed=97)[1].conf.to_json())
    conf.dtype = dtype
    net = pt.MultiLayerNetwork(conf).init()
    x = rng.normal(size=(4, 8, 6)).astype(np.float32)
    host = net.output(x)
    card = net.output(torch.from_numpy(x).to(cuda_device))
    assert len(inf.served_graphs(net)) == 1
    np.testing.assert_array_equal(card, host)
    np.testing.assert_array_equal(host, legacy(lambda: net.output(x)))
