"""The PyTorch port's char-RNN serving slice against the JAX package.

The same config JSON builds a net in each package, the JAX net's weights go
to the port through ``load_jax_params``, and the same numpy inputs go through
``output``, ``predict`` and ``rnn_time_step`` of both. The JAX side runs its
unbucketed ``output`` (``DL4JTPU_INFER=legacy``) through the Pallas sequence
kernel in interpret mode (``DL4J_TPU_PALLAS=seq``) or its scan (``=0``); the
port runs its plain versions on the CPU. Tests marked ``cuda`` run the port on
the card and skip where there is none.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.models.char_rnn import CharIterator as jax_char_iterator  # noqa: E402
from deeplearning4j_tpu.models.char_rnn import char_rnn as jax_char_rnn  # noqa: E402
from deeplearning4j_tpu.utils.serialization import write_model  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as pt_multilayer  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

ATOL = 1e-5  # f32 on both sides; sums in another order
VOCAB, HIDDEN, B, T = 11, 16, 4, 9


def _f32(tree):
    # conftest enables x64: init_params yields float64; cast for f32 parity
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _bidirectional_conf():
    return dj.MultiLayerConfiguration(
        layers=[dj.GravesBidirectionalLSTM(n_in=VOCAB, n_out=HIDDEN),
                dj.RnnOutputLayer(n_in=HIDDEN, n_out=VOCAB, activation="softmax")],
        input_type=dj.InputType.recurrent(VOCAB), seed=7)


CONFS = {
    "char_rnn": lambda: jax_char_rnn(VOCAB, HIDDEN, num_layers=2, seed=3),
    "bidirectional": _bidirectional_conf,
}


def _pair(conf_name, monkeypatch, pallas="seq"):
    """(JAX net, port net on the CPU) with the same config and weights."""
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4J_TPU_PALLAS", pallas)
    jconf = CONFS[conf_name]()
    jnet = dj.MultiLayerNetwork(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jconf.to_json()),
                                device="cpu")
    pt.load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                              for p in jnet.params])
    return jnet, pnet


def _one_hot(idx):
    return np.eye(VOCAB, dtype=np.float32)[idx]


def _batch(seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    return _one_hot(rng.integers(0, VOCAB, (b, t)))


def _ragged_mask(seed=1, b=B, t=T):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


# ------------------------------------------------------------------ output
@pytest.mark.parametrize("pallas", ["seq", "0"])
@pytest.mark.parametrize("conf_name", sorted(CONFS))
@pytest.mark.parametrize("masked", [False, True])
def test_output_matches_jax(conf_name, pallas, masked, monkeypatch):
    jnet, pnet = _pair(conf_name, monkeypatch, pallas)
    x = _batch()
    fm = _ragged_mask() if masked else None
    want = np.asarray(jnet.output(x, features_mask=None if fm is None else jnp.asarray(fm)))
    got = pnet.output(x, features_mask=fm)
    assert got.shape == (B, T, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_predict_matches_jax(monkeypatch):
    jnet, pnet = _pair("char_rnn", monkeypatch)
    x = _batch(seed=4)
    got = pnet.predict(x)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnet.output(x), -1)))


def test_bf16_conf_serves_close_to_f32(monkeypatch):
    _, pnet = _pair("char_rnn", monkeypatch)
    conf = pt.MultiLayerConfiguration.from_json(pnet.conf.to_json())
    conf.dtype = "bfloat16"
    bnet = pt.MultiLayerNetwork(conf, device="cpu").init(
        params=[{k: v.detach() for k, v in p.items()} for p in pnet.layer_params])
    x = _batch(seed=5)
    assert bnet.compute_dtype == torch.bfloat16
    np.testing.assert_allclose(bnet.output(x), pnet.output(x), atol=2e-2)


# --------------------------------------------------------------- streaming
@pytest.mark.parametrize("pallas", ["seq", "0"])
def test_rnn_time_step_trajectory_matches_jax(pallas, monkeypatch):
    jnet, pnet = _pair("char_rnn", monkeypatch, pallas)
    rng = np.random.default_rng(8)
    steps = [_one_hot(rng.integers(0, VOCAB, B)) for _ in range(3)]
    multi, fm = _batch(seed=9, t=5), _ragged_mask(seed=10, t=5)
    for x in steps:  # 2-D single steps
        got = pnet.rnn_time_step(x)
        assert got.shape == (B, VOCAB)
        np.testing.assert_allclose(got, np.asarray(jnet.rnn_time_step(x)), atol=ATOL)
    got = pnet.rnn_time_step(multi, features_mask=fm)
    want = jnet.rnn_time_step(multi, features_mask=jnp.asarray(fm))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    for layer in (0, 1):
        for k in ("h", "c"):
            np.testing.assert_allclose(
                pnet.rnn_get_previous_state(layer)[k].numpy(),
                np.asarray(jnet.rnn_get_previous_state(layer)[k]), atol=ATOL)
    assert pnet.rnn_get_previous_state(2) is None
    x = steps[0]  # after a clear both start again from zero state
    pnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    np.testing.assert_allclose(pnet.rnn_time_step(x), np.asarray(jnet.rnn_time_step(x)),
                               atol=ATOL)


def test_rnn_set_previous_state_round_trips(monkeypatch):
    _, pnet = _pair("char_rnn", monkeypatch)
    x = _batch(seed=11, t=3)
    pnet.rnn_time_step(x)
    saved = [{k: v.clone() for k, v in pnet.rnn_get_previous_state(i).items()}
             for i in (0, 1)]
    first = pnet.rnn_time_step(x[:, 0])
    for i, st in enumerate(saved):
        pnet.rnn_set_previous_state(i, {k: v.numpy() for k, v in st.items()})
    np.testing.assert_array_equal(pnet.rnn_time_step(x[:, 0]), first)


def test_rnn_time_step_batch_change_restarts_state(monkeypatch):
    _, pnet = _pair("char_rnn", monkeypatch)
    pnet.rnn_time_step(_batch(seed=12, t=2))
    one = _batch(seed=13, b=1, t=2)
    got = pnet.rnn_time_step(one)
    pnet.rnn_clear_previous_state()
    np.testing.assert_array_equal(got, pnet.rnn_time_step(one))


# ------------------------------------------------------------------ decode
def _decode(server, first, n, out, key):
    sid = server.open()
    tok, rows = first, []
    try:
        for _ in range(n):
            row = server.step(sid, _one_hot(tok))
            rows.append(row)
            tok = int(np.argmax(row))
    finally:
        server.close(sid)
    out[key] = np.stack(rows)


def _alone(pnet, first, n):
    pnet.rnn_clear_previous_state()
    tok, rows = first, []
    for _ in range(n):
        row = pnet.rnn_time_step(_one_hot(np.array([tok])))[0]
        rows.append(row)
        tok = int(np.argmax(row))
    return np.stack(rows)


def test_decode_sessions_match_running_alone(monkeypatch):
    _, pnet = _pair("char_rnn", monkeypatch)
    server = pt.DecodeServer(pnet, capacity=4, max_delay_ms=5.0)
    out = {}
    try:
        threads = [threading.Thread(target=_decode, args=(server, s, 6 + s, out, s))
                   for s in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        server.stop()
    assert sorted(out) == [0, 1, 2]
    for s, rows in out.items():
        np.testing.assert_allclose(rows, _alone(pnet, s, 6 + s), atol=ATOL)


def test_decode_close_and_open_resets_slot(monkeypatch):
    _, pnet = _pair("char_rnn", monkeypatch)
    server = pt.DecodeServer(pnet, capacity=2, max_delay_ms=0.0)
    try:
        sid = server.open()
        first = server.step(sid, _one_hot(3))
        server.step(sid, _one_hot(5))
        server.close(sid)
        sid = server.open()
        assert server.sessions() == 1
        np.testing.assert_array_equal(server.step(sid, _one_hot(3)), first)
        for layer in (0, 1):
            assert bool(torch.count_nonzero(pnet._rnn_state[layer]["h"][1]) == 0)
        with pytest.raises(KeyError):
            server.step("no-such-session", _one_hot(0))
        server.open()
        with pytest.raises(RuntimeError, match="slots are in use"):
            server.open()
    finally:
        server.stop()


def test_decode_open_after_streaming_another_batch(monkeypatch):
    """The net streamed a batch of another size before the server: opening
    any slot restarts from zero state instead of indexing the old one."""
    _, pnet = _pair("char_rnn", monkeypatch)
    first = _alone(pnet, 2, 1)[0]  # leaves a batch-1 streaming state
    server = pt.DecodeServer(pnet, capacity=4, max_delay_ms=0.0)
    try:
        server.open()
        sid = server.open()  # slot 1, beyond the batch-1 state
        np.testing.assert_allclose(server.step(sid, _one_hot(2)), first, atol=ATOL)
    finally:
        server.stop()


# ------------------------------------------------------- weights and config
def test_load_jax_model_zip_round_trip(tmp_path, monkeypatch):
    jnet, _ = _pair("char_rnn", monkeypatch)
    path = str(tmp_path / "char_rnn.zip")
    write_model(jnet, path)
    pnet = pt.load_jax_model_zip(path, device="cpu")
    x = _batch(seed=14)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)), atol=ATOL)
    assert pnet.conf.to_json() == jnet.conf.to_json()


def test_load_jax_params_refuses_wrong_shapes(monkeypatch):
    jnet, pnet = _pair("char_rnn", monkeypatch)
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    params[0]["RW"] = params[0]["RW"][:, :-1]
    with pytest.raises(ValueError, match="RW"):
        pt.load_jax_params(pnet, params)
    params[0] = {"W": params[0]["W"]}
    with pytest.raises(ValueError, match="keys"):
        pt.load_jax_params(pnet, params)


@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_same_json_configures_both_packages(conf_name):
    jconf = CONFS[conf_name]()
    pconf = pt.MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.to_json() == jconf.to_json()
    ported = pt.char_rnn(VOCAB, HIDDEN, num_layers=2, seed=3)
    back = dj.MultiLayerConfiguration.from_json(ported.to_json())
    assert back.to_json() == jax_char_rnn(VOCAB, HIDDEN, num_layers=2, seed=3).to_json()


def test_unported_layer_is_refused():
    """A layer type the port does not know is refused by name. Every layer
    of the JAX package is ported, so the JSON names a type of its own (as a
    user's layer registered with the JAX package alone would)."""
    conf = dj.MultiLayerConfiguration(
        layers=[dj.AutoEncoder(n_out=4)],
        input_type=dj.InputType.feed_forward(8))
    text = conf.to_json().replace('"AutoEncoder"', '"UsersOwnLayer"')
    with pytest.raises(ValueError, match="UsersOwnLayer.*not ported"):
        pt.MultiLayerConfiguration.from_json(text)


def test_char_iterator_batches():
    """The port's CharIterator yields the JAX package's DataSets, batch for
    batch from the same seed."""
    text = "hello world, hello port " * 4
    it = pt.models.char_rnn.CharIterator(text, seq_length=5, batch_size=3)
    batches = list(it)
    theirs = list(jax_char_iterator(text, seq_length=5, batch_size=3))
    assert len(batches) == len(theirs) > 1
    ds = batches[0]
    assert isinstance(ds, pt.DataSet)
    x, y = ds.features, ds.labels
    assert x.shape == y.shape == (3, 5, it.vocab_size)
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    for mine, jds in zip(batches, theirs):
        np.testing.assert_array_equal(mine.features, jds.features)
        np.testing.assert_array_equal(mine.labels, jds.labels)


# ------------------------------------------------------------------ device
def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.MultiLayerNetwork(pt.char_rnn(VOCAB, HIDDEN))
    with pytest.raises(RuntimeError):
        pt_multilayer.resolve_device("cuda:0")
    assert pt.MultiLayerNetwork(pt.char_rnn(VOCAB, HIDDEN), device="cpu").device.type == "cpu"


def test_unsupported_activation_runs_plain_on_cpu(monkeypatch):
    """An activation the kernel does not take goes to the plain version on
    the CPU (and raises on CUDA, tested on the card)."""
    jconf = jax_char_rnn(VOCAB, HIDDEN, num_layers=1, seed=3)
    jconf.layers[0].activation = "softmax"
    jnet = dj.MultiLayerNetwork(jconf).init()
    jnet.init(params=_f32(jnet.params), force=True)
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4J_TPU_PALLAS", "0")
    pnet = pt.load_jax_params(
        pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jconf.to_json()),
                             device="cpu"),
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    x = _batch(seed=15)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)), atol=ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cuda_serving_matches_cpu(cuda_device, dtype, atol, monkeypatch):
    _, cpu = _pair("char_rnn", monkeypatch)
    conf = pt.MultiLayerConfiguration.from_json(cpu.conf.to_json())
    conf.dtype = dtype
    params = [{k: v.detach() for k, v in p.items()} for p in cpu.layer_params]
    cpu = pt.MultiLayerNetwork(conf, device="cpu").init(params=params)
    gpu = pt.MultiLayerNetwork(conf, device=cuda_device).init(params=params)
    x, fm = _batch(seed=16), _ragged_mask(seed=17)
    before = dict(ls.launches)
    np.testing.assert_allclose(gpu.output(x, features_mask=fm),
                               cpu.output(x, features_mask=fm), atol=atol)
    assert ls.launches["lstm_seq_lean_masked"] == before["lstm_seq_lean_masked"] + 2


@pytest.mark.cuda
def test_cuda_refuses_activation_without_kernel(cuda_device):
    conf = pt.char_rnn(VOCAB, HIDDEN, num_layers=1)
    conf.layers[0].activation = "softmax"
    net = pt.MultiLayerNetwork(conf, device=cuda_device)
    with pytest.raises(NotImplementedError, match="softmax"):
        net.output(_batch())
