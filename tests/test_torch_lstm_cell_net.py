"""The char-RNN on the port's per-step cell route (``lstm_variant=
"fusedcell"``) against the JAX package's "fusedcell" scan.

The same JSON conf builds a net in each package (2 GravesLSTM layers of
width 12, or one bidirectional layer), the JAX net's params, with non-zero
peepholes, go to the port through ``load_jax_params``, and the same numpy
inputs go through ``output``, ``rnn_time_step`` and ``fit`` of both. The JAX
side runs under ``DL4J_TPU_PALLAS=1``, which makes its scan call the Pallas
cell (``fused_lstm_cell``, interpret mode) at every step; each test shows
it did, by ``kernel_select.selection_log()`` and a spy on
``pallas_kernels.fused_lstm_cell``. Serving is held to the JAX package's
unbucketed ``output`` (``DL4JTPU_INFER=legacy``) and f32 Adam runs the JAX
side with x64 off. Tolerances: f32 1e-5 (sums in another order). bf16: the
cell rounds as the JAX cell does, but the dense head and the softmax round
at other places in the two packages; the limits are about 10x the readings
on the CPU (probabilities 4.9e-4 abs, losses 2.4e-6 relative, f32 master
params 4.9e-5 abs after two SGD updates). Tests marked ``cuda`` run the
route on the card and skip where there is no card.
"""

import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    BucketingSequenceIterator as JaxBucketingIterator,
    DataSet as JaxDataSet,
)
from deeplearning4j_tpu.ops import kernel_select, pallas_kernels  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.runtime.compile_manager import next_pow2  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402

V, H, B, T, TBPTT = 11, 12, 3, 7, 3
ATOL = RTOL = 1e-5  # f32 on both sides; sums in another order
BF16_OUTPUT_ATOL, BF16_LOSS_RTOL, BF16_PARAM_ATOL = 5e-3, 1e-4, 5e-4
SGD = {"updater": "sgd", "learning_rate": 0.1}
ADAM = {"updater": "adam", "learning_rate": 0.01}


@pytest.fixture
def jax_cell(monkeypatch, tmp_path):
    """The JAX package on its "fusedcell" route, with a spy on its cell.
    Yields a check that the route ran: the selection log resolved every
    LSTM direction to "fusedcell" and the spy saw calls."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "1")
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    calls = []
    real = pallas_kernels.fused_lstm_cell

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pallas_kernels, "fused_lstm_cell", spy)

    def ran_the_cell():
        lstm = [r["variant"] for r in kernel_select.selection_log() if r["site"] == "lstm_seq"]
        assert lstm and set(lstm) == {"fusedcell"}, lstm
        assert calls

    yield ran_the_cell
    kernel_select.reset()


def _with_peepholes(params, seed):
    """The JAX net's params as f32 numpy, peepholes made non-zero (GravesLSTM
    starts them at zero, where a misplaced peephole term reads 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in params:
        layer = {k: np.asarray(v, np.float32) for k, v in p.items()}
        for k in layer:
            if k.removeprefix("bwd_") in ("pF", "pI", "pO"):
                layer[k] = rng.normal(0.0, 0.3, layer[k].shape).astype(np.float32)
        out.append(layer)
    return out


def _char_conf(mode="standard", updater=None, dtype="float32"):
    conf = pt.char_rnn(V, H, 2, tbptt_length=TBPTT, dtype=dtype)
    conf.updater = dict(updater or SGD)
    conf.backprop_type = mode
    return conf


def _bidirectional_conf(updater=None):
    return pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
        layers=[dj.GravesBidirectionalLSTM(n_in=V, n_out=H),
                dj.RnnOutputLayer(n_in=H, n_out=V, activation="softmax")],
        input_type=dj.InputType.recurrent(V),
        updater=dj.UpdaterConfig(**(updater or SGD))).to_json())


class Recorder:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _pair(conf, seed=3, lstm_variant="fusedcell"):
    """(JAX net, port net on the CPU on ``lstm_variant``): the same conf
    JSON and params, a loss recorder on each."""
    jnet = dj.MultiLayerNetwork(dj.MultiLayerConfiguration.from_json(conf.to_json()))
    jnet.conf.seed = seed
    jnet.init()
    params = _with_peepholes(jnet.params, seed)
    jnet.init(params=[{k: jnp.asarray(v) for k, v in p.items()} for p in params],
              force=True)
    pnet = pt.load_jax_params(pt.MultiLayerNetwork(conf, device="cpu",
                                                   lstm_variant=lstm_variant), params)
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    return jnet, pnet


def _batches(n=2, seed=0, masks=False, t=T):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, V, (B, t + 1))
        x = np.eye(V, dtype=np.float32)[seq[:, :-1]]
        y = np.eye(V, dtype=np.float32)[seq[:, 1:]]
        fm = lm = None
        if masks:  # leading, interior and trailing zeros
            fm = np.ones((B, t), np.float32)
            fm[0, :2] = 0.0
            fm[1, 3:5] = 0.0
            fm[2, t - 2:] = 0.0
            lm = fm.copy()
        out.append((x, y, fm, lm))
    return out


def _assert_same_training(jnet, pnet, atol=ATOL, rtol=RTOL):
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(jl) == len(pl) == jnet.iteration == pnet.iteration
    np.testing.assert_allclose(pl, jl, atol=atol, rtol=rtol, err_msg="losses")
    for i, (jp, pp) in enumerate(zip(jnet.params, pt.params_to_numpy(pnet))):
        for k in jp:
            np.testing.assert_allclose(pp[k], np.asarray(jp[k], np.float32), atol=atol,
                                       rtol=rtol, err_msg=f"layer {i} {k}")


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("conf_name", ["char_rnn", "bidirectional"])
def test_output_matches_jax(conf_name, masked, jax_cell):
    conf = _char_conf() if conf_name == "char_rnn" else _bidirectional_conf()
    jnet, pnet = _pair(conf)
    x, _, fm, _ = _batches(1, seed=1, masks=masked)[0]
    want = np.asarray(jnet.output(x, features_mask=None if fm is None else jnp.asarray(fm)))
    jax_cell()
    got = pnet.output(x, features_mask=fm)
    assert got.shape == (B, T, V)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(pnet.predict(x), pnet.output(x).argmax(-1))


def test_bf16_output_close_to_jax(jax_cell):
    conf = _char_conf(dtype="bfloat16")
    jnet, pnet = _pair(conf)
    x, _, _, _ = _batches(1, seed=2)[0]
    want = np.asarray(jnet.output(x), np.float32)
    jax_cell()
    assert pnet.compute_dtype == torch.bfloat16
    np.testing.assert_allclose(pnet.output(x), want, atol=BF16_OUTPUT_ATOL)


def test_rnn_time_step_matches_jax(jax_cell):
    jnet, pnet = _pair(_char_conf())
    x, _, fm, _ = _batches(1, seed=3, masks=True)[0]
    for t in range(3):  # single steps, then a masked multi-step call
        np.testing.assert_allclose(pnet.rnn_time_step(x[:, t]),
                                   np.asarray(jnet.rnn_time_step(x[:, t])), atol=ATOL)
    np.testing.assert_allclose(pnet.rnn_time_step(x[:, 3:], features_mask=fm[:, 3:]),
                               np.asarray(jnet.rnn_time_step(
                                   x[:, 3:], features_mask=jnp.asarray(fm[:, 3:]))),
                               atol=ATOL)
    jax_cell()
    for layer in (0, 1):
        for k in ("h", "c"):
            np.testing.assert_allclose(pnet.rnn_get_previous_state(layer)[k].numpy(),
                                       np.asarray(jnet.rnn_get_previous_state(layer)[k]),
                                       atol=ATOL)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("mode", ["standard", "tbptt"])
@pytest.mark.parametrize("masked", [False, True])
def test_sgd_fit_matches_jax(mode, masked, jax_cell):
    jnet, pnet = _pair(_char_conf(mode))
    for x, y, fm, lm in _batches(2, seed=4, masks=masked):
        jnet.fit(JaxDataSet(x, y, fm, lm))
        pnet.fit(pt.DataSet(x, y, fm, lm))
    jax_cell()
    assert pnet.iteration == (2 if mode == "standard" else 6)  # T=7: segments 3, 3, 1
    _assert_same_training(jnet, pnet)


def _sequences(n=8, seed=20):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, V, int(rng.integers(3, T + 4)))
        out.append((np.eye(V, dtype=np.float32)[seq[:-1]],
                    np.eye(V, dtype=np.float32)[seq[1:]]))
    return out


BUCKETS = (4, T + 2)


@pytest.mark.parametrize("mode", ["standard", "tbptt"])
def test_bucketed_adam_fit_matches_jax(mode, jax_cell):
    """The char-RNN's recipe, Adam over padded variable-length batches (both
    masks), two epochs; the masks stay outside the cell on both sides."""
    seqs = _sequences()
    jnet, pnet = _pair(_char_conf(mode, ADAM))
    with jax.enable_x64(False):
        jnet.fit(JaxBucketingIterator(seqs, batch=B, boundaries=BUCKETS), epochs=2)
    pnet.fit(pt.BucketingSequenceIterator(seqs, batch=B, boundaries=BUCKETS), epochs=2)
    jax_cell()
    assert pnet.epoch == 2
    _assert_same_training(jnet, pnet)


def test_bidirectional_fit_matches_jax(jax_cell):
    """The reverse direction runs the cell over the flipped sequence."""
    jnet, pnet = _pair(_bidirectional_conf({"updater": "nesterovs", "learning_rate": 0.1}))
    for x, y, fm, lm in _batches(2, seed=5, masks=True):
        jnet.fit(JaxDataSet(x, y, fm, lm))
        pnet.fit(pt.DataSet(x, y, fm, lm))
    jax_cell()
    _assert_same_training(jnet, pnet)


def test_bf16_fit_close_to_jax(jax_cell):
    """bf16 compute with f32 master params: the cell rounds as the JAX cell
    does; the loss head and the updates agree to bf16's precision."""
    jnet, pnet = _pair(_char_conf("standard", dtype="bfloat16"))
    for x, y, fm, lm in _batches(2, seed=6):
        jnet.fit(JaxDataSet(x, y, fm, lm))
        pnet.fit(pt.DataSet(x, y, fm, lm))
    jax_cell()
    np.testing.assert_allclose(pnet.listeners[0].losses, jnet.listeners[0].losses,
                               rtol=BF16_LOSS_RTOL)
    for jp, pp in zip(jnet.params, pt.params_to_numpy(pnet)):
        for k in jp:
            np.testing.assert_allclose(pp[k], np.asarray(jp[k], np.float32),
                                       atol=BF16_PARAM_ATOL, err_msg=k)


# ------------------------------------------------- the port's two routes
@pytest.mark.parametrize("mode", ["standard", "tbptt"])
def test_fusedcell_route_matches_seqfused_route(mode):
    """On the CPU both routes run plain versions of the same math: the same
    outputs and the same masked Adam trajectory at the f32 limit."""
    nets = {}
    for route in ops.LSTM_VARIANTS:
        _, net = _pair(_char_conf(mode, ADAM), lstm_variant=route)
        assert net.lstm_variant == route
        for x, y, fm, lm in _batches(2, seed=7, masks=True):
            net.fit(pt.DataSet(x, y, fm, lm))
        nets[route] = net
    cell, seq = nets["fusedcell"], nets["seqfused"]
    np.testing.assert_allclose(cell.listeners[0].losses, seq.listeners[0].losses,
                               rtol=RTOL)
    for a, b in zip(pt.params_to_numpy(cell), pt.params_to_numpy(seq)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL, err_msg=k)
    x = _batches(1, seed=8)[0][0]
    np.testing.assert_allclose(cell.output(x), seq.output(x), atol=ATOL)


def test_route_runs_the_cell_and_no_sequence_op(monkeypatch):
    """Under "fusedcell" each layer calls the cell once a step (forward and,
    under grad, its Function) and never the sequence op. ``output`` serves
    the power-of-two time bucket (T=7 runs 8 masked steps); ``fit`` runs
    the batch's own T."""
    calls = {"cell": 0, "seq": 0}
    real_cell, real_seq = ops.lstm_cell_forward, ops.lstm_sequence_apply
    cell_mod = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")

    def cell_spy(*a, **k):
        calls["cell"] += 1
        return real_cell(*a, **k)

    def seq_spy(*a, **k):
        calls["seq"] += 1
        return real_seq(*a, **k)

    monkeypatch.setattr(cell_mod, "lstm_cell_forward", cell_spy)
    monkeypatch.setattr(ops, "lstm_sequence_apply", seq_spy)
    _, pnet = _pair(_char_conf("standard"))
    x, y, _, _ = _batches(1, seed=9)[0]
    served = next_pow2(T)
    pnet.output(x)
    assert calls == {"cell": 2 * served, "seq": 0}
    pnet.fit((x, y))
    assert calls == {"cell": 2 * served + 2 * T, "seq": 0}


def test_unknown_variant_raises():
    conf = _char_conf()
    for bad in ("reference", "scan", "FusedCell"):
        with pytest.raises(ValueError, match="lstm_variant"):
            pt.MultiLayerNetwork(conf, device="cpu", lstm_variant=bad)
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    assert net.lstm_variant == "seqfused"  # the default
    net.lstm_variant = "reference"
    with pytest.raises(ValueError, match="lstm_variant"):
        net.output(_batches(1)[0][0])


# ------------------------------------------------------------------ decode
def _one_hot(idx):
    return np.eye(V, dtype=np.float32)[idx]


def _alone(net, first, n):
    net.rnn_clear_previous_state()
    tok, rows = first, []
    for _ in range(n):
        row = net.rnn_time_step(_one_hot(np.array([tok])))[0]
        rows.append(row)
        tok = int(np.argmax(row))
    return np.stack(rows)


def test_decode_server_on_the_cell_route(monkeypatch):
    """A DecodeServer over a fusedcell net: each session's outputs are those
    it gets alone, and every tick calls the cell once per layer (its masked
    tick goes through rnn_time_step)."""
    _, net = _pair(_char_conf())
    cell_mod = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    calls = []
    real = cell_mod.lstm_cell_forward

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(cell_mod, "lstm_cell_forward", spy)
    server = pt.DecodeServer(net, capacity=4, max_delay_ms=5.0)
    out = {}

    def session(first, n, key):
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

    try:
        threads = [threading.Thread(target=session, args=(s, 4 + s, s)) for s in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        ticks = server.ticks
    finally:
        server.stop()
    assert calls == [4] * (2 * ticks)  # one cell call per layer and tick, on all 4 slots
    for s, rows in out.items():
        np.testing.assert_allclose(rows, _alone(net, s, 4 + s), atol=ATOL)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_route_launches_the_cell_kernels(cuda_device):
    """On the card the route launches row 1 once per layer and step (decode:
    and tick) and row 2 once per layer and step under fit, no sequence
    kernel, and matches the CPU; an activation the kernel does not take
    raises."""
    conf = _char_conf()
    host = pt.params_to_numpy(pt.MultiLayerNetwork(conf, device="cpu").init())
    nets = {dev: pt.MultiLayerNetwork(conf, device=dev, lstm_variant="fusedcell").init(
        params=host) for dev in ("cpu", cuda_device)}
    x, y, _, _ = _batches(1, seed=10)[0]
    ops.reset_counters()
    np.testing.assert_allclose(nets[cuda_device].output(x), nets["cpu"].output(x), atol=1e-4)
    nets[cuda_device].fit((x, y))
    torch.cuda.synchronize()
    launched = {k: v for k, v in ops.counters().items() if v}
    assert launched == {"lstm_cell_fwd": 4 * T, "lstm_cell_bwd": 2 * T,
                        "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
    ops.reset_counters()
    server = pt.DecodeServer(nets[cuda_device], capacity=4, max_delay_ms=0.0)
    try:
        sid = server.open()
        for tok in range(3):
            server.step(sid, _one_hot(tok))
        ticks = server.ticks
    finally:
        server.stop()
    assert ops.counters()["lstm_cell_fwd"] == 2 * ticks
    conf.layers[0].activation = "softmax"
    bad = pt.MultiLayerNetwork(conf, device=cuda_device, lstm_variant="fusedcell").init()
    with pytest.raises(NotImplementedError, match="softmax"):
        bad.output(x)
