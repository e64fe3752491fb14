"""The PyTorch port's causal self-attention network against the JAX package.

The net is the transformer block of ``examples/long_context.py`` without its
MoE layer, two blocks deep: [SelfAttention(causal, flash), LayerNorm] x 2
and an RnnOutputLayer, at small widths (n_out 16, 4 heads, vocab 12). The
same conf JSON builds it in each package, the JAX net's params go to the
port through ``load_jax_params``, and the same numpy inputs go through both.
The JAX side runs either leg of its attention: ``attention_impl="flash"``
(the Pallas kernels in interpret mode) or ``"xla"`` (``ring_attention.
attention``); on the CPU the port runs the kernels' plain versions whatever
``attention_impl`` says. f32 outputs, losses and params are compared at
1e-5. Tests marked ``cuda`` run the port on the card and skip where there
is none.
"""

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
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402

V, N, HEADS, B, T = 12, 16, 4, 3, 11
ATOL = RTOL = 1e-5  # f32 on both sides; sums in another order
ADAM = {"updater": "adam", "learning_rate": 3e-3}  # examples/long_context.py's
IMPLS = ("flash", "xla")
BUCKETS = (16, 40)
TBPTT = 7


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
    """The JAX package's unbucketed inference and its own kernel choice,
    cleared around each test."""
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _jax_conf(impl="flash", dtype="float32", mode="standard", activation="identity",
              **reg):
    def attn():
        return dj.SelfAttentionLayer(n_out=N, n_heads=HEADS, causal=True,
                                     attention_impl=impl, activation=activation, **reg)

    return dj.MultiLayerConfiguration(
        layers=[attn(), dj.LayerNormLayer(**reg), attn(), dj.LayerNormLayer(**reg),
                dj.RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent")],
        input_type=dj.InputType.recurrent(V), updater=dj.UpdaterConfig(**ADAM), seed=5,
        dtype=dtype, backprop_type=mode, tbptt_fwd_length=TBPTT, tbptt_back_length=TBPTT)


def _f32(tree):
    # conftest enables x64: init_params yields float64; cast for f32 parity
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


class Recorder:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _pair(jconf, perturb=0.0):
    """(JAX net, port net on the CPU): the same conf JSON and the JAX net's
    params (as f32; LayerNorm's gamma and beta moved off 1 and 0 by
    ``perturb`` so that they matter), a loss recorder on each."""
    jnet = dj.MultiLayerNetwork(jconf).init()
    rng = np.random.default_rng(1)
    params = [{k: np.asarray(v, np.float32) + (perturb * rng.normal(size=np.shape(v))
                                                  if k in ("gamma", "beta") else 0.0)
               for k, v in p.items()} for p in jnet.params]
    jnet.init(params=_f32(tuple(params)), force=True)
    pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jconf.to_json()),
                                device="cpu")
    pt.load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    return jnet, pnet


def _text(seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


def _padding_mask(seed=1, b=B, t=T):
    """Ragged lengths (trailing zeros) and a row with leading zeros."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, t + 1, b)
    m = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    m[0, :3] = 0.0
    return m


def _sequences(n=9, seed=20):
    """Next-char (features [L, V], labels [L, V]) pairs of lengths 5 to 36."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, V, int(rng.integers(6, 38)))
        out.append((np.eye(V, dtype=np.float32)[seq[:-1]],
                    np.eye(V, dtype=np.float32)[seq[1:]]))
    return out


def _assert_same_training(jnet, pnet, atol=ATOL, rtol=RTOL):
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(jl) == len(pl) and jnet.iteration == pnet.iteration
    np.testing.assert_allclose(pl, jl, atol=atol, rtol=rtol, err_msg="losses")
    for i, (jp, pp) in enumerate(zip(jnet.params, pt.params_to_numpy(pnet))):
        assert set(jp) == set(pp)
        for k in jp:
            np.testing.assert_allclose(pp[k], np.asarray(jp[k], np.float32), atol=atol,
                                       rtol=rtol, err_msg=f"layer {i} {k}")


# ------------------------------------------------------------------ conf
def test_conf_json_round_trips_both_ways():
    jconf = _jax_conf("xla", l2=0.01)
    pconf = pt.MultiLayerConfiguration.from_json(jconf.to_json())
    assert [type(l).__name__ for l in pconf.layers] == [
        "SelfAttentionLayer", "LayerNormLayer", "SelfAttentionLayer", "LayerNormLayer",
        "RnnOutputLayer"]
    assert isinstance(pconf.layers[0], pt.SelfAttentionLayer)
    assert isinstance(pconf.layers[1], pt.LayerNormLayer)
    assert dj.MultiLayerConfiguration.from_json(pconf.to_json()).to_dict() == jconf.to_dict()
    net = pt.MultiLayerNetwork(pconf, device="cpu").init()
    keys = [sorted(p) for p in net.layer_params]
    assert keys[:2] == [["Wk", "Wo", "Wq", "Wv", "bo"], ["beta", "gamma"]]
    assert sum(len(k) for k in keys) == 16
    with pytest.raises(ValueError, match="divisible"):
        pt.SelfAttentionLayer(n_out=10, n_heads=4).init_params(
            torch.Generator(), pt.InputType.recurrent(V))


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("activation", ["identity", "tanh"])
def test_layer_norm_matches_jax(activation):
    rng = np.random.default_rng(2)
    jlayer = dj.LayerNormLayer(activation=activation, eps=1e-3)
    player = pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
        layers=[jlayer], input_type=dj.InputType.recurrent(N)).to_json()).layers[0]
    params = {"gamma": rng.normal(size=N).astype(np.float32),
              "beta": rng.normal(size=N).astype(np.float32)}
    for shape in ((B, T, N), (B, N)):
        x = (3.0 * rng.normal(size=shape) + 1.0).astype(np.float32)
        want, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), {})
        got, _ = player.apply({k: torch.tensor(v) for k, v in params.items()},
                              torch.tensor(x), {})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("impl", IMPLS)
def test_self_attention_layer_matches_jax(impl, masked):
    rng = np.random.default_rng(3)
    jlayer = dj.SelfAttentionLayer(n_out=N, n_heads=HEADS, causal=True, attention_impl=impl)
    player = pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
        layers=[jlayer], input_type=dj.InputType.recurrent(V)).to_json()).layers[0]
    params = {k: np.asarray(v, np.float32) + 0.1 for k, v in jlayer.init_params(
        jax.random.PRNGKey(0), dj.InputType.recurrent(V)).items()}
    x = rng.normal(size=(B, T, V)).astype(np.float32)
    mask = _padding_mask() if masked else None
    want, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), {},
                           mask=None if mask is None else jnp.asarray(mask))
    got, _ = player.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x),
                          {}, mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_regularization_key_rule_matches_jax():
    """bo takes the bias coefficients, Wq/Wk/Wv/Wo the weight ones and
    LayerNorm's gamma none. beta takes the bias coefficients: the JAX rule
    tests the "b" prefix before it skips the normalization keys, and the
    port keeps the rule as it is."""
    reg = {"l1": 0.1, "l2": 0.2, "l1_bias": 0.03, "l2_bias": 0.05}
    for jlayer, it in ((dj.SelfAttentionLayer(n_out=N, n_heads=HEADS, **reg),
                        dj.InputType.recurrent(V)),
                       (dj.LayerNormLayer(**reg), dj.InputType.recurrent(N))):
        player = pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
            layers=[jlayer], input_type=it).to_json()).layers[0]
        params = {k: np.asarray(v, np.float64) + 0.3
                  for k, v in jlayer.init_params(jax.random.PRNGKey(0), it).items()}
        want = jlayer.regularization_loss({k: jnp.asarray(v) for k, v in params.items()})
        got = player.regularization_loss({k: torch.from_numpy(v) for k, v in params.items()})
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    attn = pt.SelfAttentionLayer(n_out=N, **reg)
    assert float(attn.regularization_loss({"bo": torch.ones(2)})) == pytest.approx(
        0.5 * 0.05 * 2 + 0.03 * 2)
    ln = pt.LayerNormLayer(**reg)
    assert float(ln.regularization_loss({"gamma": torch.ones(3)})) == 0.0
    assert float(ln.regularization_loss({"beta": torch.ones(3)})) == pytest.approx(
        0.5 * 0.05 * 3 + 0.03 * 3)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("impl", IMPLS)
def test_output_and_predict_match_jax(impl, masked):
    jnet, pnet = _pair(_jax_conf(impl, activation="tanh"), perturb=0.3)
    x = _text()
    mask = _padding_mask() if masked else None
    want = np.asarray(jnet.output(x, features_mask=mask))
    got = pnet.output(x, features_mask=mask)
    assert got.shape == (B, T, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if not masked:
        np.testing.assert_array_equal(pnet.predict(x), np.asarray(jnet.predict(x)))


def test_rnn_time_step_and_tbptt_attend_within_the_chunk():
    """The attention layer has no recurrent state: rnn_time_step attends
    within the chunk it is given, as in the JAX package, so a chunk's output
    is the output of that chunk alone."""
    jnet, pnet = _pair(_jax_conf("flash"), perturb=0.3)
    x = _text(seed=4, t=9)
    for chunk in (x[:, :4], x[:, 4:], x[:, 8]):
        want = np.asarray(jnet.rnn_time_step(chunk))
        got = pnet.rnn_time_step(chunk)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        alone = pnet.output(chunk if chunk.ndim == 3 else chunk[:, None])
        np.testing.assert_allclose(got, alone if chunk.ndim == 3 else alone[:, 0],
                                   atol=ATOL, rtol=RTOL)
    assert all(st == {} for st in pnet._rnn_state)


# -------------------------------------------------------------- training
def _bucketed(seqs):
    pit = pt.BucketingSequenceIterator(seqs, batch=B, boundaries=BUCKETS)
    jit = JaxBucketingIterator(seqs, batch=B, boundaries=BUCKETS)
    return pit, jit


@pytest.mark.parametrize("mode", ["standard", "tbptt"])
@pytest.mark.parametrize("impl", IMPLS)
def test_bucketed_adam_training_matches_jax(impl, mode):
    """The slice's training path: Adam over the bucketing iterator's padded
    batches (features and labels masks), l2 on, two epochs."""
    pit, jit = _bucketed(_sequences())
    assert {ds.features.shape[1] for ds in pit} == set(BUCKETS)
    jnet, pnet = _pair(_jax_conf(impl, mode=mode, l2=1e-3, l2_bias=5e-4))
    jnet.fit(jit, epochs=2)
    pnet.fit(pit, epochs=2)
    assert pnet.iteration >= 3 and pnet.epoch == 2
    if mode == "tbptt":  # one update per segment of 7 steps, a shorter tail included
        assert pnet.iteration == 2 * sum(-(-ds.features.shape[1] // TBPTT) for ds in pit)
    _assert_same_training(jnet, pnet)


def test_bf16_training_is_close_to_jax():
    """bf16 compute with f32 master params, against the JAX flash leg (which,
    as the port, computes attention in f32 and rounds its outputs once). The
    two packages round bf16 at other places around it (projections,
    LayerNorm, the cast of the features), and Adam turns a gradient near its
    rounding noise into a full step either way. Over seeds 21-23 the losses
    read at most 1.3e-3 apart and a tensor's change at most 0.19 of its norm
    (beta, whose gradient is small); held at 1e-2 and 0.4, where an update
    left out reads 1."""
    pit, jit = _bucketed(_sequences(seed=21))
    jnet, pnet = _pair(_jax_conf("flash", dtype="bfloat16"))
    start = pt.params_to_numpy(pnet)
    jnet.fit(jit)
    pnet.fit(pit)
    np.testing.assert_allclose(pnet.listeners[0].losses, jnet.listeners[0].losses, rtol=1e-2)
    assert pnet.layer_params[0]["Wq"].dtype == torch.float32  # f32 master params
    for jp, pp, p0 in zip(jnet.params, pt.params_to_numpy(pnet), start):
        for k in jp:
            want = np.asarray(jp[k], np.float32) - p0[k]
            assert np.linalg.norm(pp[k] - p0[k] - want) <= 0.4 * np.linalg.norm(want), k


def test_evaluate_matches_jax():
    seqs = _sequences(seed=22)
    jnet, pnet = _pair(_jax_conf("flash"))
    pit, jit = _bucketed(seqs)
    jnet.fit(jit)
    pnet.fit(pit)
    mine, theirs = pnet.evaluate(_bucketed(seqs)[0]), jnet.evaluate(_bucketed(seqs)[1])
    np.testing.assert_array_equal(mine.confusion.matrix, theirs.confusion.matrix)
    assert mine.accuracy() == pytest.approx(theirs.accuracy(), abs=1e-12)


def _same_next_update(jnet, pnet, ds):
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    jnet.fit(JaxDataSet(ds.features, ds.labels, ds.features_mask, ds.labels_mask))
    pnet.fit(ds)
    _assert_same_training(jnet, pnet)


def test_checkpoints_move_both_ways(tmp_path):
    """A JAX zip resumes in the port and a port zip in the JAX package, each
    with its 16 params' Adam moments, to the same next update; port to port
    is exact."""
    seqs = _sequences(seed=23)
    batches = list(pt.BucketingSequenceIterator(seqs, batch=B, boundaries=BUCKETS))
    jnet, pnet = _pair(_jax_conf("flash"))
    jnet.fit(_bucketed(seqs)[1])
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.restore_model(path, device="cpu")
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    assert len(jleaves) == len(pnet.updater_state_leaves()) == 2 + 2 * 16  # counts, moments
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    _same_next_update(jnet, pnet, batches[0])

    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    assert jback.iteration == pnet.iteration
    again = pt.restore_model(path, device="cpu")
    _same_next_update(jback, pnet, batches[1])
    for net in (again,):
        net.set_listeners(Recorder())
        net.fit(batches[1])
    for a, b in zip(pt.params_to_numpy(again), pt.params_to_numpy(pnet)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_net_launches_the_kernels_and_matches_cpu(cuda_device):
    conf = pt.MultiLayerConfiguration.from_json(_jax_conf("flash").to_json())
    cpu = pt.MultiLayerNetwork(conf, device="cpu").init()
    card = pt.MultiLayerNetwork(conf).init(params=pt.params_to_numpy(cpu))
    x, mask = _text(), _padding_mask()
    ops.reset_counters()
    got = card.output(x, features_mask=mask)
    assert ops.counters()["flash_attn_fwd"] == 2
    np.testing.assert_allclose(got, cpu.output(x, features_mask=mask), atol=1e-4)
    ds = next(iter(pt.BucketingSequenceIterator(_sequences(), B, BUCKETS)))
    ops.reset_counters()
    card.fit(ds)
    cpu.fit(ds)
    counts = ops.counters()
    assert (counts["flash_attn_fwd"], counts["flash_attn_bwd_dq"],
            counts["flash_attn_bwd_dkv"], counts["adam_update"]) == (2, 2, 2, 1)
    for a, b in zip(pt.params_to_numpy(card), pt.params_to_numpy(cpu)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4)
