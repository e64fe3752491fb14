"""The PyTorch port's LSTM sequence training (forward with residuals and the
reverse-time backward) against the JAX package.

The JAX side runs ``fused_lstm_sequence`` under ``jax.grad`` with its Pallas
kernels in interpret mode (as tests/test_pallas_ops.py runs them), and its
``_seq_fwd_impl``/``_seq_bwd`` directly; the port runs
``LstmSequenceFunction`` and its plain versions on the CPU. The same numpy
inputs go to both: f64 is held at 1e-9, f32 at 1e-5. One exception: the JAX
backward sums dRW and the peephole grads in f32 scratch whatever the input
dtype (``pallas_kernels.py:632-634``), so in f64 those four are held to the
JAX kernel at 1e-6 of their largest element, and at 1e-9 to an f64 autograd
oracle (torch autograd through the plain forward). The layer tests take
the gradient through ``GravesLSTM``, so a forward under grad that skipped the
residuals or a wrong dRW fails them as it fails the op tests. Tests marked
``cuda`` hold the CUDA kernels against the plain versions and skip where
there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    _seq_bwd,
    _seq_fwd_impl,
    fused_lstm_sequence as jax_seq,
)

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

T, B, H, V = 7, 3, 8, 11
TOL = {np.float64: 1e-9, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
ACT_GATE = [("tanh", "sigmoid"), ("tanh", "hardsigmoid"), ("relu", "sigmoid")]
NAMES = ("zx", "h0", "c0", "RW", "pF", "pI", "pO")


def _inputs(dtype, seed=0, t=T):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.5).astype(dtype)  # noqa: E731
    return [r(t, B, 4 * H), r(B, H), r(B, H), r(H, 4 * H) * 0.8,
            r(H) * 0.4, r(H) * 0.4, r(H) * 0.4]


def _upstream(dtype, seed=1, t=T):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in ((t, B, H), (B, H), (B, H))]


SUMMED = ("RW", "pF", "pI", "pO", "dRW", "dpF", "dpI", "dpO")


def _close(got, want, dtype, name=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=name)


def _close_to_jax(got, want, dtype, name):
    """As _close, but an f64 grad that the JAX kernel sums in f32 scratch is
    held at 1e-6 of its largest element."""
    if dtype is np.float64 and name in SUMMED:
        want = np.asarray(want)
        atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0, err_msg=name)
    else:
        _close(got, want, dtype, name)


def _objective(ys, hT, cT, sin):
    # touches all three outputs, so every upstream gradient is nonzero
    return (ys * ys).sum() + hT.sum() + 0.5 * sin(cT).sum()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_function_grads_match_jax_under_grad(act, gate, dtype):
    arrs = _inputs(dtype, seed=3)
    want = jax.grad(lambda *a: _objective(*jax_seq(*a, act, gate), jnp.sin),
                    argnums=tuple(range(7)))(*[jnp.asarray(a) for a in arrs])
    tens = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = ops.lstm_sequence_apply(*tens, act, gate)
    assert type(out[0].grad_fn).__name__ == "LstmSequenceFunctionBackward"
    _objective(*out, torch.sin).backward()
    for t, w, name in zip(tens, want, NAMES):
        _close_to_jax(t.grad.numpy(), w, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_function_grads_match_autograd_oracle(act, gate, dtype):
    """All seven grads against torch autograd through the plain forward loop,
    code that shares nothing with the hand-derived backward."""
    arrs = _inputs(dtype, seed=4)
    tens = [torch.from_numpy(a).requires_grad_() for a in arrs]
    oracle = [torch.from_numpy(a).requires_grad_() for a in arrs]
    _objective(*ops.lstm_sequence_apply(*tens, act, gate), torch.sin).backward()
    _objective(*ls.lstm_sequence_reference(*oracle, act, gate), torch.sin).backward()
    for t, o, name in zip(tens, oracle, NAMES):
        _close(t.grad.numpy(), o.grad.numpy(), dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_train_forward_reference_matches_jax_residuals(act, gate, dtype):
    arrs = _inputs(dtype, seed=5)
    want = _seq_fwd_impl(*[jnp.asarray(a) for a in arrs], act, gate)
    got = ops.lstm_sequence_train_forward(*[torch.from_numpy(a) for a in arrs],
                                          act, gate)
    for g, w, name in zip(got, want, ("ys", "a", "f", "o", "i", "c", "hT", "cT")):
        _close(g.numpy(), w, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_backward_reference_matches_jax_seq_bwd(act, gate, dtype):
    arrs = _inputs(dtype, seed=7)
    jarrs = [jnp.asarray(a) for a in arrs]
    ys, a, f, o, i, c, _, _ = _seq_fwd_impl(*jarrs, act, gate)
    residuals = (ys, a, f, o, i, c) + tuple(jarrs[1:])
    up = _upstream(dtype, seed=8)
    want = _seq_bwd(act, gate, residuals, tuple(jnp.asarray(u) for u in up))
    got = ls.lstm_sequence_backward_reference(
        *[torch.from_numpy(u) for u in up],
        *[torch.from_numpy(np.array(r)) for r in residuals], act, gate)
    for g, w, name in zip(got, want, ("dzx", "dh0", "dc0", "dRW", "dpF", "dpI", "dpO")):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype, name
        _close_to_jax(g.numpy(), w, dtype, name)


def test_primal_and_forward_rule_split():
    """Under grad the op keeps the residuals; under no_grad, or with no input
    that needs a gradient, it runs the lean primal and keeps nothing."""
    arrs = [torch.from_numpy(a) for a in _inputs(np.float32)]
    leaves = [a.clone().requires_grad_() for a in arrs]
    ys, _, _ = ops.lstm_sequence_apply(*leaves)
    assert len(ys.grad_fn.saved_tensors) == 12  # ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO
    with torch.no_grad():
        lean = ops.lstm_sequence_apply(*leaves)
    assert lean[0].grad_fn is None
    plain = ops.lstm_sequence_apply(*arrs)
    assert plain[0].grad_fn is None
    for x, y in zip(lean, plain):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(lean, ops.lstm_sequence_reference(*arrs)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_apply_with_a_mask_picks_the_masked_version():
    """With a mask the op runs the masked training forward under the
    Function when an input needs a gradient, the lean masked primal
    otherwise; both give the masked reference's values."""
    arrs = [torch.from_numpy(a) for a in _inputs(np.float32, seed=3)]
    mask = torch.from_numpy(
        (np.arange(T)[:, None] < np.array([T, 4, 2])[None, :]).astype(np.float32)[..., None])
    want = ls.lstm_sequence_masked_reference(arrs[0], mask, *arrs[1:])
    leaves = [a.clone().requires_grad_() for a in arrs]
    trained = ops.lstm_sequence_apply(*leaves, mask=mask)
    assert type(trained[0].grad_fn).__name__ == "LstmSequenceFunctionBackward"
    with torch.no_grad():
        lean = ops.lstm_sequence_apply(*leaves, mask=mask)
    assert lean[0].grad_fn is None
    for got in (trained, lean):
        for x, y in zip(got, want):
            torch.testing.assert_close(x.detach(), y, rtol=0, atol=0)


def test_empty_sequence_passes_the_state_through():
    arrs = [torch.from_numpy(a) for a in _inputs(np.float32, t=0)]
    up = [torch.from_numpy(u) for u in _upstream(np.float32, t=0)]
    ys, a, f, o, i, c, hT, cT = ops.lstm_sequence_train_forward(*arrs)
    assert ys.shape == (0, B, H)
    torch.testing.assert_close(hT, arrs[1])
    grads = ops.lstm_sequence_backward(*up, ys, a, f, o, i, c, *arrs[1:])
    assert grads[0].shape == (0, B, 4 * H)
    torch.testing.assert_close(grads[1], up[1])
    assert float(grads[3].abs().max()) == 0.0


# ----------------------------------------------------- through the layers
def _layer_pair(kind, dtype, seed=11):
    """A JAX layer and the port's, with the same params (numpy, ``dtype``)."""
    jlayer = {"lstm": dj.GravesLSTM, "bidirectional": dj.GravesBidirectionalLSTM}[kind](
        n_in=V, n_out=H)
    params = jlayer.init_params(jax.random.PRNGKey(seed), dj.InputType.recurrent(V))
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.2 * rng.normal(size=np.shape(v))).astype(dtype)
              for k, v in params.items()}
    player = pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
        layers=[jlayer], input_type=dj.InputType.recurrent(V)).to_json()).layers[0]
    return jlayer, player, params


@pytest.mark.parametrize("pallas", ["seq", "0"])
@pytest.mark.parametrize("kind", ["lstm", "bidirectional"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_layer_param_grads_match_jax(kind, pallas, dtype, monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_PALLAS", pallas)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "cal.json"))
    jlayer, player, params = _layer_pair(kind, dtype)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, T, V)).astype(dtype)
    w = rng.normal(size=(B, T, H)).astype(dtype)

    def jloss(p):
        y, _ = jlayer.apply(p, jnp.asarray(x), {}, train=True)
        return jnp.sum(y * w)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    y, _ = player.apply(tp, torch.from_numpy(x), {}, train=True)
    (y * torch.from_numpy(w)).sum().backward()
    for k in params:
        name = k.replace("bwd_", "")
        if pallas == "seq":
            _close_to_jax(tp[k].grad.numpy(), want[k], dtype, name)
        else:
            _close(tp[k].grad.numpy(), want[k], dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_masked_layer_training_on_cpu_matches_jax(dtype, monkeypatch, tmp_path):
    """Masked training through the layer against the JAX scan path (the
    Pallas path and more masks: tests/test_torch_lstm_seq_masked_train.py)."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "0")
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "cal.json"))
    jlayer, player, params = _layer_pair("lstm", dtype, seed=13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, T, V)).astype(dtype)
    mask = (np.arange(T)[None, :] < np.array([T, 4, 2])[:, None]).astype(dtype)

    def jloss(p):
        y, _ = jlayer.apply(p, jnp.asarray(x), {}, train=True, mask=jnp.asarray(mask))
        return jnp.sum(jnp.tanh(y))

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    y, _ = player.apply(tp, torch.from_numpy(x), {}, train=True,
                        mask=torch.from_numpy(mask))
    torch.tanh(y).sum().backward()
    for k in params:
        _close(tp[k].grad.numpy(), want[k], dtype, k)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# odd sizes: ragged blocks in every dimension of every kernel
CT, CB, CH = 9, 37, 40


def _kernel_close(got, want, dtype, name):
    """f32: max abs error 1e-4, over the largest element for the summed
    grads. bf16: relative to the output's own size, max |err| / max |ref|
    2e-2 and mean |err| / mean |ref| 5e-4, chip_smoke.py's limits for a
    short sequence (an absolute bf16 limit would be as large as a typical
    gradient)."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    if dtype == torch.float32:
        scale = float(ref.max()) if name in SUMMED else 1.0
        assert float(err.max()) <= 1e-4 * scale, name
    else:
        assert float(err.max() / ref.max()) <= 2e-2, name
        assert float(err.mean() / ref.mean()) <= 5e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_training_kernels_match_plain_versions(cuda_device, dtype):
    rng = np.random.default_rng(21)
    arrs = [rng.normal(size=s) * 0.5 for s in
            ((CT, CB, 4 * CH), (CB, CH), (CB, CH), (CH, 4 * CH), (CH,), (CH,), (CH,))]
    tens = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in arrs]
    before = ops.counters()
    got = ops.lstm_sequence_train_forward(*tens)
    want = ls.lstm_sequence_train_reference(*tens)
    for name, g, w in zip(("ys", "a", "f", "o", "i", "c", "hT", "cT"), got, want):
        _kernel_close(g, w, dtype, name)
    up = [torch.as_tensor(rng.normal(size=s) * 0.1, dtype=dtype, device=cuda_device)
          for s in ((CT, CB, CH), (CB, CH), (CB, CH))]
    res = tuple(want[:6]) + tuple(tens[1:])
    grads = ops.lstm_sequence_backward(*up, *res)
    ref = ls.lstm_sequence_backward_reference(*up, *res)
    torch.cuda.synchronize()
    for name, g, w in zip(("dzx", "dh0", "dc0", "dRW", "dpF", "dpI", "dpO"), grads, ref):
        _kernel_close(g, w, dtype, name)
    after = ops.counters()
    assert after["lstm_seq_train_fwd"] == before["lstm_seq_train_fwd"] + 1
    assert after["lstm_seq_bwd"] == before["lstm_seq_bwd"] + 1


@pytest.mark.cuda
def test_cuda_masked_training_launches_the_kernels(cuda_device):
    """Masked training on the card runs the masked training forward and
    backward kernels (rows 8-9) and no unmasked or lean one."""
    conf = pt.char_rnn(V, H, 1)
    conf.updater = {"updater": "sgd", "learning_rate": 0.1}
    conf.backprop_type = "standard"
    net = pt.MultiLayerNetwork(conf, device=cuda_device).init()
    rng = np.random.default_rng(0)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    fm = (np.arange(T)[None, :] < np.array([T, 4, 2])[:, None]).astype(np.float32)
    ds = pt.DataSet(x, x, features_mask=fm, labels_mask=fm)
    ops.reset_counters()
    net.fit(ds)
    torch.cuda.synchronize()
    launched = ops.counters()
    assert launched["lstm_seq_masked_train_fwd"] == launched["lstm_seq_masked_bwd"] == 1
    assert launched["lstm_seq_train_fwd"] == launched["lstm_seq_bwd"] == 0
    assert launched["lstm_seq_lean"] == launched["lstm_seq_lean_masked"] == 0
    assert np.isfinite(net.score())
