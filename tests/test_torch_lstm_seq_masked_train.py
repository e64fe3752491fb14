"""The PyTorch port's masked LSTM sequence training (the masked forward with
residuals and the masked reverse-time backward) against the JAX package.

The JAX side runs ``_seq_masked_fwd_impl`` and ``_seq_masked_bwd`` directly
and ``fused_lstm_sequence_masked`` under ``jax.grad``, with its Pallas
kernels in interpret mode; the port runs its plain versions and
``LstmSequenceFunction`` with a mask, on the CPU. The same numpy inputs go
to both: f64 at 1e-9, f32 at 1e-5; in f64 the four grads that the JAX kernel
sums in f32 scratch (dRW and the peepholes) are held to it at 1e-6 of their
largest element, and all seven grads to an f64 autograd oracle through the
plain masked forward at 1e-9. The masks have leading, trailing and interior
zeros and a row that is all zeros: a backward that left out the (1-m)
carry of dh or dc would pass with an all-ones mask and fails these. Tests
marked ``cuda`` hold the CUDA kernels against the plain versions and skip
where there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    _seq_masked_bwd,
    _seq_masked_fwd_impl,
    fused_lstm_sequence_masked as jax_seq_masked,
)

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

T, B, H, V = 9, 3, 8, 11
TOL = {np.float64: 1e-9, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
ACT_GATE = [("tanh", "sigmoid"), ("tanh", "hardsigmoid"), ("relu", "sigmoid")]
NAMES = ("zx", "h0", "c0", "RW", "pF", "pI", "pO")
GRADS = ("dzx", "dh0", "dc0", "dRW", "dpF", "dpI", "dpO")
SUMMED = ("RW", "pF", "pI", "pO", "dRW", "dpF", "dpI", "dpO")
# [B, T] rows: leading and interior zeros; trailing zeros; all zeros
RAGGED = np.array([[0, 0, 1, 1, 0, 1, 1, 1, 1],
                   [1, 1, 1, 1, 1, 0, 0, 0, 0],
                   [0, 0, 0, 0, 0, 0, 0, 0, 0]])


def _mask(dtype, rows=RAGGED):
    """[T, B, 1] as the op takes it."""
    return np.ascontiguousarray(rows.T[..., None]).astype(dtype)


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.5).astype(dtype)  # noqa: E731
    return [r(T, B, 4 * H), r(B, H), r(B, H), r(H, 4 * H) * 0.8,
            r(H) * 0.4, r(H) * 0.4, r(H) * 0.4]


def _upstream(dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in ((T, B, H), (B, H), (B, H))]


def _close(got, want, dtype, name=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=name)


def _close_to_jax(got, want, dtype, name):
    if dtype is np.float64 and name in SUMMED:
        want = np.asarray(want)
        atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0, err_msg=name)
    else:
        _close(got, want, dtype, name)


def _objective(ys, hT, cT, sin):
    return (ys * ys).sum() + hT.sum() + 0.5 * sin(cT).sum()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_masked_train_forward_matches_jax(act, gate, dtype):
    arrs, mask = _inputs(dtype, seed=5), _mask(dtype)
    want = _seq_masked_fwd_impl(jnp.asarray(arrs[0]), jnp.asarray(mask),
                                *[jnp.asarray(a) for a in arrs[1:]], act, gate)
    got = ops.lstm_sequence_masked_train_forward(
        torch.from_numpy(arrs[0]), torch.from_numpy(mask),
        *[torch.from_numpy(a) for a in arrs[1:]], act, gate)
    for g, w, name in zip(got, want, ("ys", "a", "f", "o", "i", "c", "hT", "cT")):
        _close(g.numpy(), w, dtype, name)
    # the all-zeros row holds h0 and c0 throughout
    np.testing.assert_array_equal(got[0][:, 2].numpy(), np.broadcast_to(arrs[1][2], (T, H)))
    np.testing.assert_array_equal(got[7][2].numpy(), arrs[2][2])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_masked_backward_matches_jax(act, gate, dtype):
    arrs, mask = _inputs(dtype, seed=7), _mask(dtype)
    jarrs = [jnp.asarray(a) for a in arrs]
    ys, a, f, o, i, c, _, _ = _seq_masked_fwd_impl(jarrs[0], jnp.asarray(mask),
                                                   *jarrs[1:], act, gate)
    residuals = (ys, a, f, o, i, c, jnp.asarray(mask)) + tuple(jarrs[1:])
    up = _upstream(dtype, seed=8)
    want = _seq_masked_bwd(act, gate, residuals, tuple(jnp.asarray(u) for u in up))
    want = (want[0],) + tuple(want[2:])  # the mask takes no gradient
    tens = [torch.from_numpy(np.array(r)) for r in residuals]
    got = ls.lstm_sequence_masked_backward_reference(
        *[torch.from_numpy(u) for u in up], tens[6], *tens[:6], *tens[7:], act, gate)
    for g, w, name in zip(got, want, GRADS):
        _close_to_jax(g.numpy(), w, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_masked_function_grads_match_jax_under_grad(act, gate, dtype):
    arrs, mask = _inputs(dtype, seed=3), _mask(dtype)
    jm = jnp.asarray(mask)
    want = jax.grad(
        lambda zx, *rest: _objective(*jax_seq_masked(zx, jm, *rest, act, gate), jnp.sin),
        argnums=tuple(range(7)))(*[jnp.asarray(a) for a in arrs])
    tens = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = ops.lstm_sequence_apply(*tens, act, gate, mask=torch.from_numpy(mask))
    assert type(out[0].grad_fn).__name__ == "LstmSequenceFunctionBackward"
    assert len(out[0].grad_fn.saved_tensors) == 13  # the 12 residuals and the mask
    _objective(*out, torch.sin).backward()
    for t, w, name in zip(tens, want, NAMES):
        _close_to_jax(t.grad.numpy(), w, dtype, name)


MASKS = {"ragged": RAGGED, "trailing_only": (np.arange(T)[None, :] < np.array([T, 4, 1])[:, None]),
         "all_zero": np.zeros((B, T)), "interior_zero": np.ones((B, T)) - np.eye(B, T, 4)}


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("act,gate", ACT_GATE)
def test_masked_function_grads_match_autograd_oracle(act, gate, mask_name):
    """All seven grads in f64 against torch autograd through the plain masked
    forward loop, code that shares nothing with the hand-derived backward."""
    arrs = _inputs(np.float64, seed=4)
    mask = torch.from_numpy(_mask(np.float64, MASKS[mask_name]))
    tens = [torch.from_numpy(a).requires_grad_() for a in arrs]
    oracle = [torch.from_numpy(a).requires_grad_() for a in arrs]
    _objective(*ops.lstm_sequence_apply(*tens, act, gate, mask=mask), torch.sin).backward()
    _objective(*ls.lstm_sequence_masked_reference(oracle[0], mask, *oracle[1:], act, gate),
               torch.sin).backward()
    for t, o, name in zip(tens, oracle, NAMES):
        _close(t.grad.numpy(), o.grad.numpy(), np.float64, name)


def test_all_ones_mask_is_the_unmasked_op():
    arrs = [torch.from_numpy(a) for a in _inputs(np.float64, seed=9)]
    ones = torch.ones((T, B, 1), dtype=torch.float64)
    masked = ops.lstm_sequence_masked_train_forward(arrs[0], ones, *arrs[1:])
    plain = ops.lstm_sequence_train_forward(*arrs)
    for x, y in zip(masked, plain):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    up = [torch.from_numpy(u) for u in _upstream(np.float64, seed=2)]
    res = tuple(plain[:6]) + tuple(arrs[1:])
    for x, y in zip(ops.lstm_sequence_masked_backward(*up, ones, *res),
                    ops.lstm_sequence_backward(*up, *res)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ----------------------------------------------------- through the layers
def _layer_pair(kind, dtype, seed=11):
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
def test_masked_layer_param_grads_match_jax(kind, pallas, dtype, monkeypatch, tmp_path):
    """Through GravesLSTM and the bidirectional layer, whose reverse
    direction runs the masked op on the flipped mask."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", pallas)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "cal.json"))
    jlayer, player, params = _layer_pair(kind, dtype, seed=13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, T, V)).astype(dtype)
    mask = RAGGED.astype(dtype)
    w = rng.normal(size=(B, T, H)).astype(dtype)

    def jloss(p):
        y, _ = jlayer.apply(p, jnp.asarray(x), {}, train=True, mask=jnp.asarray(mask))
        return jnp.sum(jnp.tanh(y) * w)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    y, _ = player.apply(tp, torch.from_numpy(x), {}, train=True,
                        mask=torch.from_numpy(mask))
    (torch.tanh(y) * torch.from_numpy(w)).sum().backward()
    for k in params:
        name = k.replace("bwd_", "")
        if pallas == "seq":
            _close_to_jax(tp[k].grad.numpy(), want[k], dtype, name)
        else:
            _close(tp[k].grad.numpy(), want[k], dtype, name)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# odd sizes: ragged blocks in every dimension of every kernel
CT, CB, CH = 9, 37, 40


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_masked_training_kernels_match_plain_versions(cuda_device, dtype):
    rng = np.random.default_rng(31)
    arrs = [rng.normal(size=s) * 0.5 for s in
            ((CT, CB, 4 * CH), (CB, CH), (CB, CH), (CH, 4 * CH), (CH,), (CH,), (CH,))]
    tens = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in arrs]
    rows = np.ones((CB, CT))
    rows[:3] = RAGGED
    rows[3:10, 6:] = 0.0
    mask = torch.as_tensor(rows.T[..., None], dtype=dtype, device=cuda_device).contiguous()
    before = ops.counters()
    got = ops.lstm_sequence_masked_train_forward(tens[0], mask, *tens[1:])
    want = ls.lstm_sequence_masked_train_reference(tens[0], mask, *tens[1:])
    for name, g, w in zip(("ys", "a", "f", "o", "i", "c", "hT", "cT"), got, want):
        _kernel_close(g, w, dtype, name)
    up = [torch.as_tensor(rng.normal(size=s) * 0.1, dtype=dtype, device=cuda_device)
          for s in ((CT, CB, CH), (CB, CH), (CB, CH))]
    res = tuple(want[:6]) + tuple(tens[1:])
    grads = ops.lstm_sequence_masked_backward(*up, mask, *res)
    ref = ls.lstm_sequence_masked_backward_reference(*up, mask, *res)
    torch.cuda.synchronize()
    for name, g, w in zip(GRADS, grads, ref):
        _kernel_close(g, w, dtype, name)
    after = ops.counters()
    assert after["lstm_seq_masked_train_fwd"] == before["lstm_seq_masked_train_fwd"] + 1
    assert after["lstm_seq_masked_bwd"] == before["lstm_seq_masked_bwd"] + 1


def _kernel_close(got, want, dtype, name):
    """f32: max abs error 1e-4, over the largest element for the summed
    grads. bf16: max |err| / max |ref| 2e-2 and mean |err| / mean |ref| 5e-4,
    chip_smoke.py's limits for a short sequence."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    if dtype == torch.float32:
        scale = float(ref.max()) if name in SUMMED else 1.0
        assert float(err.max()) <= 1e-4 * scale, name
    else:
        assert float(err.max() / ref.max()) <= 2e-2, name
        assert float(err.mean() / ref.mean()) <= 5e-4, name
