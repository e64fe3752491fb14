"""The PyTorch port's per-step LSTM cell (rows 1-2 of the kernel table)
against the JAX package.

The same numpy inputs, drawn from a seed with non-zero peepholes (GravesLSTM
starts them at zero, where a misplaced peephole term reads 0), go to the JAX
package's ``_cell_fwd_impl`` and ``_cell_bwd`` (their Pallas kernels in
interpret mode, as tests/test_pallas_ops.py runs them) and to the port's
plain versions on the CPU, at ragged sizes, for every activation pair the
kernels take. Tolerances: f32 1e-5 (sums in another order). bf16 is held bit
for bit: the plain versions round where XLA on the CPU rounds, constants
rounded to the dtype and the peephole products formed in f32 for their f32
sum. The gradients of ``LstmCellFunction`` are held against ``jax.grad``
through ``fused_lstm_cell``, and ``ops.lstm_cell`` against the JAX
``ops.lstm_cell`` with its helpers on. Tests marked ``cuda`` hold the CUDA
kernels against the plain versions and skip where there is no card.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.ops as jax_ops  # noqa: E402
from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    _cell_bwd,
    _cell_fwd_impl,
    fused_lstm_cell as jax_cell,
)

from deeplearning4j_tpu_torch import ops  # noqa: E402

lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")

B, H = 5, 6  # ragged: neither divides a tile of the kernels
NAMES = ("tanh", "sigmoid", "hardsigmoid", "relu", "identity")
PAIRS = [(a, g) for a in NAMES for g in NAMES]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5
FWD = ("h", "c", "a", "f", "o", "i", "cact")
BWD = ("dzx", "dh_prev", "dc_prev", "dRW", "dpF", "dpI", "dpO")
ARGS = ("zx", "h_prev", "c_prev", "RW", "pF", "pI", "pO")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """torch's intra-op threads capped at one for this module: its tensors
    are small, and under several test workers the threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b=B, h=H):
    """(zx, h_prev, c_prev, RW, pF, pI, pO) as float64 numpy, peepholes non-zero."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s) * 0.7  # noqa: E731
    return [r(b, 4 * h), r(b, h), r(b, h), r(h, 4 * h) * 0.6, r(h) * 0.5 + 0.2,
            r(h) * 0.5 - 0.2, r(h) * 0.5 + 0.1]


def _jax(arrs, dtype):
    return [jnp.asarray(a, DTYPES[dtype][0]) for a in arrs]


def _torch(jarrs, dtype):
    """JAX arrays as torch tensors of the same values (bf16 exactly)."""
    return [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(DTYPES[dtype][1])
            for a in jarrs]


def _assert_same(got, want, dtype, names):
    for g, w, name in zip(got, want, names):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.dtype == DTYPES[dtype][1], name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=F32_TOL, rtol=F32_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g.float().numpy(), w, err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act,gate", PAIRS)
def test_forward_reference_matches_jax_kernel(act, gate, dtype):
    jarrs = _jax(_inputs(1), dtype)
    want = _cell_fwd_impl(*jarrs, act, gate)
    got = ops.lstm_cell_forward(*_torch(jarrs, dtype), act, gate)
    assert len(got) == 7
    _assert_same(got, want, dtype, FWD)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act,gate", PAIRS)
def test_backward_reference_matches_jax_kernel(act, gate, dtype):
    jarrs = _jax(_inputs(2), dtype)
    h, c, a, f, o, i, cact = _cell_fwd_impl(*jarrs, act, gate)
    zx, h_prev, c_prev, RW, pF, pI, pO = jarrs
    residuals = (a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO)
    rng = np.random.default_rng(3)
    up = _jax([rng.normal(size=(B, H)) for _ in range(2)], dtype)
    want = _cell_bwd(act, gate, residuals, tuple(up))
    got = ops.lstm_cell_backward(*_torch(residuals, dtype), *_torch(up, dtype), act, gate)
    assert [tuple(g.shape) for g in got] == [(B, 4 * H), (B, H), (B, H), (H, 4 * H),
                                             (H,), (H,), (H,)]
    _assert_same(got, want, dtype, BWD)


def _objective(h, c, sin):
    # touches both outputs, so both upstream gradients are non-zero
    return (h * h).sum() + 0.5 * sin(c).sum()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act,gate", [("tanh", "sigmoid"), ("relu", "hardsigmoid"),
                                      ("identity", "tanh")])
def test_function_grads_match_jax_grad(act, gate, dtype):
    jarrs = _jax(_inputs(4), dtype)
    want = jax.grad(lambda *a: _objective(*jax_cell(*a, act, gate), jnp.sin),
                    argnums=tuple(range(7)))(*jarrs)
    tens = [t.requires_grad_() for t in _torch(jarrs, dtype)]
    h, c = ops.fused_lstm_cell(*tens, act, gate)
    assert type(h.grad_fn).__name__ == "LstmCellFunctionBackward"
    assert len(h.grad_fn.saved_tensors) == 12  # _cell_fwd's residuals
    _objective(h, c, torch.sin).backward()
    _assert_same([t.grad for t in tens], want, dtype, ARGS)


def test_function_takes_a_missing_c_gradient_as_zeros():
    """Only h reaches the loss: c's gradient is None, taken as zeros, as
    jax.grad's zero cotangent for the unused output."""
    jarrs = _jax(_inputs(5), "float32")
    want = jax.grad(lambda *a: jnp.sum(jnp.tanh(jax_cell(*a)[0])),
                    argnums=tuple(range(7)))(*jarrs)
    tens = [t.requires_grad_() for t in _torch(jarrs, "float32")]
    h, _ = lc.LstmCellFunction.apply(*tens, "tanh", "sigmoid")
    torch.tanh(h).sum().backward()
    _assert_same([t.grad for t in tens], want, "float32", ARGS)
    # the backward itself, given None for dc
    node = lc.LstmCellFunction.apply(*tens, "tanh", "sigmoid")[0].grad_fn
    grads = node.apply(torch.ones(B, H), None)
    zeros = node.apply(torch.ones(B, H), torch.zeros(B, H))
    assert grads[7:] == (None, None)
    for g, z in zip(grads[:7], zeros):
        torch.testing.assert_close(g, z, rtol=0, atol=0)


def test_function_grads_match_autograd_oracle():
    """In f64 the hand-derived backward equals torch autograd through the
    plain forward, code that shares nothing with it."""
    arrs = _inputs(6, b=4, h=7)
    tens = [torch.from_numpy(a).requires_grad_() for a in arrs]
    oracle = [torch.from_numpy(a).requires_grad_() for a in arrs]
    _objective(*ops.fused_lstm_cell(*tens, "tanh", "sigmoid"), torch.sin).backward()
    h, c, *_ = lc.lstm_cell_forward_reference(*oracle, "tanh", "sigmoid")
    _objective(h, c, torch.sin).backward()
    for t, o, name in zip(tens, oracle, ARGS):
        np.testing.assert_allclose(t.grad.numpy(), o.grad.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=name)


def test_op_without_grad_runs_the_forward_alone():
    tens = [torch.from_numpy(a).float() for a in _inputs(7)]
    leaves = [t.clone().requires_grad_() for t in tens]
    with torch.no_grad():
        h, c = ops.fused_lstm_cell(*leaves)
    assert h.grad_fn is None and c.grad_fn is None
    want = lc.lstm_cell_forward_reference(*tens)
    torch.testing.assert_close(h, want[0], rtol=0, atol=0)
    torch.testing.assert_close(c, want[1], rtol=0, atol=0)


@pytest.fixture
def jax_helpers_on():
    jax_ops.set_helpers_enabled(True)
    yield
    jax_ops.set_helpers_enabled(None)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ops_lstm_cell_matches_jax_ops_lstm_cell(dtype, jax_helpers_on, monkeypatch):
    """The public op against the JAX ``ops.lstm_cell`` with its helpers on;
    a spy shows the JAX side ran its fused cell."""
    calls = []
    real = jax_ops.fused_lstm_cell

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_ops, "fused_lstm_cell", spy)
    jarrs = _jax(_inputs(8), dtype)
    want = jax_ops.lstm_cell(*jarrs, "tanh", "hardsigmoid")
    assert calls == [1]
    got = ops.lstm_cell(*_torch(jarrs, dtype), "tanh", "hardsigmoid")
    _assert_same(got, want, dtype, ("h", "c"))


def test_ops_lstm_cell_refuses_unknown_activations(jax_helpers_on):
    arrs = _inputs(9)
    with pytest.raises(ValueError, match="Unknown LSTM activations"):
        jax_ops.lstm_cell(*[jnp.asarray(a) for a in arrs], "softsign", "sigmoid")
    with pytest.raises(ValueError, match="Unknown LSTM activations"):
        ops.lstm_cell(*[torch.from_numpy(a) for a in arrs], "softsign", "sigmoid")


def test_counters_and_variant_report_the_cell():
    assert {"lstm_cell_fwd", "lstm_cell_bwd"} <= set(ops.counters())
    before = ops.counters()
    ops.fused_lstm_cell(*[torch.from_numpy(a) for a in _inputs(10)])
    assert ops.counters() == before  # the plain version launches nothing
    t = torch.zeros(1)
    assert ops.variant(t, "fusedcell") == "reference"  # on the CPU
    assert ops.LSTM_VARIANTS == ("seqfused", "fusedcell")
    for bad in ("reference", "cell", ""):
        with pytest.raises(ValueError, match="lstm_variant"):
            ops.variant(t, bad)


def test_empty_batch():
    arrs = [torch.from_numpy(a).float() for a in _inputs(11, b=0)]
    out = ops.lstm_cell_forward(*arrs)
    assert [tuple(o.shape) for o in out] == [(0, H)] * 7


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h", [(67, 130), (8, 512)])
def test_cuda_cell_kernels_match_plain_versions(cuda_device, dtype, rel, b, h):
    """Rows 1-2 against their plain versions on the same CUDA tensors, each
    output as max |err| over max |ref|: f32 differs in the products' sum
    order only; in bf16 such a difference can round one product to the
    neighbouring bf16 value, which the gates carry on."""
    tens = [torch.as_tensor(a, dtype=dtype, device=cuda_device)
            for a in _inputs(12, b=b, h=h)]
    before = ops.counters()
    got = ops.lstm_cell_forward(*tens)
    want = lc.lstm_cell_forward_reference(*tens)
    res = tuple(want[2:7]) + (tens[2], want[1], tens[1], tens[3], tens[4], tens[5], tens[6])
    up = [torch.ones(b, h, dtype=dtype, device=cuda_device) * 0.1] * 2
    grads = ops.lstm_cell_backward(*res, *up)
    ref = lc.lstm_cell_backward_reference(*res, *up)
    torch.cuda.synchronize()
    for name, g, w in zip(FWD + BWD, list(got) + list(grads), list(want) + list(ref)):
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= rel, name
    after = ops.counters()
    assert after["lstm_cell_fwd"] == before["lstm_cell_fwd"] + 1
    assert after["lstm_cell_bwd"] == before["lstm_cell_bwd"] + 1
