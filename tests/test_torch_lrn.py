"""The PyTorch port's cross-channel LRN against the JAX package.

The same numpy x and upstream gradient go through the JAX ``fused_lrn`` (its
Pallas kernels in interpret mode, as ``tests/test_pallas_ops.py`` runs them)
and the port's op on the CPU, which runs the kernels' plain versions: y, the
d the backward takes, and dx (JAX's custom VJP against the port's autograd
Function). Windows n = 1, 2, 4, 5 (even n has the asymmetric window and the
reflected adjoint), C = 13 and 33, 2-D and 4-D x, at the reference's alpha
and at alpha 0.05 and x of scale 30, where the window sums weigh on y and dx.
f32 is held at 1e-5 relative (both sides compute in f32; XLA on the CPU and
torch take powers and sums in their own ways, ~1e-7 here). bf16 is held at
one bf16 step of the value (2^-8), though it reads 0 here: both sides
compute in bf16 and round at the same points. Tests marked ``cuda`` hold
the CUDA kernels against the plain versions on the card and skip where
there is none.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.pallas_kernels import _lrn_fwd_impl  # noqa: E402
from deeplearning4j_tpu.ops.pallas_kernels import fused_lrn as jax_lrn  # noqa: E402

from deeplearning4j_tpu_torch import ops  # noqa: E402

lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")

RTOL = 1e-5  # f32, relative to each value
ATOL = 1e-7  # f32, for values near 0
BF16_RTOL = 2.0 ** -8  # one bf16 step
K, BETA = 2.0, 0.75
SHAPES = [(7, 13), (2, 3, 5, 33)]
# (alpha, scale of x): the reference's alpha, where the second term of dx is
# ~1e-3 of the first; the same alpha at activations of scale 30 and alpha
# 0.05, where the window sums weigh on y and dx
REGIMES = [(1e-4, 1.0), (1e-4, 30.0), (0.05, 1.0)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, scale, seed):
    rng = np.random.default_rng(seed)
    return ((scale * rng.normal(size=shape)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _jax(x, g, n, alpha, jdt):
    """(y, d as [rows, C], dx) of the JAX package's fused LRN in interpret mode."""
    jx = jnp.asarray(x, jdt)
    y, vjp = jax.vjp(lambda v: jax_lrn(v, K, n, alpha, BETA), jx)
    (dx,) = vjp(jnp.asarray(g, jdt))
    _, d = _lrn_fwd_impl(jx, K, n, alpha, BETA)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, d, dx)]


def _close(got, want, dtype, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("alpha,scale", REGIMES, ids=["ref", "large_x", "large_alpha"])
@pytest.mark.parametrize("shape", SHAPES, ids=["2d_C13", "4d_C33"])
@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_lrn_and_its_gradient_match_jax(n, shape, alpha, scale, dtype):
    jdt, tdt = DTYPES[dtype]
    x, g = _inputs(shape, scale, seed=n + len(shape))
    want_y, want_d, want_dx = _jax(x, g, n, alpha, jdt)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    y = ops.lrn(tx, K, n, alpha, BETA)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt and y.shape == tx.shape
    _close(y, want_y, dtype, "y")
    _close(tx.grad, want_dx, dtype, "dx")
    # the plain versions the port runs on the CPU, and the d the backward takes
    ry, rd = lr.lrn_reference(tx.detach(), K, n, alpha, BETA)
    _close(ry, want_y, dtype, "lrn_reference y")
    _close(rd.reshape(-1, shape[-1]), want_d, dtype, "d")
    rdx = lr.lrn_backward_reference(tx.detach(), rd, torch.from_numpy(g).to(tdt), K, n,
                                    alpha, BETA)
    _close(rdx, want_dx, dtype, "lrn_backward_reference dx")


def test_serving_forward_needs_no_d_and_counts_nothing_on_the_cpu():
    x, _ = _inputs((4, 9), 3.0, seed=1)
    before = ops.counters()
    with torch.no_grad():
        y = ops.lrn(torch.from_numpy(x))
    y2, d = lr.lrn_forward(torch.from_numpy(x), with_d=False)
    assert d is None
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(y, lr.lrn_reference(torch.from_numpy(x))[0], rtol=0, atol=0)
    assert ops.counters() == before  # CPU tensors launch nothing
    assert {"lrn_fwd", "lrn_bwd"} <= set(before)


def test_window_adjoint_is_reflected_for_even_n():
    """The backward's window is W reflected: for n=4, W(c) = [c-2, c+1] and
    the adjoint sums t over [c-1, c+2]. A backward that reused W would give
    another dx; autograd through the plain forward gives the reflected one."""
    x, g = _inputs((3, 8), 3.0, seed=9)
    tx = torch.from_numpy(x).double().requires_grad_()
    ylin = lr.lrn_reference(tx, K, 4, 0.05, BETA)[0]
    ylin.backward(torch.from_numpy(g).double())
    d = lr.lrn_reference(tx.detach(), K, 4, 0.05, BETA)[1]
    gt = torch.from_numpy(g).double()
    got = lr.lrn_backward_reference(tx.detach(), d, gt, K, 4, 0.05, BETA)
    torch.testing.assert_close(got, tx.grad, rtol=1e-12, atol=1e-12)
    t = gt * tx.detach() * d ** (-BETA - 1.0)
    unreflected = gt * d ** -BETA - 2 * 0.05 * BETA * tx.detach() * lr._window_sum(t, 4, 2)
    assert float((unreflected - tx.grad).abs().max()) > 1e-3


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _at_offset(a, offset, device):
    """a on the device as a contiguous view ``offset`` elements into its storage."""
    buf = torch.empty(a.numel() + offset, dtype=a.dtype, device=device)
    out = buf[offset:].view(a.shape)
    out.copy_(a)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("n", [1, 4, 5])
@pytest.mark.parametrize("shape", [(1001, 3), (2, 7, 9, 33), (4099, 96), (3, 5, 256),
                                   (1001, 8), (7, 4100)])
@pytest.mark.parametrize("offset", ["none", "x_and_g", "x_only"])
def test_cuda_kernels_match_plain_versions(cuda_device, offset, shape, n, dtype, rtol):
    """Contiguous tensors, and views one element into their storage: x and g
    (16-byte accesses after a head of single elements), or x alone (the
    backward's pointers disagree: one element an access)."""
    x, g = (torch.from_numpy(a).to(dtype) for a in _inputs(shape, 30.0, seed=n))
    x = _at_offset(x, 0 if offset == "none" else 1, cuda_device)
    g = _at_offset(g, 1 if offset == "x_and_g" else 0, cuda_device)
    before = ops.counters()
    y, d = lr.lrn_forward(x, K, n, 1e-4, BETA)
    y_serving, none = lr.lrn_forward(x, K, n, 1e-4, BETA, with_d=False)
    dx = lr.lrn_backward(x, d, g, K, n, 1e-4, BETA)
    torch.cuda.synchronize()
    ry, rd = lr.lrn_reference(x, K, n, 1e-4, BETA)
    rdx = lr.lrn_backward_reference(x, rd, g, K, n, 1e-4, BETA)
    # and from the kernel's own d, the backward alone
    rdx_own_d = lr.lrn_backward_reference(x, d, g, K, n, 1e-4, BETA)
    assert none is None
    for got, want in ((y, ry), (y_serving, ry), (d, rd), (dx, rdx), (dx, rdx_own_d)):
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        assert err <= rtol
    after = ops.counters()
    assert after["lrn_fwd"] == before["lrn_fwd"] + 2
    assert after["lrn_bwd"] == before["lrn_bwd"] + 1


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    with pytest.raises(TypeError):
        lr.lrn_forward(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        lr.lrn_forward(x.t())
    with pytest.raises(ValueError, match="channels"):
        lr.lrn_forward(torch.zeros((1, lr.MAX_CHANNELS + 1), device=cuda_device))
    with pytest.raises(ValueError, match="on"):
        lr.lrn_backward(x, x, x.cpu())
