"""The PyTorch port's flash attention against the JAX package.

The same numpy q, k, v [B, H, T, D], key mask and upstream gradient go
through the JAX ``flash_attention`` (its Pallas kernels in interpret mode,
with blocks of 4 query rows and 8 keys, so several tiles run and T=13 and 40
are not a multiple of a block) and the port's op on the CPU, which runs the
kernels' plain versions. Forward out and lse, and dq, dk, dv, are compared
at 1e-5 (f32 on both sides, sums in another order); the forward also against
the JAX package's XLA ``attention``. Masks have leading, interior and
trailing zeros and an all-zero row. Tests marked ``cuda`` hold the CUDA
kernels against the plain versions on the card and skip where there is none.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.flash_attention import _flash_call  # noqa: E402
from deeplearning4j_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from deeplearning4j_tpu.parallel.ring_attention import attention as jax_xla  # noqa: E402

from deeplearning4j_tpu_torch import ops  # noqa: E402

fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

ATOL = RTOL = 1e-5  # f32 on both sides; sums in another order
# bf16: both sides compute in f32 from the same bf16 inputs and round out,
# dq, dk and dv once; an f32 sum in another order can land on the
# neighbouring bf16, one step, which is at most 2^-7 of the value
BF16_RTOL = 2.0 ** -7
BLOCK_Q, BLOCK_K = 4, 8
B, H = 2, 2
SHAPES = [(8, 4), (13, 16), (40, 64)]  # (T, D)


def _mask(T):
    """Row 0: leading, interior and trailing zeros; row 1: all zeros."""
    m = np.ones((B, T), np.float32)
    m[0, :2] = 0.0
    m[0, T // 2:T // 2 + 2] = 0.0
    m[0, -2:] = 0.0
    m[1] = 0.0
    return m


def _inputs(T, D, seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4))
    return q, k, v, g, (_mask(T) if masked else None)


def _jax_flash(q, k, v, mask, causal):
    key_mask = None if mask is None else jnp.asarray(mask)
    return jax_flash(q, k, v, causal=causal, key_mask=key_mask, block_q=BLOCK_Q,
                     block_k=BLOCK_K)


def _jax_lse(q, k, v, mask, causal):
    """lse [B, H, T] of the JAX forward kernel (``_flash_call``), at one
    block over the whole sequence."""
    Bq, Hq, T, D = q.shape
    flat = [jnp.asarray(a).reshape(Bq * Hq, T, D) for a in (q, k, v)]
    m = np.ones((Bq, T), np.float32) if mask is None else mask
    mf = jnp.repeat(jnp.asarray(m)[:, None, :], Hq, axis=1).reshape(Bq * Hq, 1, T)
    _, lse = _flash_call(*flat, mf, causal, D ** -0.5, T, T)
    return np.asarray(lse).reshape(Bq, Hq, T)


def _t(a, **kw):
    return None if a is None else torch.tensor(a, **kw)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,D", SHAPES)
def test_forward_matches_jax(T, D, causal, masked):
    q, k, v, _, mask = _inputs(T, D, seed=T + D, masked=masked)
    want = np.asarray(_jax_flash(q, k, v, mask, causal))
    out, lse = fa.flash_attention_forward(_t(q), _t(k), _t(v), _t(mask), causal)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, mask, causal), atol=ATOL,
                               rtol=RTOL)
    xla = np.asarray(jax_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             key_mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(out.numpy(), xla, atol=ATOL, rtol=RTOL)
    if masked:  # a row with no real key: out = 0 and lse = 0
        assert not out[1].any() and not lse[1].any()
        if causal:  # row 0's leading rows see only masked keys
            assert not out[0, :, :2].any() and not lse[0, :, :2].any()


# -------------------------------------------------------------- gradients
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,D", SHAPES)
def test_gradients_match_jax(T, D, causal, masked):
    """FlashAttentionFunction on the CPU (the written-out backward) against
    jax.grad through the JAX custom VJP (_flash_bwd's Pallas kernels)."""
    q, k, v, g, mask = _inputs(T, D, seed=7 * T + D, masked=masked)

    def loss(a, b, c):
        return jnp.sum(_jax_flash(a, b, c, mask, causal) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    before = ops.counters()
    out = ops.flash_attention(tq, tk, tv, causal=causal, key_mask=_t(mask))
    out.backward(_t(g))
    assert ops.counters() == before  # CPU tensors run the plain versions
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")
    if masked:  # masked keys and a row with no real key get no gradient
        for t in (tq, tk, tv):
            assert not t.grad[1].any()
        for t in (tk, tv):
            assert not t.grad[0, :, :2].any() and not t.grad[0, :, -2:].any()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    """The backward's formulas written out against torch autograd of the
    plain forward, masked keys and an empty row included."""
    q, k, v, g, mask = _inputs(13, 16, seed=3, masked=True)
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.flash_attention_reference(tq, tk, tv, _t(mask), causal)
    out.backward(_t(g))
    got = fa.flash_attention_backward_reference(
        *(_t(a) for a in (q, k, v)), _t(mask), out.detach(), lse.detach(), _t(g), causal)
    for name, t, w in zip("qkv", got, (tq, tk, tv)):
        np.testing.assert_allclose(t.numpy(), w.grad.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_bf16_matches_the_jax_kernel():
    """bf16 inputs, computed in f32 and rounded once on both sides."""
    q, k, v, g, mask = (a.astype(jnp.bfloat16) if a is not None else None
                        for a in _inputs(40, 16, seed=5, masked=True))
    mask = mask.astype(np.float32)

    def loss(a, b, c):
        return jnp.sum(_jax_flash(a, b, c, mask, True).astype(jnp.float32)
                       * g.astype(jnp.float32))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out = np.asarray(_jax_flash(jq, jk, jv, mask, True).astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, key_mask=_t(mask))
    assert out.dtype == torch.bfloat16
    out.backward(torch.tensor(np.asarray(g, np.float32)).to(torch.bfloat16))
    np.testing.assert_allclose(out.detach().float().numpy(), want_out, rtol=BF16_RTOL,
                               atol=1e-6)
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w, np.float32),
                                   rtol=BF16_RTOL, atol=1e-6, err_msg=f"d{name}")


def test_block_sizes_and_scale():
    """Block sizes are taken for the signature and change nothing; an
    explicit scale is the JAX one."""
    q, k, v, _, mask = _inputs(13, 16, seed=9, masked=True)
    tq, tk, tv, tm = (_t(a) for a in (q, k, v, mask))
    a = ops.flash_attention(tq, tk, tv, key_mask=tm)
    b = ops.flash_attention(tq, tk, tv, key_mask=tm, block_q=4, block_k=16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    got = ops.flash_attention(tq, tk, tv, causal=True, scale=0.3, key_mask=tm)
    want = jax_flash(q, k, v, causal=True, scale=0.3, key_mask=jnp.asarray(mask),
                     block_q=BLOCK_Q, block_k=BLOCK_K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_one_step_and_no_key_mask():
    """T=1 (a single streamed step) attends to itself; no mask is all ones."""
    q, k, v, _, _ = _inputs(1, 8, seed=11, masked=False)
    out, lse = fa.flash_attention_reference(_t(q), _t(k), _t(v), None, True)
    np.testing.assert_allclose(out.numpy(), v, atol=ATOL, rtol=RTOL)
    ones = fa.flash_attention_reference(_t(q), _t(k), _t(v), torch.ones(B, 1), True)
    torch.testing.assert_close(ones[0], out, rtol=0, atol=0)


# ------------------------------------------------- the kernels' argument checks
def test_kernel_argument_checks():
    """What the CUDA wrappers refuse, checked on CPU tensors before any
    launch: dtypes (TypeError), shapes, head dims, masks and layouts
    (ValueError)."""
    x = torch.zeros(2, 2, 5, 16)
    fa._check(x, x, x, torch.ones(2, 5))
    with pytest.raises(TypeError):
        fa._check(x.double(), x.double(), x.double(), None)
    with pytest.raises(TypeError):
        fa._check(x, x.bfloat16(), x, None)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros(2, 2, 5, 48)
        fa._check(y, y, y, None)
    with pytest.raises(ValueError, match="shape"):
        fa._check(x, torch.zeros(2, 2, 6, 16), x, None)
    with pytest.raises(ValueError, match="key_mask"):
        fa._check(x, x, x, torch.ones(2, 6))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 5, 2, 16).transpose(1, 2)
        fa._check(t, t, t, None)
    assert fa.HEAD_DIMS == (4, 8, 16, 32, 64, 128)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,D", [(1, 4), (13, 16), (200, 64), (77, 128)])
def test_cuda_kernels_match_plain_versions(cuda_device, T, D, causal, dtype):
    q, k, v, g, mask = _inputs(T, D, seed=T + D, masked=True)
    tq, tk, tv, tg = (torch.tensor(a).to(cuda_device, dtype) for a in (q, k, v, g))
    tm = torch.tensor(mask, device=cuda_device)
    before = ops.counters()
    out, lse = fa.flash_attention_forward(tq, tk, tv, tm, causal)
    grads = fa.flash_attention_backward(tq, tk, tv, tm, out, lse, tg, causal)
    torch.cuda.synchronize()
    after = ops.counters()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert after[name] == before[name] + 1
    want_out, want_lse = fa.flash_attention_reference(tq, tk, tv, tm, causal)
    want = fa.flash_attention_backward_reference(tq, tk, tv, tm, want_out, want_lse, tg,
                                                 causal)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    # relative to the largest value, or absolute below 1 (the inputs' scale):
    # at T=1, dq and dk are 0 up to the rounding of dp - delta
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for got, ref in zip((out,) + tuple(grads), (want_out,) + tuple(want)):
        assert got.dtype == dtype
        err = float((got.float() - ref.float()).abs().max())
        assert err <= rel * max(float(ref.float().abs().max()), 1.0)


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros((1, 1, 4, 16), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        ops.flash_attention(x, x, x)
    y = torch.zeros((1, 1, 4, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(y, y, y)
    z = torch.zeros((1, 1, 4, 16), device=cuda_device)
    with pytest.raises(ValueError, match="on cpu"):
        ops.flash_attention(z, z, z, key_mask=torch.ones(1, 4))
