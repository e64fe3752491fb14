"""The rounding of the tensor-core flash kernels (rows 13-15), emulated on
the CPU and held against the JAX kernels and the port's plain versions.

The forward (``csrc/flash_attn.cu``) and the dq and dk/dv backward kernels
(``csrc/flash_attn_bwd.cu``) take their products on the tensor cores. This
file repeats their arithmetic in plain torch, in the kernels' tiles of 64
keys (forward, online softmax with its guards; dq) and 64 query rows
(dk/dv):

- bf16: the products of bf16 inputs are exact with an f32 sum; P and dS are
  rounded to bf16 before the products that take them (P V, dS K, P^T dO,
  dS^T Q);
- f32: every product is 3xTF32, hi·hi + hi·lo + lo·hi with hi = tf32(x)
  and lo = tf32(x - hi), tf32 rounding done on the bits as ``cvt.rna``
  rounds (to nearest, ties away from zero).

The emulation feeds the forward's out and lse to the emulated dq, which
forms delta, and that delta to the emulated dk/dv, as the kernels run in
order on the card. Out, lse, dq, dk and dv are held against the JAX flash
kernels in interpret mode (``tests/test_torch_flash_attention.py`` runs
them the same way, here with blocks of 64) and against the port's plain
versions, at ``chip_smoke.py``'s ``ATTN_REL``: max |err| at most 1e-4 (f32)
or 1e-2 (bf16) of max(max |ref|, 1). This is the CPU's check that the
rounding design fits the limits the card is held to.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.flash_attention import _flash_call  # noqa: E402
from deeplearning4j_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402

fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

ATTN_REL = {"float32": 1e-4, "bfloat16": 1e-2}  # chip_smoke.py's limits
TILE = 64  # keys per forward tile, query rows per dk/dv tile
B, H = 2, 2
NEG_INF = fa.NEG_INF


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: the 13 low
    mantissa bits dropped, to nearest, ties away from zero (adding half a
    step to the magnitude bits carries into the kept ones)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, dtype, passes=3):
    """a @ b as the kernels' tensor cores form it, summed in f32: bf16
    operands exactly; f32 as 3xTF32 (``passes=1``: one TF32 product)."""
    if dtype == "bfloat16":
        return torch.matmul(a.double(), b.double()).float()
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return torch.matmul(ah.double(), bh.double()).float()
    return (torch.matmul(al.double(), bh.double()) + torch.matmul(ah.double(), bl.double())
            + torch.matmul(ah.double(), bh.double())).float()


def operand(x, dtype):
    """P or dS as it enters its product: rounded to bf16 in bf16, as it is
    in f32 (the split happens in ``product``)."""
    return x.bfloat16().float() if dtype == "bfloat16" else x


def emulate_forward(q, k, v, mask, causal, scale, dtype, passes=3):
    """Row 13: (out in the input type, lse f32), key tiles of 64."""
    T = q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    valid = fa._valid(mask, T, causal, q.device)
    m = torch.full(q.shape[:3], NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, T, TILE):
        kt, vt = kf[..., k0:k0 + TILE, :], vf[..., k0:k0 + TILE, :]
        s = product(qf, kt.transpose(-1, -2), dtype, passes) * scale
        s = torch.where(valid[..., k0:k0 + TILE], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        alpha = torch.exp(torch.where(m <= NEG_INF / 2, m_safe, m) - m_safe)
        p = torch.exp(s - m_safe[..., None])
        acc = acc * alpha[..., None] + product(operand(p, dtype), vt, dtype, passes)
        l = l * alpha + p.sum(-1)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    m_fin = torch.where(m <= NEG_INF / 2, 0.0, m)
    lse = torch.where(l > 0, m_fin + torch.log(l_safe), 0.0)
    return (acc / l_safe[..., None]).to(q.dtype), lse


def emulate_dq(q, k, v, mask, out, lse, g, causal, scale, dtype, passes=3, tile=TILE):
    """Row 14: (dq in the input type, delta f32), key tiles of ``tile``;
    delta = rowsum(dO * O) in f32, then per tile P = exp(S * scale - lse)
    (0 where the key is not real), dS = P (dP - delta) and
    dq += (dS K) * scale."""
    T = q.shape[2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = (gf * out.float()).sum(-1)
    valid = fa._valid(mask, T, causal, q.device)
    dq = torch.zeros(qf.shape)
    for k0 in range(0, T, tile):
        kt, vt = kf[..., k0:k0 + tile, :], vf[..., k0:k0 + tile, :]
        s = product(qf, kt.transpose(-1, -2), dtype, passes) * scale
        p = torch.where(valid[..., k0:k0 + tile], torch.exp(s - lse[..., None]), 0.0)
        dp = product(gf, vt.transpose(-1, -2), dtype, passes)
        ds = p * (dp - delta[..., None])
        dq = dq + product(operand(ds, dtype), kt, dtype, passes) * scale
    return dq.to(q.dtype), delta


def emulate_dkv(q, k, v, mask, lse, delta, g, causal, scale, dtype, passes=3):
    """Row 15: (dk, dv) in the input type, query tiles of 64; the scores
    transposed, keys in rows."""
    T = q.shape[2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    valid = fa._valid(mask, T, causal, q.device).transpose(-1, -2)  # [key, query]
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)
    for q0 in range(0, T, TILE):
        qt, gt = qf[..., q0:q0 + TILE, :], gf[..., q0:q0 + TILE, :]
        st = product(kf, qt.transpose(-1, -2), dtype, passes) * scale
        p = torch.where(valid[..., q0:q0 + TILE],
                        torch.exp(st - lse[..., None, q0:q0 + TILE]), 0.0)
        dv = dv + product(operand(p, dtype), gt, dtype, passes)
        dp = product(vf, gt.transpose(-1, -2), dtype, passes)
        ds = p * (dp - delta[..., None, q0:q0 + TILE])
        dk = dk + product(operand(ds, dtype), qt, dtype, passes) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def emulate(q, k, v, mask, g, causal, dtype, passes=3):
    """(out, lse, dq, dk, dv) of the kernels in their launch order: the
    forward, the dq kernel with delta, then dk/dv."""
    scale = q.shape[-1] ** -0.5
    out, lse = emulate_forward(q, k, v, mask, causal, scale, dtype, passes)
    dq, delta = emulate_dq(q, k, v, mask, out, lse, g, causal, scale, dtype, passes)
    dk, dv = emulate_dkv(q, k, v, mask, lse, delta, g, causal, scale, dtype, passes)
    return out, lse, dq, dk, dv


def _mask(T):
    """Row 0: leading, interior and trailing zeros; row 1: all zeros."""
    m = np.ones((B, T), np.float32)
    m[0, :2] = 0.0
    m[0, T // 2:T // 2 + 2] = 0.0
    m[0, -2:] = 0.0
    m[1] = 0.0
    return m


def _inputs(T, D, dtype, masked, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":  # values a bf16 tensor holds, on both sides
        arrays = [np.asarray(torch.tensor(a).bfloat16().float()) for a in arrays]
    return arrays, (_mask(T) if masked else None)


def _jax(arrays, mask, causal, dtype):
    """(out, lse, dq, dk, dv) of the JAX flash kernels, interpret mode, blocks
    of 64: forward and jax.grad through the custom VJP; lse from the forward
    kernel at one block over the sequence."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, g = (jnp.asarray(a).astype(jdt) for a in arrays)
    key_mask = None if mask is None else jnp.asarray(mask)

    def run(a, b, c):
        return jax_flash(a, b, c, causal=causal, key_mask=key_mask, block_q=TILE,
                         block_k=TILE)

    def loss(a, b, c):
        return jnp.sum(run(a, b, c).astype(jnp.float32) * g.astype(jnp.float32))

    out = run(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    T, D = q.shape[2], q.shape[3]
    flat = [x.reshape(B * H, T, D) for x in (q, k, v)]
    m = np.ones((B, T), np.float32) if mask is None else mask
    mf = jnp.repeat(jnp.asarray(m)[:, None, :], H, axis=1).reshape(B * H, 1, T)
    _, lse = _flash_call(*flat, mf, causal, D ** -0.5, T, T)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, lse.reshape(B, H, T)) + grads]


def readings(got, want):
    """Per output: max |err| over the larger of max |ref| and 1."""
    return {n: float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
            / max(float(np.abs(np.asarray(b)).max()), 1.0)
            for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want)}


def _numpy(tensors):
    return [t.float().numpy() for t in tensors]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [4, 16, 64])
@pytest.mark.parametrize("T", [1, 13, 65, 200])
def test_emulated_kernels_within_limits(T, D, causal, masked, dtype):
    arrays, mask = _inputs(T, D, dtype, masked, seed=1000 * T + 10 * D + causal)
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.tensor(a).to(tdt) for a in arrays)
    tm = None if mask is None else torch.tensor(mask)
    got = _numpy(emulate(q, k, v, tm, g, causal, dtype))
    assert all(np.isfinite(x).all() for x in got)
    lim = ATTN_REL[dtype]
    vs_jax = readings(got, _jax(arrays, mask, causal, dtype))
    assert all(r <= lim for r in vs_jax.values()), vs_jax
    out, lse = fa.flash_attention_reference(q, k, v, tm, causal)
    plain = _numpy((out, lse) + fa.flash_attention_backward_reference(q, k, v, tm, out, lse, g,
                                                                      causal))
    vs_plain = readings(got, plain)
    assert all(r <= lim for r in vs_plain.values()), vs_plain
    if masked:  # a batch row with no real key: everything 0
        assert all(not x[1].any() for x in got)


def test_tf32_rounds_to_nearest_ties_away():
    """The bit rounding against hand-worked values: 10 mantissa bits kept."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -10, 3.0, 0.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10,
            3.0, 0.0]
    assert tf32(x).tolist() == want
    hi, lo = split(torch.tensor([1.0 / 3.0]))
    assert abs(float(hi) + float(lo) - 1.0 / 3.0) < 2.0 ** -21 / 3.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_rounds_where_the_kernels_round(dtype):
    """The emulation is not the plain version: P and dS are rounded (bf16)
    and the products split (f32), so the outputs differ from the f32 plain
    versions (dq, dk and dv among them), by less than the limit."""
    arrays, mask = _inputs(200, 64, dtype, True, seed=3)
    q, k, v, g = (torch.tensor(a).to(getattr(torch, dtype)) for a in arrays)
    tm = torch.tensor(mask)
    got = emulate(q, k, v, tm, g, True, dtype)
    out, lse = fa.flash_attention_reference(q, k, v, tm, True)
    plain = (out, lse) + fa.flash_attention_backward_reference(q, k, v, tm, out, lse, g, True)
    r = readings(_numpy(got), _numpy(plain))
    assert r["dq"] > 0 and r["dk"] > 0 and r["dv"] > 0, r
    assert max(r.values()) <= ATTN_REL[dtype], r


def test_one_tf32_pass_would_not_hold_the_f32_limit():
    """Why f32 takes three products: with one TF32 product each (10
    mantissa bits) the same f32 case reads above 1e-4."""
    arrays, mask = _inputs(200, 64, "float32", False, seed=5)
    q, k, v, g = (torch.tensor(a) for a in arrays)
    one = _numpy(emulate(q, k, v, None, g, False, "float32", passes=1))
    three = _numpy(emulate(q, k, v, None, g, False, "float32"))
    out, lse = fa.flash_attention_reference(q, k, v, None, False)
    plain = _numpy((out, lse) + fa.flash_attention_backward_reference(q, k, v, None, out, lse,
                                                                      g, False))
    assert max(readings(one, plain).values()) > ATTN_REL["float32"]
    assert max(readings(three, plain).values()) <= ATTN_REL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_emulated_dq_in_the_kernels_tiles_within_limits(D, dtype):
    """Row 14 at every instantiated head dim, in the tiles its kernel takes
    (32 keys in f32 at D = 128, else 64), on a causal masked case that is
    ragged past two tiles: against the plain dq and delta from the plain
    forward's out and lse, at ``ATTN_REL``."""
    arrays, mask = _inputs(130, D, dtype, True, seed=7 + D)
    q, k, v, g = (torch.tensor(a).to(getattr(torch, dtype)) for a in arrays)
    tm = torch.tensor(mask)
    out, lse = fa.flash_attention_reference(q, k, v, tm, True)
    tile = 32 if dtype == "float32" and D == 128 else TILE
    got = emulate_dq(q, k, v, tm, out, lse, g, True, D ** -0.5, dtype, tile=tile)
    want = fa.flash_attention_dq_reference(q, k, v, tm, out, lse, g, True)
    assert torch.equal(got[1], want[1])  # delta: the same f32 sum
    dq, ref = got[0].double(), want[0].double()
    r = float((dq - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
    assert 0 < r <= ATTN_REL[dtype], r
    assert not got[0][1].float().any()  # a batch row with no real key: dq = 0
