"""The rounding of the LSTM sequence backward's tensor-core product (rows 7
and 9), emulated on the CPU and held against the JAX kernels and the port's
plain versions; and the wrapper's scratch held to the kernel's tiling.

The step kernel of ``csrc/lstm_seq_bwd.cu`` forms dh_carry = dzx[t+1] @ RW^T
on the tensor cores: k = 4H streams through the block in chunks of 1024
bytes of a row, each chunk split into k slices, one warp each; a warp takes
its slice in k steps (8 in f32, 16 in bf16), and the slices' partial sums
are added in slice order at the end. This file repeats that in plain torch
(``emulate_product``):

- bf16: the products of bf16 operands exact, each mma's sum rounded to f32
  and added to the warp's f32 accumulator;
- f32: 3xTF32 (``tf32``/``split`` as ``tests/test_torch_flash_tc_numerics.py``
  rounds them, as ``cvt.rna`` does): each k step's lo·hi, hi·lo and hi·hi
  mma summed from zero in that order, then added to the warp's
  accumulator.

The emulated product runs inside a test-local copy of the reverse
recurrence, and its dzx, dh0, dc0, dRW and peephole grads are held against
the JAX ``_seq_bwd`` and ``_seq_masked_bwd`` (Pallas, interpret mode, as
``tests/test_torch_lstm_seq_train.py`` runs them) and against the port's
plain versions, at ``chip_smoke.py``'s limits: f32 max abs error 1e-4 (dRW
and the peephole grads over their largest element), bf16 max |err| / max
|ref| and mean |err| / mean |ref| within ``BF16_TRAIN_REL``. One
exception: in bf16 the JAX kernel's peephole grads, run by XLA on the CPU,
sum the bf16 products df*c_prev, di*c_prev and do*c in f32 before rounding
them (excess precision, as in the cell backward, ROADMAP Queue 3), where the
port's plain version and kernel round each product to bf16 first, as the
TPU does; so those three are held to JAX at the long-sequence limit, and to
the port's plain version at the limit of T. The tile constants are read
from the kernel's source.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    _seq_bwd,
    _seq_fwd_impl,
    _seq_masked_bwd,
    _seq_masked_fwd_impl,
)
from test_torch_flash_tc_numerics import split  # noqa: E402

from deeplearning4j_tpu_torch.ops import _build  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

# the product's tile lives in the header lstm_seq_bwd.cu shares with the
# forward step and the cell backward
SOURCE = (Path(ls.__file__).parent / "csrc" / "lstm_mma.cuh").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)", SOURCE)
    assert m, f"lstm_mma.cuh defines no {name}"
    return int(m.group(1))


ROWS, WARPS = _const("kBwdRows"), _const("kBwdWarps")
SLICES = WARPS // (ROWS // 16)  # kSlices
CHUNK_BYTES = int(re.search(r"constexpr int kChunk = (\d+) /", SOURCE).group(1))
# chip_smoke.py's limits
KERNEL_ATOL = 1e-4
BF16_TRAIN_REL = {"tail": {"max": 2e-2, "mean": 5e-4}, "long": {"max": 3e-2, "mean": 1e-2}}
TAIL = 6
SUMMED = ("dRW", "dpF", "dpI", "dpO")
GRADS = ("dzx", "dh0", "dc0") + SUMMED
# H=136: 4H = 544 columns, 3 chunks in f32 and 2 in bf16, the last partial
B, H = 5, 136


def emulate_product(dz: torch.Tensor, RW: torch.Tensor) -> torch.Tensor:
    """dz [B, 4H] @ RW [H, 4H]^T in f32, as lstm_bwd_step_mma forms it from
    operands stored in dz's dtype."""
    dtype = dz.dtype
    Bn, K = dz.shape
    chunk = CHUNK_BYTES // dz.element_size()
    kw = chunk // SLICES
    step = 8 if dtype == torch.float32 else 16
    nch = -(-K // chunk)
    shape = (nch, SLICES, kw // step, step)
    a = F.pad(dz.float(), (0, nch * chunk - K)).reshape(Bn, *shape)
    b = F.pad(RW.float(), (0, nch * chunk - K)).reshape(RW.shape[0], *shape)
    if dtype == torch.float32:
        (ah, al), (bh, bl) = split(a), split(b)
        terms = ((al, bh), (ah, bl), (ah, bh))
    else:
        terms = ((a, b),)
    # one mma's sum of products, exact, rounded to f32: [B, H, nch, slices, steps]
    sums = [torch.einsum("bcsqe,hcsqe->bhcsq", x.double(), y.double()).float()
            for x, y in terms]
    acc = torch.zeros(Bn, RW.shape[0], SLICES)
    for c in range(nch):
        for q in range(kw // step):
            part = sums[0][:, :, c, :, q]
            for s in sums[1:]:
                part = part + s[:, :, c, :, q]
            acc = acc + part
    out = acc[..., 0]
    for s in range(1, SLICES):
        out = out + acc[..., s]
    return out


def recurrence(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO,
               product=emulate_product):
    """The reverse recurrence of the kernels (tanh, sigmoid), each
    elementwise op rounded to the dtype, the carry's product by ``product``;
    dRW and the peephole sums in f32. Returns (dzx, dh0, dc0, dRW, dpF,
    dpI, dpO)."""
    act, dact, dgate = ls.ACT["tanh"], ls.DACT["tanh"], ls.DACT["sigmoid"]
    dt = ys.dtype
    T = ys.shape[0]
    dRW = torch.zeros(RW.shape)
    dp = [torch.zeros(pF.shape) for _ in range(3)]
    dzx = []
    dh_carry, dc_carry = dhT, dcT
    for t in reversed(range(T)):
        c_prev = c0 if t == 0 else c[t - 1]
        h_prev = h0 if t == 0 else ys[t - 1]
        ct = f[t] * c_prev + i[t] * a[t]
        cact = act(ct)
        dh = dh_t = dys[t] + dh_carry
        dc = dc_t = dc_carry
        if mask is not None:
            dh, dc = mask[t] * dh_t, mask[t] * dc_t
        d_o = dh * cact * dgate(o[t])
        dc_tot = dc + dh * o[t] * dact(cact) + d_o * pO
        d_f = dc_tot * c_prev * dgate(f[t])
        d_i = dc_tot * a[t] * dgate(i[t])
        d_a = dc_tot * i[t] * dact(a[t])
        dz = torch.cat([d_a, d_f, d_o, d_i], dim=-1)
        dzx.append(dz)
        dh_carry = product(dz, RW).to(dt)
        dc_carry = dc_tot * f[t] + d_f * pF + d_i * pI
        if mask is not None:
            keep = 1.0 - mask[t]
            dh_carry = dh_carry + keep * dh_t
            dc_carry = dc_carry + keep * dc_t
        dRW += h_prev.float().t() @ dz.float()
        for s, term in zip(dp, (d_f * c_prev, d_i * c_prev, d_o * ct)):
            s += term.float().sum(0)
    return (torch.stack(dzx[::-1]), dh_carry, dc_carry, dRW.to(dt)) + tuple(
        s.to(dt) for s in dp)


def _mask_rows(T):
    """[B, T]: leading and interior zeros, trailing zeros, all zeros, two
    full rows."""
    rows = np.ones((B, T))
    rows[0, :2] = 0.0
    rows[0, T // 2:T // 2 + 2] = 0.0
    rows[1, T - max(2, T // 3):] = 0.0
    rows[2] = 0.0
    return rows


def _case(T, masked, dtype, seed):
    """numpy inputs of one backward: the JAX training forward's residuals
    and random upstream grads, in f32 (cast to the case's dtype on use)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    arrs = [r(T, B, 4 * H), r(B, H), r(B, H), r(H, 4 * H) * 0.3,
            r(H) * 0.4, r(H) * 0.4, r(H) * 0.4]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jarrs = [jnp.asarray(x, jdt) for x in arrs]
    mask = _mask_rows(T).T[..., None].astype(np.float32) if masked else None
    if masked:
        fwd = _seq_masked_fwd_impl(jarrs[0], jnp.asarray(mask, jdt), *jarrs[1:],
                                   "tanh", "sigmoid")
    else:
        fwd = _seq_fwd_impl(*jarrs, "tanh", "sigmoid")
    up = [jnp.asarray(rng.normal(size=s) * 0.1, jdt) for s in ((T, B, H), (B, H), (B, H))]
    return jarrs, fwd[:6], mask, up


def _jax_grads(jarrs, res, mask, up, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if mask is None:
        return _seq_bwd("tanh", "sigmoid", tuple(res) + tuple(jarrs[1:]), tuple(up))
    want = _seq_masked_bwd("tanh", "sigmoid",
                           tuple(res) + (jnp.asarray(mask, jdt),) + tuple(jarrs[1:]), tuple(up))
    return (want[0],) + tuple(want[2:])  # the mask takes no gradient


def _torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def _readings(got, want, dtype):
    """Each output's reading and whether it is within chip_smoke.py's limit."""
    out = {}
    for name, g, w in zip(GRADS, got, want):
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        if dtype == torch.float32:
            scale = float(ref.max()) if name in SUMMED else 1.0
            out[name] = float(err.max()) / scale
        else:
            out[name] = (float(err.max() / ref.max()), float(err.mean() / ref.mean()))
    return out


PEEPHOLE_GRADS = ("dpF", "dpI", "dpO")


def _outside(readings, dtype, T, against):
    """The readings past chip_smoke.py's limits (NaN is past them)."""
    if dtype == torch.float32:
        return {n: r for n, r in readings.items() if not r <= KERNEL_ATOL}
    bad = {}
    for n, r in readings.items():
        long = T > TAIL or (against == "jax" and n in PEEPHOLE_GRADS)
        lim = BF16_TRAIN_REL["long" if long else "tail"]
        if not (r[0] <= lim["max"] and r[1] <= lim["mean"]):
            bad[n] = r
    return bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("T", [6, 50])
@pytest.mark.parametrize("against", ["jax", "plain"])
def test_emulated_product_within_limits(against, T, masked, dtype):
    jarrs, res, mask, up = _case(T, masked, dtype, seed=T + 10 * masked)
    tens = [_torch(x, dtype) for x in tuple(up) + tuple(res) + tuple(jarrs[1:])]
    tmask = None if mask is None else torch.from_numpy(mask).to(dtype)
    got = recurrence(*tens[:3], tmask, *tens[3:])
    if against == "jax":
        want = [_torch(w, dtype) for w in _jax_grads(jarrs, res, mask, up, dtype)]
    else:
        want = ls.lstm_sequence_masked_backward_reference(*tens[:3], tmask, *tens[3:])
    for g, w, name in zip(got, want, GRADS):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g.float()).all()), name
    bad = _outside(_readings(got, want, dtype), dtype, T, against)
    assert not bad, bad


def test_the_emulated_product_is_the_product():
    """In f64-exact arithmetic the chunking and the slices change nothing:
    emulate_product of tf32-exact f32 values equals their f64 product
    rounded once, within the f32 sum's rounding."""
    rng = np.random.default_rng(0)
    dz = torch.from_numpy(rng.normal(size=(B, 4 * H)).astype(np.float32))
    RW = torch.from_numpy(rng.normal(size=(H, 4 * H)).astype(np.float32))
    want = dz.double() @ RW.double().t()
    got = emulate_product(dz, RW)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    bf = emulate_product(dz.bfloat16(), RW.bfloat16())
    want_bf = dz.bfloat16().double() @ RW.bfloat16().double().t()
    assert float((bf.double() - want_bf).abs().max()) <= 1e-5 * float(want_bf.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_slices_follow_the_kernel_source(dtype):
    """The emulation's chunk and slices are the kernel's: 1024 bytes a row,
    kBwdWarps / (kBwdRows / 16) slices, each a whole number of mma k steps."""
    chunk = CHUNK_BYTES // torch.tensor([], dtype=dtype).element_size()
    step = 8 if dtype == torch.float32 else 16
    assert (chunk // SLICES) % step == 0
    assert ROWS % 16 == 0 and SLICES * (ROWS // 16) == WARPS


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("batch", [1, ROWS, ROWS + 1, 64])
def test_psum_scratch_follows_the_kernel_row_block(monkeypatch, masked, batch):
    """The wrapper's psum holds steps * ceil(B / kBwdRows) * 3 * H f32
    slots, the kernel's row block read from its source: a smaller psum
    would be written out of bounds on the card and pass every CPU test."""
    assert ls.BWD_ROW_BLOCK == ROWS
    calls = []
    monkeypatch.setattr(_build, "bind", lambda lib, sym, *counts: (lib, sym, counts))
    monkeypatch.setattr(_build, "launch",
                        lambda counts, name, fn, device, *args: calls.append((fn, args)))
    T, Hs = 3, 8
    seq = lambda: torch.zeros(T, batch, Hs)  # noqa: E731
    state = lambda: torch.zeros(batch, Hs)  # noqa: E731
    vec = lambda: torch.zeros(Hs)  # noqa: E731
    mask = torch.ones(T, batch, 1) if masked else None
    ls._launch_bwd(seq(), state(), state(), mask, seq(), seq(), seq(), seq(), seq(), seq(),
                   state(), state(), torch.zeros(Hs, 4 * Hs), vec(), vec(), vec(),
                   "tanh", "sigmoid")
    (lib, sym, counts), args = calls[0]
    assert (lib, sym) == ("lstm_seq_bwd",
                          "dl4j_lstm_seq_masked_bwd" if masked else "dl4j_lstm_seq_bwd")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    assert len(tensors) == counts[0]  # every pointer the C entry takes
    psum = tensors[-1]
    assert psum.dtype == torch.float32
    assert psum.numel() == T * math.ceil(batch / ROWS) * 3 * Hs
