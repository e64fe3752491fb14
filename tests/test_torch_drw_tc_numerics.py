"""The rounding of the LSTM backward's dRW product on the tensor cores (rows
2, 7 and 9), emulated on the CPU and held against the JAX kernels and the
port's plain versions; and the wrappers' split-R scratch held to the
kernel's tiling.

``drw_mma`` (``csrc/lstm_drw.cuh``) forms dRW = sum_r hprev[r]^T dzx[r] over
R = T*B rows (R = B for the cell) on the tensor cores: r streams through a
block in tiles of ``kDrwTileBytes`` of a column (32 rows in f32, 64 in
bf16), which a warp takes in k steps (8 rows in f32, 16 in bf16) into its
f32 sum; R may be split into slices of whole tiles, whose f32 partials
``drw_reduce`` adds in slice order before rounding to the type. This file
repeats that in plain torch (``emulate_drw``):

- bf16: the products of bf16 operands exact, each mma's sum rounded to f32
  and added to the warp's f32 sum;
- f32: 3xTF32 (``split`` as ``tests/test_torch_flash_tc_numerics.py``
  rounds it, as ``cvt.rna`` does): each k step's lo·hi, hi·lo and hi·hi
  mma summed from zero in that order, then added to the warp's f32 sum;
- the slices from zero each, added in slice order.

The emulated dRW, from the dzx that each reference computed, is held
against the dRW of the JAX ``_seq_bwd``, ``_seq_masked_bwd`` and
``_cell_bwd`` (Pallas, interpret mode, as
``tests/test_torch_lstm_seq_train.py`` runs them) and of the port's plain
versions, at ``chip_smoke.py``'s limits: f32 max abs error over dRW's
largest element 1e-4 (``KERNEL_ATOL``); bf16 max |err| / max |ref| and mean
|err| / mean |ref| within ``BF16_TRAIN_REL`` (its short-sequence limits:
dRW is rounded once from an f32 sum). Sizes are ragged (H=136: 1.06 unit
tiles of 128 and 4.25 column tiles; B=5 and 64), and R runs to 3200 rows
(T=50, B=64, three slices) and 2400 (T=300 steps at H=8, two slices), so
the long k order is exercised. The tile constants are read from the
kernel's source.
"""

import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    _cell_bwd,
    _cell_fwd_impl,
    _seq_bwd,
    _seq_fwd_impl,
    _seq_masked_bwd,
    _seq_masked_fwd_impl,
)
from test_torch_flash_tc_numerics import split, tf32  # noqa: E402

from deeplearning4j_tpu_torch.ops import _build  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

# the module, which ops' function of the same name shadows as an attribute
lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
SOURCE = (Path(ls.__file__).parent / "csrc" / "lstm_drw.cuh").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"lstm_drw.cuh defines no {name}"
    return int(m.group(1))


TILE_M, TILE_N = _const("kDrwM"), _const("kDrwN")
TILE_BYTES = _const("kDrwTileBytes")
# chip_smoke.py's limits
KERNEL_ATOL = 1e-4
BF16_REL = {"max": 2e-2, "mean": 5e-4}  # BF16_TRAIN_REL["tail"]
# (T, B, H) of the sequence cases: ragged H, a short and a long R, and R
# long enough that the wrapper splits it (3 slices at 3200 rows and H=136,
# 2 at 2400 rows and H=8)
SEQ_CASES = [(50, 5, 136), (50, 64, 136), (300, 8, 8)]


def tile_rows(dtype) -> int:
    return TILE_BYTES // torch.tensor([], dtype=dtype).element_size()


def emulate_drw(hp: torch.Tensor, dz: torch.Tensor, slices: int,
                fault: str = "") -> torch.Tensor:
    """hp [R, H]^T @ dz [R, 4H] in f32, as drw_mma (and drw_reduce over
    ``slices``) forms it from operands stored in dz's dtype. ``fault``:
    "r_tile_dropped" leaves out the first tile of r, "one_tf32_pass" takes
    one TF32 product in place of 3xTF32 (f32)."""
    dtype = dz.dtype
    R, H = hp.shape
    rows = tile_rows(dtype)
    step = 8 if dtype == torch.float32 else 16
    tiles = -(-R // rows)
    slice_rows = -(-tiles // slices) * rows
    pad = slices * slice_rows - R
    a, b = F.pad(hp.float(), (0, 0, 0, pad)), F.pad(dz.float(), (0, 0, 0, pad))
    if fault == "r_tile_dropped":
        a[:rows] = 0.0
    if dtype != torch.float32:
        terms = ((a, b),)
    elif fault == "one_tf32_pass":
        terms = ((tf32(a), tf32(b)),)
    else:
        (ah, al), (bh, bl) = split(a), split(b)
        terms = ((al, bh), (ah, bl), (ah, bh))
    out = None
    for s in range(slices):
        acc = torch.zeros(H, dz.shape[1])
        for k0 in range(s * slice_rows, (s + 1) * slice_rows, step):
            part = None
            for x, y in terms:  # one mma's sum of products, exact, rounded to f32
                p = (x[k0:k0 + step].double().t() @ y[k0:k0 + step].double()).float()
                part = p if part is None else part + p
            acc = acc + part
        out = acc if out is None else out + acc
    return out


def _stacked(h0, ys, dzx):
    """(hprev [R, H], dz [R, 4H]) as the kernel reads them: h0, then ys[:-1]."""
    H = h0.shape[-1]
    return (torch.cat([h0[None], ys[:dzx.shape[0] - 1]]).reshape(-1, H),
            dzx.reshape(-1, 4 * H))


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def _mask(T, B):
    """[T, B, 1]: leading and interior zeros, trailing zeros, an all-zero
    row."""
    rows = np.ones((B, T))
    rows[0, :2] = 0.0
    rows[0, T // 2:T // 2 + 2] = 0.0
    rows[1, T - max(2, T // 3):] = 0.0
    rows[2] = 0.0
    return rows.T[..., None].astype(np.float32)


def _seq_case(T, B, H, masked, dtype, seed):
    """(h0, ys, dzx, dRW) of the JAX sequence backward and (h0, ys, dzx,
    dRW) of the port's plain backward on the JAX forward's residuals, in
    the case's dtype."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    jdt = _jdt(dtype)
    jarrs = [jnp.asarray(x, jdt) for x in (r(T, B, 4 * H), r(B, H), r(B, H),
                                           r(H, 4 * H) * 0.3, r(H) * 0.4, r(H) * 0.4,
                                           r(H) * 0.4)]
    mask = _mask(T, B) if masked else None
    if masked:
        jm = jnp.asarray(mask, jdt)
        res = _seq_masked_fwd_impl(jarrs[0], jm, *jarrs[1:], "tanh", "sigmoid")[:6]
    else:
        res = _seq_fwd_impl(*jarrs, "tanh", "sigmoid")[:6]
    up = tuple(jnp.asarray(rng.normal(size=s) * 0.1, jdt) for s in ((T, B, H), (B, H), (B, H)))
    if masked:
        want = _seq_masked_bwd("tanh", "sigmoid", tuple(res) + (jm,) + tuple(jarrs[1:]), up)
        want = (want[0],) + tuple(want[2:])  # the mask takes no gradient
    else:
        want = _seq_bwd("tanh", "sigmoid", tuple(res) + tuple(jarrs[1:]), up)
    h0, ys = _torch(jarrs[1], dtype), _torch(res[0], dtype)
    jax_side = (h0, ys, _torch(want[0], dtype), _torch(want[3], dtype))
    tens = [_torch(x, dtype) for x in up + tuple(res) + tuple(jarrs[1:])]
    tmask = None if mask is None else torch.from_numpy(mask).to(dtype)
    plain = ls.lstm_sequence_masked_backward_reference(*tens[:3], tmask, *tens[3:])
    return jax_side, (h0, ys, plain[0], plain[3])


def _cell_case(B, H, dtype, seed):
    """(h_prev, dzx, dRW) of the JAX ``_cell_bwd`` and of the port's plain
    cell backward on the JAX forward's residuals."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    jdt = _jdt(dtype)
    zx, h_prev, c_prev, RW, pF, pI, pO = (
        jnp.asarray(x, jdt) for x in (r(B, 4 * H), r(B, H), r(B, H), r(H, 4 * H) * 0.3,
                                      r(H) * 0.4, r(H) * 0.4, r(H) * 0.4))
    h, c, a, f, o, i, cact = _cell_fwd_impl(zx, h_prev, c_prev, RW, pF, pI, pO,
                                            "tanh", "sigmoid")
    jres = (a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO)
    jup = tuple(jnp.asarray(rng.normal(size=(B, H)) * 0.1, jdt) for _ in range(2))
    want = _cell_bwd("tanh", "sigmoid", jres, jup)
    hp = _torch(h_prev, dtype)
    plain = lc.lstm_cell_backward_reference(*(_torch(x, dtype) for x in jres + jup))
    return (hp, _torch(want[0], dtype), _torch(want[3], dtype)), (hp, plain[0], plain[3])


def _reading(got, want):
    """(max |err| / max |ref|, mean |err| / mean |ref|) of dRW."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    return float(err.max() / ref.max()), float(err.mean() / ref.mean())


def _within(reading, dtype) -> bool:
    if dtype == torch.float32:
        return reading[0] <= KERNEL_ATOL  # NaN fails too
    return reading[0] <= BF16_REL["max"] and reading[1] <= BF16_REL["mean"]


def _emulated_seq(h0, ys, dzx, fault=""):
    hp, dz = _stacked(h0, ys, dzx)
    return emulate_drw(hp, dz, ls.drw_slices(hp.shape[0], hp.shape[1]), fault).to(dzx.dtype)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("T,B,H", SEQ_CASES)
@pytest.mark.parametrize("against", ["jax", "plain"])
def test_emulated_sequence_drw_within_limits(against, T, B, H, masked, dtype):
    """Rows 7 and 9: dRW of the emulated kernel from a backward's dzx
    against that backward's dRW (JAX's, or the port's plain version's)."""
    jax_side, plain = _seq_case(T, B, H, masked, dtype, seed=T + B + H + masked)
    h0, ys, dzx, want = jax_side if against == "jax" else plain
    got = _emulated_seq(h0, ys, dzx)
    assert got.shape == want.shape == (H, 4 * H) and got.dtype == want.dtype
    reading = _reading(got, want)
    assert _within(reading, dtype), reading
    if against == "plain":  # the plain dRW product alone is the backward's
        assert torch.equal(ls.drw_product_reference(h0, ys, dzx), want)


@DTYPES
@pytest.mark.parametrize("B", [5, 64])
@pytest.mark.parametrize("against", ["jax", "plain"])
def test_emulated_cell_drw_within_limits(against, B, dtype):
    """Row 2: one step's dRW (R = B) of the emulated kernel against the JAX
    ``_cell_bwd``'s and the port's plain version's."""
    jax_side, plain = _cell_case(B, 136, dtype, seed=B)
    hp, dzx, want = jax_side if against == "jax" else plain
    got = emulate_drw(hp, dzx, ls.drw_slices(B, 136)).to(dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    reading = _reading(got, want)
    assert _within(reading, dtype), reading


@DTYPES
@pytest.mark.parametrize("slices", [1, 2, 3])
def test_the_emulation_is_the_product(dtype, slices):
    """In f64-exact arithmetic the tiles, k steps and slices change
    nothing: the emulation of f32 (3xTF32) or bf16 operands equals their
    f64 product within the f32 sums' rounding."""
    rng = np.random.default_rng(slices)
    hp = torch.from_numpy(rng.normal(size=(300, 40)).astype(np.float32)).to(dtype)
    dz = torch.from_numpy(rng.normal(size=(300, 160)).astype(np.float32)).to(dtype)
    want = hp.double().t() @ dz.double()
    got = emulate_drw(hp, dz, slices)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("fault,dtype", [("r_tile_dropped", torch.float32),
                                         ("r_tile_dropped", torch.bfloat16),
                                         ("one_tf32_pass", torch.float32)],
                         ids=["r_tile_dropped-f32", "r_tile_dropped-bf16", "one_tf32_pass-f32"])
def test_wrong_products_read_past_the_limit(fault, dtype):
    """The limits catch the dRW product done wrong, against the JAX
    backward's dRW, at the longest R: the first r tile left out, or (f32)
    one TF32 product in place of 3xTF32."""
    (h0, ys, dzx, want), _ = _seq_case(50, 64, 136, False, dtype, seed=7)
    assert _within(_reading(_emulated_seq(h0, ys, dzx), want), dtype)
    reading = _reading(_emulated_seq(h0, ys, dzx, fault), want)
    assert not _within(reading, dtype), reading


def test_tiles_follow_the_kernel_source():
    """The wrapper's tile (which sets the slices) is the kernel's, and a
    tile is whole k steps in either type."""
    assert ls.DRW_TILE == (TILE_M, TILE_N)
    assert tile_rows(torch.float32) % 8 == 0 and tile_rows(torch.bfloat16) % 16 == 0


def _expected_slices(R, H):
    tiles = math.ceil(H / TILE_M) * math.ceil(4 * H / TILE_N)
    return max(1, min(ls.DRW_BLOCKS // tiles, R // ls.DRW_SLICE_ROWS))


def _fake_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "bind", lambda lib, sym, *counts: (lib, sym, counts))
    monkeypatch.setattr(_build, "launch",
                        lambda counts, name, fn, device, *args: calls.append((fn, args)))
    return calls


def _scratch(args, slices_at):
    """(the dRW scratch, the slices the C entry is given) from a launch's
    arguments: the scratch is the f32 tensor before psum, or the last one."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if isinstance(a, int)]
    return tensors, ints[slices_at]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("T,B,H", [(3, 5, 8), (32, 64, 8), (256, 64, 8), (50, 64, 512),
                                   (40, 64, 136)])
def test_drw_scratch_follows_the_kernel_tile(monkeypatch, T, B, H, masked):
    """The sequence backward's dRW scratch holds slices * H * 4H f32
    partials, the slices set by the kernel's tile read from its source (an
    empty scratch, a null pointer, for one slice), and the C entry is told
    the same slices: a smaller scratch would be written out of bounds on the
    card and pass every CPU test."""
    calls = _fake_launches(monkeypatch)
    seq = lambda: torch.zeros(T, B, H)  # noqa: E731
    state = lambda: torch.zeros(B, H)  # noqa: E731
    vec = lambda: torch.zeros(H)  # noqa: E731
    mask = torch.ones(T, B, 1) if masked else None
    ls._launch_bwd(seq(), state(), state(), mask, seq(), seq(), seq(), seq(), seq(), seq(),
                   state(), state(), torch.zeros(H, 4 * H), vec(), vec(), vec(),
                   "tanh", "sigmoid")
    (lib, sym, counts), args = calls[0]
    tensors, slices = _scratch(args, -2)
    assert len(tensors) == counts[0]
    want = _expected_slices(T * B, H)
    part = tensors[-2]
    assert slices == want and part.dtype == torch.float32
    assert part.numel() == (want * H * 4 * H if want > 1 else 0)


@pytest.mark.parametrize("T,B,H", [(1, 64, 512), (32, 64, 8), (300, 8, 8)])
def test_drw_product_scratch_follows_the_kernel_tile(monkeypatch, T, B, H):
    """The same for the product alone, whose C entry takes (h0, ys, dzx,
    dRW, scratch) and (R, B, H, slices, bf16)."""
    calls = _fake_launches(monkeypatch)
    got = ls._launch_drw(torch.zeros(B, H), torch.zeros(T, B, H), torch.zeros(T, B, 4 * H))
    (lib, sym, counts), args = calls[0]
    assert (lib, sym, counts) == ("lstm_seq_bwd", "dl4j_drw_product", (5, 5))
    tensors, slices = _scratch(args, 3)
    assert len(tensors) == 5 and tensors[3] is got and got.shape == (H, 4 * H)
    want = _expected_slices(T * B, H)
    assert slices == want and args[5:8] == (T * B, B, H)
    assert tensors[4].numel() == (want * H * 4 * H if want > 1 else 0)


@pytest.mark.parametrize("B", [5, 64, 2048])
def test_cell_drw_scratch_follows_the_kernel_tile(monkeypatch, B):
    """The same for the cell backward, whose dRW has R = B rows."""
    calls = _fake_launches(monkeypatch)
    H = 8
    state = lambda: torch.zeros(B, H)  # noqa: E731
    vec = lambda: torch.zeros(H)  # noqa: E731
    lc._launch_backward(*(state() for _ in range(8)), torch.zeros(H, 4 * H), vec(), vec(),
                        vec(), state(), state(), "tanh", "sigmoid")
    (lib, sym, counts), args = calls[0]
    assert (lib, sym) == ("lstm_cell", "dl4j_lstm_cell_bwd")
    tensors, slices = _scratch(args, -2)
    assert len(tensors) == counts[0]
    want = _expected_slices(B, H)
    assert slices == want
    assert tensors[-2].numel() == (want * H * 4 * H if want > 1 else 0)


def test_plain_backwards_take_the_drw_hook():
    """The plain backwards form dRW through their ``drw`` hook (the one
    chip_smoke.py passes wrong products to), with the dzx they computed."""
    seen = []

    def drw(h0_, ys_, dzx_):
        seen.append(dzx_)
        return torch.full((h0_.shape[-1], dzx_.shape[-1]), 7.0)

    T, B, H = 6, 5, 8
    rng = np.random.default_rng(2)
    tens = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((T, B, H), (B, H), (B, H), (T, B, H), (T, B, H), (T, B, H),
                      (T, B, H), (T, B, H), (T, B, H), (B, H), (B, H), (H, 4 * H), (H,),
                      (H,), (H,))]
    grads = ls.lstm_sequence_masked_backward_reference(*tens[:3], None, *tens[3:], drw=drw)
    assert torch.equal(grads[3], torch.full((H, 4 * H), 7.0))
    assert torch.equal(seen[0], grads[0])
    res = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in [(B, H)] * 8 + [(H, 4 * H), (H,), (H,), (H,), (B, H), (B, H)]]
    cell = lc.lstm_cell_backward_reference(*res, drw=drw)
    assert torch.equal(cell[3], torch.full((H, 4 * H), 7.0))
    assert torch.equal(seen[1], cell[0][None])
