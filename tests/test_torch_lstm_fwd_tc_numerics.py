"""The rounding of the LSTM forward step's tensor-core product (rows 1, 5, 6
and 8) and of the cell backward's dh product (row 2), emulated on the CPU
and held against the JAX kernels and the port's plain versions; and the
cell wrapper's scratch held to the kernel's tiling.

``lstm_step_mma`` (``csrc/lstm_mma.cuh``) forms h_prev @ RW on the tensor
cores: k = H streams through the block in chunks of ``kFwdChunkBytes`` of an
h row, each chunk split into k slices, one warp each; a warp takes its
slice in k steps (8 in f32, 16 in bf16), and the slices' partial sums are
added in slice order at the end. ``emulate_product`` repeats that in plain
torch for any such product:

- bf16: the products of bf16 operands exact, each mma's sum rounded to f32
  and added to the warp's f32 accumulator;
- f32: 3xTF32 (``split`` as ``tests/test_torch_flash_tc_numerics.py``
  rounds it, as ``cvt.rna`` does): each k step's lo·hi, hi·lo and hi·hi
  mma summed from zero in that order, then added to the warp's
  accumulator.

The emulated product runs inside a test-local copy of the forward
recurrence, whose outputs (ys, h_T, c_T, and the residuals a, f, o, i, c of
the training forward) are held against the JAX ``_seq_lean_impl`` (masked
and unmasked), ``_seq_fwd_impl``, ``_seq_masked_fwd_impl`` and
``_cell_fwd_impl`` (Pallas, interpret mode, as
``tests/test_torch_lstm_seq_train.py`` runs them) and against the port's
plain versions, at ``chip_smoke.py``'s limits: the sequence in f32 at max
abs error 1e-4 (``KERNEL_ATOL``), in bf16 at max |err| / max |ref| and
mean |err| / mean |ref| within ``BF16_TRAIN_REL``; the cell at
``CELL_REL``. The cell backward's dh_prev = dzx @ RW^T runs through the
sequence backward's product (``lstm_bwd_dh_mma``), so it is emulated by
``tests/test_torch_lstm_bwd_tc_numerics.py``'s ``emulate_product`` and held
against the JAX ``_cell_bwd``. The tile constants are read from the
kernel's source, at H=136: two chunks in f32 and one in bf16, the last
partial, and 8.5 unit tiles of 16.
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
    _seq_fwd_impl,
    _seq_lean_impl,
    _seq_masked_fwd_impl,
)
from test_torch_flash_tc_numerics import split  # noqa: E402
from test_torch_lstm_bwd_tc_numerics import emulate_product as emulate_bwd_product  # noqa: E402

from deeplearning4j_tpu_torch.ops import _build  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

# the module, which ops' function of the same name shadows as an attribute
lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
CSRC = Path(ls.__file__).parent / "csrc"
SOURCE = (CSRC / "lstm_mma.cuh").read_text()
CELL_SOURCE = (CSRC / "lstm.cuh").read_text()


def _const(name: str, text: str = SOURCE) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"the source defines no {name}"
    return int(m.group(1))


ROWS, UNITS, WARPS = _const("kFwdRows"), _const("kFwdUnits"), _const("kFwdWarps")
SLICES = WARPS // (ROWS // 16)  # kFwdSlices
CHUNK_BYTES = _const("kFwdChunkBytes")
# chip_smoke.py's limits
KERNEL_ATOL = 1e-4
BF16_TRAIN_REL = {"tail": {"max": 2e-2, "mean": 5e-4}, "long": {"max": 3e-2, "mean": 1e-2}}
CELL_REL = {torch.float32: {"max": 1e-5, "mean": 1e-5}, torch.bfloat16: BF16_TRAIN_REL["tail"]}
TAIL = 6
# H=136: 136 = 8.5 unit tiles; k = H is 2 chunks in f32 (128 each) and 1
# in bf16 (256), the last partial; B=5 is a partial row tile
B, H = 5, 136
KINDS = ("lean", "lean_masked", "train", "train_masked")
TRAIN_NAMES = ("ys", "a", "f", "o", "i", "c", "hT", "cT")
LEAN_NAMES = ("ys", "hT", "cT")
CELL_NAMES = ("h", "c", "a", "f", "o", "i", "cact")


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulation is hundreds of tiny ops a step: under several test
    workers, torch's intra-op threads only contend (seconds a test against
    a tenth of one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def emulate_product(a: torch.Tensor, bt: torch.Tensor, chunk_bytes: int = CHUNK_BYTES,
                    slices: int = SLICES) -> torch.Tensor:
    """a [M, K] @ bt [N, K]^T in f32, as a tensor-core product of this port
    forms it from operands stored in a's dtype: k in chunks of
    ``chunk_bytes`` of a row, ``slices`` k slices a chunk, each slice's k
    steps summed into its own f32 accumulator, the slices added in order."""
    dtype = a.dtype
    M, K = a.shape
    chunk = chunk_bytes // a.element_size()
    kw = chunk // slices
    step = 8 if dtype == torch.float32 else 16
    nch = -(-K // chunk)
    shape = (nch, slices, kw // step, step)
    x = F.pad(a.float(), (0, nch * chunk - K)).reshape(M, *shape)
    y = F.pad(bt.float(), (0, nch * chunk - K)).reshape(bt.shape[0], *shape)
    if dtype == torch.float32:
        (xh, xl), (yh, yl) = split(x), split(y)
        terms = ((xl, yh), (xh, yl), (xh, yh))
    else:
        terms = ((x, y),)
    # one mma's sum of products, exact, rounded to f32: [M, N, nch, slices, steps]
    sums = [torch.einsum("mcsqe,ncsqe->mncsq", u.double(), v.double()).float()
            for u, v in terms]
    acc = torch.zeros(M, bt.shape[0], slices)
    for c in range(nch):
        for q in range(kw // step):
            part = sums[0][:, :, c, :, q]
            for s in sums[1:]:
                part = part + s[:, :, c, :, q]
            acc = acc + part
    out = acc[..., 0]
    for s in range(1, slices):
        out = out + acc[..., s]
    return out


def emulate_forward(h: torch.Tensor, RW: torch.Tensor) -> torch.Tensor:
    """h [B, H] @ RW [H, 4H] in f32, as lstm_step_mma forms it."""
    return emulate_product(h, RW.t())


def recurrence(zx, mask, h0, c0, RW, pF, pI, pO, product=emulate_forward):
    """The forward recurrence of the kernels (tanh, sigmoid), each
    elementwise op rounded to the dtype, z's product by ``product`` rounded
    to the dtype before the add; a masked step holds h and c. Returns (ys,
    a, f, o, i, c, h_T, c_T), a, f, o, i as computed at every step, c (like
    ys) after the mask."""
    act, gate = ls.ACT["tanh"], ls.ACT["sigmoid"]
    dt = zx.dtype
    h, c = h0, c0
    streams = [[] for _ in range(6)]
    for t in range(zx.shape[0]):
        z = zx[t] + product(h, RW).to(dt)
        a = act(z[:, :H])
        f = gate(z[:, H:2 * H] + c * pF)
        i = gate(z[:, 3 * H:] + c * pI)
        c_new = f * c + i * a
        o = gate(z[:, 2 * H:3 * H] + c_new * pO)
        h_new = o * act(c_new)
        if mask is not None:
            m = mask[t]
            h_new = m * h_new + (1.0 - m) * h
            c_new = m * c_new + (1.0 - m) * c
        h, c = h_new, c_new
        for s, v in zip(streams, (h, a, f, o, i, c)):
            s.append(v)
    return tuple(torch.stack(s) for s in streams) + (h, c)


def _mask_rows(T):
    """[B, T]: leading and interior zeros, trailing zeros, all zeros, two
    full rows."""
    rows = np.ones((B, T))
    rows[0, :2] = 0.0
    rows[0, T // 2:T // 2 + 2] = 0.0
    rows[1, T - max(2, T // 3):] = 0.0
    rows[2] = 0.0
    return rows


def _inputs(T, dtype, seed):
    """numpy inputs of one sequence (f32; cast to the case's dtype on use)
    and its [T, B, 1] mask."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    arrs = [r(T, B, 4 * H), r(B, H), r(B, H), r(H, 4 * H) * 0.3,
            r(H) * 0.4, r(H) * 0.4, r(H) * 0.4]
    arrs[0][..., H:2 * H] += 1.0  # forget bias, as the char-RNN's
    mask = _mask_rows(T).T[..., None].astype(np.float32)
    return arrs, mask


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def _jax_forward(kind, arrs, mask, dtype):
    """The JAX kernel of ``kind`` in interpret mode: its outputs in the
    order of the port's (lean: ys, h_T, c_T; train: TRAIN_NAMES)."""
    jdt = _jdt(dtype)
    j = [jnp.asarray(x, jdt) for x in arrs]
    jm = jnp.asarray(mask, jdt)
    if kind == "lean":
        return _seq_lean_impl(j[0], None, *j[1:], "tanh", "sigmoid")
    if kind == "lean_masked":
        return _seq_lean_impl(j[0], jm, *j[1:], "tanh", "sigmoid")
    if kind == "train":
        return _seq_fwd_impl(*j, "tanh", "sigmoid")
    return _seq_masked_fwd_impl(j[0], jm, *j[1:], "tanh", "sigmoid")


def _plain_forward(kind, tens, tmask):
    if kind == "lean":
        return ls.lstm_sequence_reference(*tens)
    if kind == "lean_masked":
        return ls.lstm_sequence_masked_reference(tens[0], tmask, *tens[1:])
    if kind == "train":
        return ls.lstm_sequence_train_reference(*tens)
    return ls.lstm_sequence_masked_train_reference(tens[0], tmask, *tens[1:])


def _emulated_forward(kind, tens, tmask):
    out = recurrence(tens[0], tmask if kind.endswith("masked") else None, *tens[1:])
    if kind.startswith("lean"):
        return out[0], out[6], out[7]
    return out


def _outside(got, want, names, dtype, T):
    """Outputs past chip_smoke.py's limits: f32 by max abs error, bf16 by
    max and mean error relative to the reference's own size (NaN is past
    them)."""
    bad = {}
    lim = BF16_TRAIN_REL["long" if T > TAIL else "tail"]
    for n, g, w in zip(names, got, want):
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        if dtype == torch.float32:
            if not float(err.max()) <= KERNEL_ATOL:
                bad[n] = float(err.max())
        else:
            r = (float(err.max() / ref.max()), float(err.mean() / ref.mean()))
            if not (r[0] <= lim["max"] and r[1] <= lim["mean"]):
                bad[n] = r
    return bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [6, 50])
@pytest.mark.parametrize("against", ["jax", "plain"])
def test_emulated_forward_within_limits(against, T, kind, dtype):
    arrs, mask = _inputs(T, dtype, seed=T + KINDS.index(kind))
    tens = [_torch(x, dtype) for x in arrs]
    tmask = torch.from_numpy(mask).to(dtype)
    got = _emulated_forward(kind, tens, tmask)
    if against == "jax":
        want = [_torch(w, dtype) for w in _jax_forward(kind, arrs, mask, dtype)]
    else:
        want = _plain_forward(kind, tens, tmask)
    names = LEAN_NAMES if kind.startswith("lean") else TRAIN_NAMES
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g.float()).all()), name
    bad = _outside(got, want, names, dtype, T)
    assert not bad, bad


def _cell_case(dtype, seed):
    arrs, _ = _inputs(1, dtype, seed)
    arrs[0] = arrs[0][0]
    rng = np.random.default_rng(seed + 1)
    up = [(rng.normal(size=(B, H)) * 0.1).astype(np.float32) for _ in range(2)]
    return arrs, up


def _rel_within(got, want, names, lim):
    bad = {}
    for n, g, w in zip(names, got, want):
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        mx, mn = float(ref.max()), float(ref.mean())
        r = (float(err.max()) / mx if mx else float(err.max()),
             float(err.mean()) / mn if mn else float(err.mean()))
        if not (r[0] <= lim["max"] and r[1] <= lim["mean"]):
            bad[n] = r
    return bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("against", ["jax", "plain"])
def test_emulated_cell_forward_within_limits(against, dtype):
    """Row 1: one step through the emulated product, against the JAX
    ``_cell_fwd_impl`` and the port's plain version, at ``CELL_REL``."""
    arrs, _ = _cell_case(dtype, seed=3)
    tens = [_torch(x, dtype) for x in arrs]
    zx = tens[0]
    h, a, f, o, i, c = (v[0] for v in recurrence(zx[None], None, *tens[1:])[:6])
    got = (h, c, a, f, o, i, ls.ACT["tanh"](c))
    if against == "jax":
        want = [_torch(w, dtype) for w in _cell_fwd_impl(
            *[jnp.asarray(x, _jdt(dtype)) for x in arrs], "tanh", "sigmoid")]
    else:
        want = lc.lstm_cell_forward_reference(*tens)
    for g, w, name in zip(got, want, CELL_NAMES):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    bad = _rel_within(got, want, CELL_NAMES, CELL_REL[dtype])
    assert not bad, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("against", ["jax", "plain"])
def test_emulated_cell_dh_product_within_limits(against, dtype):
    """Row 2's dh_prev = dzx @ RW^T through the sequence backward's product
    (lstm_bwd_dh_mma, emulated as tests/test_torch_lstm_bwd_tc_numerics.py
    emulates it), from the plain backward's dzx, against the JAX
    ``_cell_bwd`` and the port's plain version, at ``CELL_REL``."""
    arrs, up = _cell_case(dtype, seed=4)
    jdt = _jdt(dtype)
    jarrs = [jnp.asarray(x, jdt) for x in arrs]
    fwd = _cell_fwd_impl(*jarrs, "tanh", "sigmoid")
    zx, h_prev, c_prev, RW, pF, pI, pO = jarrs
    h, c, a, f, o, i, cact = fwd
    jres = (a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO)
    jup = tuple(jnp.asarray(x, jdt) for x in up)
    res = [_torch(x, dtype) for x in jres]
    tup = [_torch(x, dtype) for x in jup]
    plain = lc.lstm_cell_backward_reference(*res, *tup)
    got = emulate_bwd_product(plain[0], res[8]).to(dtype)
    if against == "jax":
        want = _torch(_cell_bwd("tanh", "sigmoid", jres, jup)[1], dtype)
    else:
        want = plain[1]
    assert got.shape == want.shape == (B, H) and got.dtype == want.dtype
    bad = _rel_within([got], [want], ["dh_prev"], CELL_REL[dtype])
    assert not bad, bad


def test_the_emulated_product_is_the_product():
    """In f64-exact arithmetic the chunking and the slices change nothing:
    the emulated forward product equals the f64 product rounded once,
    within the f32 sum's rounding."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    RW = torch.from_numpy(rng.normal(size=(H, 4 * H)).astype(np.float32))
    want = h.double() @ RW.double()
    got = emulate_forward(h, RW)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    bf = emulate_forward(h.bfloat16(), RW.bfloat16())
    want_bf = h.bfloat16().double() @ RW.bfloat16().double()
    assert float((bf.double() - want_bf).abs().max()) <= 1e-5 * float(want_bf.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_tf32_pass_or_a_dropped_chunk_reads_past_the_limit(dtype):
    """The wrong products chip_smoke.py must catch are caught by the same
    limit here: the first chunk of k left out, and in f32 one TF32 pass in
    place of 3xTF32 (the emulation with only its hi·hi term)."""
    T = 50
    arrs, _ = _inputs(T, dtype, seed=7)
    tens = [_torch(x, dtype) for x in arrs]
    right = recurrence(tens[0], None, *tens[1:])
    chunk = CHUNK_BYTES // tens[0].element_size()

    def dropped(h, RW):
        h = h.clone()
        h[:, :chunk] = 0.0
        return emulate_forward(h, RW)

    wrongs = [dropped]
    if dtype == torch.float32:
        wrongs.append(lambda h, RW: split(h)[0] @ split(RW)[0])
    for product in wrongs:
        wrong = recurrence(tens[0], None, *tens[1:], product=product)
        assert _outside(wrong, right, TRAIN_NAMES, dtype, T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_slices_follow_the_kernel_source(dtype):
    """The emulation's chunk and slices are the kernel's: kFwdChunkBytes of
    an h row, kFwdWarps / (kFwdRows / 16) slices, each a whole number of
    mma k steps; a block's (row, unit) pairs split evenly over its
    threads."""
    chunk = CHUNK_BYTES // torch.tensor([], dtype=dtype).element_size()
    step = 8 if dtype == torch.float32 else 16
    assert (chunk // SLICES) % step == 0
    assert ROWS % 16 == 0 and SLICES * (ROWS // 16) == WARPS
    assert ROWS * UNITS % (32 * WARPS) == 0 and UNITS % 8 == 0
    # H=136 exercises a partial last chunk and a partial unit tile
    assert H % chunk and H % UNITS


@pytest.mark.parametrize("batch", [1, 31, 32, 33, 64])
def test_cell_psum_scratch_follows_the_kernel_row_block(monkeypatch, batch):
    """The cell backward's psum holds ceil(B / kRows) * 3 * H f32 slots,
    the row block of lstm.cuh's cell_bwd_gates read from its source: a
    smaller psum would be written out of bounds on the card and pass every
    CPU test."""
    rows = _const("kRows", CELL_SOURCE)
    assert lc.CELL_ROW_BLOCK == rows
    calls = []
    monkeypatch.setattr(_build, "bind", lambda lib, sym, *counts: (lib, sym, counts))
    monkeypatch.setattr(_build, "launch",
                        lambda counts, name, fn, device, *args: calls.append((fn, args)))
    Hs = 8
    state = lambda: torch.zeros(batch, Hs)  # noqa: E731
    vec = lambda: torch.zeros(Hs)  # noqa: E731
    lc._launch_backward(*(state() for _ in range(8)), torch.zeros(Hs, 4 * Hs), vec(), vec(),
                        vec(), state(), state(), "tanh", "sigmoid")
    (lib, sym, counts), args = calls[0]
    assert (lib, sym) == ("lstm_cell", "dl4j_lstm_cell_bwd")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    assert len(tensors) == counts[0]  # every pointer the C entry takes
    psum = tensors[-1]
    assert psum.dtype == torch.float32
    assert psum.numel() == math.ceil(batch / rows) * 3 * Hs
