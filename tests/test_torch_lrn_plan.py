"""The launch plan of the port's LRN kernels and their walk over it, on the CPU.

``ops/lrn.py:plan`` decides how ``csrc/lrn.cu`` walks rows*C elements: the
vector width (16 bytes, or one element where the pointers disagree modulo
16 bytes), the head (elements before the first 16-byte-aligned one), the
tile (``kThreads * kElems`` elements, read here from the source), the ragged
tail and whether the windows run in registers. These tests pin the plan,
then repeat the kernels' walk in plain torch: per tile, stage x*x (forward)
or t = (g*x)*d^(-beta-1) (backward) of its elements and of its halo (the
values a window reaches past the tile's ends), sum each element's window
from the staged tile in j order over the taps inside its row, and take the
head and the tail one element at a time. Every element must be covered
once, every wide tile must start 16-byte aligned, every tap must land in
the staged tile or its halo, and the outputs must equal ``lrn_reference``
and ``lrn_backward_reference`` bit for bit (f32 and bf16 round at the same
points). A stand-in for the C entries checks the arguments the wrappers
pass, as ``check_plan`` in ``lrn.cu`` does, and runs the walk on the memory
they point at.
"""

import ctypes
import importlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu_torch import ops  # noqa: E402

lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")

SOURCE = (Path(lr.__file__).parent / "csrc" / "lrn.cu").read_text()
K, ALPHA, BETA = 2.0, 1e-4, 0.75
CHANNELS = [1, 3, 8, 33, 96, 256, 4096, 4100, 16384]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"lrn.cu defines no {name}"
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    assert lr.TILE_THREADS == _constant("kThreads")
    assert lr.TILE_ELEMS == _constant("kElems")
    assert lr.FAST_N == _constant("kFastN")
    assert lr.VEC_BYTES == _constant("kVecBytes")
    m = re.search(r"constexpr float kFastBeta = ([0-9.]+)f;", SOURCE)
    assert m and float(m.group(1)) == lr.FAST_BETA


# (total, C, n, beta, itemsize, element offsets of the pointers) -> the plan
PINNED = [
    # AlexNet's LRN 1 and 2 rows, f32 and bf16, aligned: 16-byte vectors,
    # windows in registers
    ((1001 * 96, 96, 5, 0.75, 4, (0, 0, 0)), lr.Plan(4, 0, 2048, True, 47, 0)),
    ((1001 * 256, 256, 5, 0.75, 2, (0, 0)), lr.Plan(8, 0, 2048, True, 126, 0)),
    # another window or another beta: from shared memory
    ((1001 * 96, 96, 4, 0.75, 4, (0, 0, 0)), lr.Plan(4, 0, 2048, False, 47, 0)),
    ((1001 * 96, 96, 5, 0.5, 4, (0, 0, 0)), lr.Plan(4, 0, 2048, False, 47, 0)),
    # C not a multiple of the vector: vectors cross rows
    ((1001 * 33, 33, 5, 0.75, 2, (0, 0)), lr.Plan(8, 0, 2048, False, 17, 1)),
    ((1001 * 3, 3, 5, 0.75, 4, (0, 0, 0)), lr.Plan(4, 0, 2048, False, 2, 3)),
    # every pointer one element past 16 bytes: a head of 3 (f32) or 7 (bf16)
    ((1001 * 96, 96, 5, 0.75, 4, (1, 1, 1)), lr.Plan(4, 3, 2048, False, 47, 1)),
    ((1001 * 96, 96, 5, 0.75, 2, (1, 1, 1, 1)), lr.Plan(8, 7, 2048, False, 47, 1)),
    # pointers that disagree: one element an access
    ((1001 * 96, 96, 5, 0.75, 4, (1, 0)), lr.Plan(1, 0, 2048, False, 47, 0)),
    # fewer elements than the head
    ((2, 1, 5, 0.75, 4, (1, 1)), lr.Plan(4, 2, 2048, False, 0, 0)),
]


@pytest.mark.parametrize("args,want", PINNED)
def test_plan_is_pinned(args, want):
    total, C, n, beta, size, offs = args
    assert lr.plan(total, C, n, beta, size, [4096 + o * size for o in offs]) == want


def _at(a: torch.Tensor, off: int) -> torch.Tensor:
    """A copy of a whose first element lies ``off`` elements past a 16-byte
    boundary (the CPU allocator aligns storage to 64 bytes)."""
    buf = torch.empty(a.numel() + 16, dtype=a.dtype)
    base = (-(buf.data_ptr() % 16) // a.element_size()) % (16 // a.element_size())
    out = buf[base + off:base + off + a.numel()].view(a.shape)
    out.copy_(a)
    assert out.data_ptr() % 16 == off * a.element_size()
    return out


def _inputs(rows, C, dtype, seed, scale=30.0):
    g = torch.Generator().manual_seed(seed)
    return ((scale * torch.randn(rows, C, generator=g)).to(dtype),
            torch.randn(rows, C, generator=g).to(dtype))


def _consts(dtype):
    c = lambda v: float(lr._const(v, dtype))  # noqa: E731
    return {"k": c(K), "alpha": c(ALPHA), "neg_beta": c(-BETA),
            "neg_beta_m1": c(-BETA - 1.0), "two_ab": c(2.0 * ALPHA * BETA)}


def _ops(kind, ins, c):
    """(stage, finish) over element indices, rounded where the kernels round:
    the forward's x*x and d, the backward's t and dx. The powers of the
    backward's d are taken over the whole tensor at once, as the plain
    version takes them: torch's pow on the CPU can differ in the last bit
    with an element's place in a vector, and the walk tests the tiles."""
    if kind == "fwd":
        (x,) = ins
        return (lambda i: x[i] * x[i]), (lambda i, s: (c["k"] + c["alpha"] * s,))
    x, d, g = ins
    p1, p0 = d ** c["neg_beta_m1"], d ** c["neg_beta"]
    return ((lambda i: g[i] * x[i] * p1[i]),
            lambda i, s: (g[i] * p0[i] - c["two_ab"] * x[i] * s,))


def walk(kind, ins, C, n, p, consts, addrs=()):
    """The outputs of the kernels' walk of plan ``p`` over the flat inputs
    (x for the forward; x, d, g for the backward): (y, d) or (dx,). The
    forward's y is x * d^(-beta) of the walk's d, its power taken over the
    whole tensor."""
    dt = ins[0].dtype
    total = ins[0].numel()
    lo = n // 2 if kind == "fwd" else n - 1 - n // 2
    hl, hr = min(lo, C - 1), min(n - 1 - lo, C - 1)
    stage, finish = _ops(kind, ins, consts)
    outs = [torch.zeros(total, dtype=dt)]
    covered = torch.zeros(total, dtype=torch.int64)
    end = p.head + (total - p.head) // p.vec * p.vec

    def sums(staged, base, elems):
        """Window sums of the elements at global positions ``elems`` from the
        values staged for positions base, base + 1, ..."""
        c = elems % C
        s = torch.zeros(len(elems), dtype=dt)
        for j in range(n):
            ch = c - lo + j
            ok = (ch >= 0) & (ch < C)
            idx = elems - lo + j - base
            assert bool(((idx[ok] >= 0) & (idx[ok] < len(staged))).all()), "tap off the halo"
            s = torch.where(ok, s + staged[idx.clamp(0, len(staged) - 1)], s)
        return s

    for t in range(p.tiles):
        start = p.head + t * p.tile
        length = min(p.tile, end - start)
        assert length > 0 and length % p.vec == 0
        if p.vec > 1:
            assert all((a + start * ins[0].element_size()) % 16 == 0 for a in addrs)
        pos = torch.arange(start - hl, start + length + hr)
        inside = (pos >= 0) & (pos < total)
        staged = torch.zeros(len(pos), dtype=dt)
        staged[inside] = stage(pos[inside])
        elems = torch.arange(start, start + length)
        for o, v in zip(outs, finish(elems, sums(staged, start - hl, elems))):
            o[elems] = v
        covered[elems] += 1
    one = torch.tensor(list(range(p.head)) + list(range(end, total)), dtype=torch.long)
    assert len(one) == p.head + p.tail
    if len(one):  # head and tail: each window read from the whole tensor
        s = sums(stage(torch.arange(total)), 0, one)
        for o, v in zip(outs, finish(one, s)):
            o[one] = v
        covered[one] += 1
    assert bool((covered == 1).all()), "an element not covered exactly once"
    if kind == "fwd":
        return ins[0] * outs[0] ** consts["neg_beta"], outs[0]
    return outs


def _rows(C, dtype):
    """Rows for two and a half tiles and a ragged end."""
    return 5 * lr.TILE_THREADS * lr.TILE_ELEMS // (2 * C) + 3


@pytest.mark.parametrize("n", [1, 2, 4, 5])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("C", CHANNELS)
def test_tile_walk_equals_the_plain_versions(C, dtype, offset, n):
    dt = DTYPES[dtype]
    rows = _rows(C, dt)
    x, g = (_at(a, offset) for a in _inputs(rows, C, dt, seed=C + n))
    ry, rd = lr.lrn_reference(x, K, n, ALPHA, BETA)
    d = _at(rd, offset)
    rdx = lr.lrn_backward_reference(x, d, g, K, n, ALPHA, BETA)
    addrs = [x.data_ptr(), d.data_ptr(), g.data_ptr()]
    p = lr.plan(rows * C, C, n, BETA, x.element_size(), addrs)
    wide = 16 // x.element_size()
    assert p.vec == wide and p.head == (wide - offset) % wide
    assert p.tile == lr.TILE_THREADS * lr.TILE_ELEMS
    assert p.fast == (n == 5 and offset == 0 and C % wide == 0)
    flat = [t.reshape(-1) for t in (x, d, g)]
    y, dd = walk("fwd", flat[:1], C, n, p, _consts(dt), addrs)
    (dx,) = walk("bwd", flat, C, n, p, _consts(dt), addrs)
    assert torch.equal(y, ry.reshape(-1)) and torch.equal(dd, rd.reshape(-1))
    assert torch.equal(dx, rdx.reshape(-1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_narrow_walk_equals_the_plain_versions(dtype):
    """Pointers that disagree modulo 16 bytes: one element an access."""
    dt = DTYPES[dtype]
    C, n = 96, 5
    rows = _rows(C, dt)
    x, g = _inputs(rows, C, dt, seed=3)
    x, g = _at(x, 1), _at(g, 0)
    ry, rd = lr.lrn_reference(x, K, n, ALPHA, BETA)
    p = lr.plan(rows * C, C, n, BETA, x.element_size(), [x.data_ptr(), g.data_ptr()])
    assert (p.vec, p.head, p.tail, p.fast) == (1, 0, 0, False)
    flat = [t.reshape(-1) for t in (x, rd, g)]
    (dx,) = walk("bwd", flat, C, n, p, _consts(dt))
    assert torch.equal(dx, lr.lrn_backward_reference(x, rd, g, K, n, ALPHA, BETA).reshape(-1))


# --------------------------------------------- the C entries' arguments
def _c_entry(kind, calls):
    """A stand-in for dl4j_lrn_fwd (x, y, d; rows, C, n, bf16, vec, head,
    tile, fast; k, alpha, -beta) or dl4j_lrn_bwd (x, d, g, dx; the same
    ints; -beta, -beta-1, 2ab) over CPU memory: it checks the plan against
    the pointers and the powers' exponents as check_plan does, then writes
    the walk's outputs where the output pointers point."""
    n_ptrs = 3 if kind == "fwd" else 4

    def entry(*a):
        ptrs, ints, floats = a[:n_ptrs], a[n_ptrs:n_ptrs + 8], a[n_ptrs + 8:]
        rows, C, n, bf16, vec, head, tile, fast = ints
        dt = torch.bfloat16 if bf16 else torch.float32
        size, total = (2 if bf16 else 4), rows * C
        wide = 16 // size
        assert vec in (1, wide) and 0 <= head < vec and head <= total
        assert tile == lr.TILE_THREADS * lr.TILE_ELEMS
        powers = floats[2:3] if kind == "fwd" else floats[:2]
        assert not fast or (n == lr.FAST_N and vec == wide and head == 0 and C % vec == 0
                            and tuple(powers) == (-0.75, -1.75)[:len(powers)])
        for ptr in ptrs:
            assert ptr is None or (ptr % size == 0 and (
                (total - head) // vec == 0 or (ptr + head * size) % (vec * size) == 0))
        mem = [None if ptr is None else torch.frombuffer(
            (ctypes.c_char * (total * size)).from_address(ptr), dtype=dt) for ptr in ptrs]
        nvec = (total - head) // vec
        p = lr.Plan(vec, head, tile, bool(fast), -(-nvec * vec // tile), total - head - nvec * vec)
        if kind == "fwd":
            consts = dict(zip(("k", "alpha", "neg_beta"), floats))
            ins, outs = mem[:1], mem[1:]
        else:
            consts = dict(zip(("neg_beta", "neg_beta_m1", "two_ab"), floats))
            ins, outs = mem[:3], mem[3:]
        for o, v in zip(outs, walk(kind, ins, C, n, p, consts)):
            if o is not None:
                o.copy_(v)
        calls.append((kind, p))
        return 0

    return entry


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("layout", ["aligned", "offset1", "g_aligned"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_c_entry_arguments(monkeypatch, dtype, layout, n):
    """The wrappers' launches with a stand-in library: the arguments the C
    entries read, outputs allocated at x's alignment (so an offset view keeps
    16-byte accesses after a head), one launch counted a call, and outputs
    equal to the plain versions."""
    calls = []

    def bind(lib, symbol, n_ptrs, n_ints, n_floats):
        assert (lib, n_ints, n_floats) == ("lrn", 8, 3)
        return _c_entry({"dl4j_lrn_fwd": "fwd", "dl4j_lrn_bwd": "bwd"}[symbol], calls)

    def launch(counts, name, fn, device, *a):
        assert fn(*[t.data_ptr() if isinstance(t, torch.Tensor) else t for t in a]) == 0
        counts[name] += 1

    monkeypatch.setattr(lr._build, "bind", bind)
    monkeypatch.setattr(lr._build, "launch", launch)
    dt = DTYPES[dtype]
    x, g = _inputs(37, 96, dt, seed=7)
    x = _at(x, 0 if layout == "aligned" else 1)
    g = _at(g, 1 if layout == "offset1" else 0)
    before = ops.counters()
    y, d = lr._kernel_fwd(x, K, n, ALPHA, BETA, True)
    y_serving, none = lr._kernel_fwd(x, K, n, ALPHA, BETA, False)
    dx = lr._kernel_bwd(x, d, g, K, n, ALPHA, BETA)
    after = ops.counters()
    assert (after["lrn_fwd"] - before["lrn_fwd"], after["lrn_bwd"] - before["lrn_bwd"]) == (2, 1)
    assert none is None
    for t in (y, d, y_serving, dx):
        assert t.shape == x.shape and t.is_contiguous()
        assert t.data_ptr() % 16 == x.data_ptr() % 16
    ry, rd = lr.lrn_reference(x, K, n, ALPHA, BETA)
    assert torch.equal(y, ry) and torch.equal(y_serving, ry) and torch.equal(d, rd)
    # the plain backward on the same memory as the launch (its powers as the walk's)
    assert torch.equal(dx, lr.lrn_backward_reference(x, d, g, K, n, ALPHA, BETA))
    wide = 16 // x.element_size()
    head = 0 if layout == "aligned" else wide - 1
    assert [c[1].head for c in calls[:2]] == [head, head]
    assert calls[0][1].fast == (layout == "aligned" and n == 5)
    assert calls[2][1].vec == (1 if layout == "g_aligned" else wide)
