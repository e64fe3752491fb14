"""Cross-channel local response normalization with its gradient.

Port of ``deeplearning4j_tpu/ops/pallas_kernels.py:fused_lrn``: over the
trailing (channel) axis of x,

    d = k + alpha * sum_{j in W(c)} x_j^2,   y = x * d^(-beta),

with the window W(c) = [c - n//2, c + n - 1 - n//2] (``_window_sum``), and
the custom VJP of ``_lrn_bwd``,

    dx = g * d^(-beta) - 2*alpha*beta * x * sum_{j: c in W(j)} g_j x_j d_j^(-beta-1),

whose window is W reflected (``_window_sum_adjoint``; one channel off for
even n). Everything is computed in x's dtype, as the Pallas kernel does:
in bf16 every operation rounds to bf16, and the Python constants round to
x's dtype first, as JAX's weakly typed scalars do.

For CUDA tensors the forward and the backward launch the hand-written
kernels of ``csrc/lrn.cu`` (float32 or bfloat16, at most 16384 channels) and
raise on anything they do not take: ``TypeError`` on the dtype,
``ValueError`` on the shape, the device or the layout. The serving forward
(no gradient wanted) writes y alone; the training forward also writes d,
which the backward reads. Each launch follows :func:`plan`: 16-byte
accesses from the first element at which every pointer is 16-byte aligned,
the elements before it (the head) and the ragged tail one at a time. The
outputs are allocated at x's alignment modulo 16 bytes, so a view of x at
any element offset keeps the 16-byte accesses. For CPU tensors they run
the plain versions, :func:`lrn_reference` and :func:`lrn_backward_reference`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

# count of wrapper calls that launched each kernel (one launch each)
launches = {"lrn_fwd": 0, "lrn_bwd": 0}

MAX_CHANNELS = 16384  # the widest channel axis the kernels are held to on the card
_DTYPES = (torch.float32, torch.bfloat16)

# the tile of csrc/lrn.cu: TILE_THREADS threads a block (kThreads), each
# holding TILE_ELEMS elements (kElems) of each input; windows of
# FAST_N (kFastN) channels under beta FAST_BETA (kFastBeta) are summed in
# registers, with powers whose exponents the compiler knows
TILE_THREADS, TILE_ELEMS, FAST_N, FAST_BETA = 256, 8, 5, 0.75
VEC_BYTES = 16


class Plan(NamedTuple):
    """How one launch walks rows*C elements (the C entries check it)."""

    vec: int    # elements an access: 16 bytes of them, or 1 where pointers disagree
    head: int   # elements before the first vector, taken one at a time
    tile: int   # elements a tile: TILE_THREADS * TILE_ELEMS
    fast: bool  # windows in registers: n, beta == FAST_N, FAST_BETA, every vector in a row
    tiles: int  # tiles over the vectors (the last may be short)
    tail: int   # elements after the last vector, taken one at a time


def plan(total: int, C: int, n: int, beta: float, itemsize: int,
         addrs: Sequence[int]) -> Plan:
    """The launch plan of ``total`` elements of ``C`` channels, window ``n``
    and power ``beta``, whose tensors start at ``addrs`` (bytes, each a
    multiple of ``itemsize``). Where every address lies the same number of
    elements past a 16-byte boundary, the vectors are 16 bytes and start at
    the head, the first element 16-byte aligned in all of them; else they
    are one element (the narrow plan)."""
    wide = VEC_BYTES // itemsize
    offsets = {(a % VEC_BYTES) // itemsize for a in addrs}
    vec = wide if len(offsets) == 1 else 1
    head = min(-offsets.pop() % wide, total) if vec > 1 else 0
    nvec = (total - head) // vec
    tile = TILE_THREADS * TILE_ELEMS
    fast = n == FAST_N and beta == FAST_BETA and vec > 1 and head == 0 and C % vec == 0
    return Plan(vec, head, tile, fast, -(-nvec * vec // tile), total - head - nvec * vec)


def _empty_at(x: torch.Tensor) -> torch.Tensor:
    """An uninitialized contiguous tensor of x's shape and dtype whose address
    lies as far past a 16-byte boundary as x's (on the card, where fresh
    storage starts aligned), so the kernels take 16-byte accesses for both."""
    off = (x.data_ptr() % VEC_BYTES) // x.element_size()
    if off == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    return torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[off:].view(x.shape)


def _const(v: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python constant as a 0-d tensor of ``dtype``: rounded to it, as JAX
    rounds a weakly typed scalar to the array's dtype."""
    return torch.tensor(v, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``float(_const(v, dtype))``, kept: a kernel's launch makes no tensor
    for its constants."""
    return float(_const(v, dtype))


def _window_sum(x: torch.Tensor, n: int, lo: int) -> torch.Tensor:
    """sum_{j < n} x[..., c - lo + j], zero outside [0, C): the pad-and-add
    loop of the JAX package's window sums, adding in the same order."""
    C = x.shape[-1]
    padded = F.pad(x, (lo, n - 1 - lo))
    acc = torch.zeros_like(x)
    for j in range(n):
        acc = acc + padded[..., j:j + C]
    return acc


# ------------------------------------------------------------ plain versions
def lrn_reference(x: torch.Tensor, k: float = 2.0, n: int = 5, alpha: float = 1e-4,
                  beta: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward (``_lrn_fwd_kernel``): (y, d) in x's
    dtype and shape, over the trailing axis."""
    dt = x.dtype
    d = _const(k, dt) + _const(alpha, dt) * _window_sum(x * x, n, n // 2)
    return x * d ** float(_const(-beta, dt)), d


def lrn_backward_reference(x: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                           k: float = 2.0, n: int = 5, alpha: float = 1e-4,
                           beta: float = 0.75) -> torch.Tensor:
    """Plain version of the backward (``_lrn_bwd_kernel``): dx in x's dtype
    from x, the forward's d and the output gradient g."""
    dt = x.dtype
    t = g * x * d ** float(_const(-beta - 1.0, dt))
    return (g * d ** float(_const(-beta, dt))
            - _const(2.0 * alpha * beta, dt) * x * _window_sum(t, n, n - 1 - n // 2))


# ------------------------------------------------------------------ kernels
def _check(x: torch.Tensor, n: int, **others: torch.Tensor) -> Tuple[int, int]:
    """(rows, C) of x taken as [rows, C]; raises on what the kernels do not
    take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the CUDA LRN kernels take float32 or bfloat16, not {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must have a non-empty trailing (channel) axis, got "
                         f"{tuple(x.shape)}")
    C = x.shape[-1]
    if C > MAX_CHANNELS:
        raise ValueError(f"the CUDA LRN kernels take at most {MAX_CHANNELS} channels, "
                         f"got {C}")
    if n < 1:
        raise ValueError(f"the window n must be at least 1, got {n}")
    rows = x.numel() // C
    if rows * C >= 2 ** 31:
        raise ValueError(f"x of {x.numel()} elements is too large for the LRN kernels")
    for name, t in (("x", x), *others.items()):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, x is {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (channels innermost)")
    return rows, C


def _plan_args(rows: int, C: int, n: int, beta: float, tensors) -> tuple:
    """The plan of tensors [rows, C] as the C entries take it: bf16, vec,
    head, tile, fast."""
    x = tensors[0]
    p = plan(rows * C, C, n, beta, x.element_size(), [t.data_ptr() for t in tensors])
    return int(x.dtype == torch.bfloat16), p.vec, p.head, p.tile, int(p.fast)


def _kernel_fwd(x, k, n, alpha, beta, with_d: bool):
    rows, C = _check(x, n)
    y = _empty_at(x)
    d = _empty_at(x) if with_d else None
    if rows == 0:
        return y, d
    dt = x.dtype
    fn = _build.bind("lrn", "dl4j_lrn_fwd", 3, 8, 3)
    _build.launch(launches, "lrn_fwd", fn, x.device, x, y, d, rows, C, n,
                  *_plan_args(rows, C, n, beta, [t for t in (x, y, d) if t is not None]),
                  _rounded(k, dt), _rounded(alpha, dt), _rounded(-beta, dt))
    return y, d


def _kernel_bwd(x, d, g, k, n, alpha, beta):
    rows, C = _check(x, n, d=d, g=g)
    dx = _empty_at(x)
    if rows == 0:
        return dx
    dt = x.dtype
    fn = _build.bind("lrn", "dl4j_lrn_bwd", 4, 8, 3)
    _build.launch(launches, "lrn_bwd", fn, x.device, x, d, g, dx, rows, C, n,
                  *_plan_args(rows, C, n, beta, [x, d, g, dx]), _rounded(-beta, dt),
                  _rounded(-beta - 1.0, dt), _rounded(2.0 * alpha * beta, dt))
    return dx


def lrn_forward(x: torch.Tensor, k: float = 2.0, n: int = 5, alpha: float = 1e-4,
                beta: float = 0.75, with_d: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, d) of x over its trailing axis: the kernel for CUDA tensors (d is
    None when ``with_d`` is False, the serving forward, which writes y
    alone), the plain version for CPU tensors."""
    if x.is_cuda:
        return _kernel_fwd(x, k, n, alpha, beta, with_d)
    y, d = lrn_reference(x, k, n, alpha, beta)
    return y, (d if with_d else None)


def lrn_backward(x: torch.Tensor, d: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                 n: int = 5, alpha: float = 1e-4, beta: float = 0.75) -> torch.Tensor:
    """dx from x, d and g: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return _kernel_bwd(x, d, g, k, n, alpha, beta)
    return lrn_backward_reference(x, d, g, k, n, alpha, beta)


class LrnFunction(torch.autograd.Function):
    """LRN of x under autograd: the training forward stores x and d, the
    backward takes the output gradient as the kernel wants it
    (contiguous, x's dtype)."""

    @staticmethod
    def forward(ctx, x, k, n, alpha, beta):
        y, d = lrn_forward(x, k, n, alpha, beta)
        ctx.save_for_backward(x, d)
        ctx.hyper = (k, n, alpha, beta)
        return y

    @staticmethod
    def backward(ctx, g):
        x, d = ctx.saved_tensors
        return (lrn_backward(x, d, g.contiguous(), *ctx.hyper), None, None, None, None)


def fused_lrn(x: torch.Tensor, k: float = 2.0, n: int = 5, alpha: float = 1e-4,
              beta: float = 0.75) -> torch.Tensor:
    """Cross-channel LRN over the trailing axis, differentiable in x. Without
    a gradient to take (``torch.no_grad()`` or an x that does not require
    one) it runs the serving forward, which does not write d."""
    if torch.is_grad_enabled() and x.requires_grad:
        return LrnFunction.apply(x, k, n, alpha, beta)
    return lrn_forward(x, k, n, alpha, beta, with_d=False)[0]
