"""Per-step peephole LSTM cell: one step forward and its backward.

Port of ``fused_lstm_cell`` of ``deeplearning4j_tpu/ops/pallas_kernels.py``
(a custom VJP: forward ``_cell_fwd_impl`` over ``_cell_math``, backward
``_cell_bwd``). ``zx`` [B, 4H] is this step's hoisted ``x @ W + b``; gate
columns are [a, f, o, i]; the peepholes pF and pI see c_prev, pO sees c.

- :func:`lstm_cell_forward` launches row 1 (CUDA kernel ``csrc/lstm_cell.cu``,
  ``dl4j_lstm_cell_fwd``) and returns the seven [B, H] arrays the TPU kernel
  writes: (h, c, a, f, o, i, act(c)).
- :func:`lstm_cell_backward` launches row 2 (``dl4j_lstm_cell_bwd``) and
  returns (dzx [B, 4H], dh_prev, dc_prev, dRW [H, 4H], dpF, dpI, dpO), each in
  the dtype of ``dh``.
- :class:`LstmCellFunction` is the custom VJP: its forward runs row 1 and
  keeps the 12 residuals of ``_cell_fwd``, its backward runs row 2.
- :func:`fused_lstm_cell` is the op: (h, c), through the Function under grad,
  through row 1 alone otherwise.

Each wrapper launches its kernel for CUDA tensors and raises on anything it
does not take; for CPU tensors it runs the plain version
(:func:`lstm_cell_forward_reference`, :func:`lstm_cell_backward_reference`),
which ``chip_smoke.py`` holds the kernels against. The plain versions follow
the Pallas kernels as XLA runs them on the CPU: the tanh-form sigmoid,
products accumulated in at least f32 and rounded to the dtype, every
elementwise op in the dtype, and the peephole sums of products formed and
summed in at least f32 (``jnp.sum`` of a bf16 product) and rounded once.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _build
from .lstm_sequence import (_ACT_CODES, ACT, DACT, _acc_dtype, _cell, _check_tensors,
                            _drw_scratch, drw_product_reference)
from .lstm_sequence import launches as _seq_launches

# count of wrapper calls that launched the kernels (one step each; the
# backward is four launches of one C call, its dRW product also counted as
# lstm_sequence's "drw_product")
launches = {"lstm_cell_fwd": 0, "lstm_cell_bwd": 0}

# batch rows a block of the backward's gate kernel owns, and so the row block
# of its peephole partials (csrc/lstm.cuh: kRows)
CELL_ROW_BLOCK = 32

# (h, c, a, f, o, i, act(c)) of the forward
CellResult = Tuple[torch.Tensor, ...]
# (dzx, dh_prev, dc_prev, dRW, dpF, dpI, dpO) of the backward
CellGrads = Tuple[torch.Tensor, ...]


# ------------------------------------------------------------ plain versions
def lstm_cell_forward_reference(zx, h_prev, c_prev, RW, pF, pI, pO,
                                act: str = "tanh", gate: str = "sigmoid",
                                product: Optional[Callable] = None) -> CellResult:
    """Plain version of row 1 (``_fwd_kernel``): (h, c, a, f, o, i, act(c)),
    each contiguous, as the kernel writes them. ``product`` as
    ``lstm_sequence._cell`` takes it."""
    h, c, a, f, o, i = _cell(zx, h_prev, c_prev, RW, pF, pI, pO, ACT[act], ACT[gate],
                             product)
    return tuple(t.contiguous() for t in (h, c, a, f, o, i, ACT[act](c)))


def lstm_cell_backward_reference(a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO,
                                 dh, dc, act: str = "tanh", gate: str = "sigmoid",
                                 drw: Optional[Callable] = None) -> CellGrads:
    """Plain version of row 2 (``_bwd_kernel``) from the residuals of
    ``_cell_fwd`` (a, f, o, i, act(c), c_prev, c, h_prev, RW, pF, pI, pO) and
    the upstream (dh, dc): (dzx, dh_prev, dc_prev, dRW, dpF, dpI, dpO) in
    dh's dtype. ``drw(h0, ys, dzx)`` forms dRW as
    ``lstm_sequence_masked_backward_reference`` takes it, over one step
    (default ``drw_product_reference``)."""
    dact, dgate = DACT[act], DACT[gate]
    dt = dh.dtype
    acc = _acc_dtype(dt)
    d_o = dh * cact * dgate(o)
    dc_tot = dc + dh * o * dact(cact) + d_o * pO
    d_f = dc_tot * c_prev * dgate(f)
    d_i = dc_tot * a * dgate(i)
    d_a = dc_tot * i * dact(a)
    dzx = torch.cat([d_a, d_f, d_o, d_i], dim=-1)
    dc_prev = dc_tot * f + d_f * pF + d_i * pI
    dh_prev = torch.matmul(dzx.to(acc), RW.to(acc).t()).to(dt)
    dRW = (drw or drw_product_reference)(h_prev, h_prev[None], dzx[None])
    # XLA on the CPU forms these products in f32 for the f32 sum of a bf16
    # jnp.sum (excess precision): the product is not rounded to the dtype
    dps = tuple((x.to(acc) * y.to(acc)).sum(0).to(dt)
                for x, y in ((d_f, c_prev), (d_i, c_prev), (d_o, c)))
    return (dzx, dh_prev, dc_prev, dRW) + dps


# ------------------------------------------------------------------ kernels
def _launch_forward(zx, h_prev, c_prev, RW, pF, pI, pO, act, gate) -> CellResult:
    if zx.dim() != 2 or zx.shape[1] % 4:
        raise ValueError(f"zx must be [B, 4H], got {tuple(zx.shape)}")
    B, H4 = zx.shape
    H = H4 // 4
    state = (B, H)
    _check_tensors("zx", {"zx": (zx, (B, H4)), "h_prev": (h_prev, state),
                          "c_prev": (c_prev, state), "RW": (RW, (H, H4)),
                          "pF": (pF, (H,)), "pI": (pI, (H,)), "pO": (pO, (H,))},
                   act, gate)
    outs = tuple(zx.new_empty(state) for _ in range(7))
    if B == 0 or H == 0:
        return outs
    fn = _build.bind("lstm_cell", "dl4j_lstm_cell_fwd", 14, 5)
    _build.launch(launches, "lstm_cell_fwd", fn, zx.device, zx, h_prev, c_prev, RW,
                  pF, pI, pO, *outs, B, H, _ACT_CODES[act], _ACT_CODES[gate],
                  int(zx.dtype == torch.bfloat16))
    return outs


def _launch_backward(a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO, dh, dc,
                     act, gate) -> CellGrads:
    if dh.dim() != 2:
        raise ValueError(f"dh must be [B, H], got {tuple(dh.shape)}")
    B, H = dh.shape
    state = (B, H)
    named = {"dh": dh, "dc": dc, "a": a, "f": f, "o": o, "i": i, "cact": cact,
             "c_prev": c_prev, "c": c, "h_prev": h_prev}
    tensors = {n: (t, state) for n, t in named.items()}
    tensors.update({"RW": (RW, (H, 4 * H)), "pF": (pF, (H,)), "pI": (pI, (H,)),
                    "pO": (pO, (H,))})
    _check_tensors("dh", tensors, act, gate)
    dzx = dh.new_empty((B, 4 * H))
    dh_prev, dc_prev = dh.new_empty(state), dh.new_empty(state)
    dRW = dh.new_zeros((H, 4 * H)) if B == 0 else dh.new_empty((H, 4 * H))
    dps = tuple(dh.new_zeros((H,)) if B == 0 else dh.new_empty((H,)) for _ in range(3))
    grads = (dzx, dh_prev, dc_prev, dRW) + dps
    if B == 0 or H == 0:
        return grads
    slices, drw_part = _drw_scratch(B, H, dh.device)
    psum = torch.empty((-(-B // CELL_ROW_BLOCK) * 3 * H,), dtype=torch.float32,
                       device=dh.device)
    fn = _build.bind("lstm_cell", "dl4j_lstm_cell_bwd", 23, 6)
    _build.launch(launches, "lstm_cell_bwd", fn, dh.device, a, f, o, i, cact, c_prev, c,
                  h_prev, RW, pF, pI, pO, dh, dc, *grads, drw_part, psum, B, H,
                  _ACT_CODES[act], _ACT_CODES[gate], slices, int(dh.dtype == torch.bfloat16))
    _build.count(_seq_launches, "drw_product")  # the C entry launched the dRW product too
    return grads


def lstm_cell_forward(zx, h_prev, c_prev, RW, pF, pI, pO, act: str = "tanh",
                      gate: str = "sigmoid") -> CellResult:
    """One step, ``zx`` [B, 4H] -> (h, c, a, f, o, i, act(c)) [B, H] each.
    CUDA tensors run row 1; CPU tensors the plain version."""
    fn = _launch_forward if zx.is_cuda else lstm_cell_forward_reference
    return fn(zx, h_prev, c_prev, RW, pF, pI, pO, act, gate)


def lstm_cell_backward(a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO, dh, dc,
                       act: str = "tanh", gate: str = "sigmoid") -> CellGrads:
    """One step's backward from the forward's residuals and (dh, dc):
    (dzx, dh_prev, dc_prev, dRW, dpF, dpI, dpO). CUDA tensors run row 2; CPU
    tensors the plain version."""
    fn = _launch_backward if dh.is_cuda else lstm_cell_backward_reference
    return fn(a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO, dh, dc, act, gate)


class LstmCellFunction(torch.autograd.Function):
    """The cell under autograd, over (zx, h_prev, c_prev, RW, pF, pI, pO);
    ``act``/``gate`` are names and take no gradient. Outputs (h, c). Its
    forward keeps ``_cell_fwd``'s 12 residuals; a gradient of None for h or c
    is taken as zeros."""

    @staticmethod
    def forward(ctx, zx, h_prev, c_prev, RW, pF, pI, pO, act, gate):
        h, c, a, f, o, i, cact = lstm_cell_forward(zx, h_prev, c_prev, RW, pF, pI, pO,
                                                   act, gate)
        ctx.act, ctx.gate = act, gate
        ctx.save_for_backward(a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO)
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        res = ctx.saved_tensors
        c_prev = res[5]
        dh, dc = (torch.zeros_like(c_prev) if g is None else g.contiguous()
                  for g in (dh, dc))
        return lstm_cell_backward(*res, dh, dc, ctx.act, ctx.gate) + (None, None)


def fused_lstm_cell(zx, h_prev, c_prev, RW, pF, pI, pO, act: str = "tanh",
                    gate: str = "sigmoid") -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step -> (h, c): :class:`LstmCellFunction` when an input needs
    a gradient under grad mode, row 1 alone otherwise (all seven outputs are
    written either way, as the TPU kernel writes them)."""
    tensors = (zx, h_prev, c_prev, RW, pF, pI, pO)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return LstmCellFunction.apply(*tensors, act, gate)
    h, c, *_ = lstm_cell_forward(*tensors, act, gate)
    return h, c
