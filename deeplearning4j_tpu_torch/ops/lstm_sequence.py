"""Whole-sequence peephole LSTM: inference primal, training forward and
backward, unmasked and masked.

Port of the Pallas sequence kernels of
``deeplearning4j_tpu/ops/pallas_kernels.py``: ``zx`` [T, B, 4H] is the
hoisted ``x @ W + b``; the op runs the recurrence and returns
``(ys [T, B, H], h_T, c_T)``. Gate columns are [a, f, o, i]; the peepholes
pF and pI see c_{t-1}, pO sees c_t. With a ``mask`` [T, B, 1], a step whose
mask is 0 holds h/c.

- :func:`fused_lstm_sequence` and :func:`fused_lstm_sequence_masked` are the
  lean primal (``_seq_lean_impl``): CUDA kernel ``csrc/lstm_seq.cu``.
- :func:`drw_product` is the backward's dRW product alone (``dl4j_drw_product``,
  the kernel ``csrc/lstm_drw.cuh``'s ``drw_mma`` that rows 2, 7 and 9 run
  inside their backward), for timing and holding it alone.
- :class:`LstmSequenceFunction` is the custom VJP of both
  ``fused_lstm_sequence`` (``_seq_fwd``/``_seq_bwd``) and
  ``fused_lstm_sequence_masked`` (``_seq_masked_fwd``/``_seq_masked_bwd``):
  under grad its forward runs the training forward (``_seq_fwd_impl`` or
  ``_seq_masked_fwd_impl``, residual-storing instantiations of the same
  kernel), and its backward the reverse-time kernel ``csrc/lstm_seq_bwd.cu``
  (``_seq_bwd``, or its masked instantiation for ``_seq_masked_bwd``).
  :func:`lstm_sequence_apply` is the entry the layers call and the one place
  that picks what runs: the Function under grad, the lean primal otherwise.

Every wrapper launches its kernel for CUDA tensors and raises on anything it
does not take. For CPU tensors it runs the plain version
(:func:`lstm_sequence_reference`, :func:`lstm_sequence_masked_reference`,
:func:`lstm_sequence_train_reference`,
:func:`lstm_sequence_masked_train_reference`,
:func:`lstm_sequence_backward_reference`,
:func:`lstm_sequence_masked_backward_reference`, :func:`drw_product_reference`),
which does the same math as a loop over t and is what ``chip_smoke.py`` holds
the kernel against.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from . import _build

# count of wrapper calls that launched the kernel (each call runs T steps)
launches = {"lstm_seq_lean": 0, "lstm_seq_lean_masked": 0,
            "lstm_seq_train_fwd": 0, "lstm_seq_bwd": 0,
            "lstm_seq_masked_train_fwd": 0, "lstm_seq_masked_bwd": 0,
            # the dRW product: one launch in each sequence or cell backward
            # call (ops/lstm_cell.py counts the cell's here), or alone
            "drw_product": 0}


# batch rows a block of the backward's step kernel owns, and so the row block
# of its per-step peephole partials (csrc/lstm_seq_bwd.cu: kBwdRows)
BWD_ROW_BLOCK = 16

# the dRW product's block tile, hidden units x gate columns of dRW
# (csrc/lstm_drw.cuh: kDrwM, kDrwN), and how R is split: into as many
# slices as keep about DRW_BLOCKS blocks busy (the H100's 132 SMs each take
# one), each of at least DRW_SLICE_ROWS rows
DRW_TILE = (128, 128)
DRW_BLOCKS = 128
DRW_SLICE_ROWS = 1024


def drw_slices(R: int, H: int) -> int:
    """Slices of the dRW product's R rows for H units: 1 unless the
    output tiles leave blocks free and R is long enough to share."""
    tiles = -(-H // DRW_TILE[0]) * -(-4 * H // DRW_TILE[1])
    return max(1, min(DRW_BLOCKS // tiles, R // DRW_SLICE_ROWS))


def _drw_scratch(R: int, H: int, device) -> Tuple[int, torch.Tensor]:
    """(slices, the f32 scratch of their partials [slices, H, 4H]; empty,
    a null pointer, for one slice)."""
    slices = drw_slices(R, H)
    n = slices * H * 4 * H if slices > 1 else 0
    return slices, torch.empty((n,), dtype=torch.float32, device=device)


def _sigmoid_tanh_form(x):
    """sigmoid as 0.5 * (tanh(x / 2) + 1), the form the Pallas kernels use;
    it saturates to exactly 0/1 where torch.sigmoid keeps tiny values."""
    return 0.5 * (torch.tanh(0.5 * x) + 1.0)


def _hard_sigmoid(x):
    """clip(0.2 * x + 0.5, 0, 1) with 0.2 in x's dtype, as JAX rounds a
    Python constant to a bf16 array's dtype (torch would multiply by the f32
    0.2 and round once)."""
    return torch.clamp(torch.tensor(0.2, dtype=x.dtype) * x + 0.5, 0.0, 1.0)


# the activations the kernel takes (pallas_kernels._ACT_KERNEL), with the
# codes of csrc/common.cuh's Act enum
ACT = {
    "tanh": torch.tanh,
    "sigmoid": _sigmoid_tanh_form,
    "hardsigmoid": _hard_sigmoid,
    "relu": torch.relu,
    "identity": lambda x: x,
}
_ACT_CODES = {"tanh": 0, "sigmoid": 1, "hardsigmoid": 2, "relu": 3,
              "identity": 4}
# derivatives from the activated value y (pallas_kernels._ACT), in y's dtype
DACT = {
    "tanh": lambda y: 1.0 - y * y,
    "sigmoid": lambda y: y * (1.0 - y),
    "hardsigmoid": lambda y: ((y > 0.0) & (y < 1.0)).to(y.dtype) * 0.2,
    "relu": lambda y: (y > 0.0).to(y.dtype),
    "identity": torch.ones_like,
}

Activation = Union[str, Callable[[torch.Tensor], torch.Tensor]]
Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# (ys, a, f, o, i, c, h_T, c_T) of the training forward
TrainResult = Tuple[torch.Tensor, ...]
# (dzx, dh0, dc0, dRW, dpF, dpI, dpO) of the backward
Grads = Tuple[torch.Tensor, ...]


def supported_lstm_activations(act: str, gate: str) -> bool:
    return act in ACT and gate in ACT


# ------------------------------------------------------------ plain versions
def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Product accumulator (pallas_kernels._acc_dtype): at least f32, never
    below the input dtype."""
    return torch.float32 if dt.itemsize < 4 else dt


def _cell(zx, h_prev, c_prev, RW, pF, pI, pO, act, gate,
          product: Optional[Callable] = None):
    """One step of _cell_math: the recurrent product accumulates in at least
    f32 and is rounded to the storage dtype before the add. ``product(h,
    RW)`` forms it in the accumulator dtype (default ``torch.matmul``;
    ``chip_smoke.py`` passes wrong ones the limits must catch). Returns
    (h, c, a, f, o, i)."""
    H = c_prev.shape[-1]
    acc = _acc_dtype(zx.dtype)
    z = zx + (product or torch.matmul)(h_prev.to(acc), RW.to(acc)).to(zx.dtype)
    a = act(z[..., :H])
    f = gate(z[..., H:2 * H] + c_prev * pF)
    i = gate(z[..., 3 * H:] + c_prev * pI)
    c = f * c_prev + i * a
    o = gate(z[..., 2 * H:3 * H] + c * pO)
    return o * act(c), c, a, f, o, i


def _hold(mask, t, new, old):
    """A masked step holds the state: m*new + (1-m)*old (``mask`` None: new)."""
    if mask is None:
        return new
    m = mask[t]
    return m * new + (1.0 - m) * old


def lstm_sequence_masked_reference(zx, mask, h0, c0, RW, pF, pI, pO,
                                   act: Activation = "tanh",
                                   gate: Activation = "sigmoid",
                                   product: Optional[Callable] = None) -> Result:
    """Plain version of the masked kernel (``mask`` [T, B, 1], or None for
    the unmasked one): a masked step holds h/c. ``act``/``gate`` are names
    of :data:`ACT` or callables; ``product`` as :func:`_cell` takes it."""
    act_fn = ACT[act] if isinstance(act, str) else act
    gate_fn = ACT[gate] if isinstance(gate, str) else gate
    h, c = h0, c0
    ys = []
    for t in range(zx.shape[0]):
        h_new, c_new, *_ = _cell(zx[t], h, c, RW, pF, pI, pO, act_fn, gate_fn,
                                 product)
        h, c = _hold(mask, t, h_new, h), _hold(mask, t, c_new, c)
        ys.append(h)
    ys = torch.stack(ys) if ys else zx.new_empty((0,) + tuple(h0.shape))
    return ys, h, c


def lstm_sequence_reference(zx, h0, c0, RW, pF, pI, pO,
                            act: Activation = "tanh",
                            gate: Activation = "sigmoid") -> Result:
    """Plain version of the unmasked kernel."""
    return lstm_sequence_masked_reference(zx, None, h0, c0, RW, pF, pI, pO,
                                          act, gate)


def lstm_sequence_masked_train_reference(zx, mask, h0, c0, RW, pF, pI, pO,
                                         act: str = "tanh",
                                         gate: str = "sigmoid") -> TrainResult:
    """Plain version of the masked training forward
    (``_seq_fwd_kernel_masked``; ``mask`` None for ``_seq_fwd_kernel``): the
    recurrence, also returning the residuals a, f, o, i and c [T, B, H]; a, f,
    o, i as computed at every step, c (like ys) after the mask. Returns (ys,
    a, f, o, i, c, h_T, c_T)."""
    T, B, _ = zx.shape
    H = h0.shape[-1]
    if T == 0:
        empty = zx.new_empty((0, B, H))
        return (empty,) * 6 + (h0, c0)
    h, c = h0, c0
    streams = [[] for _ in range(6)]  # ys a f o i c
    for t in range(T):
        h_new, c_new, a, f, o, i = _cell(zx[t], h, c, RW, pF, pI, pO, ACT[act],
                                         ACT[gate])
        h, c = _hold(mask, t, h_new, h), _hold(mask, t, c_new, c)
        for s, v in zip(streams, (h, a, f, o, i, c)):
            s.append(v)
    return tuple(torch.stack(s) for s in streams) + (h, c)


def lstm_sequence_train_reference(zx, h0, c0, RW, pF, pI, pO,
                                  act: str = "tanh",
                                  gate: str = "sigmoid") -> TrainResult:
    """Plain version of the unmasked training forward (``_seq_fwd_kernel``)."""
    return lstm_sequence_masked_train_reference(zx, None, h0, c0, RW, pF, pI,
                                                pO, act, gate)


def lstm_sequence_masked_backward_reference(dys, dhT, dcT, mask, ys, a, f, o,
                                            i, c, h0, c0, RW, pF, pI, pO,
                                            act: str = "tanh",
                                            gate: str = "sigmoid",
                                            product: Optional[Callable] = None,
                                            drw: Optional[Callable] = None) -> Grads:
    """Plain version of the masked backward (``_seq_bwd_kernel_masked``;
    ``mask`` None for ``_seq_bwd_kernel``), an explicit reverse loop at the
    kernel's rounding points: c and act(c) recomputed from the gates (the
    pre-mask c); ``dh`` rounded to the dtype after the product accumulated in
    at least f32; dRW and the peephole sums accumulated in at least f32 and
    rounded at the end. Masked, the gate math takes m*dh and m*dc, and
    (1-m)*dh and (1-m)*dc pass through to the step before. ``product(dz,
    RWt)`` forms the recurrent product in the accumulator dtype (default
    ``torch.matmul``; ``chip_smoke.py`` passes wrong ones the limits must
    catch); ``drw(h0, ys, dzx)`` forms dRW from the stacked dzx (default
    :func:`drw_product_reference`, the sum step by step; wrong ones too).
    Returns (dzx, dh0, dc0, dRW, dpF, dpI, dpO)."""
    act_fn, dact = ACT[act], DACT[act]
    dgate = DACT[gate]
    product = product or torch.matmul
    dt = ys.dtype
    acc = _acc_dtype(dt)
    T, B, H = ys.shape
    RWt = RW.to(acc).t()
    dp = [torch.zeros(pF.shape, dtype=acc, device=pF.device) for _ in range(3)]
    dzx = []
    dh_carry, dc_carry = dhT, dcT
    for t in reversed(range(T)):
        c_prev = c0 if t == 0 else c[t - 1]
        h_prev = h0 if t == 0 else ys[t - 1]
        ct = f[t] * c_prev + i[t] * a[t]
        cact = act_fn(ct)
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
        dh_carry = product(dz.to(acc), RWt).to(dt)
        dc_carry = dc_tot * f[t] + d_f * pF + d_i * pI
        if mask is not None:
            keep = 1.0 - mask[t]
            dh_carry = dh_carry + keep * dh_t
            dc_carry = dc_carry + keep * dc_t
        for s, term in zip(dp, (d_f * c_prev, d_i * c_prev, d_o * ct)):
            s += term.to(acc).sum(0)
    dzx = torch.stack(dzx[::-1]) if dzx else ys.new_zeros((T, B, 4 * H))
    dRW = (drw or drw_product_reference)(h0, ys, dzx)
    return (dzx, dh_carry, dc_carry, dRW) + tuple(s.to(dt) for s in dp)


def drw_product_reference(h0, ys, dzx):
    """Plain version of the dRW product: sum over t of h_prev^T dzx[t]
    (h_prev = h0 at t = 0, else ys[t-1]; ``dzx`` [T, B, 4H], ``ys``
    [T, B, H]), one step at a time from t = T-1 down as the reference
    backward sums it, in at least f32, rounded to dzx's dtype."""
    dt = dzx.dtype
    acc = _acc_dtype(dt)
    dRW = torch.zeros((h0.shape[-1], dzx.shape[-1]), dtype=acc, device=dzx.device)
    for t in reversed(range(dzx.shape[0])):
        h_prev = h0 if t == 0 else ys[t - 1]
        dRW += torch.matmul(h_prev.to(acc).t(), dzx[t].to(acc))
    return dRW.to(dt)


def lstm_sequence_backward_reference(dys, dhT, dcT, ys, a, f, o, i, c, h0, c0,
                                     RW, pF, pI, pO, act: str = "tanh",
                                     gate: str = "sigmoid") -> Grads:
    """Plain version of the unmasked backward (``_seq_bwd_kernel``)."""
    return lstm_sequence_masked_backward_reference(
        dys, dhT, dcT, None, ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO, act, gate)


# ------------------------------------------------------------------ kernel
def _check_tensors(lead: str, tensors: dict, act: str = "tanh",
                   gate: str = "sigmoid") -> None:
    """Raise on what the kernels do not take. ``tensors`` maps each name to
    (tensor, expected shape); all must be contiguous and share the dtype and
    device of the ``lead`` tensor."""
    if act not in _ACT_CODES or gate not in _ACT_CODES:
        raise NotImplementedError(
            f"the CUDA LSTM kernels take activations "
            f"{sorted(_ACT_CODES)}; got act={act!r}, gate={gate!r}")
    ref = tensors[lead][0]
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA LSTM kernels take float32 or "
                        f"bfloat16, not {ref.dtype}")
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {lead} on {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, {lead} is {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(zx, mask, h0, c0, RW, pF, pI, pO, act, gate) -> None:
    if zx.dim() != 3 or zx.shape[2] % 4:
        raise ValueError(f"zx must be [T, B, 4H], got {tuple(zx.shape)}")
    T, B, H4 = zx.shape
    H = H4 // 4
    tensors = {"zx": (zx, (T, B, H4)), "h0": (h0, (B, H)), "c0": (c0, (B, H)),
               "RW": (RW, (H, H4)), "pF": (pF, (H,)), "pI": (pI, (H,)),
               "pO": (pO, (H,))}
    if mask is not None:
        tensors["mask"] = (mask, (T, B, 1))
    _check_tensors("zx", tensors, act, gate)


def _launch(name, zx, mask, h0, c0, RW, pF, pI, pO, act, gate) -> Result:
    _check(zx, mask, h0, c0, RW, pF, pI, pO, act, gate)
    T, B, H4 = zx.shape
    H = H4 // 4
    if T == 0:
        return zx.new_empty((0, B, H)), h0.clone(), c0.clone()
    ys, hT, cT = (zx.new_empty(s) for s in ((T, B, H), (B, H), (B, H)))
    cbuf = zx.new_empty((2, B, H))
    fn = _build.bind("lstm_seq", "dl4j_lstm_seq_lean", 12, 6)
    _build.launch(launches, name, fn, zx.device, zx, mask, h0, c0, RW, pF, pI,
                  pO, ys, hT, cT, cbuf, T, B, H, _ACT_CODES[act],
                  _ACT_CODES[gate], int(zx.dtype == torch.bfloat16))
    return ys, hT, cT


def _launch_train_fwd(zx, mask, h0, c0, RW, pF, pI, pO, act, gate) -> TrainResult:
    _check(zx, mask, h0, c0, RW, pF, pI, pO, act, gate)
    T, B, H4 = zx.shape
    H = H4 // 4
    if T == 0:
        empty = zx.new_empty((0, B, H))
        return (empty,) * 6 + (h0.clone(), c0.clone())
    ys, a, f, o, i, c = (zx.new_empty((T, B, H)) for _ in range(6))
    hT, cT = zx.new_empty((B, H)), zx.new_empty((B, H))
    ints = (T, B, H, _ACT_CODES[act], _ACT_CODES[gate], int(zx.dtype == torch.bfloat16))
    outs = (ys, a, f, o, i, c, hT, cT)
    if mask is None:
        fn = _build.bind("lstm_seq", "dl4j_lstm_seq_train_fwd", 15, 6)
        _build.launch(launches, "lstm_seq_train_fwd", fn, zx.device, zx, h0, c0,
                      RW, pF, pI, pO, *outs, *ints)
    else:
        fn = _build.bind("lstm_seq", "dl4j_lstm_seq_masked_train_fwd", 16, 6)
        _build.launch(launches, "lstm_seq_masked_train_fwd", fn, zx.device, zx,
                      mask, h0, c0, RW, pF, pI, pO, *outs, *ints)
    return outs


def _launch_bwd(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO,
                act, gate) -> Grads:
    if ys.dim() != 3:
        raise ValueError(f"ys must be [T, B, H], got {tuple(ys.shape)}")
    T, B, H = ys.shape
    seq, state = (T, B, H), (B, H)
    tensors = {"ys": (ys, seq), "dys": (dys, seq), "dhT": (dhT, state),
               "dcT": (dcT, state), "a": (a, seq), "f": (f, seq), "o": (o, seq),
               "i": (i, seq), "c": (c, seq), "h0": (h0, state), "c0": (c0, state),
               "RW": (RW, (H, 4 * H)), "pF": (pF, (H,)), "pI": (pI, (H,)),
               "pO": (pO, (H,))}
    if mask is not None:
        tensors["mask"] = (mask, (T, B, 1))
    _check_tensors("ys", tensors, act, gate)
    dzx = ys.new_empty((T, B, 4 * H))
    dh0, dc0 = ys.new_empty((B, H)), ys.new_empty((B, H))
    dRW = ys.new_empty((H, 4 * H))
    dpF, dpI, dpO = (ys.new_empty((H,)) for _ in range(3))
    if T == 0:
        return (dzx, dhT.clone(), dcT.clone(), dRW.zero_(), dpF.zero_(),
                dpI.zero_(), dpO.zero_())
    dcbuf = ys.new_empty((2, B, H))
    slices, drw_part = _drw_scratch(T * B, H, ys.device)
    psum = torch.empty((T * -(-B // BWD_ROW_BLOCK) * 3 * H,), dtype=torch.float32,
                       device=ys.device)
    grads = (dzx, dh0, dc0, dRW, dpF, dpI, dpO)
    ints = (T, B, H, _ACT_CODES[act], _ACT_CODES[gate], slices,
            int(ys.dtype == torch.bfloat16))
    res = (ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO)
    if mask is None:
        fn = _build.bind("lstm_seq_bwd", "dl4j_lstm_seq_bwd", 25, 7)
        _build.launch(launches, "lstm_seq_bwd", fn, ys.device, dys, dhT, dcT, *res,
                      *grads, dcbuf, drw_part, psum, *ints)
    else:
        dhbuf = ys.new_empty((2, B, H))  # each step's pre-mask dh, for the step before
        fn = _build.bind("lstm_seq_bwd", "dl4j_lstm_seq_masked_bwd", 27, 7)
        _build.launch(launches, "lstm_seq_masked_bwd", fn, ys.device, dys, dhT, dcT,
                      mask, *res, *grads, dcbuf, dhbuf, drw_part, psum, *ints)
    _build.count(launches, "drw_product")  # the C entry launched the dRW product too
    return grads


def _launch_drw(h0, ys, dzx) -> torch.Tensor:
    if dzx.dim() != 3 or dzx.shape[2] % 4:
        raise ValueError(f"dzx must be [T, B, 4H], got {tuple(dzx.shape)}")
    T, B, H4 = dzx.shape
    H = H4 // 4
    _check_tensors("dzx", {"dzx": (dzx, (T, B, H4)), "h0": (h0, (B, H)),
                           "ys": (ys, (T, B, H))})
    dRW = dzx.new_empty((H, H4))
    if T == 0 or B == 0 or H == 0:
        return dRW.zero_()
    slices, part = _drw_scratch(T * B, H, dzx.device)
    fn = _build.bind("lstm_seq_bwd", "dl4j_drw_product", 5, 5)
    _build.launch(launches, "drw_product", fn, dzx.device, h0, ys, dzx, dRW, part, T * B, B,
                  H, slices, int(dzx.dtype == torch.bfloat16))
    return dRW


def fused_lstm_sequence(zx, h0, c0, RW, pF, pI, pO, act: str = "tanh",
                        gate: str = "sigmoid") -> Result:
    """``zx`` [T, B, 4H] -> (ys [T, B, H], h_T, c_T), unmasked, forward in
    time. CUDA tensors run the kernel; CPU tensors the plain version."""
    if zx.is_cuda:
        return _launch("lstm_seq_lean", zx, None, h0, c0, RW, pF, pI, pO,
                       act, gate)
    return lstm_sequence_reference(zx, h0, c0, RW, pF, pI, pO, act, gate)


def fused_lstm_sequence_masked(zx, mask, h0, c0, RW, pF, pI, pO,
                               act: str = "tanh",
                               gate: str = "sigmoid") -> Result:
    """As :func:`fused_lstm_sequence` with ``mask`` [T, B, 1] in zx's dtype:
    a step whose mask is 0 holds h/c."""
    if zx.is_cuda:
        return _launch("lstm_seq_lean_masked", zx, mask, h0, c0, RW, pF, pI,
                       pO, act, gate)
    return lstm_sequence_masked_reference(zx, mask, h0, c0, RW, pF, pI, pO,
                                          act, gate)


def drw_product(h0, ys, dzx) -> torch.Tensor:
    """The backward's dRW [H, 4H] = sum over t of h_prev^T dzx[t] (h_prev =
    h0 [B, H] at t = 0, else ys[t-1]; ``ys`` [T, B, H], ``dzx`` [T, B, 4H]),
    summed in f32 and rounded to dzx's dtype. CUDA tensors run the kernel
    (``drw_mma``, the one rows 2, 7 and 9 run); CPU tensors the plain
    version."""
    fn = _launch_drw if dzx.is_cuda else drw_product_reference
    return fn(h0, ys, dzx)


# the LSTM routes a caller can ask for (MultiLayerNetwork's lstm_variant):
# the sequence kernels (the default), or the per-step cell kernels
# (ops/lstm_cell.py). No route runs the plain version on the card.
LSTM_VARIANTS = ("seqfused", "fusedcell")


def check_lstm_variant(lstm_variant: str) -> str:
    """``lstm_variant`` if it names a route of :data:`LSTM_VARIANTS`; raises
    ValueError on any other value, "reference" included."""
    if lstm_variant not in LSTM_VARIANTS:
        raise ValueError(f"lstm_variant must be one of {LSTM_VARIANTS}, got "
                         f"{lstm_variant!r}")
    return lstm_variant


def variant(t: torch.Tensor, lstm_variant: str = "seqfused") -> str:
    """What runs for a tensor on ``t``'s device under the route
    ``lstm_variant``: its kernels ("seqfused" or "fusedcell") on CUDA,
    "reference" (the plain versions) elsewhere. A report, not a knob."""
    route = check_lstm_variant(lstm_variant)
    return route if t.is_cuda else "reference"


def lstm_sequence_masked_train_forward(zx, mask, h0, c0, RW, pF, pI, pO,
                                       act: str = "tanh",
                                       gate: str = "sigmoid") -> TrainResult:
    """Training forward with ``mask`` [T, B, 1] (None: unmasked): (ys, a, f,
    o, i, c, h_T, c_T). CUDA tensors run the kernel; CPU tensors the plain
    version."""
    fn = _launch_train_fwd if zx.is_cuda else lstm_sequence_masked_train_reference
    return fn(zx, mask, h0, c0, RW, pF, pI, pO, act, gate)


def lstm_sequence_train_forward(zx, h0, c0, RW, pF, pI, pO, act: str = "tanh",
                                gate: str = "sigmoid") -> TrainResult:
    """Unmasked training forward: (ys, a, f, o, i, c, h_T, c_T)."""
    return lstm_sequence_masked_train_forward(zx, None, h0, c0, RW, pF, pI, pO,
                                              act, gate)


def lstm_sequence_masked_backward(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0,
                                  c0, RW, pF, pI, pO, act: str = "tanh",
                                  gate: str = "sigmoid") -> Grads:
    """Backward from the masked training forward's residuals and its
    ``mask`` (None: unmasked): (dzx, dh0, dc0, dRW, dpF, dpI, dpO). CUDA
    tensors run the kernel; CPU tensors the plain version."""
    fn = _launch_bwd if ys.is_cuda else lstm_sequence_masked_backward_reference
    return fn(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO, act,
              gate)


def lstm_sequence_backward(dys, dhT, dcT, ys, a, f, o, i, c, h0, c0, RW, pF,
                           pI, pO, act: str = "tanh",
                           gate: str = "sigmoid") -> Grads:
    """Backward from the unmasked training forward's residuals."""
    return lstm_sequence_masked_backward(dys, dhT, dcT, None, ys, a, f, o, i, c,
                                         h0, c0, RW, pF, pI, pO, act, gate)


class LstmSequenceFunction(torch.autograd.Function):
    """The sequence op under autograd, over (zx, h0, c0, RW, pF, pI, pO);
    ``act``/``gate`` are names and ``mask`` [T, B, 1] (or None) a constant:
    they take no gradient. Its forward runs the training forward (residuals
    kept for the backward) when an input needs a gradient, the lean primal
    otherwise; its backward runs the reverse-time backward, masked when the
    forward was. Outputs (ys, h_T, c_T)."""

    @staticmethod
    def forward(ctx, zx, h0, c0, RW, pF, pI, pO, act, gate, mask=None):
        ctx.act, ctx.gate = act, gate
        if not any(ctx.needs_input_grad[:7]):
            if mask is None:
                return fused_lstm_sequence(zx, h0, c0, RW, pF, pI, pO, act, gate)
            return fused_lstm_sequence_masked(zx, mask, h0, c0, RW, pF, pI, pO, act,
                                              gate)
        ys, a, f, o, i, c, hT, cT = lstm_sequence_masked_train_forward(
            zx, mask, h0, c0, RW, pF, pI, pO, act, gate)
        saved = (ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO)
        ctx.save_for_backward(*saved, *(() if mask is None else (mask,)))
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO, *mask = ctx.saved_tensors
        dys, dhT, dcT = (torch.zeros_like(like) if g is None else g.contiguous()
                         for g, like in ((dys, ys), (dhT, h0), (dcT, c0)))
        grads = lstm_sequence_masked_backward(
            dys, dhT, dcT, mask[0] if mask else None, ys, a, f, o, i, c, h0,
            c0, RW, pF, pI, pO, ctx.act, ctx.gate)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (None,) * 3


def lstm_sequence_apply(zx, h0, c0, RW, pF, pI, pO, act: str = "tanh",
                        gate: str = "sigmoid",
                        mask: Optional[torch.Tensor] = None) -> Result:
    """The sequence op as the layers call it, and the one place that picks
    what runs (``mask`` [T, B, 1] or None). With no gradient to keep (grad
    mode off, or no input requiring one) the lean primal, masked or not, as
    ``fused_lstm_sequence``'s custom VJP splits primal and forward rule.
    Under grad, :class:`LstmSequenceFunction`: the training forward and
    backward kernels, masked or not."""
    tensors = (zx, h0, c0, RW, pF, pI, pO)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        if mask is None:
            return fused_lstm_sequence(*tensors, act, gate)
        return fused_lstm_sequence_masked(zx, mask, *tensors[1:], act, gate)
    return LstmSequenceFunction.apply(*tensors, act, gate, mask)
