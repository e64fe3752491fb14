"""Adam update, one leaf or every leaf of an update at once.

Port of ``deeplearning4j_tpu/ops/pallas_kernels.py:fused_adam_update``: for
one parameter leaf, from its gradient ``g`` and moments ``m``, ``v``,

    m' = b1*m + (1-b1)*g,  v' = b2*v + (1-b2)*g*g,
    u  = -lr * (m'/bc1) / (sqrt(v'/bc2) + eps)

returning ``(u, m', v')``. ``lr`` is the schedule's value and ``bc1``,
``bc2`` the bias corrections ``1 - b^t``, all given at run time
(``nn/updaters.py`` computes them as the JAX package does).

:func:`fused_adam_update_leaves` updates a list of leaves: for CUDA tensors
it launches the multi-tensor kernel of ``csrc/adam.cu`` once per
``MAX_LEAVES`` leaves (float32 only: the update runs in the f32 island of
``optimizer_update`` whatever the model's dtype) and raises on anything it
does not take. For CPU tensors it runs the plain version,
:func:`adam_update_reference`, leaf by leaf, which takes any float dtype.
:func:`fused_adam_update` is the JAX package's one-leaf op, the same call
over a list of one.

:func:`fused_adam_update_leaves_dev` is the same update with ``lr``,
``bc1`` and ``bc2`` in a tensor of three f32 on the leaves' device, which
the kernel reads when it runs (the C entry ``dl4j_adam_update_multi_dev``):
the form a training step captured in a CUDA graph takes, since a by-value
scalar is frozen at the capture. Its plain version is
:func:`adam_update_reference` with those three as 0-d tensors. Its launches
count as ``adam_update_dev``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

# count of kernel launches (one per MAX_LEAVES leaves of an update), by entry
launches = {"adam_update": 0, "adam_update_dev": 0}

MAX_LEAVES = 48  # leaves one launch takes: kMaxLeaves of csrc/adam.cu
_ALIGN = 4  # floats: each leaf's outputs start 16 bytes apart at least

Update = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Updates = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def adam_update_reference(g, m, v, lr, bc1, bc2,
                          b1: float, b2: float, eps: float) -> Update:
    """Plain version (``_adam_kernel``), in the leaf's dtype, rounding where
    the kernel rounds: (u, m', v'). ``lr``, ``bc1`` and ``bc2`` are floats
    or 0-d tensors (the device-scalar entry's plain version): on the CPU a
    0-d f32 tensor rounds as its float does."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    u = -lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    return u, m2, v2


def _check_leaves(gs, ms, vs, kernel: bool) -> None:
    """Raise on lists of different lengths, leaves on different devices or
    a leaf whose m or v is not g's shape; with ``kernel``, also on what the
    kernel does not take: a dtype other than float32, a non-contiguous
    tensor, a leaf of 2^31 elements or more."""
    if not len(gs) == len(ms) == len(vs):
        raise ValueError(f"{len(gs)} gradients, {len(ms)} first and {len(vs)} second moments")
    dev = gs[0].device if gs else None
    for i, leaf in enumerate(zip(gs, ms, vs)):
        shape = leaf[0].shape
        for name, t in zip("gmv", leaf):
            if t.device != dev:
                raise ValueError(f"{name} of leaf {i} is on {t.device}, leaf 0 on {dev}")
            if t.shape != shape:
                raise ValueError(f"{name} of leaf {i} is {tuple(t.shape)}, g is {tuple(shape)}")
            if kernel and t.dtype != torch.float32:
                raise TypeError(f"the CUDA Adam kernel takes float32, {name} of leaf {i} "
                                f"is {t.dtype}")
            if kernel and not t.is_contiguous():
                raise ValueError(f"{name} of leaf {i} must be contiguous")
        if kernel and leaf[0].numel() >= 2 ** 31:
            raise ValueError(f"leaf {i} of {leaf[0].numel()} elements is too large for the "
                             "Adam kernel")


def _launch(gs, ms, vs, lr, bc1, bc2, b1, b2, eps, scalars=None) -> Updates:
    """One launch per MAX_LEAVES leaves of the by-value entry, or of the
    device-scalar entry where ``scalars`` (lr, bc1, bc2 on the card) is
    given."""
    sizes = [g.numel() for g in gs]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    dev = gs[0].device
    bufs = [torch.empty(total, dtype=torch.float32, device=dev) for _ in range(3)]
    outs = tuple([buf.as_strided(g.shape, g.stride(), off) for g, off in zip(gs, offsets)]
                 for buf in bufs)
    bases = [buf.data_ptr() for buf in bufs]
    live = [i for i, n in enumerate(sizes) if n]
    if scalars is None:
        fn = _build.bind("adam", "dl4j_adam_update_multi", 7, 1, 8)
    else:
        fn = _build.bind("adam", "dl4j_adam_update_multi_dev", 8, 1, 5)
    for s in range(0, len(live), MAX_LEAVES):
        group = live[s:s + MAX_LEAVES]
        k = len(group)
        # the six pointer arrays and the counts, one host table of 7 k int64
        table = (ctypes.c_int64 * (7 * k))(
            *[t[i].data_ptr() for t in (gs, ms, vs) for i in group],
            *[base + 4 * offsets[i] for base in bases for i in group],
            *[sizes[i] for i in group])
        at = ctypes.addressof(table)
        ptrs = [at + 8 * k * j for j in range(7)]
        if scalars is None:
            _build.launch(launches, "adam_update", fn, dev, *ptrs,
                          k, lr, bc1, bc2, b1, 1.0 - b1, b2, 1.0 - b2, eps)
        else:
            _build.launch(launches, "adam_update_dev", fn, dev, *ptrs, scalars,
                          k, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    return outs


def fused_adam_update_leaves(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor], lr: float, bc1: float, bc2: float,
                             b1: float, b2: float, eps: float) -> Updates:
    """One Adam step for every leaf: ``(us, m2s, v2s)``, lists in the
    leaves' order. CUDA leaves take one kernel launch per ``MAX_LEAVES``
    leaves (none for empty leaves), their outputs views into one buffer per
    kind at 16-byte-aligned offsets; CPU leaves the plain version. The
    kernel reads contiguous leaves, so a leaf in other strides (a
    convolution's weight gradient comes back in its channels-last view's)
    is copied first. Raises ``ValueError`` on lists of different lengths,
    mixed devices or a leaf whose m or v is not g's shape, and for CUDA
    leaves ``TypeError`` on a dtype other than float32."""
    gs, ms, vs = ([t.contiguous() for t in ts] for ts in (gs, ms, vs))
    on_card = bool(gs) and gs[0].is_cuda
    _check_leaves(gs, ms, vs, kernel=on_card)
    if on_card:
        return _launch(gs, ms, vs, lr, bc1, bc2, b1, b2, eps)
    outs = [adam_update_reference(g, m, v, lr, bc1, bc2, b1, b2, eps)
            for g, m, v in zip(gs, ms, vs)]
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]


def fused_adam_update(g, m, v, lr: float, bc1: float, bc2: float,
                      b1: float, b2: float, eps: float) -> Update:
    """One Adam step for one leaf: (u, m', v'). CUDA tensors run the kernel;
    CPU tensors the plain version."""
    us, m2s, v2s = fused_adam_update_leaves([g], [m], [v], lr, bc1, bc2, b1, b2, eps)
    return us[0], m2s[0], v2s[0]


def _check_scalars(scalars, dev) -> None:
    if not isinstance(scalars, torch.Tensor):
        raise TypeError("scalars must be a tensor of (lr, bc1, bc2)")
    if scalars.dtype != torch.float32 or scalars.numel() != 3 or not scalars.is_contiguous():
        raise ValueError(f"scalars must be 3 contiguous float32 (lr, bc1, bc2), got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if dev is not None and scalars.device != dev:
        raise ValueError(f"scalars are on {scalars.device}, the leaves on {dev}")


def fused_adam_update_leaves_dev(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                                 vs: Sequence[torch.Tensor], scalars: torch.Tensor,
                                 b1: float, b2: float, eps: float) -> Updates:
    """:func:`fused_adam_update_leaves` with ``lr``, ``bc1`` and ``bc2`` read
    from ``scalars`` (three contiguous f32 on the leaves' device) when the
    kernel runs: the update of a captured training step. CUDA leaves launch
    ``dl4j_adam_update_multi_dev`` (counted as ``adam_update_dev``); CPU
    leaves run :func:`adam_update_reference` with the three as 0-d tensors.
    Raises as :func:`fused_adam_update_leaves` does, and ``ValueError`` on
    scalars of another shape, dtype or device."""
    gs, ms, vs = ([t.contiguous() for t in ts] for ts in (gs, ms, vs))
    on_card = bool(gs) and gs[0].is_cuda
    _check_leaves(gs, ms, vs, kernel=on_card)
    _check_scalars(scalars, gs[0].device if gs else None)
    if on_card:
        return _launch(gs, ms, vs, None, None, None, b1, b2, eps, scalars=scalars)
    lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    outs = [adam_update_reference(g, m, v, lr, bc1, bc2, b1, b2, eps)
            for g, m, v in zip(gs, ms, vs)]
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]
