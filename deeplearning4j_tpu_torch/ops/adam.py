"""Per-leaf Adam update.

Port of ``deeplearning4j_tpu/ops/pallas_kernels.py:fused_adam_update``: for
one parameter leaf, from its gradient ``g`` and moments ``m``, ``v``,

    m' = b1*m + (1-b1)*g,  v' = b2*v + (1-b2)*g*g,
    u  = -lr * (m'/bc1) / (sqrt(v'/bc2) + eps)

returning ``(u, m', v')``. ``lr`` is the schedule's value and ``bc1``,
``bc2`` the bias corrections ``1 - b^t``, all given at run time
(``nn/updaters.py`` computes them as the JAX package does).

:func:`fused_adam_update` launches the CUDA kernel of ``csrc/adam.cu`` for
CUDA tensors (float32 only: the update runs in the f32 island of
``optimizer_update`` whatever the model's dtype) and raises on anything it
does not take. For CPU tensors it runs the plain version,
:func:`adam_update_reference`, which takes any float dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

# count of wrapper calls that launched the kernel (one leaf each)
launches = {"adam_update": 0}

Update = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def adam_update_reference(g, m, v, lr: float, bc1: float, bc2: float,
                          b1: float, b2: float, eps: float) -> Update:
    """Plain version (``_adam_kernel``), in the leaf's dtype, rounding where
    the kernel rounds: (u, m', v')."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    u = -lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    return u, m2, v2


def _launch(g, m, v, lr, bc1, bc2, b1, b2, eps) -> Update:
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA Adam kernel takes float32, {name} is {t.dtype}")
        if tuple(t.shape) != tuple(g.shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, g is {tuple(g.shape)}")
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = g.numel()
    if n >= 2 ** 31:
        raise ValueError(f"a leaf of {n} elements is too large for the Adam kernel")
    u, m2, v2 = torch.empty_like(g), torch.empty_like(g), torch.empty_like(g)
    if n == 0:
        return u, m2, v2
    fn = _build.bind("adam", "dl4j_adam_update", 6, 1, 8)
    _build.launch(launches, "adam_update", fn, g.device, g, m, v, u, m2, v2, n,
                  lr, bc1, bc2, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    return u, m2, v2


def fused_adam_update(g, m, v, lr: float, bc1: float, bc2: float,
                      b1: float, b2: float, eps: float) -> Update:
    """One Adam step for one leaf: (u, m', v'). CUDA tensors run the kernel;
    CPU tensors the plain version."""
    fn = _launch if g.is_cuda else adam_update_reference
    return fn(g, m, v, lr, bc1, bc2, b1, b2, eps)
