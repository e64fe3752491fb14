"""Row-wise softmax cross-entropy with its gradient.

Port of ``deeplearning4j_tpu/ops/pallas_kernels.py:fused_softmax_xent``:
per row of logits ``preout`` [N, C] and ``labels`` [N, C],
``-sum(labels * log_softmax(preout))``, computed in
``promote_types(dtype, float32)`` and returned as [N] in that dtype (f32 for
bf16 logits). :class:`SoftmaxXentFunction` is its custom VJP: the forward is
``_sxent_fwd_impl``, the backward ``_sxent_bwd``, which rebuilds the softmax
and returns ``d preout = (p * sum(labels) - labels) * g`` and
``d labels = -log_softmax(preout) * g``.

For CUDA tensors both launch the hand-written kernels of
``csrc/softmax_xent.cu`` (float32 or bfloat16 logits and labels) and raise
on anything they do not take. For CPU tensors they run the plain versions,
:func:`softmax_xent_reference` and :func:`softmax_xent_backward_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

# count of wrapper calls that launched each kernel (one launch each)
launches = {"softmax_xent_fwd": 0, "softmax_xent_bwd": 0}


def compute_dtype(dt: torch.dtype) -> torch.dtype:
    """The softmax math's dtype: at least f32 (``_sxent_compute_dt``)."""
    return torch.promote_types(dt, torch.float32)


# ------------------------------------------------------------ plain versions
def softmax_xent_reference(preout: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward (``_sxent_fwd_kernel``): [N] row losses
    in the compute dtype."""
    cdt = compute_dtype(preout.dtype)
    x, lab = preout.to(cdt), labels.to(cdt)
    m = x.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(-1, keepdim=True)) + m
    return -(lab * (x - lse)).sum(-1)


def softmax_xent_backward_reference(
        preout: torch.Tensor, labels: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward (``_sxent_bwd_kernel``): (d preout in
    preout's dtype, d labels in labels' dtype) from the row gradient ``g``."""
    cdt = compute_dtype(preout.dtype)
    x, lab = preout.to(cdt), labels.to(cdt)
    g = g.to(cdt).reshape(-1, 1)
    m = x.amax(-1, keepdim=True)
    ex = torch.exp(x - m)
    s = ex.sum(-1, keepdim=True)
    p = ex / s
    logp = x - (torch.log(s) + m)
    lab_sum = lab.sum(-1, keepdim=True)
    return ((p * lab_sum - lab) * g).to(preout.dtype), (-logp * g).to(labels.dtype)


# ------------------------------------------------------------------ kernels
_DTYPES = (torch.float32, torch.bfloat16)


def _check(preout: torch.Tensor, labels: torch.Tensor,
           g: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernels do not take, one pass over the tensors."""
    shape, device = preout.shape, preout.device
    if preout.dim() != 2 or labels.shape != shape:
        raise ValueError(f"preout and labels must both be [N, C], got "
                         f"{tuple(shape)} and {tuple(labels.shape)}")
    if g is not None and (g.shape != shape[:1] or g.dtype != torch.float32):
        raise ValueError(f"g must be float32 [{shape[0]}], got "
                         f"{g.dtype} {tuple(g.shape)}")
    for name, t in (("preout", preout), ("labels", labels), ("g", g)):
        if t is None:
            continue
        if name != "g" and t.dtype not in _DTYPES:
            raise TypeError(f"the CUDA softmax-xent kernels take float32 or "
                            f"bfloat16 {name}, not {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, preout on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_fwd(preout: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    _check(preout, labels)
    N, C = preout.shape
    loss = torch.empty((N,), dtype=torch.float32, device=preout.device)
    if N == 0:
        return loss
    fn = _build.bind("softmax_xent", "dl4j_softmax_xent_fwd", 3, 4)
    _build.launch(launches, "softmax_xent_fwd", fn, preout.device, preout,
                  labels, loss, N, C, int(preout.dtype == torch.bfloat16),
                  int(labels.dtype == torch.bfloat16))
    return loss


def _kernel_bwd(preout: torch.Tensor, labels: torch.Tensor,
                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.to(torch.float32).contiguous()
    _check(preout, labels, g)
    N, C = preout.shape
    dx, dl = torch.empty_like(preout), torch.empty_like(labels)
    if N == 0:
        return dx, dl
    fn = _build.bind("softmax_xent", "dl4j_softmax_xent_bwd", 5, 4)
    _build.launch(launches, "softmax_xent_bwd", fn, preout.device, preout,
                  labels, g, dx, dl, N, C, int(preout.dtype == torch.bfloat16),
                  int(labels.dtype == torch.bfloat16))
    return dx, dl


def softmax_xent_forward(preout: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[N] row losses: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if preout.is_cuda:
        return _kernel_fwd(preout, labels)
    return softmax_xent_reference(preout, labels)


def softmax_xent_backward(preout: torch.Tensor, labels: torch.Tensor,
                          g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d preout, d labels) from the row gradient ``g``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if preout.is_cuda:
        return _kernel_bwd(preout, labels, g)
    return softmax_xent_backward_reference(preout, labels, g)


class SoftmaxXentFunction(torch.autograd.Function):
    """Row losses of (preout, labels) [N, C] under autograd; both inputs
    take gradients."""

    @staticmethod
    def forward(ctx, preout, labels):
        ctx.save_for_backward(preout, labels)
        return softmax_xent_forward(preout, labels)

    @staticmethod
    def backward(ctx, g):
        preout, labels = ctx.saved_tensors
        dx, dl = softmax_xent_backward(preout, labels, g)
        need_x, need_l = ctx.needs_input_grad
        return (dx if need_x else None), (dl if need_l else None)


def fused_softmax_xent(preout: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """[N] row losses of ``preout``, ``labels`` [N, C] in the compute dtype,
    differentiable in both: under grad through :class:`SoftmaxXentFunction`,
    otherwise :func:`softmax_xent_forward` alone, with no autograd node."""
    if torch.is_grad_enabled() and (preout.requires_grad or labels.requires_grad):
        return SoftmaxXentFunction.apply(preout, labels)
    return softmax_xent_forward(preout, labels)
