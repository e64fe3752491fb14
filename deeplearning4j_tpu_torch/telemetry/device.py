"""Device-side step accumulators: the metrics vector of a training step
(counterpart of ``deeplearning4j_tpu/telemetry/device.py``).

The instrumentation contract that keeps telemetry off the dispatch critical
path: everything per step is computed on the device as a tiny
``[NUM_SLOTS]`` float32 tensor (loss, global grad norm, non-finite flag)
beside the step's outputs. The host keeps these tensors without reading
them — fetching (the only host sync) happens once every K steps in
:class:`telemetry.session.Telemetry`, or once per staged window, whose
captured step writes its vector into a window buffer ``[steps, NUM_SLOTS]``.

``step_stats`` is tensor ops only: it never reads a value on the host, so
it runs inside a CUDA-graph capture as well as eagerly.
"""

from __future__ import annotations

import torch

# Slot layout of the per-step metrics vector.
LOSS = 0
GRAD_NORM = 1
NONFINITE = 2
NUM_SLOTS = 3

# Test seam: a callable invoked each time step_stats builds a vector (the
# JAX package calls it at trace time, the port at every call).
_TRACE_HOOK = None


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _float_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _float_leaves(v)]
    return []


def step_stats(loss, grads=None) -> torch.Tensor:
    """The per-step metrics vector (float32 ``[NUM_SLOTS]``, on the loss's
    device).

    ``loss``: a scalar tensor. ``grads``: the gradients (a list of dicts, a
    dict or a tensor; None when the step has no gradient view — grad norm
    reports 0). The grad norm is sqrt of the sum of every floating leaf's
    f32 squares (each leaf's norm from one grouped ``_foreach_norm``, then
    the norm of those); the non-finite flag is 1.0 when the loss or the
    grad norm is NaN/Inf.
    """
    if _TRACE_HOOK is not None:
        _TRACE_HOOK()
    loss32 = torch.as_tensor(loss).detach().to(torch.float32).reshape(())
    finite = torch.isfinite(loss32)
    leaves = _float_leaves(grads) if grads is not None else []
    if leaves:
        norms = torch._foreach_norm([l.detach().to(torch.float32) for l in leaves], 2)
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
        finite = finite & torch.isfinite(gnorm)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=loss32.device)
    nonfinite = 1.0 - finite.to(torch.float32)
    return torch.stack([loss32, gnorm, nonfinite])


__all__ = ["GRAD_NORM", "LOSS", "NONFINITE", "NUM_SLOTS", "step_stats"]
