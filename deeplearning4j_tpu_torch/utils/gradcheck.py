"""Gradient checking: autograd against central finite differences
(counterpart of ``deeplearning4j_tpu/utils/gradcheck.py``; reference:
gradientcheck/GradientCheckUtil.java:76).

Run it in float64 with the reference's epsilon 1e-6 and its relative error
|analytic - numeric| / (|analytic| + |numeric|), on the CPU, where the ops
run their plain versions. ``params`` is a dict of tensors, or a list or
tuple of them (nested), taken leaf by leaf in the JAX package's
``jax.tree_util`` order (sorted keys), so the same ``seed`` checks the same
elements as the JAX package's ``gradient_check``.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    return [l for v in tree for l in _leaves(v)]


def _rebuild(tree, it):
    """``tree`` with its leaves, in ``_leaves`` order, taken from ``it``."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        got = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    return type(tree)(_rebuild(v, it) for v in tree)


def gradient_check(
    loss_fn: Callable,
    params,
    *args,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-3,
    min_abs_error: float = 1e-8,
    max_params_to_check: int = 256,
    seed: int = 0,
    verbose: bool = False,
) -> Tuple[bool, int, float]:
    """Check d(loss)/d(params) against central differences.
    ``loss_fn(params, *args)`` returns a scalar tensor. Where there are more
    than ``max_params_to_check`` elements, each leaf gets its share of them,
    drawn by ``np.random.default_rng(seed)``. Returns (passed, failures,
    the largest relative error seen)."""
    p_leaves = [p.detach() for p in _leaves(params)]
    live = [p.clone().requires_grad_(True) for p in p_leaves]
    loss0 = loss_fn(_rebuild(params, iter(live)), *args)
    if not bool(torch.isfinite(loss0)):
        raise ValueError(f"loss is not finite: {float(loss0)}")
    if loss0.requires_grad:
        grads = torch.autograd.grad(loss0, live, allow_unused=True, materialize_grads=True)
    else:  # no param reaches the loss through autograd (all frozen)
        grads = [torch.zeros_like(p) for p in live]

    rng = np.random.default_rng(seed)
    failures = 0
    max_rel = 0.0
    total = sum(p.numel() for p in p_leaves)
    budget = [max(1, int(max_params_to_check * p.numel() / max(total, 1))) for p in p_leaves]
    p_np = [p.cpu().numpy().astype(np.float64) for p in p_leaves]

    def loss_with(leaf: int, flat: int, value: float) -> float:
        mod = [p.copy() if i == leaf else p for i, p in enumerate(p_np)]
        mod[leaf].flat[flat] = value
        with torch.no_grad():
            return float(loss_fn(_rebuild(params, (torch.from_numpy(m) for m in mod)), *args))

    for li, (p, g) in enumerate(zip(p_np, grads)):
        n = p.size
        if n == 0:
            continue
        idxs = np.arange(n) if n <= budget[li] else rng.choice(n, size=budget[li],
                                                               replace=False)
        g_flat = g.detach().double().cpu().numpy().reshape(-1)
        for fi in idxs:
            orig = p.flat[fi]
            numeric = (loss_with(li, fi, orig + epsilon)
                       - loss_with(li, fi, orig - epsilon)) / (2 * epsilon)
            analytic = g_flat[fi]
            denom = abs(analytic) + abs(numeric)
            rel = 0.0 if denom == 0 else abs(analytic - numeric) / denom
            max_rel = max(max_rel, rel)
            if rel > max_rel_error and abs(analytic - numeric) > min_abs_error:
                failures += 1
                if verbose:
                    print(f"  leaf {li} idx {fi}: analytic={analytic:.8g} "
                          f"numeric={numeric:.8g} rel={rel:.3g}")
    return failures == 0, failures, max_rel
