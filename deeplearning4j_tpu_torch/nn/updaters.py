"""Updaters: gradient transforms with learning-rate schedules and clipping
(counterpart of ``deeplearning4j_tpu/nn/updaters.py``).

The JAX package builds optax transforms; the port does the same arithmetic
with an explicit state, so a run from the same params and data takes the
same steps:

- :func:`build_schedule` maps the iteration count to the learning rate, by
  every policy of the JAX package;
- :func:`gradient_normalization` by every mode;
- :class:`UpdaterConfig` is the same JSON dict; ``build()`` gives an
  :class:`Updater` for every updater of the JAX package: ``sgd``,
  ``momentum`` and ``nesterovs`` (optax's ``sgd`` with and without
  ``trace``), ``adam`` (optax's ``adam``, with the arithmetic of the JAX
  package's fused path, every leaf of an update in one grouped call,
  ``ops.adam.fused_adam_update_leaves``), ``adamw``, ``adamax``,
  ``adadelta``, ``adagrad``, ``rmsprop``, ``lamb`` and ``lion`` (optax's
  transforms as plain tensor ops, in optax's order of operations, with the
  JAX package's arguments: adamw's default weight decay 1e-4; adadelta at
  learning rate 1.0 whatever the conf says, with no schedule count;
  adagrad's initial accumulator 0.1; rmsprop with eps inside the square
  root; lamb and lion at optax's defaults) and ``none``/``noop`` (optax's
  ``set_to_zero``). The optax chain is ``(normalization, core)``, and the
  learning rate of update k is ``schedule(k)``.
- :func:`opt_state_leaves` and :func:`opt_state_from_leaves` read and build
  the state as the leaves of the optax state, in ``jax.tree_util`` order
  (what ``updaterState.npz`` holds).
- :func:`optimizer_update` is the f32 update island of the JAX package:
  with any bf16 leaf, grads, state and params are upcast, updated in f32 and
  cast back per leaf; with f32 only it is ``update`` plus ``p + u``.
- The staged loop (``fit_on_device``) runs one training step captured in a
  CUDA graph, replayed once per update. A by-value scalar would be frozen
  at the capture, so there the step's learning rate and Adam's bias
  corrections come from :func:`step_scalars`, a table the host computes per
  window with the same ``schedule`` and :func:`bias_corrections` as the
  per-batch path (so the same floats), one row a step, which the step reads
  through device memory (``scalars``); :func:`optimizer_update_in_place`
  writes the new params and state into the tensors the capture holds, and
  :func:`advance_counts` moves the counts on by the window's steps.

Params, grads and updates are lists of per-layer dicts of tensors, as the
JAX package's are tuples of dicts.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import adam as _adam

Tree = List[Dict[str, torch.Tensor]]

_PORTED = ("sgd", "momentum", "nesterovs", "adam", "adamw", "adamax", "adadelta", "adagrad",
           "rmsprop", "lamb", "lion", "none", "noop")
# the cores that run as plain tensor ops (no Pallas kernel in the JAX
# package either), with the state key each keeps its moments under
_PLAIN_CORES = {"adamw": "adam", "adamax": "adam", "lamb": "adam", "lion": "lion",
                "adagrad": "rss", "rmsprop": "rms", "adadelta": "adadelta"}
# the cores whose scalar row carries Adam's bias corrections (bc1, bc2), or
# bc1 alone
_BIAS_CORRECTED = {"adam": 2, "adamw": 2, "lamb": 2, "adamax": 1}
# the order of the core's state in the optax chain, before the schedule's
# count
_STATE_KEYS = ("adam", "lion", "rss", "rms", "adadelta", "trace")


# ---------------------------------------------------------------------------
# Learning-rate schedules (reference: LearningRatePolicy)
# ---------------------------------------------------------------------------
def build_schedule(
    lr: float,
    policy: str = "none",
    decay_rate: float = 0.0,
    power: float = 0.0,
    steps: float = 1.0,
    gamma: float = 0.0,
    max_iterations: int = 1,
    schedule: Optional[Dict[int, float]] = None,
) -> Callable[[int], float]:
    """Return iteration -> learning rate, by the JAX package's policies."""
    policy = (policy or "none").lower()
    if policy == "none":
        return lambda it: lr
    if policy == "exponential":
        return lambda it: lr * decay_rate ** it
    if policy == "inverse":
        return lambda it: lr / (1.0 + decay_rate * it) ** power
    if policy == "poly":
        return lambda it: lr * (1.0 - min(it / max_iterations, 1.0)) ** power
    if policy == "sigmoid":
        return lambda it: lr / (1.0 + math.exp(-gamma * (it - steps)))
    if policy in ("step", "torch_step"):
        return lambda it: lr * decay_rate ** math.floor(it / steps)
    if policy == "schedule":
        # piecewise-constant map {iteration: lr}, like conf.learningRateSchedule
        sched = sorted((int(k), float(v)) for k, v in (schedule or {}).items())
        boundaries = [k for k, _ in sched] if sched else [0]
        values = [lr] + [v for _, v in sched]
        return lambda it: values[sum(it >= b for b in boundaries)]
    raise ValueError(f"Unknown learning-rate policy '{policy}'")


# ---------------------------------------------------------------------------
# Gradient normalization (reference: GradientNormalization)
# ---------------------------------------------------------------------------
def _per_leaf_l2(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.sum(g * g), min=1e-12))


def _layer_norm(layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    # summed in sorted key order, the order of jax.tree_util's leaves
    return torch.sqrt(sum(torch.sum(layer[k] * layer[k]) for k in sorted(layer))
                      + 1e-12)


def gradient_normalization(kind: str, threshold: float = 1.0) -> Callable[[Tree], Tree]:
    """The reference's GradientNormalization modes as a function of the
    gradient list. "PerLayer" modes normalize over all params of one layer
    jointly, "PerParamType" modes each tensor alone."""
    kind = (kind or "none").lower()

    def per_layer(fn):
        def apply(grads):
            norms = [_layer_norm(layer) if layer else None for layer in grads]
            return [{k: fn(g, n) for k, g in layer.items()}
                    for layer, n in zip(grads, norms)]
        return apply

    def per_leaf(fn):
        return lambda grads: [{k: fn(g) for k, g in layer.items()} for layer in grads]

    def clip(g, n):
        return torch.where(n > threshold, g * threshold / n, g)

    if kind == "none":
        return lambda grads: grads
    if kind == "renormalizel2perlayer":
        return per_layer(lambda g, norm: g / norm)
    if kind == "renormalizel2perparamtype":
        return per_leaf(lambda g: g / _per_leaf_l2(g))
    if kind == "clipelementwiseabsolutevalue":
        return per_leaf(lambda g: torch.clamp(g, -threshold, threshold))
    if kind == "clipl2perlayer":
        return per_layer(clip)
    if kind == "clipl2perparamtype":
        return per_leaf(lambda g: clip(g, _per_leaf_l2(g)))
    raise ValueError(f"Unknown gradient normalization '{kind}'")


# ---------------------------------------------------------------------------
# Updater config (reference: Updater enum + per-updater hyperparams)
# ---------------------------------------------------------------------------
@dataclass
class UpdaterConfig:
    """JSON-serializable updater description -> :class:`Updater` via build()."""

    updater: str = "sgd"
    learning_rate: float = 0.1
    # momentum family
    momentum: float = 0.9
    # adam family
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    # rmsprop / adadelta
    rms_decay: float = 0.95
    rho: float = 0.95
    # schedules
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_gamma: float = 0.0
    max_iterations: int = 1
    learning_rate_schedule: Optional[Dict[int, float]] = None
    # gradient normalization (reference: GradientNormalization)
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "UpdaterConfig":
        d = dict(d)
        if d.get("learning_rate_schedule"):
            d["learning_rate_schedule"] = {
                int(k): float(v) for k, v in d["learning_rate_schedule"].items()
            }
        return UpdaterConfig(**d)

    def build(self) -> "Updater":
        name = self.updater.lower()
        if name not in _PORTED:
            raise ValueError(f"Unknown updater '{self.updater}'")
        sched = build_schedule(
            self.learning_rate, self.lr_policy, self.lr_policy_decay_rate,
            self.lr_policy_power, self.lr_policy_steps, self.lr_policy_gamma,
            self.max_iterations, self.learning_rate_schedule)
        momentum = self.momentum if name in ("momentum", "nesterovs") else None
        # the JAX package's arguments to each optax alias (nn/updaters.py
        # UpdaterConfig.build): what it leaves out takes optax's default
        hyper = {
            "adamw": dict(b1=self.beta1, b2=self.beta2, eps=self.epsilon, weight_decay=1e-4),
            "adamax": dict(b1=self.beta1, b2=self.beta2, eps=self.epsilon),
            "adadelta": dict(rho=self.rho, eps=self.epsilon),
            "adagrad": dict(eps=self.epsilon, initial=0.1),
            "rmsprop": dict(decay=self.rms_decay, eps=self.epsilon, initial=0.0),
            "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0),
            "lion": dict(b1=0.9, b2=0.99, weight_decay=1e-3),
        }.get(name)
        if name == "adadelta":
            sched = lambda it: 1.0  # noqa: E731 - optax.adadelta(learning_rate=1.0)
        return Updater(
            schedule=sched, momentum=momentum, nesterov=name == "nesterovs",
            zero=name in ("none", "noop"),
            normalize=gradient_normalization(
                self.gradient_normalization, self.gradient_normalization_threshold),
            adam=(self.beta1, self.beta2, self.epsilon) if name == "adam" else None,
            core=name if name in _PLAIN_CORES else None, hyper=hyper)


def _zeros_like(tree: Tree) -> Tree:
    return [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in tree]


def bias_corrections(count: int, b1: float, b2: float,
                     dtype: torch.dtype) -> Tuple[float, float]:
    """(1 - b1**count, 1 - b2**count) as the JAX package computes them for
    its Adam kernel: in ``promote_types(dtype, float32)`` (f32 for f32 and
    bf16 leaves, f64 for f64), the int32 count as the exponent."""
    sdt = torch.promote_types(dtype, torch.float32)
    t = torch.tensor(count, dtype=torch.int32)
    return tuple(float(1.0 - torch.tensor(b, dtype=sdt) ** t) for b in (b1, b2))


def step_scalars(tx: "Updater", state: dict, n: int) -> np.ndarray:
    """The scalars of the next ``n`` updates from ``state``, one f32 row
    each: (the learning rate ``schedule(count + i)``, the bias corrections
    ``bc1`` and ``bc2`` for the count of Adam's state ``+ i + 1``: both for
    adam, adamw and lamb, bc1 alone for adamax, else 1), the values the
    per-batch path hands the update for the same counts. adadelta keeps no
    count: its rate is ``schedule(0)``, 1.0. A captured step reads its row
    through device memory."""
    rows = np.ones((int(n), 3), np.float32)
    if tx.zero:
        return rows
    c = state.get("count", 0)
    rows[:, 0] = [tx.schedule(c + i) for i in range(int(n))]
    kind = tx.core or ("adam" if tx.adam is not None else None)
    if kind in _BIAS_CORRECTED:
        b1, b2, _ = tx.adam if tx.adam is not None else (tx.hyper["b1"], tx.hyper["b2"], None)
        ac = state["adam"]["count"]
        cols = _BIAS_CORRECTED[kind]
        rows[:, 1:1 + cols] = [bias_corrections(ac + i + 1, b1, b2, torch.float32)[:cols]
                               for i in range(int(n))]
    return rows


def advance_counts(state: dict, n: int) -> dict:
    """``state`` after ``n`` updates whose tensors were written in place: the
    schedule's count and the core's (Adam's, Lion's) moved on by ``n``;
    adadelta's state has no count."""
    new = dict(state)
    if "count" in new:
        new["count"] = state["count"] + int(n)
    for key in ("adam", "lion"):
        if key in state:
            new[key] = {**state[key], "count": state[key]["count"] + int(n)}
    return new


def _full_like(tree: Tree, value: float) -> Tree:
    return [{k: torch.full_like(v, value) for k, v in layer.items()} for layer in tree]


def _trust_ratio(u: List[torch.Tensor], p: List[torch.Tensor]) -> List[torch.Tensor]:
    """optax's ``scale_by_trust_ratio`` (min_norm 0, coefficient 1, eps 0),
    leaf by leaf: each ``u`` times ||p|| / ||u||, or times 1 where either
    norm is 0 (the norms of all leaves in two grouped calls)."""
    pn = torch.stack(torch._foreach_norm(p))
    un = torch.stack(torch._foreach_norm(u))
    ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / (un + 0.0))
    return torch._foreach_mul(u, list(ratio.unbind()))


@dataclass
class Updater:
    """optax's ``chain(normalization, core)`` with the core's state as a
    plain dict that holds what the optax state holds: {} for ``set_to_zero``
    (``zero``); else ``count`` (the schedule's step,
    ``ScaleByScheduleState.count``; adadelta has none), with ``trace``
    (momentum and nesterovs: ``TraceState``, a gradient-shaped list),
    ``adam`` (``ScaleByAdamState`` as {"count", "mu", "nu"}: adam, adamw,
    adamax, lamb), ``lion`` (``ScaleByLionState`` as {"count", "mu"}),
    ``rss`` (adagrad's ``ScaleByRssState.sum_of_squares``), ``rms``
    (rmsprop's ``ScaleByRmsState.nu``) or ``adadelta``
    (``ScaleByAdaDeltaState`` as {"e_g", "e_x"}). The core is ``sgd(schedule,
    momentum, nesterov)``, ``adam(schedule, b1, b2, eps)`` (``adam`` = (b1,
    b2, eps)), one of the plain-op cores (``core``, with its arguments in
    ``hyper``) or ``set_to_zero``."""

    schedule: Callable[[int], float]
    momentum: Optional[float]
    nesterov: bool
    zero: bool
    normalize: Callable[[Tree], Tree]
    adam: Optional[Tuple[float, float, float]] = None
    core: Optional[str] = None
    hyper: Optional[dict] = None

    def init(self, params: Tree) -> dict:
        if self.zero:
            return {}
        core = self.core
        if core == "adadelta":
            return {"adadelta": {"e_g": _zeros_like(params), "e_x": _zeros_like(params)}}
        state: dict = {}
        if self.adam is not None or _PLAIN_CORES.get(core) == "adam":
            state["adam"] = {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}
        elif core == "lion":
            state["lion"] = {"count": 0, "mu": _zeros_like(params)}
        elif core == "adagrad":
            state["rss"] = _full_like(params, self.hyper["initial"])
        elif core == "rmsprop":
            state["rms"] = _full_like(params, self.hyper["initial"])
        elif self.momentum is not None:
            state["trace"] = _zeros_like(params)
        state["count"] = 0
        return state

    def update(self, grads: Tree, state: dict, scalars: Optional[torch.Tensor] = None,
               params: Optional[Tree] = None):
        """(updates, new_state): updates are to be added to the params.
        ``scalars`` (a row of :func:`step_scalars` on the grads' device) takes
        the place of the schedule's value and the bias corrections for the
        count in ``state``: the form of a captured step. ``params`` (the
        params before the update) feed the weight decay of adamw and lion
        and lamb's trust ratio."""
        grads = self.normalize(grads)
        if self.zero:
            return [{k: torch.zeros_like(g) for k, g in layer.items()}
                    for layer in grads], state
        if self.core is not None:
            return self._plain(grads, state, scalars, params)
        new = {**state, "count": state["count"] + 1}
        if self.adam is not None:
            updates, new["adam"] = self._adam(grads, state, scalars)
            return updates, new
        if self.momentum is not None:
            mu = self.momentum
            # optax.trace: t = g + mu * t; nesterov takes g + mu * t as well
            new["trace"] = [{k: g + mu * t[k] for k, g in layer.items()}
                            for layer, t in zip(grads, state["trace"])]
            if self.nesterov:
                grads = [{k: g + mu * t[k] for k, g in layer.items()}
                         for layer, t in zip(grads, new["trace"])]
            else:
                grads = new["trace"]
        step = -self.schedule(state["count"]) if scalars is None else -scalars[0]
        return [{k: step * g for k, g in layer.items()} for layer in grads], new

    def _plain(self, grads: Tree, state: dict, scalars: Optional[torch.Tensor],
               params: Optional[Tree]):
        """The plain-op cores, every leaf at once through ``torch._foreach_*``
        ops (grouped launches) in optax's order of operations, then
        ``scale_by_learning_rate``. The learning rate and the bias
        corrections are 0-d tensors on the grads' device in both forms (the
        per-batch one fills them from :func:`step_scalars`' floats), so both
        divide by a tensor and give the same bits."""
        core, h = self.core, self.hyper
        if params is None and (h.get("weight_decay") or core == "lamb"):
            raise ValueError(f"the {core} updater needs the params")
        g0 = next((g for layer in grads for g in layer.values()), None)
        if g0 is None:
            return grads, advance_counts(state, 1)
        if scalars is None:
            bcs = (1.0, 1.0)
            if core in _BIAS_CORRECTED:  # in the leaves' precision, as Adam's
                bcs = bias_corrections(state["adam"]["count"] + 1, h["b1"], h["b2"], g0.dtype)
                bcs = bcs if _BIAS_CORRECTED[core] == 2 else (bcs[0], 1.0)
            lr, bc1, bc2 = (torch.full((), v, dtype=g0.dtype, device=g0.device)
                            for v in (self.schedule(state.get("count", 0)), *bcs))
        else:
            lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
        key = _PLAIN_CORES[core]
        new = dict(state)
        G = _tree_leaves(grads)
        mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
        sqrt, rsqrt = torch._foreach_sqrt, torch._foreach_rsqrt

        def ema(x, t, decay):  # optax's update_moment: (1 - decay) * x + decay * t
            return add(mul(x, 1 - decay), mul(t, decay))

        if key == "adam":
            a = state["adam"]
            M, V = _tree_leaves(a["mu"]), _tree_leaves(a["nu"])
            mu = ema(G, M, h["b1"])
            if core == "adamax":
                nu = torch._foreach_maximum(add(torch._foreach_abs(G), h["eps"]),
                                            mul(V, h["b2"]))
                u = div(div(mu, bc1), nu)
            else:
                nu = ema(mul(G, G), V, h["b2"])
                u = div(div(mu, bc1), add(sqrt(div(nu, bc2)), h["eps"]))
            u = self._decayed(u, params)
            if core == "lamb":
                u = _trust_ratio(u, _tree_leaves(params))
            new["adam"] = {"count": a["count"] + 1, "mu": _unflatten(a["mu"], mu),
                           "nu": _unflatten(a["nu"], nu)}
        elif key == "lion":
            M = _tree_leaves(state["lion"]["mu"])
            u = self._decayed(torch._foreach_sign(ema(G, M, h["b1"])), params)
            new["lion"] = {"count": state["lion"]["count"] + 1,
                           "mu": _unflatten(state["lion"]["mu"], ema(G, M, h["b2"]))}
        elif key == "rss":
            # the sum of squares starts at initial > 0 and only grows, so
            # optax's where(t > 0, rsqrt(t + eps), 0) is the rsqrt alone
            sos = add(mul(G, G), _tree_leaves(state["rss"]))
            u = mul(rsqrt(add(sos, h["eps"])), G)
            new["rss"] = _unflatten(state["rss"], sos)
        elif key == "rms":
            nu = ema(mul(G, G), _tree_leaves(state["rms"]), h["decay"])
            u = mul(rsqrt(add(nu, h["eps"])), G)
            new["rms"] = _unflatten(state["rms"], nu)
        else:  # adadelta
            st, rho, eps = state["adadelta"], h["rho"], h["eps"]
            EG, EX = _tree_leaves(st["e_g"]), _tree_leaves(st["e_x"])
            e_g = ema(mul(G, G), EG, rho)
            u = mul(div(sqrt(add(EX, eps)), sqrt(add(e_g, eps))), G)
            new["adadelta"] = {"e_g": _unflatten(st["e_g"], e_g),
                               "e_x": _unflatten(st["e_x"], ema(mul(u, u), EX, rho))}
        if "count" in new:
            new["count"] = state["count"] + 1
        return _unflatten(grads, mul(u, -lr)), new

    def _decayed(self, u: List[torch.Tensor], params: Tree) -> List[torch.Tensor]:
        """optax's ``add_decayed_weights``: u + weight_decay * p (none at
        weight decay 0)."""
        wd = self.hyper.get("weight_decay")
        if not wd:
            return u
        return torch._foreach_add(u, torch._foreach_mul(_tree_leaves(params), wd))

    def _adam(self, grads: Tree, state: dict, scalars: Optional[torch.Tensor] = None):
        """optax's scale_by_adam, then the schedule: one grouped Adam call
        over every leaf (one kernel launch per ``MAX_LEAVES`` leaves on the
        card), with the JAX package's fused path's arithmetic. Returns
        (updates, the new ScaleByAdamState)."""
        b1, b2, eps = self.adam
        adam = state["adam"]
        count = adam["count"] + 1  # optax.safe_int32_increment
        leaves = _tree_leaves(grads)
        ms = _tree_leaves(adam["mu"])
        vs = _tree_leaves(adam["nu"])
        if scalars is None:
            lr = self.schedule(state["count"])
            dtype = leaves[0].dtype if leaves else torch.float32
            bc1, bc2 = bias_corrections(count, b1, b2, dtype)
            outs = _adam.fused_adam_update_leaves(leaves, ms, vs, lr, bc1, bc2, b1, b2, eps)
        else:
            outs = _adam.fused_adam_update_leaves_dev(leaves, ms, vs, scalars, b1, b2, eps)
        updates, mu, nu = (_unflatten(grads, o) for o in outs)
        return updates, {"count": count, "mu": mu, "nu": nu}


def _tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of a param-shaped list in jax.tree_util order: layer by
    layer, each dict in sorted key order."""
    return [layer[k] for layer in tree for k in sorted(layer)]


def _unflatten(tree: Tree, leaves: Sequence[torch.Tensor]) -> Tree:
    """A list shaped as ``tree`` holding ``leaves`` (``_tree_leaves``
    order), each dict in the key order of ``tree``'s."""
    it = iter(leaves)
    at = [{k: next(it) for k in sorted(layer)} for layer in tree]
    return [{k: a[k] for k in layer} for layer, a in zip(tree, at)]


def _host_array(a) -> np.ndarray:
    """A host array of a leaf; ml_dtypes types (JAX's bf16) widen to f32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


def opt_state_leaves(state: dict) -> List[torch.Tensor]:
    """The leaves of the optax state that ``state`` stands for, in
    ``jax.tree_util.tree_leaves`` order, counts as int32 scalars. With optax
    0.2.6 the chain's state is ``(EmptyState(), core)``, core
    ``EmptyState()`` for none, ``(EmptyState(), ScaleByScheduleState(count))``
    for sgd, ``(TraceState(trace), ScaleByScheduleState(count))`` for
    momentum and nesterovs, ``(ScaleByAdamState(count, mu, nu), [EmptyState
    ...,] ScaleByScheduleState(count))`` for adam, adamw, adamax and lamb,
    ``(ScaleByLionState(count, mu), EmptyState(), ScaleByScheduleState(count))``
    for lion, ``(ScaleByRssState(sum_of_squares), ScaleByScheduleState(count))``
    for adagrad, ``(ScaleByRmsState(nu), ScaleByScheduleState(count),
    EmptyState())`` for rmsprop and ``(EmptyState(), ScaleByAdaDeltaState(e_g,
    e_x), EmptyState())`` for adadelta: the core's leaves, then the
    schedule's count."""
    out: List[torch.Tensor] = []
    for key in _STATE_KEYS:
        sub = state.get(key)
        if isinstance(sub, list):
            out += _tree_leaves(sub)
        elif sub is not None:  # a NamedTuple's fields in order: count, then trees
            for name, v in sub.items():
                out += ([torch.tensor(v, dtype=torch.int32)] if name == "count"
                        else _tree_leaves(v))
    if "count" in state:
        out.append(torch.tensor(state["count"], dtype=torch.int32))
    return out


def opt_state_from_leaves(updater: Updater, params: Tree, leaves: Sequence) -> dict:
    """The state of ``updater`` for ``params`` whose :func:`opt_state_leaves`
    are ``leaves`` (arrays or tensors, e.g. a JAX net's
    ``jax.tree_util.tree_leaves(opt_state)``). Each float leaf takes its
    param's dtype and device; shapes and the count of leaves are checked."""
    state = updater.init(params)
    want = len(opt_state_leaves(state))
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} updater state leaves, the updater "
                         f"expects {want}")
    it = iter(_host_array(a) for a in leaves)

    def tree() -> Tree:
        out = []
        for i, layer in enumerate(params):
            got = {}
            for k in sorted(layer):
                a = next(it)
                if tuple(a.shape) != tuple(layer[k].shape):
                    raise ValueError(f"updater state of layer {i} {k}: shape "
                                     f"{tuple(a.shape)}, expected {tuple(layer[k].shape)}")
                got[k] = torch.tensor(a).to(layer[k].device, layer[k].dtype)
            out.append({k: got[k] for k in layer})
        return out

    for key in _STATE_KEYS:
        sub = state.get(key)
        if isinstance(sub, list):
            state[key] = tree()
        elif sub is not None:
            state[key] = {name: int(next(it)) if name == "count" else tree() for name in sub}
    if "count" in state:
        state["count"] = int(next(it))
    return state


# ---------------------------------------------------------------------------
# Mixed-precision update island + loss scaling
# ---------------------------------------------------------------------------
def _is_low_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.dtype.itemsize < 4


def _leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return []


def _map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return tree


def _to_f32(tree):
    return _map(lambda t: t.float() if _is_low_float(t) else t, tree)


def _like(tree, ref):
    return _map(lambda t, r: t.to(r.dtype) if t.dtype != r.dtype else t, tree, ref)


def _apply_updates(params: Tree, updates: Tree) -> Tree:
    """optax.apply_updates: ``p + u`` in p's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def optimizer_update(tx: Updater, grads: Tree, opt_state: dict, params: Tree,
                     scalars: Optional[torch.Tensor] = None):
    """``tx.update`` plus ``p + u`` under the precision contract: with any
    sub-f32 leaf in grads, state or params, the update runs in an f32 island
    and the new state and params are cast back per leaf; with f32 only it is
    the plain update. ``scalars`` as in ``Updater.update``. Returns
    (updates, new_opt_state, new_params)."""
    if not any(_is_low_float(t) for t in
               _leaves(grads) + _leaves(opt_state) + _leaves(params)):
        updates, new_opt = tx.update(grads, opt_state, scalars, params)
        return updates, new_opt, _apply_updates(params, updates)
    p32 = _to_f32(params)
    updates, new_opt32 = tx.update(_to_f32(grads), _to_f32(opt_state), scalars, p32)
    new_p32 = _apply_updates(p32, updates)
    return updates, _like(new_opt32, opt_state), _like(new_p32, params)


@torch.no_grad()
def optimizer_update_in_place(tx: Updater, grads: Tree, opt_state: dict, params: Tree,
                              scalars: torch.Tensor) -> None:
    """:func:`optimizer_update` with the step's ``scalars``, its new params
    and state tensors written into ``params`` and ``opt_state``'s tensors in
    place (the counts are left: :func:`advance_counts`). The update of a
    captured step, whose graph holds those tensors' addresses; the same
    arithmetic as the per-batch path's, so the same bits."""
    _, new_opt, new_params = optimizer_update(tx, grads, opt_state, params, scalars)
    for layer, new in zip(params, new_params):
        for k, v in layer.items():
            v.copy_(new[k])
    for old, new in zip(_leaves(opt_state), _leaves(new_opt)):
        old.copy_(new)


def scaled_loss(loss: torch.Tensor, loss_scale: Optional[float]) -> torch.Tensor:
    """The loss times ``loss_scale`` for sub-f32 backprop (None: identity)."""
    return loss * loss_scale if loss_scale else loss


def unscale_loss(loss: torch.Tensor, loss_scale: Optional[float]) -> torch.Tensor:
    """Undo :func:`scaled_loss` on the reported loss value."""
    return loss / loss_scale if loss_scale else loss


def unscale_grads(grads: Tree, loss_scale: Optional[float]) -> Tree:
    """Undo :func:`scaled_loss` on the gradients, in at least f32 (no-op for
    a falsy scale)."""
    if not loss_scale:
        return grads
    inv = 1.0 / float(loss_scale)
    return _map(lambda g: (g.float() if _is_low_float(g) else g) * inv
                if g.is_floating_point() else g, grads)
