"""Typed knob registry + scoped env setters (counterpart of
``deeplearning4j_tpu/tune/knobs.py``; restore on exit, never leak).

Every tunable surface of the port registers here as a :class:`Knob` with a
finite default domain, the library default, and a hint saying which term
of the step's cost it moves. Two application kinds:

- ``kind="env"`` — the surface reads a ``DL4JTPU_*`` env var dynamically
  (the micro-batcher's delay and row cap, ``serving/batcher.py``; the
  admission pair, ``serving/service.py``; decode slots,
  ``serving/decode.py``). These only ever apply through an
  :class:`EnvScope` / :func:`scoped_env`, which records the prior value
  (including *absence*) and restores it bit-identically on exit — a search
  that trials a hundred configs leaves ``os.environ`` untouched.
- ``kind="call"`` — the surface takes the value as a constructor or call
  argument (staging window, train batch, telemetry fetch cadence, the
  params' dtype, bucket boundaries). The search engine threads these into
  the trial workload; the tuned-config store threads them into
  ``fit``/``warmup``/``register``/``OnlineTrainer`` at auto-apply time.

Knobs of the JAX registry that have no surface in the port stay out of this
registry, so :func:`get_knob` raises ``KeyError`` for them as for any
unknown name: ``donation`` (XLA buffer donation) and
``xla_persistent_cache`` (XLA's disk cache; a CUDA graph cannot be saved);
the five ``kernel_<site>`` knobs (the port has no roofline selection
between a kernel and its plain version, so ``apply_config`` composes no
``DL4JTPU_KERNELS``); ``flash_min_seq`` (the port's attention always runs
its flash kernel on the card and reads no ``DL4JTPU_FLASH_MIN_SEQ``); and
``pipe_microbatches`` and ``precision_loss_scale``, whose surfaces
(``PipelinedTrainer``, ``PrecisionPolicy``) come with the parallelism item.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

__all__ = [
    "EnvScope",
    "Knob",
    "LEFT_OUT",
    "all_knobs",
    "apply_config",
    "get_knob",
    "register_knob",
    "scoped_env",
    "validate_config",
]

# the JAX registry's knobs with no surface in the port (module doc)
LEFT_OUT: Tuple[str, ...] = (
    "donation", "xla_persistent_cache", "flash_min_seq", "pipe_microbatches",
    "precision_loss_scale", "kernel_lstm_seq", "kernel_attention",
    "kernel_lrn", "kernel_softmax_xent", "kernel_optimizer")

_MISSING = object()  # distinguishes "var was unset" from "var was empty"


class EnvScope:
    """Restore-on-exit env setter: the ONLY sanctioned way tuning code
    touches ``os.environ``.

    ``set(name, value)`` records the prior state of ``name`` exactly once
    (first write wins, so nested sets of the same var still restore the
    ORIGINAL value) and writes ``str(value)`` — or unsets when ``value`` is
    None. ``restore()`` puts every touched var back, including re-deleting
    vars that did not exist; it is idempotent and runs from ``__exit__``
    even when the body raised, so a crashed trial cannot leak state.
    """

    def __init__(self) -> None:
        self._saved: Dict[str, object] = {}

    def set(self, name: str, value) -> None:
        if name not in self._saved:
            self._saved[name] = os.environ.get(name, _MISSING)
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = str(value)

    def restore(self) -> None:
        for name, prior in self._saved.items():
            if prior is _MISSING:
                os.environ.pop(name, None)
            else:
                os.environ[name] = prior
        self._saved.clear()

    def __enter__(self) -> "EnvScope":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()


@contextlib.contextmanager
def scoped_env(mapping: Optional[Dict[str, object]] = None,
               **vars) -> Iterator[EnvScope]:
    """``with scoped_env(DL4JTPU_X="1"):`` — set vars, restore on exit.

    Accepts a mapping (for names that are not identifiers) and/or kwargs;
    a value of None unsets the var for the scope. Yields the underlying
    :class:`EnvScope` so the body can set more vars under the same
    restore guarantee.
    """
    scope = EnvScope()
    try:
        for name, value in {**(mapping or {}), **vars}.items():
            scope.set(name, value)
        yield scope
    finally:
        scope.restore()


@dataclass(frozen=True)
class Knob:
    """One tunable surface.

    ``cost_hint`` names the cost term the knob moves —
    ``compute``/``memory``/``latency``/``host``/``neutral``.
    ``contexts`` lists the auto-apply sites that consume it
    (``fit``/``serve``/``online``/``warmup``); an empty tuple means the
    knob is search-scoped only (applied per trial, never at startup).
    """

    name: str
    domain: Tuple
    default: object
    kind: str  # "env" | "call"
    env: Optional[str] = None
    cost_hint: str = "neutral"
    contexts: Tuple[str, ...] = ()
    doc: str = ""

    def __post_init__(self):
        if self.kind not in ("env", "call"):
            raise ValueError(f"knob {self.name}: kind must be env|call, "
                             f"got {self.kind!r}")
        if self.kind == "env" and not self.env:
            raise ValueError(f"env knob {self.name} needs an env var name")


_REGISTRY: "Dict[str, Knob]" = {}


def register_knob(knob: Knob) -> Knob:
    if knob.name in _REGISTRY:
        raise ValueError(f"knob {knob.name!r} already registered")
    _REGISTRY[knob.name] = knob
    return knob


def get_knob(name: str) -> Knob:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown knob {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def all_knobs() -> Tuple[Knob, ...]:
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def _register_builtins() -> None:
    add = register_knob
    # ---- call knobs: threaded as arguments by trials / auto-apply
    add(Knob("train_batch", (32, 128, 256, 512, 1024), 512, "call",
             cost_hint="memory", contexts=(),
             doc="per-step batch rows; small batches re-pay the weight "
                 "traffic per sample"))
    add(Knob("stage_window", (2, 4, 8, 16), 4, "call",
             cost_hint="host", contexts=("fit", "online"),
             doc="batches staged per captured window "
                 "(fit stage_on_device= / OnlineTrainer stage=)"))
    add(Knob("bucket_boundaries", ("pow2",), "pow2", "call",
             cost_hint="compute", contexts=("fit", "online"),
             doc="sequence-length bucket granularity: 'pow2' (default "
                 "family) or an explicit boundary list "
                 "(OnlineTrainer time_boundaries=)"))
    add(Knob("telemetry_fetch_every", (1, 5, 10, 20, 50), 10, "call",
             cost_hint="host", contexts=("fit", "warmup", "online"),
             doc="device->host metric fetch cadence K "
                 "(Telemetry fetch_every=)"))
    add(Knob("precision_params_dtype", ("float32", "bfloat16"), "float32",
             "call", cost_hint="memory", contexts=(),
             doc="parameter and compute dtype of the net's conf; "
                 "trial-scoped — changing a live net's dtype re-inits it"))
    # ---- env knobs: surfaces read these dynamically; scoped apply only
    add(Knob("serve_max_delay_ms", (0.0, 0.5, 1.0, 2.0, 5.0), 2.0, "env",
             env="DL4JTPU_SERVE_MAX_DELAY_MS",
             cost_hint="latency", contexts=("serve",),
             doc="micro-batcher latency budget: how long a request waits "
                 "for company"))
    add(Knob("serve_max_batch", (16, 32, 64, 128, 256), 64, "env",
             env="DL4JTPU_SERVE_MAX_BATCH",
             cost_hint="compute", contexts=("serve",),
             doc="micro-batcher row cap = largest captured serving bucket"))
    add(Knob("serve_max_queue_depth", (0, 64, 128, 256, 512), 0, "env",
             env="DL4JTPU_SERVE_MAX_QUEUE",
             cost_hint="latency", contexts=("serve",),
             doc="admission control: shed (429) once this many requests "
                 "queue for a model; 0 disables the cap (per-model "
                 "InferenceService.register(max_queue_depth=) overrides)"))
    add(Knob("serve_latency_budget_ms", (0.0, 25.0, 50.0, 100.0, 250.0),
             0.0, "env", env="DL4JTPU_SERVE_LATENCY_BUDGET_MS",
             cost_hint="latency", contexts=("serve",),
             doc="admission control: shed (429) while the recent-ring p99 "
                 "exceeds this budget; 0 disables (per-model "
                 "InferenceService.register(latency_budget_ms=) "
                 "overrides)"))
    add(Knob("decode_slots", (8, 16, 32, 64), 8, "env",
             env="DL4JTPU_SERVE_DECODE_SLOTS",
             cost_hint="memory", contexts=(),
             doc="continuous-decode stream slots per recurrent model "
                 "(search-scoped: DecodeServer reads the env at "
                 "construction)"))


_register_builtins()


def validate_config(config: Dict[str, object]) -> None:
    """Reject unknown knob names early — a typo'd config must not silently
    tune nothing. Values outside the default domain are allowed (domains
    are seeds for the search grid, not hard bounds — e.g. an explicit
    bucket-boundary list)."""
    for name in config:
        get_knob(name)


def apply_config(config: Dict[str, object], scope: EnvScope) -> Dict[str, object]:
    """Apply every env-kind knob in ``config`` into ``scope`` and return
    the call-kind residue for the caller to thread as arguments.
    Restoring ``scope`` undoes everything."""
    validate_config(config)
    call_args: Dict[str, object] = {}
    for name, value in config.items():
        knob = get_knob(name)
        if knob.kind == "call":
            call_args[name] = value
        else:
            scope.set(knob.env, value)
    return call_args
