"""Search engine (counterpart of ``deeplearning4j_tpu/tune/search.py``):
successive halving over measured trials.

Candidate configs come from the knob registry's domains, and every one is
measured: the JAX package ranks and prunes candidates by a static roofline
prior from ``net.analyze_ir``, which is out of the port's scope, so the
port's workloads have no prior (``prior`` returns ``None``; the
``prior=``/``prune_factor`` plumbing of :func:`successive_halving` stays
for callers that bring one). The candidates race through successive
halving — short measured trials first, the top fraction graduating to
longer ones — until the budget lapses or one config stands.

Measurement discipline:

- every trial captures its step first (``warmup``), then pins the compile
  manager's ``compiles`` counter across the timed region — on the card a
  "compile" is a CUDA-graph capture, so a trial that captured
  mid-measurement is re-run once and fails loudly the second time (a
  config whose steady state can't be measured must not win on its capture
  stall);
- the timed region ends in ``torch.cuda.synchronize`` on the card;
- every trial records its evidence (captures, the bytes of its captured
  graphs' pool, ms per step) next to its measured objective, and frees its
  network's graphs and pool before the next trial starts;
- env-kind knobs apply through :class:`~.knobs.EnvScope` only; after a
  search ``run_autotune`` asserts the process env is bit-identical to the
  pre-search snapshot and refuses to return a winner otherwise.
"""

from __future__ import annotations

import gc
import itertools
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .knobs import EnvScope, apply_config, get_knob
from . import store as tuned_store

__all__ = [
    "MlpFitWorkload",
    "SearchResult",
    "ServeWorkload",
    "Trial",
    "grid",
    "parse_budget",
    "run_autotune",
    "successive_halving",
]


@dataclass
class Trial:
    """One candidate's journey: static prediction, then measured rungs."""

    config: Dict[str, object]
    predicted: Optional[float] = None  # objective units (higher is better)
    measured: Optional[float] = None   # last (highest-fidelity) measurement
    p99_ms: Optional[float] = None
    compiles_measured: int = 0         # compiles inside timed regions: MUST be 0
    telemetry: Dict[str, object] = field(default_factory=dict)
    rung: int = -1                     # highest rung measured (-1 = never ran)
    pruned: bool = False               # prior said >prune_factor worse; skipped

    def as_dict(self) -> dict:
        return {
            "config": dict(self.config), "predicted": self.predicted,
            "measured": self.measured, "p99_ms": self.p99_ms,
            "compiles_measured": self.compiles_measured,
            "telemetry": dict(self.telemetry), "rung": self.rung,
            "pruned": self.pruned,
        }


@dataclass
class SearchResult:
    best: Trial
    default: Trial
    trials: List[Trial]
    objective: str
    metric: str
    env_ok: bool
    key: Optional[str] = None
    store_path: Optional[str] = None
    elapsed_s: float = 0.0

    @property
    def pruned(self) -> List[Trial]:
        return [t for t in self.trials if t.pruned]

    def as_dict(self) -> dict:
        return {
            "best": self.best.as_dict(), "default": self.default.as_dict(),
            "objective": self.objective, "metric": self.metric,
            "env_ok": self.env_ok, "key": self.key,
            "store_path": self.store_path,
            "elapsed_s": round(self.elapsed_s, 3),
            "trials": [t.as_dict() for t in self.trials],
            "pruned_count": len(self.pruned),
        }


def grid(space: Dict[str, Sequence]) -> List[Dict[str, object]]:
    """Cross product of a ``{knob: candidate values}`` space, validated
    against the registry. Deterministic order (sorted knob names)."""
    if not space:
        return []
    names = sorted(space)
    for n in names:
        get_knob(n)  # unknown knob = loud error before anything runs
    out = []
    for combo in itertools.product(*(tuple(space[n]) for n in names)):
        out.append(dict(zip(names, combo)))
    return out


def parse_budget(text) -> float:
    """'60s' / '2m' / '1h' / plain seconds -> float seconds."""
    if isinstance(text, (int, float)):
        return float(text)
    t = str(text).strip().lower()
    mult = 1.0
    if t.endswith(("s", "m", "h")):
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[t[-1]]
        t = t[:-1]
    return float(t) * mult


def _config_key(config: Dict[str, object]) -> Tuple:
    return tuple(sorted((k, repr(v)) for k, v in config.items()))


def successive_halving(
    candidates: Sequence[Dict[str, object]],
    measure: Callable[[Dict[str, object], int], object],
    *,
    prior: Optional[Callable[[Dict[str, object]], Optional[float]]] = None,
    prune_factor: float = 2.0,
    rungs: int = 2,
    keep: float = 0.5,
    fidelities: Optional[Sequence[int]] = None,
    deadline: Optional[float] = None,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[Trial, List[Trial]]:
    """Prior-pruned successive halving. Higher objective = better.

    ``candidates[0]`` is the incumbent (the default config): it anchors the
    prior pruning threshold and is always measured, so the returned best is
    never worse-informed than the default. ``measure(config, fidelity)``
    returns the objective value, or a dict with ``value`` plus optional
    ``p99_ms``/``compiles``/``telemetry``. ``fidelities[r]`` is the trial
    length at rung ``r`` (defaults to 1, 2, 4, ...). The deadline is
    honored between trials — at least the incumbent's rung-0 measurement
    always happens, so there is always a measured winner.
    """
    if not candidates:
        raise ValueError("successive_halving needs at least one candidate")
    trials = [Trial(config=dict(c)) for c in candidates]
    say = log if log is not None else (lambda m: None)

    survivors = list(trials)
    if prior is not None:
        for t in trials:
            try:
                t.predicted = prior(t.config)
            except Exception:
                t.predicted = None
        incumbent_pred = trials[0].predicted
        if incumbent_pred is not None and incumbent_pred > 0:
            floor = incumbent_pred / float(prune_factor)
            survivors = [
                t for t in trials
                if t is trials[0] or t.predicted is None
                or t.predicted >= floor]
            for t in trials:
                if t not in survivors:
                    t.pruned = True
            if len(survivors) < len(trials):
                say(f"prior pruned {len(trials) - len(survivors)}/"
                    f"{len(trials)} candidates (predicted < "
                    f"{floor:.4g}, incumbent {incumbent_pred:.4g})")

    if fidelities is None:
        fidelities = [2 ** r for r in range(max(1, int(rungs)))]

    def run_one(t: Trial, rung: int, fidelity: int) -> None:
        out = measure(t.config, fidelity)
        if isinstance(out, dict):
            t.measured = float(out["value"])
            if out.get("p99_ms") is not None:
                t.p99_ms = float(out["p99_ms"])
            t.compiles_measured += int(out.get("compiles", 0))
            tel = out.get("telemetry")
            if isinstance(tel, dict):
                t.telemetry.update(tel)
        else:
            t.measured = float(out)
        t.rung = rung

    for rung in range(max(1, int(rungs))):
        fidelity = int(fidelities[min(rung, len(fidelities) - 1)])
        measured_this_rung: List[Trial] = []
        for t in survivors:
            out_of_time = (deadline is not None
                           and time.monotonic() >= deadline)
            # the incumbent's first measurement is non-negotiable: a search
            # with no measured trial has no winner to return
            if out_of_time and not (t is trials[0] and t.rung < 0):
                break
            run_one(t, rung, fidelity)
            measured_this_rung.append(t)
        if not measured_this_rung:
            break
        survivors = sorted(
            measured_this_rung,
            key=lambda t: (-(t.measured if t.measured is not None
                             else -math.inf)))
        n_keep = max(1, int(math.ceil(len(survivors) * float(keep))))
        survivors = survivors[:n_keep]
        say(f"rung {rung} (fidelity {fidelity}): "
            f"{len(measured_this_rung)} measured, {n_keep} advance; "
            f"leader {survivors[0].measured:.4g}")
        if deadline is not None and time.monotonic() >= deadline:
            break
        if len(survivors) == 1 and rung + 1 < max(1, int(rungs)):
            # one survivor still gets its higher-fidelity confirmation run
            continue

    measured = [t for t in trials if t.measured is not None]
    best = max(measured, key=lambda t: t.measured)
    return best, trials


# --------------------------------------------------------------- workloads
def _sync(device) -> None:
    import torch  # noqa: PLC0415

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(net) -> None:
    """Drop ``net``'s captured graphs and their pool now, not when the
    collector finds the network: a search builds one network a trial."""
    import torch  # noqa: PLC0415

    from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415

    net._step_graphs.clear()  # noqa: SLF001
    get_compile_manager().drop_token(net._cm_token)  # noqa: SLF001
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class MlpFitWorkload:
    """Fit-objective workload: the bench MLP (784-1024-1024-10, Adam 1e-3)
    trained through the staged ``warmup``/``fit_on_device`` path, one
    captured step replayed per update, so the capture pin is real.

    Objective: ``train_samples_per_sec`` (higher is better). No prior:
    every candidate is measured (module doc).
    """

    objective = "fit"
    metric = "train_samples_per_sec"

    def __init__(self, hidden: int = 1024, features: int = 784,
                 classes: int = 10, seed: int = 42, device="cuda"):
        self.hidden = int(hidden)
        self.features = int(features)
        self.classes = int(classes)
        self.seed = int(seed)
        self.device = device
        self._key: Optional[str] = None

    def default_config(self) -> Dict[str, object]:
        return {"train_batch": 512, "stage_window": 4,
                "telemetry_fetch_every": 10,
                "precision_params_dtype": "bfloat16"}

    def space(self) -> Dict[str, Sequence]:
        return {"train_batch": (32, 256, 512),
                "stage_window": (2, 4, 8),
                "telemetry_fetch_every": (10, 50)}

    # ------------------------------------------------------------ plumbing
    def conf(self, dtype: str = "bfloat16"):
        from ..nn.conf.inputs import InputType  # noqa: PLC0415
        from ..nn.conf.multi_layer import MultiLayerConfiguration  # noqa: PLC0415
        from ..nn.layers.dense import DenseLayer, OutputLayer  # noqa: PLC0415
        from ..nn.updaters import UpdaterConfig  # noqa: PLC0415

        return MultiLayerConfiguration(
            layers=[
                DenseLayer(n_out=self.hidden, activation="relu"),
                DenseLayer(n_out=self.hidden, activation="relu"),
                OutputLayer(n_out=self.classes, activation="softmax",
                            loss="mcxent"),
            ],
            input_type=InputType.feed_forward(self.features),
            updater=UpdaterConfig(updater="adam", learning_rate=1e-3),
            dtype=dtype,
            seed=self.seed,
        )

    def _build_net(self, dtype: str):
        from ..nn.multilayer import MultiLayerNetwork  # noqa: PLC0415

        return MultiLayerNetwork(self.conf(dtype), device=self.device)

    def key(self) -> str:
        """The TUNED.json key of this workload's model (cached — the conf
        signature does not depend on the tuned knobs)."""
        if self._key is None:
            self._key = tuned_store.key_for(self._build_net("bfloat16"))
        return self._key

    def prior(self, config: Dict[str, object]) -> Optional[float]:
        return None

    def batches(self, batch: int, stage: int):
        """The staged window a trial trains on: ``[stage, batch, ...]``
        features and one-hot labels, from a fixed seed."""
        import numpy as np  # noqa: PLC0415

        rng = np.random.default_rng(0)
        xs = np.stack([
            rng.normal(size=(batch, self.features)).astype(np.float32)
            for _ in range(stage)])
        ys = np.stack([
            np.eye(self.classes, dtype=np.float32)[
                rng.integers(0, self.classes, size=batch)]
            for _ in range(stage)])
        return xs, ys

    def measure(self, config: Dict[str, object], fidelity: int) -> dict:
        """One trial: ``fidelity`` timed staged windows, capture-pinned.

        Warm path: ``net.warmup`` captures the step ahead, one settle
        window absorbs first-touch costs, then the timed loop runs with
        the capture counter pinned to zero.
        """
        from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415
        from ..telemetry import MetricsRegistry, Telemetry  # noqa: PLC0415
        from ..telemetry.memory import network_pool_bytes  # noqa: PLC0415

        with EnvScope() as scope:
            args = apply_config(config, scope)
            batch = int(args.get("train_batch", 512))
            stage = int(args.get("stage_window", 4))
            fetch_every = int(args.get("telemetry_fetch_every", 10))
            dtype = str(args.get("precision_params_dtype", "bfloat16"))

            net = self._build_net(dtype).init()
            try:
                net.set_telemetry(Telemetry(registry=MetricsRegistry(),
                                            fetch_every=fetch_every))
                xs, ys = self.batches(batch, stage)
                cm = get_compile_manager()
                c_warm0 = cm.compiles.value
                net.warmup(xs, ys)          # capture-ahead (counted, expected)
                net.fit_on_device(xs, ys)   # settle: first-touch transfers
                warm_compiles = cm.compiles.value - c_warm0

                def timed_loop() -> Tuple[float, int]:
                    c0 = cm.compiles.value
                    _sync(net.device)
                    t0 = time.perf_counter()
                    for _ in range(max(1, int(fidelity))):
                        net.fit_on_device(xs, ys)
                    _sync(net.device)
                    return time.perf_counter() - t0, cm.compiles.value - c0

                dt, compiled = timed_loop()
                if compiled:
                    # a stray capture poisons the sample: re-run once
                    dt, compiled = timed_loop()
                if compiled:
                    raise RuntimeError(
                        f"trial {config} captured {compiled} program(s) "
                        "inside the timed region twice — steady state "
                        "unmeasurable")
                steps = max(1, int(fidelity)) * stage
                return {
                    "value": steps * batch / dt,
                    "compiles": compiled,
                    "telemetry": {
                        "warm_compiles": int(warm_compiles),
                        "pool_bytes": network_pool_bytes(net),
                        "step_ms": round(1000.0 * dt / steps, 4),
                    },
                }
            finally:
                release(net)


class ServeWorkload:
    """Serve-objective workload: offered load through a fresh
    ``InferenceService`` + exact p99 from the recent-latency ring.

    Objective: served samples/sec (higher is better); ``p99_ms`` rides
    along in each trial for the human reading the result. No prior —
    every candidate is measured.
    """

    objective = "serve"
    metric = "offered_load_samples_per_sec"

    def __init__(self, hidden: int = 128, features: int = 32,
                 classes: int = 8, seed: int = 7, device="cuda"):
        self._fit = MlpFitWorkload(hidden=hidden, features=features,
                                   classes=classes, seed=seed, device=device)
        self.features = int(features)
        self._key: Optional[str] = None

    def default_config(self) -> Dict[str, object]:
        return {"serve_max_delay_ms": 2.0, "serve_max_batch": 64}

    def space(self) -> Dict[str, Sequence]:
        return {"serve_max_delay_ms": (0.0, 1.0, 2.0, 5.0),
                "serve_max_batch": (32, 64, 128)}

    def key(self) -> str:
        if self._key is None:
            self._key = tuned_store.key_for(self._fit._build_net("float32"))
        return self._key

    def prior(self, config: Dict[str, object]) -> Optional[float]:
        return None

    def measure(self, config: Dict[str, object], fidelity: int) -> dict:
        import numpy as np  # noqa: PLC0415
        from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

        from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415
        from ..serving import InferenceService  # noqa: PLC0415
        from ..telemetry import MetricsRegistry  # noqa: PLC0415

        requests = 64 * max(1, int(fidelity))
        delay = float(config.get("serve_max_delay_ms", 2.0))
        rows_cap = int(config.get("serve_max_batch", 64))
        net = self._fit._build_net("float32")
        service = InferenceService(registry=MetricsRegistry(),
                                   max_delay_ms=delay, max_batch=rows_cap)
        try:
            service.register("tune", net)
            example = np.zeros((1, self.features), np.float32)
            cm = get_compile_manager()
            service.warmup("tune", example)
            rng = np.random.default_rng(3)
            payloads = [rng.normal(size=(int(r), self.features))
                        .astype(np.float32)
                        for r in rng.choice((1, 2, 4, 8), size=requests)]
            # settle one request, then pin captures across the offered load
            service.predict("tune", payloads[0])
            c0 = cm.compiles.value
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(lambda p: service.predict("tune", p),
                              payloads))
            dt = time.perf_counter() - t0
            compiled = cm.compiles.value - c0
            if compiled:
                raise RuntimeError(
                    f"serve trial {config} captured {compiled} program(s) "
                    "under load — warmup did not cover the bucket family")
            rows = sum(int(p.shape[0]) for p in payloads)
            st = service.stats()["models"]["tune"]
            p99 = st["latency_seconds"]["p99"]
            return {
                "value": rows / dt,
                "p99_ms": None if p99 is None else 1000.0 * float(p99),
                "compiles": compiled,
                "telemetry": {
                    "requests": requests,
                    "mean_batch_fill_ratio": st["mean_batch_fill_ratio"],
                },
            }
        finally:
            for name in list(service.models()):
                service.unregister(name)
            service.stop()
            release(net)


_WORKLOADS = {
    ("mlp", "fit"): MlpFitWorkload,
    ("mlp", "serve"): ServeWorkload,
}


def run_autotune(
    model: str = "mlp",
    objective: str = "fit",
    budget_s: float = 60.0,
    *,
    space: Optional[Dict[str, Sequence]] = None,
    workload=None,
    rungs: int = 2,
    keep: float = 0.5,
    prune_factor: float = 2.0,
    fidelities: Optional[Sequence[int]] = None,
    store_path: Optional[str] = None,
    persist: bool = True,
    log: Optional[Callable[[str], None]] = None,
    device=None,
) -> SearchResult:
    """The autopilot entry point: search, verify env hygiene, persist.

    Snapshots ``os.environ`` before the search and asserts bit-identical
    restoration after — a search that leaked tuning state raises instead
    of returning a winner. The winning config persists to ``TUNED.json``
    (``store_path`` or the default location) under the workload model's
    (signature, backend, topology) key, where the startup auto-apply hooks
    find it. ``device`` (default ``"cuda"``) is where a workload named by
    ``model``/``objective`` runs; a ``workload`` passed in brings its own.
    """
    if workload is None:
        try:
            factory = _WORKLOADS[(model, objective)]
        except KeyError:
            raise ValueError(
                f"no workload for model={model!r} objective={objective!r}; "
                f"available: {sorted(_WORKLOADS)}") from None
        workload = factory(device="cuda" if device is None else device)
    env_before = dict(os.environ)
    t_start = time.monotonic()
    default = workload.default_config()
    candidates = [default]
    for cand in grid(workload.space() if space is None else space):
        merged = {**default, **cand}
        if _config_key(merged) != _config_key(default) and all(
                _config_key(merged) != _config_key(c) for c in candidates):
            candidates.append(merged)
    deadline = t_start + parse_budget(budget_s)
    best, trials = successive_halving(
        candidates, workload.measure, prior=workload.prior,
        prune_factor=prune_factor, rungs=rungs, keep=keep,
        fidelities=fidelities, deadline=deadline, log=log)
    elapsed = time.monotonic() - t_start
    env_ok = dict(os.environ) == env_before
    if not env_ok:
        changed = {k for k in set(env_before) | set(os.environ)
                   if env_before.get(k) != os.environ.get(k)}
        raise RuntimeError(
            "autopilot leaked process env state; changed vars: "
            f"{sorted(changed)}")
    key = None
    if persist:
        try:
            key = workload.key()
            measured = [t for t in trials if t.measured is not None]
            tuned_store.TunedStore(store_path).put(
                key, best.config, objective=workload.objective,
                metric=workload.metric, value=best.measured,
                trials=len(measured))
        except Exception:
            key = None  # persisting is best-effort; the result still stands
    default_trial = trials[0]
    return SearchResult(
        best=best, default=default_trial, trials=trials,
        objective=workload.objective, metric=workload.metric,
        env_ok=env_ok, key=key,
        store_path=(tuned_store.TunedStore(store_path).path
                    if persist else None),
        elapsed_s=elapsed)
