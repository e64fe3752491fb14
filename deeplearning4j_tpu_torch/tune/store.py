"""Tuned-config store (counterpart of ``deeplearning4j_tpu/tune/store.py``):
persist autotuner winners, auto-apply them at startup.

Winners persist as ``TUNED.json`` keyed by ``(model-signature, backend,
topology)``: the signature hashes the conf's JSON, which the port writes
as the JAX package does, so both packages key one conf alike; the backend
is the torch device type of the net's params (``cuda`` or ``cpu``); the
topology is ``d<torch.cuda.device_count()>`` on the card and ``d1`` on the
CPU (mesh layouts come with the parallelism item). The file lives at
``DL4JTPU_TUNED_PATH`` or in the user's cache dir (the JAX package's XLA
cache-dir branch has no counterpart: a CUDA graph is not saved).

Auto-apply contract (the startup half of the loop):

- ``fit`` / ``warmup`` / ``InferenceService.register`` / ``OnlineTrainer``
  call :func:`auto_apply` with their context; a matching entry's
  context-relevant knobs come back as arguments for the caller to use.
- **Explicit user settings always win**: a knob the caller received
  explicitly (constructor arg, or its env var set in the process
  environment) is passed in ``explicit`` and never overridden.
- Every application bumps ``dl4jtpu_tuned_config_applied_total`` (labelled
  by context) and rings a ``tuned_config_applied`` flight event; lookup or
  apply failures are swallowed — the autotuner must never break a training
  or serving startup. A net with no entry is untouched.

Schema (``TUNED.json``, the JAX package's)::

    {"version": 1,
     "configs": {
       "<sig12>/<backend>/<topology>": {
         "config": {"stage_window": 8, "telemetry_fetch_every": 20, ...},
         "objective": "fit", "metric": "train_samples_per_sec",
         "value": 6120.4, "trials": 9, "tuned_at": 1754300000.0}}}
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, Optional, Sequence

from .knobs import get_knob, validate_config

__all__ = [
    "TUNED_FILENAME",
    "TUNED_PATH_ENV",
    "TunedStore",
    "auto_apply",
    "backend_name",
    "config_key",
    "install_slice",
    "key_for",
    "model_signature",
    "topology_of",
    "tuned_path",
    "tuned_slice",
]

TUNED_FILENAME = "TUNED.json"
TUNED_PATH_ENV = "DL4JTPU_TUNED_PATH"  # explicit override, mostly for tests


def tuned_path() -> str:
    """Resolve the store location: explicit env override, else the user
    cache dir."""
    explicit = os.environ.get(TUNED_PATH_ENV)
    if explicit:
        return explicit
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "deeplearning4j_tpu_torch", TUNED_FILENAME)


def model_signature(net_or_conf) -> str:
    """Stable 12-hex digest of the model architecture (conf JSON) — the
    same config always keys the same tuned entry, across processes and
    across the two packages."""
    conf = getattr(net_or_conf, "conf", net_or_conf)
    text = conf.to_json()
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:12]


def _device_type(net) -> str:
    device = getattr(net, "device", None)
    if device is not None:
        return str(getattr(device, "type", device))
    import torch  # noqa: PLC0415

    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_name(net=None) -> str:
    """The torch device type of ``net``'s params (``cuda`` or ``cpu``);
    without a net, ``cuda`` where a card is visible."""
    return _device_type(net)


def topology_of(net=None) -> str:
    """``d<cards>`` on the card, ``d1`` on the CPU."""
    if _device_type(net) != "cuda":
        return "d1"
    import torch  # noqa: PLC0415

    return f"d{int(torch.cuda.device_count())}"


def config_key(sig: str, backend: str, topology: str) -> str:
    return f"{sig}/{backend}/{topology}"


def key_for(net) -> str:
    return config_key(model_signature(net), backend_name(net), topology_of(net))


class TunedStore:
    """One TUNED.json file: load tolerantly, write atomically, merge puts.

    ``put`` merges knob values into an existing entry's config (a fit-
    objective tune and a serve-objective tune of the same model coexist
    under one key); a malformed file on disk reads as empty rather than
    poisoning startup.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else tuned_path()
        self._lock = threading.Lock()

    # -------------------------------------------------------------- disk io
    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return {"version": 1, "configs": {}}
        if not isinstance(data, dict) or not isinstance(
                data.get("configs"), dict):
            return {"version": 1, "configs": {}}
        return data

    def _save(self, data: dict) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    # ---------------------------------------------------------------- api
    def get(self, key: str) -> Optional[dict]:
        entry = self._load()["configs"].get(key)
        return entry if isinstance(entry, dict) else None

    def keys(self):
        return sorted(self._load()["configs"])

    def put(self, key: str, config: Dict[str, object], *,
            objective: str = "fit", metric: str = "",
            value: Optional[float] = None,
            trials: Optional[int] = None) -> dict:
        validate_config(config)
        with self._lock:
            data = self._load()
            entry = data["configs"].setdefault(key, {"config": {}})
            merged = dict(entry.get("config") or {})
            merged.update(config)
            entry["config"] = merged
            entry["objective"] = objective
            if metric:
                entry["metric"] = metric
            if value is not None:
                entry["value"] = float(value)
            if trials is not None:
                entry["trials"] = int(trials)
            entry["tuned_at"] = time.time()
            self._save(data)
            return entry

    def lookup(self, net) -> Optional[dict]:
        configs = self._load()["configs"]
        if not configs:  # no file (the usual case): no signature to hash
            return None
        entry = configs.get(key_for(net))
        return entry if isinstance(entry, dict) else None


# ------------------------------------------------- warm-boot bundle slice
def tuned_slice(key: str, path: Optional[str] = None) -> Optional[dict]:
    """The raw TUNED.json entry for one config key — what a warm-boot
    bundle (``fleet/artifacts.py``) embeds so a fresh worker starts from
    the same tuned knobs as the process that built the bundle."""
    return TunedStore(path).get(key)


def install_slice(key: str, entry: dict,
                  path: Optional[str] = None) -> Optional[dict]:
    """Merge a bundle-carried TUNED.json slice into this process's store
    (validated, atomic, merge-on-put — same rules as the tuner's own
    writes). Returns the merged entry, or None when the slice is
    malformed/unknown-knobbed (a stale bundle must not poison startup)."""
    config = entry.get("config") if isinstance(entry, dict) else None
    if not isinstance(config, dict) or not config:
        return None
    try:
        return TunedStore(path).put(
            key, config,
            objective=str(entry.get("objective", "fit")),
            metric=str(entry.get("metric", "")),
            value=entry.get("value"),
            trials=entry.get("trials"))
    except Exception:  # noqa: BLE001 - tolerate foreign/stale slices
        return None


# ------------------------------------------------------------- auto-apply
def _applied_counter():
    from ..telemetry import get_registry  # noqa: PLC0415

    return get_registry().counter(
        "dl4jtpu_tuned_config_applied_total",
        "tuned-config knobs auto-applied at startup, by context",
        labelnames=("context",))


def auto_apply(net, context: str, explicit: Sequence[str] = (),
               path: Optional[str] = None) -> Dict[str, object]:
    """Return the tuned knob values for ``context``, minus any the caller
    marked explicit; apply in-place what can be applied here.

    Call-kind knobs come back for the caller to thread. An env knob's
    tuned value reaches the caller only where it doubles as a constructor
    argument (``serve_*`` in ``InferenceService.register``), when
    ``context`` lists it and the process env does not already set the var
    (env set by the user = explicit); env knobs are never written
    process-globally here.

    ``telemetry_fetch_every`` is applied directly (the net's attached
    Telemetry session, unless the user constructed it with an explicit
    cadence). Returns ``{}`` on any failure — startup never breaks.
    """
    try:
        entry = TunedStore(path).lookup(net)
        if not entry:
            return {}
        config = entry.get("config") or {}
        applied: Dict[str, object] = {}
        explicit = set(explicit)
        for name, value in config.items():
            try:
                knob = get_knob(name)
            except KeyError:
                continue  # a JAX-only knob, or a newer build's: skip
            if context not in knob.contexts or name in explicit:
                continue
            if knob.kind == "env":
                if os.environ.get(knob.env) is not None:
                    continue  # user's env setting wins
                applied[name] = value
                continue
            if name == "telemetry_fetch_every":
                tel = getattr(net, "telemetry", None)
                if tel is None or getattr(tel, "fetch_every_explicit", True):
                    continue
                tel.fetch_every = max(1, int(value))
                applied[name] = value
                continue
            applied[name] = value
        if applied:
            try:
                _applied_counter().labels(context=context).inc(len(applied))
                from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

                get_flight_recorder().record(
                    "tuned_config_applied", context=context,
                    key=key_for(net), knobs=sorted(applied))
            except Exception:  # noqa: BLE001 - observability never breaks auto-apply
                pass
        return applied
    except Exception:  # noqa: BLE001 - startup never breaks
        return {}
