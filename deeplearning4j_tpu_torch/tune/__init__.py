"""The autotuner (counterpart of ``deeplearning4j_tpu/tune/``): knob
registry, search engine, tuned-config store.

- :mod:`~deeplearning4j_tpu_torch.tune.knobs` — every tunable surface of
  the port registers a typed knob (domain, default, cost hint, apply
  semantics); env-var knobs only ever apply through scoped setters that
  restore on exit.
- :mod:`~deeplearning4j_tpu_torch.tune.search` — successive halving over
  candidate configs, every one measured in short trials whose capture
  count inside the timed region is pinned to zero, so the search measures
  steady state.
- :mod:`~deeplearning4j_tpu_torch.tune.store` — winners persist as
  ``TUNED.json`` keyed by (model signature, backend, topology);
  ``fit``/``warmup``/``InferenceService.register``/``OnlineTrainer``
  auto-apply a matching entry at startup (explicit user settings always
  win).

CLI: ``python -m deeplearning4j_tpu_torch.tune --model mlp --objective fit
--budget 60s`` (on the card; ``--device cpu`` asks for the CPU).
"""

from .knobs import EnvScope, Knob, all_knobs, get_knob, scoped_env
from .search import SearchResult, Trial, run_autotune, successive_halving
from .store import TunedStore, auto_apply, config_key, model_signature, tuned_path

__all__ = [
    "EnvScope",
    "Knob",
    "SearchResult",
    "Trial",
    "TunedStore",
    "all_knobs",
    "auto_apply",
    "config_key",
    "get_knob",
    "model_signature",
    "run_autotune",
    "scoped_env",
    "successive_halving",
    "tuned_path",
]
