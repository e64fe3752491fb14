"""Runtime of the port (counterpart of ``deeplearning4j_tpu/runtime``): the
process-wide cache of captured programs and the capture rule
(``compile_manager``), the captured training steps of the staged loop
(``step_graphs``), the bucketed inference path replayed as CUDA graphs
(``inference``), the typed failure policies (``resilience``), the versioned
checkpoint store (``checkpoint``) and the online trainer (``online``). The
JAX package's C++ batch loader (``native_loader``) comes with ROADMAP Queue
1 item 6."""

import importlib

# name -> submodule; resolved at first access (PEP 562), since the datasets
# and networks import runtime submodules while this package initializes
_EXPORTS = {
    "CheckpointCorruptError": "checkpoint", "CheckpointInfo": "checkpoint",
    "CheckpointStore": "checkpoint",
    "CaptureLock": "compile_manager", "CompileManager": "compile_manager",
    "capture_lock": "compile_manager", "get_compile_manager": "compile_manager",
    "canonicalize_input": "inference", "fast_path_enabled": "inference",
    "OnlineTrainer": "online", "clear_online_trainers": "online",
    "get_online_trainers": "online",
    "CircuitBreaker": "resilience", "Deadline": "resilience",
    "DeadlinePolicy": "resilience", "RetryError": "resilience",
    "RetryPolicy": "resilience", "clear_sites": "resilience",
    "get_site": "resilience", "register_site": "resilience",
    "resilience_stats": "resilience",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))


__all__ = [
    "CaptureLock",
    "CheckpointCorruptError",
    "CheckpointInfo",
    "CheckpointStore",
    "CircuitBreaker",
    "CompileManager",
    "Deadline",
    "DeadlinePolicy",
    "OnlineTrainer",
    "RetryError",
    "RetryPolicy",
    "canonicalize_input",
    "capture_lock",
    "clear_online_trainers",
    "clear_sites",
    "fast_path_enabled",
    "get_compile_manager",
    "get_online_trainers",
    "get_site",
    "register_site",
    "resilience_stats",
]
