"""Captured training steps (the staged loop's part of
``deeplearning4j_tpu/runtime/compile_manager.py``; the port's own
``runtime/compile_manager.py`` is the process-wide cache they live in).

The JAX package compiles its staged loop (``fit_on_device``: a whole window
of updates in one dispatch) once per abstract signature and keeps the
executable in a bounded cache. The port's counterpart is a CUDA graph of one
training step, captured once per signature (``runtime.compile_manager``'s
``signature``) and replayed once per update:

- :class:`StepGraphs` is one network's cache of captured steps
  (:class:`StepGraph`), keyed by what fixes a graph (the batch's shapes and
  dtypes, which masks are present, the updater's form), bounded: the least
  recently used graph is dropped first. Every graph of a network allocates
  from one shared memory pool, so the buckets of a ragged epoch share their
  activations' memory instead of holding one pool each. Each graph is also
  an entry of the process-wide compile manager (kind ``train_step``, under
  the network's token): its capture is counted and timed there, a lookup
  is a cache hit, and the manager's LRU may drop it too.

A replay launches the kernels that the capture recorded; the op modules'
``launches`` counters count once, at the capture, so the cache counts
replays (``replays``) and each graph keeps the launches its capture made
and its own replays, so that a kernel's launches on the card are its
launches a replay times the replays.
XLA's persistent disk cache has no counterpart here. Nothing here touches
the card until a network asks for a graph.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .compile_manager import get_compile_manager

__all__ = ["StepGraph", "StepGraphs"]

# captured steps a network keeps (a ragged epoch's time buckets each need one)
CAPACITY = 4

# the kind under which the process-wide compile manager holds them
KIND = "train_step"


@dataclass
class StepGraph:
    """One captured training step: the static buffers it reads (``batch``,
    one device tensor or None per input, label and mask; ``scalars``, the
    step's row of the updater's scalar table), the loss tensor it writes,
    and, on the card, the graph, the kernel launches its capture counted
    (those of one replay) and its replays."""

    batch: List[Optional[Any]]
    scalars: Any
    loss: Any = None
    graph: Any = None
    pool: Any = None  # the network's step-graph pool (telemetry.executable_memory reads it)
    launches: Dict[str, int] = field(default_factory=dict)
    replays: int = 0


class StepGraphs:
    """A network's captured steps by :func:`signature`, at most ``CAPACITY``
    of them (the least recently used is dropped), with the memory pool they
    share and the count of replays. ``token`` is the owner's compile-manager
    token (set by the network at each ``init``); each graph is held by the
    process-wide manager under it as well."""

    def __init__(self):
        self._entries: "OrderedDict[Tuple, StepGraph]" = OrderedDict()
        self.pool = None  # the first graph's pool, handed to every later capture
        self.replays = 0
        self.token = None

    def _cm_key(self, key: Tuple) -> Tuple:
        return (self.token, KIND, key)

    def get(self, key: Tuple) -> Optional[StepGraph]:
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            get_compile_manager().get(self._cm_key(key))
        return entry

    def put(self, key: Tuple, entry: StepGraph) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        get_compile_manager().put(self._cm_key(key), entry,
                                  on_evict=lambda: self._entries.pop(key, None))
        while len(self._entries) > CAPACITY:
            old, _ = self._entries.popitem(last=False)
            get_compile_manager().discard(self._cm_key(old))

    def admit(self, key: Tuple, build) -> StepGraph:
        """The graph for ``key``, made by ``build()`` on a miss (a capture,
        counted and timed by the compile manager)."""
        entry = self.get(key)
        if entry is None:
            entry = get_compile_manager().admit(
                self._cm_key(key), build, on_evict=lambda: self._entries.pop(key, None))
            self.put(key, entry)
        return entry

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every graph and the pool (the params they captured are
        gone, or they are no longer wanted)."""
        cm = get_compile_manager()
        for key in list(self._entries):
            cm.discard(self._cm_key(key))
        self._entries.clear()
        self.pool = None
