"""Captured training steps (counterpart of
``deeplearning4j_tpu/runtime/compile_manager.py``).

The JAX package compiles its staged loop (``fit_on_device``: a whole window
of updates in one dispatch) once per abstract signature and keeps the
executable in a bounded cache. The port's counterpart is a CUDA graph of one
training step, captured once per signature and replayed once per update:

- :func:`next_pow2` is the JAX package's bucket function (window sizes,
  time buckets);
- :func:`signature` is a cache key from hashables and nested tensors or
  arrays, each array standing for its shape and dtype only;
- :class:`StepGraphs` is one network's cache of captured steps
  (:class:`StepGraph`), keyed by what fixes a graph (the batch's shapes and
  dtypes, which masks are present, the updater's form), bounded: the least
  recently used graph is dropped first. Every graph of a network allocates
  from one shared memory pool, so the buckets of a ragged epoch share their
  activations' memory instead of holding one pool each.

A replay launches the kernels that the capture recorded; the op modules'
``launches`` counters count once, at the capture, so the cache counts
replays (``replays``) and each graph keeps the launches its capture made
and its own replays, so that a kernel's launches on the card are its
launches a replay times the replays.
XLA's AOT cache and its persistent disk cache have no counterpart here.
Nothing here touches the card until a network asks for a graph.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


__all__ = ["StepGraph", "StepGraphs", "next_pow2", "signature"]

# captured steps a network keeps (a ragged epoch's time buckets each need one)
CAPACITY = 4


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the window and time bucket
    function, so the set of shapes stays logarithmic in the sizes seen."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _part(x: Any):
    """One part of a key: a tensor or array by its shape and dtype, lists,
    tuples and dicts element by element, anything else as it is."""
    shape = getattr(x, "shape", None)
    if shape is not None and hasattr(x, "dtype"):
        return ("array", tuple(int(d) for d in shape), str(x.dtype))
    if isinstance(x, dict):
        return ("dict", tuple((k, _part(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_part(v) for v in x))
    return x


def signature(*parts) -> Tuple:
    """Canonical cache key from hashables and nested tensors or arrays
    (``None`` stands for an absent mask)."""
    return tuple(_part(p) for p in parts)


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
    launches: Dict[str, int] = field(default_factory=dict)
    replays: int = 0


class StepGraphs:
    """A network's captured steps by :func:`signature`, at most ``CAPACITY``
    of them (the least recently used is dropped), with the memory pool they
    share and the count of replays."""

    def __init__(self):
        self._entries: "OrderedDict[Tuple, StepGraph]" = OrderedDict()
        self.pool = None  # the first graph's pool, handed to every later capture
        self.replays = 0

    def get(self, key: Tuple) -> Optional[StepGraph]:
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key: Tuple, entry: StepGraph) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > CAPACITY:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every graph and the pool (the params they captured are
        gone: ``init`` made new ones)."""
        self._entries.clear()
        self.pool = None
