"""Random-walk iterators over graphs.

Reference: deeplearning4j-graph iterator/RandomWalkIterator.java,
WeightedRandomWalkIterator.java + NoEdgeHandling modes
(api/NoEdgeHandling.java: EXCEPTION_ON_DISCONNECTED / SELF_LOOP_ON_DISCONNECTED /
RESTART_ON_DISCONNECTED …), parallel providers (iterator/parallel/).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .graph import IGraph

EXCEPTION_ON_DISCONNECTED = "exception"
SELF_LOOP_ON_DISCONNECTED = "self_loop"
RESTART_ON_DISCONNECTED = "restart"


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex (reference:
    RandomWalkIterator.java — one walk starting at each vertex per pass, in
    shuffled order)."""

    def __init__(self, graph: IGraph, walk_length: int, seed: int = 0,
                 no_edge_handling: str = SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.no_edge_handling = no_edge_handling
        self._rng = np.random.default_rng(seed)
        self.reset()

    def reset(self) -> None:
        self._order = self._rng.permutation(self.graph.num_vertices())
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def _choose_next(self, cur: int, start: int) -> Optional[int]:
        nbrs = self.graph.get_connected_vertex_indices(cur)
        if not nbrs:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise RuntimeError(f"vertex {cur} is disconnected")
            if self.no_edge_handling == SELF_LOOP_ON_DISCONNECTED:
                return cur
            return start  # restart
        return int(nbrs[self._rng.integers(len(nbrs))])

    def next_walk(self) -> List[int]:
        start = int(self._order[self._pos])
        self._pos += 1
        walk = [start]
        cur = start
        for _ in range(self.walk_length - 1):
            cur = self._choose_next(cur, start)
            walk.append(cur)
        return walk

    def __iter__(self) -> Iterator[List[int]]:
        self.reset()
        while self.has_next():
            yield self.next_walk()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Transition probability ∝ edge weight (reference:
    WeightedRandomWalkIterator.java)."""

    def _choose_next(self, cur: int, start: int) -> Optional[int]:
        edges = self.graph.get_edges_out(cur)
        if not edges:
            return super()._choose_next(cur, start)
        weights = np.array([e.weight for e in edges], np.float64)
        probs = weights / weights.sum()
        return int(edges[self._rng.choice(len(edges), p=probs)].dst)


def generate_walks(graph: IGraph, walk_length: int, walks_per_vertex: int = 1,
                   weighted: bool = False, seed: int = 0) -> List[List[int]]:
    """Multi-pass walk corpus (reference: the parallel GraphWalkIteratorProvider
    role — passes replace threads; generation is trivially parallelizable)."""
    cls = WeightedRandomWalkIterator if weighted else RandomWalkIterator
    walks: List[List[int]] = []
    for pass_i in range(walks_per_vertex):
        it = cls(graph, walk_length, seed=seed + pass_i)
        walks.extend(it)
    return walks
