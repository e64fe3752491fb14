"""Graph data structures.

Reference: deeplearning4j-graph graph/api/IGraph.java, graph/Graph.java,
api/Vertex.java, api/Edge.java (SURVEY.md §2.6). Adjacency-list graph with
optional edge weights and direction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, List, Optional, TypeVar

T = TypeVar("T")


@dataclass
class Vertex(Generic[T]):
    """Reference: api/Vertex.java — index + attached value."""

    idx: int
    value: Optional[T] = None


@dataclass
class Edge:
    """Reference: api/Edge.java."""

    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False


class IGraph:
    """Reference: graph/api/IGraph.java."""

    def num_vertices(self) -> int:
        raise NotImplementedError

    def get_vertex(self, idx: int) -> Vertex:
        raise NotImplementedError

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        raise NotImplementedError

    def get_vertex_degree(self, idx: int) -> int:
        raise NotImplementedError


class Graph(IGraph):
    """Reference: graph/Graph.java — list-of-edge-lists; undirected edges are
    stored on both endpoints."""

    def __init__(self, num_vertices: int, values: Optional[List[Any]] = None,
                 allow_multiple_edges: bool = True):
        self._vertices = [
            Vertex(i, values[i] if values else None) for i in range(num_vertices)
        ]
        self._edges: List[List[Edge]] = [[] for _ in range(num_vertices)]
        self.allow_multiple_edges = allow_multiple_edges

    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def add_edge(self, src: int, dst: int, weight: float = 1.0,
                 directed: bool = False) -> None:
        n = self.num_vertices()
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"edge ({src},{dst}) out of range [0,{n})")
        if not self.allow_multiple_edges and any(
            e.dst == dst for e in self._edges[src]
        ):
            return
        e = Edge(src, dst, weight, directed)
        self._edges[src].append(e)
        if not directed and src != dst:
            self._edges[dst].append(Edge(dst, src, weight, directed))

    def get_edges_out(self, idx: int) -> List[Edge]:
        return list(self._edges[idx])

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return [e.dst for e in self._edges[idx]]

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._edges[idx])
