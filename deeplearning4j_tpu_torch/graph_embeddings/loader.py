"""Graph loaders (reference: deeplearning4j-graph data/GraphLoader.java —
edge-list, weighted edge-list, adjacency-list file formats)."""

from __future__ import annotations

from typing import Optional

from .graph import Graph


def load_undirected_graph_edge_list(path: str, num_vertices: int,
                                    delimiter: Optional[str] = None) -> Graph:
    """Lines "src dst" (reference: GraphLoader.loadUndirectedGraphEdgeListFile)."""
    g = Graph(num_vertices)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            g.add_edge(int(parts[0]), int(parts[1]))
    return g


def load_weighted_edge_list(path: str, num_vertices: int, directed: bool = False,
                            delimiter: Optional[str] = None) -> Graph:
    """Lines "src dst weight" (reference: GraphLoader.loadWeightedEdgeListFile)."""
    g = Graph(num_vertices)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            g.add_edge(int(parts[0]), int(parts[1]), weight=float(parts[2]),
                       directed=directed)
    return g


def load_adjacency_list(path: str, num_vertices: Optional[int] = None,
                        delimiter: Optional[str] = None) -> Graph:
    """Lines "vertex nbr1 nbr2 ..." (reference: GraphLoader adjacency format)."""
    rows = []
    max_v = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [int(p) for p in line.split(delimiter)]
            rows.append(parts)
            max_v = max(max_v, *parts)
    g = Graph(num_vertices if num_vertices is not None else max_v + 1)
    for parts in rows:
        src = parts[0]
        for dst in parts[1:]:
            g.add_edge(src, dst, directed=True)
    return g
