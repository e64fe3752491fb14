"""Graph embeddings (counterpart of ``deeplearning4j_tpu/graph_embeddings``;
reference: deeplearning4j-graph — SURVEY.md §2.6)."""

from .graph import Vertex, Edge, IGraph, Graph
from .walks import (
    RandomWalkIterator,
    WeightedRandomWalkIterator,
    generate_walks,
    EXCEPTION_ON_DISCONNECTED,
    SELF_LOOP_ON_DISCONNECTED,
    RESTART_ON_DISCONNECTED,
)
from .deepwalk import DeepWalk, GraphVectors, GraphHuffman
from .loader import (
    load_undirected_graph_edge_list,
    load_weighted_edge_list,
    load_adjacency_list,
)

__all__ = [
    "Vertex", "Edge", "IGraph", "Graph",
    "RandomWalkIterator", "WeightedRandomWalkIterator", "generate_walks",
    "EXCEPTION_ON_DISCONNECTED", "SELF_LOOP_ON_DISCONNECTED",
    "RESTART_ON_DISCONNECTED",
    "DeepWalk", "GraphVectors", "GraphHuffman",
    "load_undirected_graph_edge_list", "load_weighted_edge_list",
    "load_adjacency_list",
]
