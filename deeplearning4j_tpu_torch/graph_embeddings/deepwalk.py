"""DeepWalk graph embeddings + GraphVectors query API (counterpart of
``deeplearning4j_tpu/graph_embeddings/deepwalk.py``).

Reference: deeplearning4j-graph models/deepwalk/DeepWalk.java (skip-gram over
random walks, hierarchical softmax via its own GraphHuffman tree keyed on
vertex degree — models/deepwalk/GraphHuffman.java), models/GraphVectors.java,
models/embeddings/GraphVectorsImpl.java + GraphVectorSerializer.

The skip-gram/HS math is word2vec's, so DeepWalk trains the port's
SequenceVectors (nlp/sequence_vectors.py, HS only) on the model's device,
vertex ids as tokens. GraphHuffman remains as the degree-weighted tree
builder for parity. ``GraphVectors.save`` writes the JAX module's ``.npz``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..nn.multilayer import resolve_device
from ..nlp.sequence_vectors import Sequence, SequenceVectors
from ..nlp.vocab import Huffman, VocabWord
from .graph import IGraph
from .walks import generate_walks


class GraphHuffman(Huffman):
    """Reference: models/deepwalk/GraphHuffman.java — Huffman tree over vertex
    degrees (walk-visit frequency is proportional to degree for uniform walks,
    so the trees coincide in expectation)."""

    @staticmethod
    def from_graph(graph: IGraph) -> "GraphHuffman":
        words = [
            VocabWord(word=str(i), count=max(graph.get_vertex_degree(i), 1), index=i)
            for i in range(graph.num_vertices())
        ]
        h = GraphHuffman(words)
        h.build()
        return h


class GraphVectors:
    """Query API over learned vertex embeddings (reference:
    models/GraphVectors.java / GraphVectorsImpl.java)."""

    def __init__(self, graph: IGraph, vectors: np.ndarray):
        self.graph = graph
        self.vectors = np.asarray(vectors, np.float32)

    def num_vertices(self) -> int:
        return self.vectors.shape[0]

    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self.vectors[idx]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.vectors[a], self.vectors[b]
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom > 0 else 0.0

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        v = self.vectors[idx]
        norms = np.linalg.norm(self.vectors, axis=1) * max(np.linalg.norm(v), 1e-12)
        sims = (self.vectors @ v) / np.maximum(norms, 1e-12)
        order = [int(i) for i in np.argsort(-sims) if i != idx]
        return order[:top_n]

    # ---- serialization (reference: GraphVectorSerializer) ----
    def save(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 vectors=self.vectors)

    @staticmethod
    def load(path: str, graph: Optional[IGraph] = None) -> "GraphVectors":
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        return GraphVectors(graph, data["vectors"])


class DeepWalk:
    """Reference: models/deepwalk/DeepWalk.java Builder — vectorSize,
    windowSize, learningRate, + fit(walk iterator). ``device`` defaults to
    the card; without CUDA it raises unless ``device="cpu"``."""

    def __init__(self, vector_size: int = 100, window: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 weighted_walks: bool = False, batch_size: int = 512,
                 seed: int = 12345, device="cuda"):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window = window
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.weighted_walks = weighted_walks
        self.batch_size = batch_size
        self.seed = seed
        self._engine: Optional[SequenceVectors] = None
        self.graph: Optional[IGraph] = None

    def fit(self, graph: IGraph) -> GraphVectors:
        self.graph = graph
        walks = generate_walks(
            graph, self.walk_length, self.walks_per_vertex,
            weighted=self.weighted_walks, seed=self.seed,
        )
        return self.fit_walks(graph, walks)

    def fit_walks(self, graph: IGraph, walks) -> GraphVectors:
        """Reference: DeepWalk.fit(GraphWalkIterator) — train on explicit walks."""
        self.graph = graph
        sequences = [Sequence(elements=[str(v) for v in walk]) for walk in walks]
        self._engine = SequenceVectors(
            layer_size=self.vector_size, window=self.window,
            learning_rate=self.learning_rate, epochs=self.epochs,
            batch_size=self.batch_size, seed=self.seed,
            use_hs=True, negative=0, min_word_frequency=1, device=self.device,
        )
        self._engine.fit(sequences)
        # map engine vocab rows back to vertex-id order
        vecs = np.zeros((graph.num_vertices(), self.vector_size), np.float32)
        for i in range(graph.num_vertices()):
            v = self._engine.get_word_vector(str(i))
            if v is not None:
                vecs[i] = v
        return GraphVectors(graph, vecs)
