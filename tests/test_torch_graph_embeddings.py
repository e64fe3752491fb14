"""The port's graph embeddings (``deeplearning4j_tpu_torch/graph_embeddings``)
against the JAX package's, on ``device="cpu"``.

Graphs, loaders, walks and the degree Huffman tree are host copies: equal
to JAX's exactly for the same seed. DeepWalk trains the port's
SequenceVectors (HS) on the same walks: its vectors are held at
``TABLE_REL`` of their largest element (the device step's sums in another
order). ``GraphVectors`` files go both ways between the packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu.graph_embeddings as jg  # noqa: E402

import deeplearning4j_tpu_torch.graph_embeddings as pg  # noqa: E402

TABLE_REL = 2e-6


def two_cliques(m, k=5):
    """Two k-cliques joined by one bridge edge, and a vertex with no edge."""
    g = m.Graph(2 * k + 1)
    for a in range(k):
        for b in range(a + 1, k):
            g.add_edge(a, b)
            g.add_edge(k + a, k + b)
    g.add_edge(0, k)
    return g


def test_graphs_and_loaders_equal_jaxs(tmp_path):
    (tmp_path / "e.txt").write_text("# edges\n0 1\n1 2\n2 0\n3 4\n")
    (tmp_path / "w.txt").write_text("0 1 0.5\n1 2 2.0\n2 3 1.0\n")
    (tmp_path / "a.txt").write_text("0 1 2\n1 2\n3 0\n")
    for loader, args in (("load_undirected_graph_edge_list", ("e.txt", 5)),
                         ("load_weighted_edge_list", ("w.txt", 4)),
                         ("load_adjacency_list", ("a.txt",))):
        path = str(tmp_path / args[0])
        got = getattr(pg, loader)(path, *args[1:])
        want = getattr(jg, loader)(path, *args[1:])
        assert got.num_vertices() == want.num_vertices()
        for v in range(want.num_vertices()):
            assert ([(e.src, e.dst, e.weight, e.directed) for e in got.get_edges_out(v)]
                    == [(e.src, e.dst, e.weight, e.directed) for e in want.get_edges_out(v)])
    g = pg.Graph(3, allow_multiple_edges=False)
    g.add_edge(0, 1)
    g.add_edge(0, 1)
    assert g.get_vertex_degree(0) == 1
    with pytest.raises(ValueError):
        g.add_edge(0, 3)


@pytest.mark.parametrize("handling", ["self_loop", "restart"])
def test_walks_equal_jaxs(handling):
    graphs = {m: two_cliques(m) for m in (jg, pg)}
    for pw, jw in ((pg.RandomWalkIterator(graphs[pg], 6, seed=3, no_edge_handling=handling),
                    jg.RandomWalkIterator(graphs[jg], 6, seed=3, no_edge_handling=handling)),):
        assert list(pw) == list(jw)
    w = {m: m.Graph(4) for m in (jg, pg)}
    for m, g in w.items():
        g.add_edge(0, 1, weight=5.0)
        g.add_edge(0, 2, weight=0.5)
        g.add_edge(2, 3, weight=1.0)
    assert (list(pg.WeightedRandomWalkIterator(w[pg], 8, seed=1))
            == list(jg.WeightedRandomWalkIterator(w[jg], 8, seed=1)))
    assert (pg.generate_walks(graphs[pg], 5, 3, seed=2)
            == jg.generate_walks(graphs[jg], 5, 3, seed=2))
    with pytest.raises(RuntimeError):
        list(pg.RandomWalkIterator(graphs[pg], 4, seed=0,
                                   no_edge_handling=pg.EXCEPTION_ON_DISCONNECTED))


def test_degree_huffman_equals_jaxs():
    got = pg.GraphHuffman.from_graph(two_cliques(pg)).words
    want = jg.GraphHuffman.from_graph(two_cliques(jg)).words
    assert [(w.word, w.count, w.codes, w.points) for w in got] == [
        (w.word, w.count, w.codes, w.points) for w in want]


def test_deepwalk_follows_jax_and_vectors_go_both_ways(tmp_path):
    kw = dict(vector_size=12, window=3, walk_length=8, walks_per_vertex=4, batch_size=64,
              seed=5)
    want = jg.DeepWalk(**kw).fit(two_cliques(jg))
    got = pg.DeepWalk(device="cpu", **kw).fit(two_cliques(pg))
    assert got.vectors.shape == want.vectors.shape
    assert (np.abs(got.vectors - want.vectors).max()
            <= TABLE_REL * np.abs(want.vectors).max())
    assert got.vertices_nearest(1, 3) == want.vertices_nearest(1, 3)
    assert got.similarity(1, 2) == pytest.approx(want.similarity(1, 2), rel=1e-5)
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "jax"))
    np.testing.assert_array_equal(pg.GraphVectors.load(str(tmp_path / "jax")).vectors,
                                  want.vectors)
    np.testing.assert_array_equal(jg.GraphVectors.load(str(tmp_path / "port.npz")).vectors,
                                  got.vectors)


def test_deepwalk_default_device_is_the_card():
    if torch.cuda.is_available():
        assert pg.DeepWalk().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pg.DeepWalk()
