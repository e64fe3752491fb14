"""The port's clustering (``clustering/trees.py``, ``clustering/kmeans.py``)
and t-SNE (``plot/tsne.py``) against the JAX package's (the cases of
``tests/test_clustering_tsne.py``).

The trees are host numpy copies: their answers equal JAX's exactly. k-means
runs on ``device="cpu"`` here: its kmeans++ start equals JAX's exactly, its
centers at ``CENTER_ATOL`` (f32 sums in another order) and its assignments
exactly. Exact t-SNE in float64 (the JAX side under the tests' x64) is held
at ``TSNE_ATOL`` after k iterations, across the early-exaggeration stop and
the momentum switch; in float32 (JAX with x64 off) at ``TSNE_F32_REL`` of
the embedding's extent after a few. The step is chaotic (in float64 the two
packages part by 1e-10 after 10 iterations and by the embedding's size
after 60; float32 against float64 the same by 20), so only the first
iterations can be held elementwise. Barnes-Hut is the JAX package's numpy
on both sides: equal exactly. N stays at or under 200.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.clustering import kmeans as jkmeans  # noqa: E402
from deeplearning4j_tpu.clustering import trees as jtrees  # noqa: E402
from deeplearning4j_tpu.plot import tsne as jtsne  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.clustering import (KDTree, KMeansClustering, QuadTree,  # noqa: E402
                                                 SPTree, VPTree)
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne  # noqa: E402
from deeplearning4j_tpu_torch.plot import tsne as ptsne  # noqa: E402

CENTER_ATOL = 1e-5
TSNE_ATOL = 1e-10
TSNE_F32_REL = 1e-5  # of the embedding's largest coordinate


def _blobs(n_per=40, k=3, d=5, seed=0, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    x = np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers])
    return x, np.repeat(np.arange(k), n_per)


# ------------------------------------------------------------------ trees
def test_kdtree_and_vptree_answers_equal_jaxs():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(120, 3))
    for mine, theirs in ((KDTree(pts), jtrees.KDTree(pts)),
                         (VPTree(pts, seed=3), jtrees.VPTree(pts, seed=3)),
                         (VPTree(pts, distance="cosine"), jtrees.VPTree(pts, distance="cosine"))):
        for q in rng.normal(size=(10, 3)):
            assert mine.knn(q, 7) == theirs.knn(q, 7)
    brute = np.argsort(np.linalg.norm(pts - pts[5], axis=1))[:4].tolist()
    assert [i for i, _ in KDTree(pts).knn(pts[5], 4)] == brute
    assert KDTree(pts).nn(pts[9])[0] == 9


def test_sptree_forces_equal_jaxs():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(60, 2))
    pts[7] = pts[3]  # a duplicate point
    mine, theirs = SPTree(pts), jtrees.SPTree(pts)
    np.testing.assert_array_equal(mine.root.com, theirs.root.com)
    assert mine.root.n_points == theirs.root.n_points == 60
    for i in range(60):
        for theta in (0.0, 0.5):
            a, b = mine.compute_non_edge_forces(i, theta), theirs.compute_non_edge_forces(i, theta)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    np.testing.assert_array_equal(QuadTree(pts).root.com, jtrees.QuadTree(pts).root.com)
    with pytest.raises(ValueError, match="2-D"):
        QuadTree(rng.normal(size=(5, 3)))
    three = rng.normal(size=(30, 3))
    np.testing.assert_array_equal(SPTree(three).compute_non_edge_forces(4, 0.5)[0],
                                  jtrees.SPTree(three).compute_non_edge_forces(4, 0.5)[0])


# ----------------------------------------------------------------- kmeans
@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_kmeans_centers_and_assignments_equal_jaxs(distance):
    x, _ = _blobs(n_per=50, k=4, d=6, seed=3, spread=4.0)
    x = x.astype(np.float32)
    mine = KMeansClustering(k=4, seed=5, distance=distance, device="cpu")
    theirs = jkmeans.KMeansClustering(k=4, seed=5, distance=distance)
    np.testing.assert_array_equal(mine._init_centers(x), theirs._init_centers(x))
    mine.fit(x)
    theirs.fit(x)
    np.testing.assert_array_equal(mine.labels_, np.asarray(theirs.labels_))
    np.testing.assert_allclose(mine.cluster_centers_, theirs.cluster_centers_,
                               atol=CENTER_ATOL)
    assert mine.inertia_ == pytest.approx(theirs.inertia_, rel=1e-5, abs=1e-5)
    np.testing.assert_array_equal(mine.predict(x), theirs.predict(x))
    assert mine.cluster_centers_.dtype == np.float32


def test_kmeans_recovers_blobs_and_rejects_bad_arguments():
    """The JAX test's blobs (corners of a cube) and seed: purity > 0.95."""
    rng = np.random.default_rng(0)
    corners = np.array([[5.0] * 4, [-5.0] * 4, [5.0, 5.0, -5.0, -5.0]])
    x = np.concatenate([c + rng.normal(size=(40, 4)) for c in corners])
    y = np.repeat(np.arange(3), 40)
    km = KMeansClustering(k=3, seed=1, device="cpu").fit(x)
    purity = sum(np.bincount(km.labels_[y == c], minlength=3).max() for c in range(3))
    assert purity / len(y) > 0.95
    np.testing.assert_array_equal(km.predict(x), km.labels_)
    assert 1 <= km.n_iter_ <= km.max_iterations
    with pytest.raises(ValueError, match="k=5"):
        KMeansClustering(k=5, device="cpu").fit(x[:3])
    with pytest.raises(ValueError, match="unsupported distance"):
        KMeansClustering(k=2, distance="manhattan", device="cpu")


def test_default_device_is_the_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KMeansClustering(k=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Tsne()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BarnesHutTsne()
    assert Tsne(device="cpu").device.type == "cpu"


# ------------------------------------------------------------------ t-SNE
def test_joint_affinities_equal_jaxs():
    x, _ = _blobs(n_per=25, k=4, d=10, seed=6)
    want = jtsne.Tsne(perplexity=8.0)._joint_p(x)
    got = Tsne(perplexity=8.0, device="cpu")._joint_p(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-15)
    d2 = ((x[:, None, :] - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(ptsne.squared_distances(torch.from_numpy(x)).numpy(), d2,
                               rtol=1e-12)


@pytest.mark.parametrize("iters", [1, 6, 14])
def test_exact_tsne_f64_matches_jax_after_k_iterations(iters):
    """k iterations in float64 on both sides: past the early-exaggeration
    stop (iteration 5) and the momentum switch (iteration 10)."""
    x, _ = _blobs(n_per=30, k=4, d=8, seed=7)
    kw = dict(perplexity=10.0, max_iter=iters, stop_lying_iteration=5, momentum_switch=10,
              seed=11)
    want = jtsne.Tsne(**kw).fit_transform(x)
    got = Tsne(device="cpu", dtype=torch.float64, **kw).fit_transform(x)
    assert got.dtype == np.float64 and got.shape == (120, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TSNE_ATOL)


def test_exact_tsne_f32_matches_jax_without_x64():
    x, _ = _blobs(n_per=25, k=3, d=6, seed=8)
    kw = dict(perplexity=10.0, max_iter=4, seed=2)
    with jax.enable_x64(False):
        want = jtsne.Tsne(**kw).fit_transform(x)
    got = Tsne(device="cpu", **kw).fit_transform(x)
    assert got.dtype == np.float32 == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TSNE_F32_REL * np.abs(want).max())


def test_exact_tsne_separates_blobs():
    x, y = _blobs(n_per=40, k=3, d=10, seed=9)
    emb = Tsne(perplexity=15.0, max_iter=250, device="cpu").fit_transform(x)
    d = ((emb[:, None] - emb[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, 1)[:, :5]
    assert (y[nn] == y[:, None]).mean() > 0.95


def test_barnes_hut_equals_jaxs_at_small_n():
    x, _ = _blobs(n_per=20, k=3, d=5, seed=10)
    kw = dict(perplexity=5.0, max_iter=25, theta=0.5, seed=4)
    got = BarnesHutTsne(device="cpu", **kw).fit_transform(x)
    want = jtsne.BarnesHutTsne(**kw).fit_transform(x)
    np.testing.assert_array_equal(got, want)


def test_barnes_hut_small_n_takes_the_exact_path():
    x, _ = _blobs(n_per=5, k=2, d=3, seed=12)  # n - 1 <= 3 * perplexity
    kw = dict(perplexity=5.0, max_iter=8, seed=1)
    got = BarnesHutTsne(device="cpu", dtype=torch.float64, **kw).fit_transform(x)
    want = jtsne.BarnesHutTsne(**kw).fit_transform(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TSNE_ATOL)


def test_exports():
    assert pt.Tsne is Tsne and pt.BarnesHutTsne is BarnesHutTsne
    assert pt.KMeansClustering is KMeansClustering
