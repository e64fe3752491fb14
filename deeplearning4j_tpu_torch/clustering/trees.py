"""Spatial index structures: KDTree, VPTree, QuadTree, SPTree (a copy of
``deeplearning4j_tpu/clustering/trees.py``: the same trees, bit for bit).

Reference: deeplearning4j-core clustering/kdtree/KDTree.java,
clustering/vptree/VPTree.java, clustering/quadtree/QuadTree.java,
clustering/sptree/SpTree.java (the Barnes-Hut t-SNE workhorse). Host-side
numpy — these are pointer-chasing structures that belong on CPU; the device
work they *enable* (the exact t-SNE step) lives in plot/tsne.py.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------- KDTree
class _KDNode:
    __slots__ = ("idx", "axis", "left", "right")

    def __init__(self, idx, axis):
        self.idx = idx
        self.axis = axis
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    """Reference: clustering/kdtree/KDTree.java — axis-median build, nn/knn."""

    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        idxs = list(range(len(self.points)))
        self.root = self._build(idxs, 0)

    def _build(self, idxs: List[int], depth: int) -> Optional[_KDNode]:
        if not idxs:
            return None
        axis = depth % self.dims
        idxs.sort(key=lambda i: self.points[i, axis])
        mid = len(idxs) // 2
        node = _KDNode(idxs[mid], axis)
        node.left = self._build(idxs[:mid], depth + 1)
        node.right = self._build(idxs[mid + 1 :], depth + 1)
        return node

    def nn(self, query) -> Tuple[int, float]:
        """Nearest neighbor: (index, distance)."""
        res = self.knn(query, 1)
        return res[0]

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.idx] - q))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            diff = q[node.axis] - self.points[node.idx, node.axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        return sorted([(i, -nd) for nd, i in heap], key=lambda t: t[1])


# ---------------------------------------------------------------------- VPTree
class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx):
        self.idx = idx
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    """Vantage-point tree (reference: clustering/vptree/VPTree.java —
    euclidean or cosine-distance metric knn)."""

    def __init__(self, points, distance: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.points))))

    def _dist(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.distance == "cosine":
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            if na == 0 or nb == 0:
                return 1.0
            return 1.0 - float(a @ b / (na * nb))
        return float(np.linalg.norm(a - b))

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp_pos = int(self._rng.integers(len(idxs)))
        idxs[0], idxs[vp_pos] = idxs[vp_pos], idxs[0]
        node = _VPNode(idxs[0])
        rest = idxs[1:]
        if rest:
            dists = [self._dist(self.points[node.idx], self.points[i]) for i in rest]
            node.threshold = float(np.median(dists))
            inside = [i for i, d in zip(rest, dists) if d < node.threshold]
            outside = [i for i, d in zip(rest, dists) if d >= node.threshold]
            node.inside = self._build(inside)
            node.outside = self._build(outside)
        return node

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist(self.points[node.idx], q)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if d < node.threshold:
                visit(node.inside)
                if d + tau >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        return sorted([(i, -nd) for nd, i in heap], key=lambda t: t[1])


# ------------------------------------------------------------- QuadTree/SPTree
class SPTree:
    """Generalized quadtree over d dims (2^d children per cell) with centers of
    mass — the Barnes-Hut accelerator (reference: clustering/sptree/SpTree.java;
    QuadTree.java is the d=2 case)."""

    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.n, self.d = self.points.shape
        center = (self.points.max(0) + self.points.min(0)) / 2
        width = np.maximum((self.points.max(0) - self.points.min(0)) / 2, 1e-10) * 1.001
        self.root = _SPCell(center, width, self.d)
        for i in range(self.n):
            self.root.insert(i, self.points)

    def compute_non_edge_forces(self, point_index: int, theta: float,
                                q_buf: Optional[dict] = None) -> Tuple[np.ndarray, float]:
        """Negative (repulsive) forces for one point + its Z contribution
        (reference: SpTree.computeNonEdgeForces)."""
        neg = np.zeros(self.d)
        state = {"z": 0.0}
        self.root.non_edge_forces(self.points[point_index], point_index, theta,
                                  self.points, neg, state)
        return neg, state["z"]


class QuadTree(SPTree):
    """Reference: clustering/quadtree/QuadTree.java — SPTree with d=2."""

    def __init__(self, points):
        points = np.asarray(points)
        if points.shape[1] != 2:
            raise ValueError("QuadTree requires 2-D points")
        super().__init__(points)


class _SPCell:
    __slots__ = ("center", "width", "d", "n_points", "com", "index", "children", "leaf")

    def __init__(self, center, width, d):
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.d = d
        self.n_points = 0
        self.com = np.zeros(d)
        self.index: Optional[int] = None  # single point if leaf
        self.children: Optional[List["_SPCell"]] = None
        self.leaf = True

    def _contains(self, p) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.width + 1e-12))

    def _child_for(self, p) -> "_SPCell":
        mask = (p > self.center).astype(int)
        idx = int((mask * (2 ** np.arange(self.d))).sum())
        return self.children[idx]

    def _subdivide(self, points):
        self.children = []
        half = self.width / 2
        for ci in range(2**self.d):
            offs = np.array([(ci >> b) & 1 for b in range(self.d)]) * 2 - 1
            self.children.append(_SPCell(self.center + offs * half, half, self.d))
        self.leaf = False
        if self.index is not None:
            moved = self.index
            self.index = None
            self._child_for(points[moved]).insert(moved, points)

    def insert(self, i: int, points) -> bool:
        p = points[i]
        if not self._contains(p):
            return False
        self.n_points += 1
        self.com += (p - self.com) / self.n_points
        if self.leaf and self.index is None:
            self.index = i
            return True
        if self.leaf:
            # duplicate-point guard: keep aggregating without infinite subdivision
            if np.allclose(points[self.index], p, atol=1e-12):
                return True
            self._subdivide(points)
        return self._child_for(p).insert(i, points)

    def non_edge_forces(self, p, skip_index, theta, points, neg, state):
        if self.n_points == 0 or (self.leaf and self.index == skip_index):
            return
        diff = p - self.com
        d2 = float(diff @ diff)
        max_width = float(self.width.max()) * 2
        if self.leaf or (d2 > 0 and max_width / np.sqrt(d2) < theta):
            if self.leaf and self.index == skip_index:
                return
            q = 1.0 / (1.0 + d2)
            mult = self.n_points * q
            state["z"] += mult
            neg += mult * q * diff
            return
        for child in self.children:
            child.non_edge_forces(p, skip_index, theta, points, neg, state)
