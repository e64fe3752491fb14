"""Batches written to and streamed from ``.npz`` files (counterpart of
``deeplearning4j_tpu/datasets/export.py``), in the JAX package's layout, so
each package reads the other's files.

``FileDataSetIterator``'s ``process_index``/``process_count`` give each of
several processes a disjoint share of the files.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .iterators import DataSet, DataSetIterator


def export_datasets(iterator, dir: str, prefix: str = "dataset") -> List[str]:
    """Write every batch to ``dir/prefix_{i}.npz``; returns the paths."""
    os.makedirs(dir, exist_ok=True)
    paths = []
    for i, ds in enumerate(iterator):
        path = os.path.join(dir, f"{prefix}_{i:06d}.npz")
        arrays = {"features": ds.features, "labels": ds.labels}
        if ds.features_mask is not None:
            arrays["features_mask"] = ds.features_mask
        if ds.labels_mask is not None:
            arrays["labels_mask"] = ds.labels_mask
        np.savez(path, **arrays)
        paths.append(path)
    return paths


def load_dataset(path: str) -> DataSet:
    with np.load(path) as z:
        return DataSet(
            z["features"], z["labels"],
            features_mask=z["features_mask"] if "features_mask" in z else None,
            labels_mask=z["labels_mask"] if "labels_mask" in z else None,
        )


class FileDataSetIterator(DataSetIterator):
    """Stream exported .npz DataSets from disk (reference: the path-based
    loading side of RDDTrainingApproach.Export).

    ``process_index``/``process_count`` stripe shards across hosts so each
    process of a multi-host mesh feeds its own disjoint subset.
    """

    def __init__(self, paths, shuffle: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if isinstance(paths, str):
            self.paths = [
                os.path.join(paths, p) for p in sorted(os.listdir(paths))
                if p.endswith(".npz")
            ]
        else:
            self.paths = list(paths)
        self.paths = self.paths[process_index::process_count]
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._batch_size = None

    def batch_size(self) -> int:
        if self._batch_size is None:
            self._batch_size = (
                0 if not self.paths else load_dataset(self.paths[0]).num_examples()
            )
        return self._batch_size

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self):
        order = list(range(len(self.paths)))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        for i in order:
            yield load_dataset(self.paths[i])
