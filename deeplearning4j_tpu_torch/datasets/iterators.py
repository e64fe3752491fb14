"""Minibatches for ``fit`` (counterpart of
``deeplearning4j_tpu/datasets/iterators.py``: its ``DataSet``,
``MultiDataSet``, ``as_iterator``, ``NumpyDataSetIterator``,
``pad_to_bucket`` and ``BucketingSequenceIterator``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import numpy as np


@dataclass
class DataSet:
    """Features + labels (+ masks) minibatch (reference: ND4J DataSet)."""

    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])


@dataclass
class MultiDataSet:
    """Multi-input, multi-output minibatch (reference: ND4J MultiDataSet),
    for ``ComputationGraph``: one array per network input and output, in
    their declared order, and optional masks aligned with them."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


def as_multi(ds) -> MultiDataSet:
    """A batch as a MultiDataSet: a DataSet or an (x, y) pair becomes one
    of one input and one output, its masks carried."""
    if isinstance(ds, MultiDataSet):
        return ds
    if isinstance(ds, (tuple, list)) and len(ds) == 2:
        ds = DataSet(ds[0], ds[1])
    if isinstance(ds, DataSet):
        return MultiDataSet(features=[ds.features], labels=[ds.labels],
                            features_masks=[ds.features_mask],
                            labels_masks=[ds.labels_mask])
    raise TypeError(f"Cannot convert {type(ds).__name__} to MultiDataSet")


def as_iterator(data) -> Iterable[DataSet]:
    """Normalize fit() input: an (x, y) tuple, a DataSet or a MultiDataSet
    becomes a one-batch list; anything else is taken as an iterable of
    those."""
    if isinstance(data, (DataSet, MultiDataSet)):
        return [data]
    if isinstance(data, tuple) and len(data) == 2:
        return [DataSet(data[0], data[1])]
    return data


class NumpyDataSetIterator:
    """(features, labels) arrays in batches of ``batch`` rows (reference:
    INDArrayDataSetIterator). With ``shuffle``, each pass over the data
    (each ``iter``) permutes the rows with
    ``np.random.default_rng(seed + epoch)``, as the JAX package does, so
    both draw the same batches. ``drop_last`` leaves a trailing short
    batch out."""

    def __init__(self, features, labels, batch: int, drop_last: bool = True,
                 shuffle: bool = False, seed: int = 0):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch = int(batch)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def batch_size(self) -> int:
        return self.batch

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = n - (n % self.batch) if self.drop_last else n
        for s in range(0, stop, self.batch):
            sl = idx[s:s + self.batch]
            yield DataSet(self.features[sl], self.labels[sl])

    def __len__(self) -> int:
        n = self.features.shape[0]
        return n // self.batch if self.drop_last else -(-n // self.batch)


def pad_to_bucket(x, boundaries: Sequence[int]):
    """Pad a [B, T, F] (or [T, F]) sequence batch to the smallest bucket
    boundary >= T. Returns ``(padded, mask, t)``: ``mask`` is the [B, bound]
    (or [bound]) features mask and ``t`` the real length (slice the model's
    output with ``out[..., :t, :]``). Pass both to ``rnn_time_step``: masked
    steps hold the recurrent state."""
    x = np.asarray(x)
    t_axis = x.ndim - 2
    t = x.shape[t_axis]
    bound = next((b for b in sorted(int(b) for b in boundaries) if t <= b), None)
    if bound is None:
        raise ValueError(f"sequence length {t} exceeds the largest bucket "
                         f"{max(boundaries)}; add a larger boundary or truncate")
    pad = [(0, 0)] * x.ndim
    pad[t_axis] = (0, bound - t)
    mask = np.zeros(x.shape[:t_axis] + (bound,), dtype=np.float32)
    mask[..., :t] = 1.0
    return np.pad(x, pad), mask, t


class BucketingSequenceIterator:
    """Variable-length sequences in batches padded to a fixed set of lengths.

    Each sequence goes to the smallest bucket boundary >= its length and is
    padded to it, with a features mask (and a labels mask for per-step
    labels); each batch is drawn from one bucket. ``sequences``: (features
    [T, F], labels [T, C] per step or [C] per sequence) pairs. A sequence
    longer than the largest boundary goes to that bucket, truncated."""

    def __init__(self, sequences, batch: int,
                 boundaries: Sequence[int] = (32, 64, 128, 256),
                 drop_remainder: bool = False):
        self.sequences = list(sequences)
        self.batch = int(batch)
        self.boundaries = sorted(int(b) for b in boundaries)
        if not self.boundaries:
            raise ValueError("need at least one bucket boundary")
        self.drop_remainder = drop_remainder

    def _bucket_of(self, length: int) -> int:
        return next((b for b in self.boundaries if length <= b), self.boundaries[-1])

    @staticmethod
    def _pad(feats, labels, bound: int):
        f = np.asarray(feats, dtype=np.float32)[:bound]
        fp = np.zeros((bound,) + f.shape[1:], dtype=np.float32)
        fp[:f.shape[0]] = f
        fmask = np.zeros(bound, dtype=np.float32)
        fmask[:f.shape[0]] = 1.0
        lab = np.asarray(labels, dtype=np.float32)
        if lab.ndim != 2:
            return fp, fmask, lab, None
        lab = lab[:bound]  # per-step labels pad, with a mask alongside
        lp = np.zeros((bound,) + lab.shape[1:], dtype=np.float32)
        lp[:lab.shape[0]] = lab
        lmask = np.zeros(bound, dtype=np.float32)
        lmask[:lab.shape[0]] = 1.0
        return fp, fmask, lp, lmask

    def __iter__(self):
        buckets: dict = {}
        for feats, labels in self.sequences:
            bound = self._bucket_of(np.asarray(feats).shape[0])
            buckets.setdefault(bound, []).append((feats, labels))
        for bound in self.boundaries:
            items = buckets.get(bound, [])
            for s in range(0, len(items), self.batch):
                chunk = items[s:s + self.batch]
                if self.drop_remainder and len(chunk) < self.batch:
                    continue
                padded = [self._pad(f, lab, bound) for f, lab in chunk]
                fs, fm, ls, lm = (np.stack([p[j] for p in padded]) if padded[0][j] is not None
                                  else None for j in range(4))
                yield DataSet(fs, ls, fm, lm)
