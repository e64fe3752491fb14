"""Records into batches (counterpart of
``deeplearning4j_tpu/datasets/record_iterators.py``; reference:
datasets/datavec/*.java).

``RecordReaderDataSetIterator`` (classification, regression or unlabelled,
with each record's metadata on request), ``SequenceRecordReaderDataSetIterator``
(one reader split per step, or a features and a labels reader aligned by
``ALIGN_START``, ``ALIGN_END`` or ``EQUAL_LENGTH``, padded to the longest
sequence of the batch with masks) and ``RecordReaderMultiDataSetIterator``
(column ranges of several readers into a MultiDataSet).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .iterators import DataSet, DataSetIterator, MultiDataSet
from .records import RecordReader, SequenceRecordReader

ALIGN_START = "align_start"
ALIGN_END = "align_end"
EQUAL_LENGTH = "equal_length"


def _one_hot(idx: int, n: int) -> np.ndarray:
    v = np.zeros(n, dtype=np.float32)
    v[idx] = 1.0
    return v


class RecordReaderDataSetIterator(DataSetIterator):
    """Records → (features, labels) batches (reference:
    RecordReaderDataSetIterator.java).

    - classification: ``label_index`` + ``num_classes`` → one-hot labels
    - regression: ``label_index``..``label_index_to`` (inclusive) → label vector
    - ``label_index=None`` → unsupervised (labels = features)
    """

    def __init__(self, reader: RecordReader, batch: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 label_index_to: Optional[int] = None,
                 regression: bool = False,
                 collect_metadata: bool = False):
        self.reader = reader
        self.batch = int(batch)
        self.label_index = label_index
        self.num_classes = num_classes
        self.label_index_to = label_index_to
        self.regression = regression or label_index_to is not None
        # reference: RecordReaderDataSetIterator.setCollectMetaData — batches
        # carry per-example RecordMetaData for Evaluation attribution
        self.collect_metadata = collect_metadata

    def batch_size(self):
        return self.batch

    def reset(self):
        self.reader.reset()

    def _split(self, rec) -> Tuple[np.ndarray, np.ndarray]:
        # one vectorized conversion — records may already be flat ndarrays
        # (ImageRecordReader) or lists of scalars (CSV)
        vals = np.asarray(rec, dtype=np.float32)
        if self.label_index is None:
            return vals, vals
        if self.regression:
            to = self.label_index_to if self.label_index_to is not None else self.label_index
            label = vals[self.label_index : to + 1]
            feat = np.concatenate([vals[: self.label_index], vals[to + 1 :]])
            return feat, label
        label = _one_hot(int(vals[self.label_index]), self.num_classes)
        feat = np.concatenate(
            [vals[: self.label_index], vals[self.label_index + 1 :]]
        )
        return feat, label

    def __iter__(self):
        feats: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        metas: List = []
        source = (self.reader.iter_with_metadata() if self.collect_metadata
                  else ((rec, None) for rec in self.reader))
        for rec, meta in source:
            f, l = self._split(rec)
            feats.append(f)
            labels.append(l)
            metas.append(meta)
            if len(feats) == self.batch:
                yield DataSet(np.stack(feats), np.stack(labels),
                              example_metadata=metas if self.collect_metadata else None)
                feats, labels, metas = [], [], []
        if feats:
            yield DataSet(np.stack(feats), np.stack(labels),
                          example_metadata=metas if self.collect_metadata else None)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequences → padded [B,T,F] batches with masks (reference:
    SequenceRecordReaderDataSetIterator.java).

    Two-reader form: ``features_reader`` + ``labels_reader`` with an
    alignment mode; single-reader form: ``label_index``(+``num_classes``)
    splits each time step.
    """

    def __init__(self, features_reader: SequenceRecordReader, batch: int,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 alignment: str = EQUAL_LENGTH):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self.batch = int(batch)
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.alignment = alignment

    def batch_size(self):
        return self.batch

    def reset(self):
        self.features_reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    # -- single sequence → (feat [t,f], label [t,l]) --------------------
    def _split_steps(self, seq) -> Tuple[np.ndarray, np.ndarray]:
        feats, labels = [], []
        for rec in seq:
            vals = [float(v) for v in rec]
            if self.label_index is None:
                feats.append(vals)
                labels.append(vals)
            elif self.regression:
                labels.append([vals[self.label_index]])
                feats.append(vals[: self.label_index] + vals[self.label_index + 1 :])
            else:
                labels.append(_one_hot(int(vals[self.label_index]), self.num_classes))
                feats.append(vals[: self.label_index] + vals[self.label_index + 1 :])
        return (np.asarray(feats, dtype=np.float32),
                np.asarray(labels, dtype=np.float32))

    def _pairs(self):
        if self.labels_reader is None:
            for seq in self.features_reader:
                yield self._split_steps(seq)
        else:
            for fseq, lseq in zip(self.features_reader, self.labels_reader):
                f = np.asarray([[float(v) for v in r] for r in fseq], np.float32)
                if self.num_classes is not None and not self.regression:
                    l = np.stack([
                        _one_hot(int(r[0]), self.num_classes) for r in lseq
                    ])
                else:
                    l = np.asarray([[float(v) for v in r] for r in lseq], np.float32)
                yield f, l

    def _assemble(self, pairs) -> DataSet:
        t_f = max(p[0].shape[0] for p in pairs)
        t_l = max(p[1].shape[0] for p in pairs)
        T = max(t_f, t_l)
        B = len(pairs)
        nf = pairs[0][0].shape[1]
        nl = pairs[0][1].shape[1]
        feats = np.zeros((B, T, nf), np.float32)
        labels = np.zeros((B, T, nl), np.float32)
        fmask = np.zeros((B, T), np.float32)
        lmask = np.zeros((B, T), np.float32)
        need_mask = False
        for i, (f, l) in enumerate(pairs):
            if self.alignment == ALIGN_END:
                fs, ls = T - f.shape[0], T - l.shape[0]
            else:  # ALIGN_START / EQUAL_LENGTH
                fs, ls = 0, 0
                if self.alignment == EQUAL_LENGTH and f.shape[0] != l.shape[0]:
                    raise ValueError(
                        f"EQUAL_LENGTH alignment but lengths differ "
                        f"({f.shape[0]} vs {l.shape[0]}); use ALIGN_START/ALIGN_END"
                    )
            feats[i, fs : fs + f.shape[0]] = f
            labels[i, ls : ls + l.shape[0]] = l
            fmask[i, fs : fs + f.shape[0]] = 1.0
            lmask[i, ls : ls + l.shape[0]] = 1.0
            if f.shape[0] != T or l.shape[0] != T:
                need_mask = True
        return DataSet(
            feats, labels,
            features_mask=fmask if need_mask else None,
            labels_mask=lmask if need_mask else None,
        )

    def __iter__(self):
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        for pair in self._pairs():
            buf.append(pair)
            if len(buf) == self.batch:
                yield self._assemble(buf)
                buf = []
        if buf:
            yield self._assemble(buf)


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Multiple readers → MultiDataSet (reference:
    RecordReaderMultiDataSetIterator.java + its Builder).

    Build with ``add_reader(name, reader)`` then ``add_input(name, from, to)``
    / ``add_output(name, from, to)`` / ``add_output_one_hot(name, col, n)``.
    Column ranges are inclusive, mirroring the reference builder.
    """

    def __init__(self, batch: int):
        self.batch = int(batch)
        self._readers: Dict[str, RecordReader] = {}
        self._inputs: List[Tuple[str, Optional[int], Optional[int]]] = []
        self._outputs: List[Tuple[str, Optional[int], Optional[int], Optional[int]]] = []

    def add_reader(self, name: str, reader: RecordReader) -> "RecordReaderMultiDataSetIterator":
        self._readers[name] = reader
        return self

    def add_input(self, name: str, col_from: Optional[int] = None,
                  col_to: Optional[int] = None) -> "RecordReaderMultiDataSetIterator":
        self._inputs.append((name, col_from, col_to))
        return self

    def add_output(self, name: str, col_from: Optional[int] = None,
                   col_to: Optional[int] = None) -> "RecordReaderMultiDataSetIterator":
        self._outputs.append((name, col_from, col_to, None))
        return self

    def add_output_one_hot(self, name: str, col: int,
                           num_classes: int) -> "RecordReaderMultiDataSetIterator":
        self._outputs.append((name, col, col, num_classes))
        return self

    def batch_size(self):
        return self.batch

    def reset(self):
        for r in self._readers.values():
            r.reset()

    def _extract(self, rec, col_from, col_to, one_hot: Optional[int]):
        vals = [float(v) for v in rec]
        if col_from is None:
            sel = vals
        else:
            to = col_to if col_to is not None else col_from
            sel = vals[col_from : to + 1]
        if one_hot is not None:
            return _one_hot(int(sel[0]), one_hot)
        return np.asarray(sel, dtype=np.float32)

    def __iter__(self):
        iters = {name: iter(r) for name, r in self._readers.items()}
        while True:
            rows: List[Dict[str, List[object]]] = []
            try:
                for _ in range(self.batch):
                    rows.append({name: next(it) for name, it in iters.items()})
            except StopIteration:
                pass
            if not rows:
                return
            feats = [
                np.stack([self._extract(r[name], cf, ct, None) for r in rows])
                for name, cf, ct in self._inputs
            ]
            labels = [
                np.stack([self._extract(r[name], cf, ct, oh) for r in rows])
                for name, cf, ct, oh in self._outputs
            ]
            yield MultiDataSet(features=feats, labels=labels)
            if len(rows) < self.batch:
                return
