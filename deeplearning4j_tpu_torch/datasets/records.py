"""Record readers (counterpart of ``deeplearning4j_tpu/datasets/records.py``;
reference: DataVec's RecordReader SPI).

A record is a list of values (or a flat array, for images); readers are
restartable iterators over records, and sequence readers over lists of
records, one per time step. ``RecordMetaData`` names where a record came
from and reloads it. ``record_iterators`` turns records into batches.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

Record = List[object]


class RecordMetaData:
    """Where a record came from (reference: DataVec RecordMetaData — the
    source URI + location the eval/meta/Prediction.java chain carries so
    misclassified examples can be traced back and reloaded).

    ``index`` is the record's ordinal within its reader; ``source`` a human
    description (file path, "collection", ...); ``reader`` the originating
    reader, kept so :meth:`load` can replay it (all readers are restartable).
    """

    __slots__ = ("index", "source", "reader")

    def __init__(self, index: int, source: str, reader: "RecordReader" = None):
        self.index = index
        self.source = source
        self.reader = reader

    def load(self) -> Record:
        """Reload the referenced record (reference:
        RecordReaderDataSetIterator.loadFromMetaData)."""
        if self.reader is None:
            raise ValueError("metadata carries no reader to reload from")
        return self.reader.load_from_metadata([self])[0]

    def __repr__(self):
        return f"RecordMetaData(index={self.index}, source={self.source!r})"

    def __eq__(self, other):
        return (isinstance(other, RecordMetaData)
                and self.index == other.index and self.source == other.source)

    def __hash__(self):
        return hash((self.index, self.source))


class RecordReader:
    """Restartable stream of records (reference SPI: DataVec RecordReader)."""

    def __iter__(self) -> Iterator[Record]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    @property
    def labels(self) -> Optional[List[str]]:
        """Class-label vocabulary, when the reader defines one (images)."""
        return None

    # -- record metadata (reference: DataVec Record.getMetaData) --
    def source_description(self) -> str:
        return getattr(self, "path", None) or type(self).__name__

    def iter_with_metadata(self) -> Iterator[tuple]:
        """Yield (record, RecordMetaData) pairs; default counts ordinals."""
        src = self.source_description()
        for i, rec in enumerate(self):
            yield rec, RecordMetaData(i, src, self)

    def load_from_metadata(self, metas: Sequence[RecordMetaData]) -> List[Record]:
        """Reload specific records by replaying the stream (reference:
        RecordReader.loadFromMetaData). Restores the reader's position."""
        wanted = {m.index for m in metas}
        by_index = {}
        self.reset()
        for i, rec in enumerate(self):
            if i in wanted:
                by_index[i] = rec
                if len(by_index) == len(wanted):
                    break
        self.reset()
        missing = wanted - set(by_index)
        if missing:
            raise KeyError(f"records not found for indices {sorted(missing)}")
        return [by_index[m.index] for m in metas]


class CollectionRecordReader(RecordReader):
    """Iterate pre-built records (reference: CollectionRecordReader)."""

    def __init__(self, records: Sequence[Record]):
        self._records = [list(r) for r in records]

    def __iter__(self):
        return iter(self._records)


class LineRecordReader(RecordReader):
    """One record per line of text (reference: LineRecordReader)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path) as f:
            for line in f:
                yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """CSV rows → records (reference: CSVRecordReader).

    Values parse to float when possible, else stay strings — matching the
    reference's Writable coercion at iterator time.
    """

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        with open(self.path, newline="") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [_coerce(v) for v in row]


def _coerce(v: str):
    try:
        return float(v)
    except ValueError:
        return v.strip()


class SequenceRecordReader(RecordReader):
    """Stream of sequences: each item is a list of records (time steps)."""

    def __iter__(self) -> Iterator[List[Record]]:  # type: ignore[override]
        raise NotImplementedError


class CollectionSequenceRecordReader(SequenceRecordReader):
    """Pre-built sequences (reference: CollectionSequenceRecordReader)."""

    def __init__(self, sequences: Sequence[Sequence[Record]]):
        self._seqs = [[list(r) for r in seq] for seq in sequences]

    def __iter__(self):
        return iter(self._seqs)


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (reference: CSVSequenceRecordReader).

    ``paths`` may be a directory (files sorted by name) or an explicit list.
    """

    def __init__(self, paths, skip_lines: int = 0, delimiter: str = ","):
        if isinstance(paths, str):
            self.paths = [
                os.path.join(paths, p)
                for p in sorted(os.listdir(paths))
                if not p.startswith(".") and os.path.isfile(os.path.join(paths, p))
            ]
        else:
            self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        for p in self.paths:
            yield list(CSVRecordReader(p, self.skip_lines, self.delimiter))


class ImageRecordReader(RecordReader):
    """Images under label directories → [flat pixels..., label_idx] records.

    Reference: DataVec ImageRecordReader + ParentPathLabelGenerator. Decoding
    uses PIL when present; `.npy` arrays always work (the hermetic path).
    Output layout is HWC float32 in [0, 255] — normalization is the
    normalizer tier's job, exactly as in the reference.
    """

    def __init__(self, height: int, width: int, channels: int = 3,
                 root: Optional[str] = None, paths: Optional[Sequence[str]] = None,
                 append_label: bool = True):
        self.height, self.width, self.channels = height, width, channels
        self.append_label = append_label
        if root is not None:
            self._labels = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )
            self._files = [
                (os.path.join(root, lab, f), i)
                for i, lab in enumerate(self._labels)
                for f in sorted(os.listdir(os.path.join(root, lab)))
            ]
        elif paths is not None:
            self._labels = []
            self._files = [(p, -1) for p in paths]
        else:
            raise ValueError("ImageRecordReader needs root= or paths=")

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def _load(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            arr = np.load(path)
        else:
            try:
                from PIL import Image  # noqa: PLC0415
            except ImportError as e:
                raise ImportError(
                    f"PIL required to decode {path}; use .npy images otherwise"
                ) from e
            img = Image.open(path)
            img = img.convert("L" if self.channels == 1 else "RGB")
            img = img.resize((self.width, self.height))
            arr = np.asarray(img)
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape != (self.height, self.width, self.channels):
            raise ValueError(
                f"{path}: shape {arr.shape} != "
                f"{(self.height, self.width, self.channels)}"
            )
        return arr

    def __iter__(self):
        for path, label in self._files:
            # flat ndarray record (not boxed python floats) — consumers
            # vectorize over it; label rides as the trailing element
            flat = self._load(path).reshape(-1)
            if self.append_label and label >= 0:
                flat = np.append(flat, np.float32(label))
            yield flat
