"""Minibatches for ``fit`` (counterpart of
``deeplearning4j_tpu/datasets/iterators.py``): ``DataSet``,
``MultiDataSet``, the ``DataSetIterator`` family (``ListDataSetIterator``,
``NumpyDataSetIterator``, ``ExistingDataSetIterator``,
``MultipleEpochsIterator``, ``SamplingDataSetIterator``,
``IteratorDataSetIterator``, ``ReconstructionDataSetIterator``,
``IteratorMultiDataSetIterator``, ``BucketingSequenceIterator``),
``as_iterator`` and ``pad_to_bucket``; the prefetching wrappers
``AsyncDataSetIterator`` and ``AsyncMultiDataSetIterator`` (a host thread
one queue ahead) and ``DevicePrefetchIterator`` (pinned host buffers and a
copy to the card one batch ahead, on a side stream).

Batches are numpy arrays on the host; the networks move each one to their
device (``fit`` on the card through ``DevicePrefetchIterator``). A batch may
carry ``example_metadata``, one record's provenance per example
(``records.RecordMetaData``), which ``evaluate`` passes on to
``Evaluation``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..utils.collections import AsyncIterator
from .bucketing import PaddedWindow


@dataclass
class DataSet:
    """Features + labels (+ masks) minibatch (reference: ND4J DataSet), with
    each example's provenance when the iterator collects it."""

    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None
    example_metadata: Optional[List] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def _take(self, idx) -> "DataSet":
        def opt(a):
            return None if a is None else a[idx]

        meta = self.example_metadata
        if meta is not None:
            meta = meta[idx] if isinstance(idx, slice) else [meta[i] for i in idx]
        return DataSet(self.features[idx], self.labels[idx], opt(self.features_mask),
                       opt(self.labels_mask), meta)

    def split_test_and_train(self, n_train: int):
        """(the first ``n_train`` examples, the rest)."""
        return self._take(slice(None, n_train)), self._take(slice(n_train, None))

    def shuffle(self, seed: int = 0) -> "DataSet":
        """The examples in the order of ``default_rng(seed).permutation``."""
        return self._take(np.random.default_rng(seed).permutation(self.num_examples()))


@dataclass
class MultiDataSet:
    """Multi-input, multi-output minibatch (reference: ND4J MultiDataSet),
    for ``ComputationGraph``: one array per network input and output, in
    their declared order, optional masks aligned with them, and each
    example's provenance, shared by the outputs."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None
    example_metadata: Optional[List] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


def as_multi(ds) -> MultiDataSet:
    """A batch as a MultiDataSet: a DataSet or an (x, y) pair becomes one
    of one input and one output, its masks and metadata carried."""
    if isinstance(ds, MultiDataSet):
        return ds
    if isinstance(ds, (tuple, list)) and len(ds) == 2:
        ds = DataSet(ds[0], ds[1])
    if isinstance(ds, DataSet):
        return MultiDataSet(features=[ds.features], labels=[ds.labels],
                            features_masks=[ds.features_mask],
                            labels_masks=[ds.labels_mask],
                            example_metadata=ds.example_metadata)
    raise TypeError(f"Cannot convert {type(ds).__name__} to MultiDataSet")


class DataSetIterator:
    """Base iterator (reference: DataSetIterator): iterable, with ``reset``
    and ``batch_size``. ``prefetch_supported`` is the JAX package's flag."""

    prefetch_supported = True

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-built batches (reference: ListDataSetIterator)."""

    def __init__(self, datasets: Sequence[DataSet]):
        self._data = list(datasets)

    def __iter__(self):
        return iter(self._data)

    def batch_size(self) -> int:
        return self._data[0].num_examples() if self._data else 0

    def __len__(self) -> int:
        return len(self._data)


def as_iterator(data) -> Iterable[DataSet]:
    """Normalize fit() input: an (x, y) tuple, a DataSet or a MultiDataSet
    becomes a one-batch ``ListDataSetIterator``; anything else is taken as
    an iterable of those. A pair's arrays (or tensors) are kept as given."""
    if isinstance(data, (DataSet, MultiDataSet)):
        return ListDataSetIterator([data])
    if isinstance(data, tuple) and len(data) == 2:
        return ListDataSetIterator([DataSet(data[0], data[1])])
    return data


class NumpyDataSetIterator(DataSetIterator):
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


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any iterable of batches (reference: ExistingDataSetIterator)."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._iterable = iterable

    def __iter__(self):
        return iter(self._iterable)

    def batch_size(self) -> int:
        return 0


class MultipleEpochsIterator(DataSetIterator):
    """Replay an iterator ``epochs`` times, reset before each (reference:
    MultipleEpochsIterator)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base

    def __iter__(self):
        for _ in range(self.epochs):
            self.base.reset()
            yield from self.base

    def batch_size(self) -> int:
        return self.base.batch_size()


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` batches of ``batch`` rows drawn with replacement,
    the same draws on every pass (reference: SamplingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch: int, total_batches: int, seed: int = 0):
        self.dataset = dataset
        self.batch = batch
        self.total = total_batches
        self.seed = seed

    def batch_size(self) -> int:
        return self.batch

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        n = self.dataset.num_examples()
        for _ in range(self.total):
            idx = rng.integers(0, n, size=self.batch)
            yield DataSet(self.dataset.features[idx], self.dataset.labels[idx])


class IteratorDataSetIterator(DataSetIterator):
    """Re-batch a stream of single examples into batches of ``batch``; a
    trailing short batch is left out (reference: IteratorDataSetIterator).
    Metadata is carried when every example of a batch has it."""

    def __init__(self, examples: Iterable[DataSet], batch: int):
        self.examples = examples
        self.batch = batch

    def batch_size(self) -> int:
        return self.batch

    def __iter__(self):
        feats, labs, metas = [], [], []
        for ex in self.examples:
            feats.append(ex.features)
            labs.append(ex.labels)
            if ex.example_metadata:
                metas.extend(ex.example_metadata)
            if len(feats) == self.batch:
                yield DataSet(np.stack(feats), np.stack(labs),
                              example_metadata=metas if len(metas) == len(feats) else None)
                feats, labs, metas = [], [], []


class ReconstructionDataSetIterator(DataSetIterator):
    """Labels = features, the features mask as the labels mask, for
    autoencoder targets (reference: ReconstructionDataSetIterator)."""

    def __init__(self, base: DataSetIterator):
        self.base = base

    def batch_size(self) -> int:
        return self.base.batch_size()

    def reset(self) -> None:
        self.base.reset()

    def __iter__(self):
        for ds in self.base:
            yield DataSet(ds.features, ds.features, features_mask=ds.features_mask,
                          labels_mask=ds.features_mask, example_metadata=ds.example_metadata)


def _take_multi(mds: MultiDataSet, sl) -> MultiDataSet:
    """Row-slice every array (and the metadata) of a MultiDataSet."""
    def opt(masks):
        return None if masks is None else [None if m is None else m[sl] for m in masks]

    return MultiDataSet(
        features=[f[sl] for f in mds.features], labels=[lab[sl] for lab in mds.labels],
        features_masks=opt(mds.features_masks), labels_masks=opt(mds.labels_masks),
        example_metadata=None if mds.example_metadata is None else mds.example_metadata[sl])


def _cat_masks(buf: List[MultiDataSet], kind: str, n: int):
    """Concatenate the masks of each position across ``buf``; a member
    without a mask there contributes ones of the masked members' shape."""
    mask_lists = [getattr(m, kind) for m in buf]
    if all(ml is None for ml in mask_lists):
        return None
    out = []
    for i in range(n):
        col = [None if ml is None else ml[i] for ml in mask_lists]
        if all(m is None for m in col):
            out.append(None)
            continue
        trailing = next(np.asarray(m).shape[1:] for m in col if m is not None)
        out.append(np.concatenate([
            np.ones((mds.num_examples(),) + trailing, np.float32) if m is None
            else np.asarray(m) for m, mds in zip(col, buf)]))
    return out


def _concat_multi(buf: List[MultiDataSet]) -> MultiDataSet:
    n_in, n_out = len(buf[0].features), len(buf[0].labels)
    metas = None
    if any(m.example_metadata for m in buf):
        metas = []
        for m in buf:
            metas.extend(m.example_metadata or [None] * m.num_examples())
    return MultiDataSet(
        features=[np.concatenate([np.asarray(m.features[i]) for m in buf])
                  for i in range(n_in)],
        labels=[np.concatenate([np.asarray(m.labels[i]) for m in buf]) for i in range(n_out)],
        features_masks=_cat_masks(buf, "features_masks", n_in),
        labels_masks=_cat_masks(buf, "labels_masks", n_out),
        example_metadata=metas)


class IteratorMultiDataSetIterator(DataSetIterator):
    """Re-batch a stream of MultiDataSets into batches of exactly ``batch``
    rows; only the trailing batch may be short (reference:
    IteratorMultiDataSetIterator). A source batch that overflows is split
    and its rest carried into the next; members without a mask merge as
    all-ones masks."""

    def __init__(self, examples: Iterable[MultiDataSet], batch: int):
        if int(batch) < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.examples = examples
        self.batch = int(batch)

    def batch_size(self) -> int:
        return self.batch

    def __iter__(self):
        buf: List[MultiDataSet] = []
        count = 0
        for mds in self.examples:
            buf.append(mds)
            count += mds.num_examples()
            if count >= self.batch:
                merged = _concat_multi(buf)  # once per fill; the batches are views of it
                k = 0
                while count - k >= self.batch:
                    yield _take_multi(merged, slice(k, k + self.batch))
                    k += self.batch
                buf = [_take_multi(merged, slice(k, None))] if count - k else []
                count -= k
        if buf:
            yield _concat_multi(buf)


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


class BucketingSequenceIterator(DataSetIterator):
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

    def batch_size(self) -> int:
        return self.batch

    def _bucket_of(self, length: int) -> int:
        return next((b for b in self.boundaries if length <= b), self.boundaries[-1])

    def num_programs(self) -> int:
        """Upper bound on the batch shapes this iterator yields: one per
        bucket its sequences reach, and one more per such bucket whose
        trailing batch is partial (unless dropped). It bounds the step
        shapes the staged loop captures and the time buckets that serving
        captures for these lengths."""
        counts: dict = {}
        for f, _ in self.sequences:
            b = self._bucket_of(np.asarray(f).shape[0])
            counts[b] = counts.get(b, 0) + 1
        full = len(counts)
        if not self.drop_remainder:
            full += sum(1 for n in counts.values() if n % self.batch)
        return full

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


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference:
    AsyncDataSetIterator.java; queue capacity 8 by default): the host's
    batch preparation overlaps the card's work. ``fit`` wraps every
    iterator whose ``prefetch_supported`` is true in one. The thread and its
    queue are ``utils.collections.AsyncIterator``'s."""

    prefetch_supported = False  # already asynchronous: never wrapped twice

    def __init__(self, base, queue_size: int = 8):
        self.base = base
        self.queue_size = queue_size

    def batch_size(self) -> int:
        return self.base.batch_size()

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self):
        yield from AsyncIterator(self.base, queue_size=self.queue_size)


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """The MultiDataSet form (reference: AsyncMultiDataSetIterator.java): the
    queue does not look at what it carries, so this is the same class under
    the reference's name."""


# pinned host buffers a DevicePrefetchIterator fills in turn: one whose copy
# to the card may still run, one being filled, one filled and waiting
PREFETCH_RING = 3
# on the card, a pass whose first batch holds fewer bytes is read as it
# comes: the batch's pageable copy (about 7 GB/s on the H100's host) takes
# less time than the worker's handoff costs the host a batch (about 1.2 ms
# for LeNet-digits' 32 KB batches); PERF.md, PR 17
PREFETCH_MIN_BYTES = 8 << 20


def _copy_ahead(host: list, dev, side):
    """Copies of ``host``'s tensors (pinned; None passes) to ``dev``, started
    ``non_blocking`` on stream ``side``, and the event recorded after them;
    on the CPU (``side`` None) clones and no event."""
    import torch  # noqa: PLC0415

    if side is None:
        return [None if a is None else a.clone() for a in host], None
    with torch.cuda.stream(side):
        out = [None if a is None else a.to(dev, non_blocking=True) for a in host]
        done = torch.cuda.Event()
        done.record(side)
    return out, done


def _use_on_current(tensors: list, done, dev) -> list:
    """``tensors`` (from :func:`_copy_ahead`) made safe to use on ``dev``'s
    current stream: it waits on ``done``, and each tensor is marked with
    ``record_stream`` so that the allocator keeps its memory while that
    stream uses it."""
    import torch  # noqa: PLC0415

    if done is not None:
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for t in tensors:
            if t is not None:
                t.record_stream(current)
    return tensors


def _flatten(ds):
    """A batch's (or a staged window's) arrays as one list, and the function
    that builds the same kind of item from such a list (masks, metadata and
    a window's real batch count kept in place)."""
    if isinstance(ds, (tuple, list)) and len(ds) == 2:
        ds = DataSet(ds[0], ds[1])
    if isinstance(ds, (MultiDataSet, PaddedWindow)):
        multi = isinstance(ds, MultiDataSet)
        n_in, n_out = len(ds.features), len(ds.labels)
        fms, lms = ds.features_masks, ds.labels_masks
        arrays = [*ds.features, *ds.labels, *(fms or [None] * n_in), *(lms or [None] * n_out)]

        def rebuild(a):
            at = n_in + n_out
            parts = (a[:n_in], a[n_in:at], None if fms is None else a[at:at + n_in],
                     None if lms is None else a[at + n_in:])
            if multi:
                return MultiDataSet(*parts, ds.example_metadata)
            return PaddedWindow(*parts, n_real=ds.n_real)
        return arrays, rebuild
    if isinstance(ds, DataSet):
        return ([ds.features, ds.labels, ds.features_mask, ds.labels_mask],
                lambda a: DataSet(*a, example_metadata=ds.example_metadata))
    raise TypeError(f"Cannot prefetch a {type(ds).__name__}")


def _nbytes(item) -> int:
    return sum(getattr(a, "nbytes", 0) for a in _flatten(item)[0] if a is not None)


class DevicePrefetchIterator(DataSetIterator):
    """Each batch on ``device`` one batch ahead of its use (the torch form of
    the JAX package's ``jax.device_put`` staging; reference: the
    AsyncDataSetIterator and GridExecutioner pipeline).

    A worker thread passes each host batch to :meth:`start_copy`: into the
    next of PREFETCH_RING pinned host buffers (a buffer is refilled only
    after the event of its last copy to the card shows that copy finished),
    and from there to the card (``non_blocking``, on a side stream), so the
    copy of batch i+1 overlaps the work on batch i; it runs at most
    PREFETCH_RING batches ahead of the consumer. :meth:`finish_copy` hands
    a batch out: the consumer's current stream waits on its copy's event,
    and each of its tensors is marked with ``record_stream``, so the
    allocator does not reuse its memory while that stream works on it.
    ``fit``'s staged loop calls the two itself, on its own thread.

    The side stream and the pinned buffers are made at the first use and
    kept for every later one (``fit`` uses one instance for all its epochs,
    pointing ``base`` at each epoch's iterator); each pass starts its own
    worker. Items come out of the same kind as they went in (a DataSet, a
    MultiDataSet, an (x, y) pair as a DataSet, or the stager's
    ``PaddedWindow``), holding device tensors in the host arrays' dtypes
    (the network casts them); tensors already on the device pass as they
    are. On the card a pass whose first batch holds fewer than
    PREFETCH_MIN_BYTES is handed out as it comes, unread ahead (the network
    copies each batch as it takes it): for such batches a handoff costs the
    host more than the copy it would hide. On the CPU the copy is a clone
    and no stream is involved."""

    prefetch_supported = False  # the device staging includes the host prefetch

    def __init__(self, base, device="cuda"):
        self.base = base
        self.device = device
        self._side = None  # the copies' stream, made at the first pass on the card
        self._pinned = [{} for _ in range(PREFETCH_RING)]  # each buffer's tensors by position
        self._copied = [None] * PREFETCH_RING  # each buffer's last copy's event
        self._next = 0  # the buffer start_copy fills next

    def batch_size(self) -> int:
        return self.base.batch_size()

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()

    # -- the worker's side
    def _wait_copied(self, copied) -> None:
        """Block until the last copy out of a buffer has finished."""
        if copied is not None:
            copied.synchronize()

    @staticmethod
    def _pin(bufs: dict, key: int, a, pin: bool):
        """``a`` in the slot's host buffer ``key`` (reallocated when its
        shape or dtype changes); device tensors and None as they are."""
        import torch  # noqa: PLC0415

        if a is None or (isinstance(a, torch.Tensor) and a.device.type != "cpu"):
            return a
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        buf = bufs.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            bufs[key] = buf
        buf.copy_(t)
        return buf

    def _to_device(self, host: list, dev, side):
        return _copy_ahead(host, dev, side)

    def start_copy(self, item):
        """Start ``item``'s copy to the card through the next pinned buffer
        (after that buffer's last copy has finished); returns the handle
        :meth:`finish_copy` takes."""
        import torch  # noqa: PLC0415

        dev = torch.device(self.device)
        on_card = dev.type == "cuda"
        if on_card and self._side is None:
            self._side = torch.cuda.Stream(dev)
        j, self._next = self._next, (self._next + 1) % PREFETCH_RING
        self._wait_copied(self._copied[j])
        arrays, rebuild = _flatten(item)
        host = [self._pin(self._pinned[j], k, a, on_card) for k, a in enumerate(arrays)]
        tensors, self._copied[j] = self._to_device(host, dev, self._side)
        return tensors, rebuild, self._copied[j], dev

    @staticmethod
    def finish_copy(handle):
        """The item of a :meth:`start_copy` handle, safe to use on the
        current stream."""
        tensors, rebuild, done, dev = handle
        return rebuild(_use_on_current(tensors, done, dev))

    def __iter__(self):
        import torch  # noqa: PLC0415

        items = iter(self.base)
        first = next(items, None)
        if first is None:
            return
        items = itertools.chain([first], items)
        if torch.device(self.device).type == "cuda" and _nbytes(first) < PREFETCH_MIN_BYTES:
            yield from items
            return
        source = iter(AsyncIterator(map(self.start_copy, items), queue_size=PREFETCH_RING))
        try:
            for handle in source:
                yield self.finish_copy(handle)
        finally:
            source.close()
