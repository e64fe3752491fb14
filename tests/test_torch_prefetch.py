"""The PyTorch port's prefetching iterators and ``fit``'s use of them.

``utils.collections.AsyncIterator`` (a producer thread and a bounded
queue), ``AsyncDataSetIterator`` over it, and ``DevicePrefetchIterator``
(a worker thread filling a ring of host buffers, the copy of batch i+1
started before batch i is handed out). Held here: order and content kept,
a worker's exception raised again in the consumer after the items before
it, ``reset`` passed on, and a consumer that stops early (or ``close``)
ending the thread. On the CPU the device copy is a clone and the ring's
discipline is held by the order of fills and copies. Every thread a test
starts is joined with a timeout, and the test fails if it is still alive.
Tests marked ``cuda`` hold the pinned side-stream copies and the captured
staged loop on the card and skip where there is none.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,  # noqa: E402
                                                AsyncMultiDataSetIterator,
                                                BucketedStager, DevicePrefetchIterator,
                                                ListDataSetIterator, PaddedWindow)
from deeplearning4j_tpu_torch.datasets.iterators import (PREFETCH_MIN_BYTES,  # noqa: E402
                                                          PREFETCH_RING, _nbytes)
from deeplearning4j_tpu_torch.utils.collections import AsyncIterator  # noqa: E402

JOIN_S = 10.0


def _threads(name):
    return [t for t in threading.enumerate() if t.name == name]


def _no_thread_left(name, before=()):
    deadline = time.monotonic() + JOIN_S
    for t in _threads(name):
        if t not in before:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
            assert not t.is_alive(), f"thread {name} still running"


def _batches(n=6, b=4, seed=0, masks=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=(b, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
        m = np.ones(b, np.float32) if masks else None
        out.append(pt.DataSet(x, y, labels_mask=m, example_metadata=[f"r{i}.{j}"
                                                                      for j in range(b)]))
    return out


# ------------------------------------------------------------ AsyncIterator
def test_async_iterator_keeps_order_and_ends_its_thread():
    before = _threads("async-iterator")
    got = list(AsyncIterator(range(100), queue_size=3))
    assert got == list(range(100))
    _no_thread_left("async-iterator", before)


def test_async_iterator_raises_the_workers_exception_after_the_items_before_it():
    def base():
        yield 1
        yield 2
        raise KeyError("bad record")

    before = _threads("async-iterator")
    seen = []
    with pytest.raises(KeyError, match="bad record"):
        for item in AsyncIterator(base(), queue_size=1):
            seen.append(item)
    assert seen == [1, 2]
    _no_thread_left("async-iterator", before)


def test_async_iterator_early_exit_and_close_end_the_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = _threads("async-iterator")
    for item in AsyncIterator(endless(), queue_size=2):
        if item == 3:
            break
    _no_thread_left("async-iterator", before)
    it = AsyncIterator(endless(), queue_size=2)
    gen = iter(it)
    assert next(gen) == 0
    it.close()
    _no_thread_left("async-iterator", before)
    with pytest.raises(ValueError, match="queue_size"):
        AsyncIterator([], queue_size=0)


def test_async_iterator_restarts_per_iteration():
    it = AsyncIterator([1, 2, 3])
    assert list(it) == [1, 2, 3] and list(it) == [1, 2, 3]


# ------------------------------------------------------ AsyncDataSetIterator
class _Resettable(ListDataSetIterator):
    def __init__(self, data):
        super().__init__(data)
        self.resets = 0

    def reset(self):
        self.resets += 1


def test_async_dataset_iterator_order_reset_and_batch_size():
    data = _batches()
    base = _Resettable(data)
    it = AsyncDataSetIterator(base, queue_size=2)
    assert not it.prefetch_supported and it.batch_size() == 4
    assert [ds is want for ds, want in zip(it, data)] == [True] * len(data)
    it.reset()
    assert base.resets == 1
    assert issubclass(AsyncMultiDataSetIterator, AsyncDataSetIterator)


# ---------------------------------------------------- DevicePrefetchIterator
class _Logged(DevicePrefetchIterator):
    """Records the order of the worker's waits before a fill and its copies,
    with the host buffers each copy reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def _wait_copied(self, copied):
        self.log.append("fill")
        super()._wait_copied(copied)

    def _to_device(self, host, dev, side):
        self.log.append(("copy", [id(t) for t in host if t is not None]))
        return super()._to_device(host, dev, side)


def _same_dataset(got, want):
    for a, b in ((got.features, want.features), (got.labels, want.labels),
                 (got.features_mask, want.features_mask), (got.labels_mask, want.labels_mask)):
        if b is None:
            assert a is None
        else:
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), b)
    assert got.example_metadata == want.example_metadata


def test_device_prefetch_on_cpu_keeps_batches_and_the_ring():
    """Content, order, masks and metadata kept; each batch waits on its
    buffer's last copy, is filled, and copied, in turn; batch k's copy reads
    the buffers of batch k - PREFETCH_RING and no others."""
    ring = PREFETCH_RING
    data = _batches(n=7, masks=True)
    it = _Logged(ListDataSetIterator(data), device="cpu")
    out = list(it)
    assert len(out) == len(data)
    for got, want in zip(out, data):
        _same_dataset(got, want)
    assert it.log[0::2] == ["fill"] * 7 and [e[0] for e in it.log[1::2]] == ["copy"] * 7
    reads = [e[1] for e in it.log[1::2]]
    for k, ids in enumerate(reads):
        for m, other in enumerate(reads[:k]):
            assert (ids == other) == ((k - m) % ring == 0)
    _no_thread_left("async-iterator")


def test_device_prefetch_takes_multidatasets_and_pairs():
    rng = np.random.default_rng(1)
    mds = pt.MultiDataSet([rng.normal(size=(2, 3)).astype(np.float32)] * 2,
                          [np.ones((2, 1), np.float32)], features_masks=[None, np.ones(2)])
    got = list(DevicePrefetchIterator([mds, (np.zeros((2, 3)), np.ones((2, 1)))],
                                      device="cpu"))
    assert isinstance(got[0], pt.MultiDataSet) and len(got[0].features) == 2
    assert got[0].features_masks[0] is None and got[0].labels_masks is None
    np.testing.assert_array_equal(got[0].features_masks[1].numpy(), np.ones(2))
    assert isinstance(got[1], pt.DataSet)


def test_device_prefetch_carries_staged_windows():
    """The stager's PaddedWindow comes out as a PaddedWindow: its stacked
    arrays, its per-position masks (None kept) and its real batch count."""
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(3, 2, 5)).astype(np.float32)]
    labels = [rng.normal(size=(3, 2, 1)).astype(np.float32), np.ones((3, 2, 2), np.float32)]
    windows = [PaddedWindow(feats, labels, None, [None, np.ones((3, 2), np.float32)], n_real=2),
               PaddedWindow(feats, labels, [np.zeros((3, 2), np.float32)], None, n_real=3)]
    got = list(DevicePrefetchIterator(windows, device="cpu"))
    for g, w in zip(got, windows):
        assert isinstance(g, PaddedWindow) and g.n_real == w.n_real
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            np.testing.assert_array_equal(a.numpy(), b)
        for gm, wm in ((g.features_masks, w.features_masks), (g.labels_masks, w.labels_masks)):
            if wm is None:
                assert gm is None
                continue
            assert len(gm) == len(wm)
            for a, b in zip(gm, wm):
                assert (a is None) if b is None else np.array_equal(a.numpy(), b)
    _no_thread_left("async-iterator")


def test_prefetch_size_counts_every_array_of_an_item():
    """The bytes that decide whether the card reads a pass ahead: every
    array of the first item (features, labels, masks; None counts 0), of a
    DataSet, a pair, a MultiDataSet or a staged window."""
    x, y, m = np.zeros((4, 5), np.float32), np.zeros((4, 3), np.float32), np.ones(4, np.float32)
    assert _nbytes(pt.DataSet(x, y, labels_mask=m)) == 80 + 48 + 16
    assert _nbytes((x, y)) == 128
    assert _nbytes(pt.MultiDataSet([x, x], [y], features_masks=[None, m])) == 224
    assert _nbytes(PaddedWindow([x[None]], [y[None]], None, [m[None]], n_real=1)) == 144
    assert PREFETCH_MIN_BYTES > _nbytes(_batches(n=1)[0])


def test_device_prefetch_keeps_its_buffers_across_passes():
    """A second pass over the same instance (``fit``'s next epoch) refills
    the host buffers of the first instead of making new ones, and starts
    and ends a worker of its own."""
    data = _batches(n=5)
    it = DevicePrefetchIterator(ListDataSetIterator(data), device="cpu")
    first = list(it)
    bufs = [dict(slot) for slot in it._pinned]
    assert all(slot for slot in bufs)
    second = list(it)
    assert [slot.keys() for slot in it._pinned] == [slot.keys() for slot in bufs]
    assert all(a is b for old, new in zip(bufs, it._pinned) for a, b in
               zip(old.values(), new.values()))
    for a, b in zip(first, second):
        assert torch.equal(a.features, b.features)
    _no_thread_left("async-iterator")


def test_device_prefetch_raises_the_workers_exception_and_stops_early():
    def base():
        yield from _batches(n=2)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(DevicePrefetchIterator(base(), device="cpu"))
    _no_thread_left("async-iterator")

    def endless():
        while True:
            yield from _batches(n=3)

    for i, _ in enumerate(DevicePrefetchIterator(endless(), device="cpu")):
        if i == 4:
            break
    _no_thread_left("async-iterator")


# ------------------------------------------------------------ fit prefetches
def _conf():
    return pt.MultiLayerConfiguration(
        layers=[pt.DenseLayer(n_out=8, activation="tanh"),
                pt.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.feed_forward(5),
        updater=pt.UpdaterConfig(updater="adam", learning_rate=1e-2).to_dict(), seed=3)


def test_fit_reads_a_prefetchable_iterator_through_the_async_wrapper(monkeypatch):
    """``fit`` wraps an iterator whose ``prefetch_supported`` is true, once
    per epoch, and the trajectory is the one of a loop over the batches."""
    made = []
    real_init = AsyncDataSetIterator.__init__

    def spy(self, *a, **kw):
        made.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(AsyncDataSetIterator, "__init__", spy)
    data = _batches(n=5)
    a = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    b = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    base = _Resettable(data)
    a.fit(base, epochs=2)
    assert len(made) == 2 and base.resets == 2
    b._updater_ready()
    for _ in range(2):
        for ds in data:
            b._fit_batch(ds)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert a.iteration == 10 and a.last_batch_size == 4
    made.clear()
    a.fit(AsyncDataSetIterator(ListDataSetIterator(data)))  # already async: not wrapped again
    assert len(made) == 1
    _no_thread_left("async-iterator")


def test_fit_reads_every_epoch_on_the_card_through_one_prefetcher():
    """On the card ``fit`` reads all its epochs through one
    DevicePrefetchIterator (its stream and pinned buffers made once), its
    ``base`` pointed at each epoch's iterator; the staged loop gets the
    iterator itself and the same DevicePrefetchIterator for its windows; a
    non-prefetchable iterator is read as it is. Held on the epochs'
    iterators alone, which touch no card until they are read."""
    net = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    net.device = torch.device("cuda")
    base = _Resettable(_batches(n=3))
    per_batch = list(net._epochs(base, 3, False))
    assert all(it is reader and reader is per_batch[0][1] for it, reader in per_batch)
    assert per_batch[0][1].base is base and base.resets == 3 and net.epoch == 3
    staged = list(net._epochs(base, 2, True))
    assert all(it is base and reader is staged[0][1] for it, reader in staged)
    assert isinstance(staged[0][1], DevicePrefetchIterator)
    plain = list(_batches(n=2))  # a list has no prefetch_supported
    assert all(it is plain for it, _ in net._epochs(plain, 2, False))


def test_staged_fit_reads_a_prefetchable_iterator_through_the_async_wrapper(monkeypatch):
    """On the CPU ``fit(stage_on_device=K)`` reads a prefetchable iterator
    through an AsyncDataSetIterator an epoch, as the JAX package does; the
    trajectory is bit for bit the one of the same batches read as they
    are."""
    made = []
    real_init = AsyncDataSetIterator.__init__

    def spy(self, *a, **kw):
        made.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(AsyncDataSetIterator, "__init__", spy)
    data = _batches(n=5)
    a = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    b = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    base = ListDataSetIterator(data)
    a.fit(base, epochs=2, stage_on_device=2)
    assert len(made) == 2 and all(m.base is base for m in made)
    b.fit(list(data), epochs=2, stage_on_device=2)
    assert len(made) == 2
    assert a.iteration == b.iteration == 10 and a.staged_steps_total == 10
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    _no_thread_left("async-iterator")


def _graph_conf():
    return (pt.ComputationGraphConfiguration.builder().seed(5)
            .updater(pt.UpdaterConfig(updater="adam", learning_rate=1e-2).to_dict())
            .add_inputs("in").add_layer("h", pt.DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
            .set_outputs("out").set_input_types(pt.InputType.feed_forward(5)).build())


@pytest.mark.parametrize("graph", [False, True])
def test_staged_epoch_stages_the_next_window_before_reading_the_losses(graph, monkeypatch):
    """A staged epoch of ragged batches (the stager's windows of up to 2):
    window i+1's copy starts after window i's updates are queued and before
    window i's losses are read; every window is queued once and read once,
    in order; the trajectory is bit for bit the one of the same windows
    trained by ``fit_on_device``."""
    rng = np.random.default_rng(6)
    data = [pt.DataSet(rng.normal(size=(b, 5)).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)])
            for b in (4, 4, 3, 4, 4, 2, 4)]
    make = ((lambda: pt.ComputationGraph(_graph_conf(), device="cpu")) if graph
            else (lambda: pt.MultiLayerNetwork(_conf(), device="cpu")))
    cls, log = type(make()), []
    real = (DevicePrefetchIterator.start_copy, cls._start_window, cls._finish_window)
    monkeypatch.setattr(DevicePrefetchIterator, "start_copy",
                        lambda self, item: log.append("copy") or real[0](self, item))
    monkeypatch.setattr(cls, "_start_window",
                        lambda self, *a: log.append("start") or real[1](self, *a))
    monkeypatch.setattr(cls, "_finish_window",
                        lambda self, q: log.append("finish") or real[2](self, q))
    net = make().init()
    net.fit(list(data), stage_on_device=2)
    ref = make().init()
    windows = [w for kind, w in BucketedStager(2).plan(data, ref._normalize)]
    assert len(windows) == 5  # (4, 4), (3), (4, 4), (2), (4) rows
    assert log == ["copy", "start"] + ["copy", "finish", "start"] * 4 + ["finish"]
    assert net.staged_steps_total == net.iteration == len(data)
    def one(a):  # MultiLayerNetwork takes the one input's and output's arrays
        return a if graph or a is None else a[0]

    for w in windows:
        ref.fit_on_device(one(w.features), one(w.labels), steps=w.n_real,
                          features_masks=one(w.features_masks),
                          labels_masks=one(w.labels_masks), real_batches=w.n_real)
    for p, q in zip(net.parameters(), ref.parameters()):
        assert torch.equal(p, q)


def test_fit_raises_the_iterators_exception():
    def base():
        yield from _batches(n=2)
        raise RuntimeError("broken reader")

    class It(pt.DataSetIterator):
        def __iter__(self):
            return base()

    net = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    with pytest.raises(RuntimeError, match="broken reader"):
        net.fit(It())
    assert net.iteration == 2
    _no_thread_left("async-iterator")


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned side-stream copies and CUDA graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_device_prefetch_matches_the_host_batches(cuda_device):
    """Batches of PREFETCH_MIN_BYTES come out on the card as the host's."""
    rng = np.random.default_rng(5)
    rows = PREFETCH_MIN_BYTES // (4 * 1024)
    data = [pt.DataSet(rng.normal(size=(rows, 1024)).astype(np.float32),
                       np.ones((rows, 3), np.float32), labels_mask=np.ones(rows, np.float32))
            for _ in range(4)]
    out = list(DevicePrefetchIterator(ListDataSetIterator(data), device=cuda_device))
    torch.cuda.synchronize()
    for got, want in zip(out, data):
        assert got.features.is_cuda
        np.testing.assert_array_equal(got.features.cpu().numpy(), want.features)
        np.testing.assert_array_equal(got.labels_mask.cpu().numpy(), want.labels_mask)
    _no_thread_left("async-iterator")


@pytest.mark.cuda
def test_cuda_device_prefetch_hands_small_batches_out_as_they_come(cuda_device):
    data = _batches(n=5, masks=True)
    before = _threads("async-iterator")
    out = list(DevicePrefetchIterator(ListDataSetIterator(data), device=cuda_device))
    assert all(got is want for got, want in zip(out, data)) and len(out) == len(data)
    assert _threads("async-iterator") == before
    window = PaddedWindow([np.stack([d.features for d in data])],
                          [np.stack([d.labels for d in data])], None, None, n_real=5)
    reader = DevicePrefetchIterator(None, device=cuda_device)  # the staged loop's use
    got = reader.finish_copy(reader.start_copy(window))
    assert got.features[0].is_cuda and got.n_real == 5
    np.testing.assert_array_equal(got.labels[0].cpu().numpy(), window.labels[0])


@pytest.mark.cuda
def test_cuda_fit_makes_one_prefetcher_a_call(cuda_device, monkeypatch):
    """Two epochs of per-batch fit and two of staged fit on the card: one
    DevicePrefetchIterator a call, and the trajectory of the staged call on
    a prefetchable iterator as the one on its batches as a list."""
    made = []
    real_init = DevicePrefetchIterator.__init__

    def spy(self, *a, **kw):
        made.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(DevicePrefetchIterator, "__init__", spy)
    data = _batches(n=4)
    net = pt.MultiLayerNetwork(_conf(), device=cuda_device).init()
    net.fit(ListDataSetIterator(data), epochs=2)
    assert len(made) == 1
    a = pt.MultiLayerNetwork(_conf(), device=cuda_device).init()
    b = pt.MultiLayerNetwork(_conf(), device=cuda_device).init()
    a.fit(ListDataSetIterator(data), epochs=2, stage_on_device=2)
    b.fit(list(data), epochs=2, stage_on_device=2)
    assert len(made) == 3 and a.staged_steps_total == 8
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    _no_thread_left("async-iterator")


@pytest.mark.cuda
def test_cuda_fit_on_device_replays_a_captured_step(cuda_device):
    """A window of 4 updates: one capture, 4 replays, the trajectory within
    1e-5 of eager per-batch fit on the card (same kernels, other host
    order)."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(2, 4, 5)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 4))]
    staged = pt.MultiLayerNetwork(_conf(), device=cuda_device).init()
    eager = pt.MultiLayerNetwork(_conf(), device=cuda_device).init()
    losses = staged.fit_on_device(xs, ys, steps=4)
    want = []
    for i in range(4):
        eager.fit((xs[i % 2], ys[i % 2]))
        want.append(float(eager.score()))
    assert staged._step_graphs.replays == 4 and len(staged._step_graphs) == 1
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)
    for p, q in zip(staged.parameters(), eager.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)
