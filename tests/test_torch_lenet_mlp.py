"""The PyTorch port's LeNet and MNIST MLP on MultiLayerNetwork, its MNIST
data path, and ``MultiLayerNetwork.summary``, ``feed_forward`` and
``clone``, against the JAX package.

``lenet_mnist_conf()`` and ``examples/mlp_mnist.py``'s MLP conf build the
same JSON in both packages. Both train with Adam at lr 1e-3 over
``NumpyDataSetIterator`` batches of the synthetic MNIST (shuffled by the
iterator's seed, two epochs), the JAX side with x64 off (under x64 it
computes Adam's bias corrections in f64, as ``test_torch_adam.py``
explains). The losses of every update are held at 1e-5, and every param
element at 1e-5 but for at most one in 10,000, which must stay within a
tenth of one Adam step (lr / 10): Adam scales each element's step by
g / (|g| + 1e-8), and where a weight's gradient is a sum that cancels to
about 1e-8, f32 rounding of that sum moves the step by a few percent of
the lr (after 8 updates 13 of LeNet's 431,080 params lie 1e-5 to 3.6e-5
from JAX's, in its convolution 2 and dense weights; none of the MLP's).
A wrong Adam moves every element by about the lr.
``MnistDataSetIterator``'s data and batch order, ``read_idx``
and ``load_mnist`` on local IDX files, ``NumpyDataSetIterator``'s options,
``summary``, ``feed_forward``, ``clone``, ``evaluate`` and ``score`` are
held exactly or at 1e-5.
"""

import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets import fetchers as jfetch  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.models.lenet import lenet_mnist_conf as jax_lenet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402
from deeplearning4j_tpu_torch.datasets import fetchers as pfetch  # noqa: E402

RTOL = ATOL = 1e-5
LR = 1e-3
ADAM_OUTLIERS = 1e-4  # share of param elements past ATOL, each within LR / 10


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    monkeypatch.delenv("MNIST_DIR", raising=False)
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _mlp_conf(pkg):
    """examples/mlp_mnist.py:26-34's conf."""
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-3)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=256, activation="relu"),
                pkg.OutputLayer(n_out=10, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(784),
        updater=u if pkg is dj else u.to_dict(), seed=123)


MODELS = {"lenet": (lambda pkg: jax_lenet() if pkg is dj else pt.lenet_mnist_conf(), 64,
                    (-1, 28, 28, 1)),
          "mlp": (_mlp_conf, 128, (-1, 784))}


def _pair(model):
    make, _, _ = MODELS[model]
    jnet = dj.MultiLayerNetwork(make(dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(make(pt), device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    return jnet, pt.load_jax_params(pnet, jnet.params)


def _reshaped(it, shape):
    for ds in it:
        yield ds.features.reshape(shape), ds.labels


# ------------------------------------------------------------- structure
def test_lenet_structure_and_summary_match_jax():
    jnet, pnet = _pair("lenet")
    assert pnet.num_params() == jnet.num_params() == 431_080
    assert pnet.summary() == jnet.summary()
    assert [tuple(l.shape) for l in jax.tree_util.tree_leaves(jnet.params)] == \
        [tuple(l[k].shape) for l in pnet._leaves() for k in sorted(l)]


# -------------------------------------------------------------- training
@pytest.mark.parametrize("model", sorted(MODELS))
def test_adam_trajectory_over_numpy_batches_matches_jax(model):
    """Two epochs of shuffled batches of the synthetic MNIST: every
    update's loss, then each param tensor, then ``evaluate`` and ``score``
    on the test split's first batch."""
    with jax.enable_x64(False):
        _, batch, shape = MODELS[model]
        jnet, pnet = _pair(model)
        x, y = pfetch.load_mnist(train=True)
        n = 4 * batch
        iters = {"jax": jit_.NumpyDataSetIterator(x[:n], np.eye(10, dtype=np.float32)[y[:n]],
                                                  batch, shuffle=True, seed=5),
                 "port": pt.NumpyDataSetIterator(x[:n], np.eye(10, dtype=np.float32)[y[:n]],
                                                 batch, shuffle=True, seed=5)}
        losses = {"jax": [], "port": []}
        for _ in range(2):
            for (jx, jy), (px, py) in zip(_reshaped(iters["jax"], shape),
                                           _reshaped(iters["port"], shape)):
                np.testing.assert_array_equal(px, jx)
                jnet.fit((jx, jy))
                pnet.fit((px, py))
                losses["jax"].append(float(jnet.score()))
                losses["port"].append(pnet.score())
        assert len(losses["port"]) == 8 and losses["port"][-1] < losses["port"][0]
        np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL)
        diffs = np.concatenate([np.abs(pp[k] - np.asarray(v)).ravel() for jp, pp in
                                zip(jnet.params, pt.params_to_numpy(pnet))
                                for k, v in jp.items()])
        assert diffs.max() <= LR / 10, diffs.max()
        assert (diffs > ATOL).sum() <= ADAM_OUTLIERS * diffs.size, (diffs > ATOL).sum()
        tx, ty = pfetch.load_mnist(train=False)
        tx, ty = tx[:batch].reshape(shape), np.eye(10, dtype=np.float32)[ty[:batch]]
        np.testing.assert_array_equal(pnet.evaluate((tx, ty)).confusion.matrix,
                                      jnet.evaluate([dj.DataSet(tx, ty)]).confusion.matrix)
        assert pnet.score(pt.DataSet(tx, ty)) == pytest.approx(
            float(jnet.score(dj.DataSet(tx, ty))), rel=RTOL)


def test_adam_gets_contiguous_leaves_from_convolutions(monkeypatch):
    """The Adam kernel takes contiguous leaves; LeNet's convolution weights'
    gradients come back in a channels-last view's strides, so the Adam
    wrapper copies them before its checks (the same path on the CPU, where
    the plain version would take any strides)."""
    from deeplearning4j_tpu_torch.ops import adam

    given, checked = [], []
    real_update, real_check = adam.fused_adam_update_leaves, adam._check_leaves

    def spy_update(gs, ms, vs, *args):
        given.extend(g.is_contiguous() for g in gs)
        return real_update(gs, ms, vs, *args)

    def spy_check(gs, ms, vs, kernel):
        checked.extend(t.is_contiguous() for leaves in (gs, ms, vs) for t in leaves)
        return real_check(gs, ms, vs, kernel)

    monkeypatch.setattr(adam, "fused_adam_update_leaves", spy_update)
    monkeypatch.setattr(adam, "_check_leaves", spy_check)
    _, pnet = _pair("lenet")
    x, y = pfetch.load_mnist(train=True)
    pnet.fit((x[:8].reshape(-1, 28, 28, 1), np.eye(10, dtype=np.float32)[y[:8]]))
    assert len(given) == 8 and not all(given)
    assert len(checked) == 24 and all(checked)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_mnist_iterator_draws_jax_data_in_jax_order(train):
    """The synthetic stand-in (4096 and 1024 rows, seeds 0 and 1) and the
    shuffled batch order over two epochs, as the JAX package's."""
    x, y = pfetch.load_mnist(train=train)
    jx, jy = jfetch.load_mnist(train=train, root="/nonexistent")
    assert x.shape == (4096 if train else 1024, 784) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    mine = pt.MnistDataSetIterator(batch=100, train=train, num_examples=1000)
    theirs = jfetch.MnistDataSetIterator(batch=100, train=train, num_examples=1000,
                                         root="/nonexistent")
    assert len(mine) == len(theirs) == 10 and mine.batch_size() == 100
    for _ in range(2):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_numpy_iterator_options_match_jax(shuffle, drop_last):
    rng = np.random.default_rng(8)
    x, y = rng.normal(size=(23, 3)), rng.normal(size=(23, 2))
    mine = pt.NumpyDataSetIterator(x, y, 5, drop_last=drop_last, shuffle=shuffle, seed=3)
    theirs = jit_.NumpyDataSetIterator(x, y, 5, drop_last=drop_last, shuffle=shuffle, seed=3)
    assert len(mine) == len(theirs) == (4 if drop_last else 5)
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)


def _write_idx(path, arr, code):
    header = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(">" + "I" * arr.ndim,
                                                                   *arr.shape)
    data = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data)


def test_read_idx_and_load_mnist_read_local_files(tmp_path):
    """IDX files, raw and gzipped, of each dtype code, read as the JAX
    package reads them; ``load_mnist`` takes local files from ``root``
    (and ``$MNIST_DIR``), else the stand-in; a bad magic raises."""
    rng = np.random.default_rng(9)
    for code, dt in ((0x08, np.uint8), (0x0C, np.int32), (0x0D, np.float32)):
        arr = (rng.random((3, 4, 2)) * 100).astype(dt)
        for suffix in ("", ".gz"):
            path = str(tmp_path / f"a{code}{suffix}")
            _write_idx(path, arr, code)
            np.testing.assert_array_equal(pfetch.read_idx(path), jfetch.read_idx(path))
            np.testing.assert_array_equal(pfetch.read_idx(path), arr)
    images = rng.integers(0, 256, (7, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 7).astype(np.uint8)
    _write_idx(str(tmp_path / "t10k-images-idx3-ubyte.gz"), images, 0x08)
    _write_idx(str(tmp_path / "t10k-labels-idx1-ubyte"), labels, 0x08)
    got = pfetch.load_mnist(train=False, root=str(tmp_path))
    want = jfetch.load_mnist(train=False, root=str(tmp_path))
    assert got[0].shape == (7, 784)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pfetch.load_mnist(train=True, root=str(tmp_path))[0].shape == (4096, 784)
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as f:
        f.write(b"\x01\x00\x08\x01\x00\x00\x00\x01\x00")
    with pytest.raises(ValueError, match="bad IDX magic"):
        pfetch.read_idx(bad)


def test_load_mnist_reads_mnist_dir(tmp_path, monkeypatch):
    labels = np.arange(3, dtype=np.uint8)
    _write_idx(str(tmp_path / "train-images-idx3-ubyte"),
               np.zeros((3, 28, 28), np.uint8), 0x08)
    _write_idx(str(tmp_path / "train-labels-idx1-ubyte"), labels, 0x08)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    x, y = pfetch.load_mnist()
    assert x.shape == (3, 784) and y.tolist() == [0, 1, 2]


# ------------------------------------------------- network methods (MLN)
def test_feed_forward_and_clone_match_jax():
    """``feed_forward`` gives every layer's activation as JAX's does; a
    clone holds the same params, layer state, Adam state and iteration,
    and trains apart from the original."""
    jnet, pnet = _pair("lenet")
    x, y = pfetch.load_mnist(train=True)
    x, y = x[:16].reshape(-1, 28, 28, 1), np.eye(10, dtype=np.float32)[y[:16]]
    got, want = pnet.feed_forward(x), jnet.feed_forward(jnp.asarray(x))
    assert [a.shape for a in got] == [tuple(a.shape) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    pnet.fit((x, y))
    twin = pnet.clone()
    assert twin.iteration == pnet.iteration == 1 and twin.lstm_variant == pnet.lstm_variant
    np.testing.assert_array_equal(twin.output(x), pnet.output(x))
    for a, b in zip(twin.updater_state_leaves(), pnet.updater_state_leaves()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    before = pt.params_to_numpy(pnet)
    twin.fit((x, y))
    for a, b in zip(pt.params_to_numpy(pnet), before):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    pnet.fit((x, y))
    for a, b in zip(pt.params_to_numpy(pnet), pt.params_to_numpy(twin)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cuda_mnist_training_launches_the_kernels(cuda_device, model):
    """On the card: one softmax-xent forward and backward and one Adam
    launch per update; the losses as the CPU's."""
    make, batch, shape = MODELS[model]
    cpu = pt.MultiLayerNetwork(make(pt), device="cpu").init()
    card = pt.MultiLayerNetwork(make(pt)).init(params=pt.params_to_numpy(cpu))
    ops.reset_counters()
    for ds in pt.MnistDataSetIterator(batch=batch, num_examples=2 * batch):
        b = (ds.features.reshape(shape), ds.labels)
        card.fit(b)
        cpu.fit(b)
        assert card.score() == pytest.approx(cpu.score(), rel=1e-4)
    counts = ops.counters()
    assert (counts["softmax_xent_fwd"], counts["softmax_xent_bwd"], counts["adam_update"]) == \
        (2, 2, 2)
