"""The port's C++ batch loader (``runtime/native_loader.py`` over its copy
of ``runtime/native/dataloader.cpp``) and ``load_mnist``'s native IDX path,
against the JAX package's loader (its cases of
``tests/test_native_runtime.py``).

Both packages' libraries are built here with g++ (the port's into
``build/torch_native/``). The CSV and IDX reads are held bit for bit
against JAX's native reads and the Python readers (CSV against numpy's
parse at 1e-6: ``strtof`` and numpy's parse may round a decimal apart);
the batches bit for bit and in the same order as JAX's
``NativeDataSetIterator`` for the same seed, over two epochs; a small
conf's Adam losses through each package's loader at 1e-5 relative (f32 on
both sides, JAX with x64 off).
"""

import ctypes
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.datasets import fetchers as jfetch  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.runtime import native_loader as jnative  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import runtime as prt  # noqa: E402
from deeplearning4j_tpu_torch.datasets import fetchers as pfetch  # noqa: E402
from deeplearning4j_tpu_torch.runtime import native_loader as pnative  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True)
def both_built(monkeypatch):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    for _ in range(30):
        if jnative.native_available():
            break
        # the JAX loader builds beside its source without a lock: a test
        # process that read the file while another one's g++ wrote it
        # remembers the failed load, so look again once that build is done
        time.sleep(1.0)
        monkeypatch.setattr(jnative, "_build_failed", False)
    assert jnative.native_available(), "the JAX package's loader did not build"
    assert pnative.native_available()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def _batches(it):
    return [(np.array(ds.features), np.array(ds.labels)) for ds in it]


# ----------------------------------------------------------------- build
def test_library_is_built_under_build_torch_native():
    path = pnative.lib_path()
    assert path.parent.parts[-2:] == ("build", "torch_native") and path.exists()
    assert path.parent != pnative.SRC.parent  # not beside the source, as JAX's
    assert pnative.SRC.read_text().count("dl4j_shuffled_indices") == \
        open(jnative._SRC).read().count("dl4j_shuffled_indices")


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(pnative, "SRC", bad)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_error", None)
    with pytest.raises(pnative.NativeCompileError, match="broken.cpp") as err:
        pnative.native_idx_read(str(tmp_path / "x"))
    assert "error" in str(err.value)  # g++'s diagnostics are in the message
    assert pnative.native_available() is False
    with pytest.raises(pnative.NativeCompileError):  # remembered, raised again
        pt.NativeDataSetIterator(np.zeros((2, 1)), np.zeros((2, 1)), batch=1)
    assert not list((tmp_path / "build").glob("*.so"))


# ----------------------------------------------------------------- reads
def test_csv_read_matches_jax_and_python(tmp_path):
    mat = np.random.default_rng(0).normal(size=(50, 7)).astype(np.float32)
    p = tmp_path / "m.csv"
    with open(p, "w") as f:
        f.write("h1,h2,h3,h4,h5,h6,h7\n")
        for row in mat:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    got = prt.native_csv_read(str(p), skip_lines=1)
    np.testing.assert_array_equal(got, jnative.native_csv_read(str(p), skip_lines=1))
    assert got.shape == (50, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.loadtxt(p, delimiter=",", skiprows=1), atol=1e-6)
    semi = tmp_path / "s.csv"
    semi.write_text("1;2\n3;4\n")
    np.testing.assert_array_equal(prt.native_csv_read(str(semi), delimiter=";"),
                                  [[1, 2], [3, 4]])


def test_ragged_csv_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("1,2,3\n4,5\n")
    with pytest.raises(IOError, match="code 3"):
        prt.native_csv_read(str(p))
    with pytest.raises(IOError):
        prt.native_csv_read(str(tmp_path / "missing.csv"))


def test_idx_read_matches_jax_and_python(tmp_path):
    data = np.random.default_rng(1).integers(0, 256, (10, 5, 4)).astype(np.uint8)
    p = str(tmp_path / "x-idx3-ubyte")
    _write_idx(p, data)
    got = prt.native_idx_read(p)
    np.testing.assert_array_equal(got, jnative.native_idx_read(p))
    np.testing.assert_array_equal(got, pfetch.read_idx(p))
    assert got.dtype == np.float32 and got.shape == (10, 5, 4)
    scaled = prt.native_idx_read(p, scale=255.0)
    np.testing.assert_array_equal(scaled, jnative.native_idx_read(p, scale=255.0))
    np.testing.assert_allclose(scaled, data / 255.0, atol=1e-7)
    wrong_type = str(tmp_path / "f-idx1")
    with open(wrong_type, "wb") as f:  # float32 IDX: the native reader takes ubyte only
        f.write(struct.pack(">HBBI", 0, 0x0D, 1, 1) + b"\x00" * 4)
    with pytest.raises(IOError, match="code 4"):
        prt.native_idx_read(wrong_type)


def test_load_mnist_reads_through_the_native_reader(tmp_path, monkeypatch):
    """Uncompressed files go through ``native_idx_read`` (JAX's arrays bit
    for bit); a native read that fails raises, with no fallback."""
    rng = np.random.default_rng(2)
    _write_idx(str(tmp_path / "t10k-images-idx3-ubyte"),
               rng.integers(0, 256, (9, 28, 28)).astype(np.uint8))
    _write_idx(str(tmp_path / "t10k-labels-idx1-ubyte"), rng.integers(0, 10, 9).astype(np.uint8))
    calls = []
    real = pnative.native_idx_read
    monkeypatch.setattr(pnative, "native_idx_read",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    x, y = pfetch.load_mnist(train=False, root=str(tmp_path))
    jx, jy = jfetch.load_mnist(train=False, root=str(tmp_path))
    assert len(calls) == 2 and x.shape == (9, 784) and y.dtype == np.int64
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)

    def failing(path, scale=0.0):
        raise IOError(f"dl4j_idx_read({path}) failed with code 2")

    monkeypatch.setattr(pnative, "native_idx_read", failing)
    with pytest.raises(IOError, match="code 2"):
        pfetch.load_mnist(train=False, root=str(tmp_path))


# ---------------------------------------------------------------- loader
def test_shuffled_indices_are_jaxs():
    lib = jnative._load()
    for n, seed in ((1, 0), (64, 7), (1000, 123), (60000, 1234)):
        want = np.empty(n, np.int64)
        lib.dl4j_shuffled_indices(n, seed, want.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        np.testing.assert_array_equal(pnative.native_shuffled_indices(n, seed), want)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_and_order_match_jax_over_two_epochs(drop_last, shuffle):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(70, 3, 2)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 70)]
    kw = dict(batch=16, shuffle=shuffle, seed=11, drop_last=drop_last, queue_size=3,
              workers=2)
    mine = pt.NativeDataSetIterator(feats, labels, **kw)
    theirs = jnative.NativeDataSetIterator(feats, labels, **kw)
    assert len(mine) == len(theirs) == (4 if drop_last else 5)
    epochs = []
    for epoch in range(2):
        got, want = _batches(mine), _batches(theirs)
        assert len(got) == len(want) == len(mine)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
        rows = np.concatenate([gx[:, 0, 0] for gx, _ in got])
        epochs.append(rows)
        if shuffle:  # the epoch's order is the shuffle of seed + epoch
            order = pnative.native_shuffled_indices(70, 11 + epoch)
            np.testing.assert_array_equal(rows, feats[order[:len(rows)], 0, 0])
    assert got[0][0].shape[1:] == (3, 2)
    if not drop_last:
        assert got[-1][0].shape[0] == 70 - 4 * 16
    assert (not np.array_equal(epochs[0], epochs[1])) == shuffle


def test_one_active_iterator_guard_and_reset():
    feats = np.arange(32, dtype=np.float32)[:, None]
    it = pt.NativeDataSetIterator(feats, feats.copy(), batch=8)
    gen1 = iter(it)
    next(gen1)
    gen2 = iter(it)
    with pytest.raises(RuntimeError, match="one active iterator"):
        next(gen2)
    assert sum(1 for _ in gen1) == 3  # the first generator drains undisturbed
    assert sum(1 for _ in it) == 4  # an exhausted epoch restarts
    gen3 = iter(it)
    next(gen3)
    it.reset()
    assert list(gen3) == []  # invalidated, it does not drain the new epoch
    seen = [int(v) for ds in it for v in ds.labels[:, 0]]
    assert sorted(seen) == list(range(32))
    assert pt.NativeDataSetIterator.prefetch_supported is False
    with pytest.raises(ValueError, match="batch"):
        pt.NativeDataSetIterator(feats, feats, batch=0)
    with pytest.raises(ValueError, match="rows"):
        pt.NativeDataSetIterator(feats, feats[:5], batch=2)
    it.close()
    it.close()


def test_fit_through_the_loader_matches_jax_losses():
    """A small conf's Adam training, two epochs through each package's
    loader (shuffled, two workers), from the same f32 params."""
    def conf(pkg):
        u = pkg.UpdaterConfig(updater="adam", learning_rate=5e-3)
        return pkg.MultiLayerConfiguration(
            layers=[pkg.ConvolutionLayer(n_out=4, kernel=(3, 3), activation="relu"),
                    pkg.DenseLayer(n_out=16, activation="relu"),
                    pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
            input_type=pkg.InputType.convolutional(6, 6, 1),
            updater=u if pkg is dj else u.to_dict(), seed=3)

    rng = np.random.default_rng(5)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)]
    imgs = (labels @ rng.normal(size=(3, 36)).astype(np.float32)).reshape(96, 6, 6, 1)
    imgs += 0.1 * rng.normal(size=imgs.shape).astype(np.float32)
    with jax.enable_x64(False):
        jnet = dj.MultiLayerNetwork(conf(dj)).init()
        jnet.init(params=_f32(jnet.params), force=True)
        pnet = pt.load_jax_params(pt.MultiLayerNetwork(conf(pt), device="cpu"), jnet.params)
        losses = {"jax": [], "port": []}

        class Rec:
            def __init__(self, out):
                self.out = out

            def iteration_done(self, model, iteration, score):
                self.out.append(float(score))

        jnet.set_listeners(Rec(losses["jax"]))
        pnet.set_listeners(Rec(losses["port"]))
        kw = dict(batch=32, shuffle=True, seed=9, workers=2)
        jnet.fit(jnative.NativeDataSetIterator(imgs, labels, **kw), epochs=2)
        pnet.fit(pt.NativeDataSetIterator(imgs, labels, **kw), epochs=2)
    assert len(losses["port"]) == len(losses["jax"]) == 6
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL)
    assert losses["port"][-1] < losses["port"][0]
