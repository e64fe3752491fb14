"""Dataset fetchers and their iterators (counterpart of
``deeplearning4j_tpu/datasets/fetchers.py``): MNIST, the handwritten
digits, Iris, CIFAR-10, LFW and Curves.

- ``load_mnist`` reads the four IDX files from a local directory (``root``,
  else ``$MNIST_DIR``) when they are there, and otherwise returns the JAX
  package's deterministic stand-in of the same shape (seed 0 for the
  training split, 1 for the test split). ``fetch_mnist`` downloads and
  checks the four archives into such a directory (any URL ``urllib``
  opens, ``file://`` mirrors included). Uncompressed IDX files are read
  by the native C++ reader (``runtime.native_idx_read``) where it builds,
  as the JAX package reads them; a native read that fails raises (there is
  no quiet fallback to the Python reader), and ``.gz`` files and machines
  without a C++ compiler use the Python ``read_idx``.
- ``load_digits_dataset`` and ``load_iris`` read the corpora bundled in
  ``data/``: ``digits.csv.gz`` (the UCI Optical Recognition of Handwritten
  Digits set, 1,797 8x8 scans) and ``iris.csv`` (Fisher's Iris), both
  byte for byte as scikit-learn ships them (BSD-3). Each file's sha256 is
  checked, and a mismatch raises: they never fall back to synthetic data.
  They parse as scikit-learn does, so the arrays are the JAX package's.
- ``load_cifar10`` reads the binary batch files and ``LFWDataSetIterator``
  an image tree from ``root`` (else ``$CIFAR_DIR``, ``$LFW_DIR``), each
  with the JAX package's synthetic stand-in where there is no local copy.

Nothing here reads or writes a directory under ``$HOME``: a directory comes
from the caller or from its environment variable.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from .iterators import DataSet, DataSetIterator, NumpyDataSetIterator

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
               0x0D: np.float32, 0x0E: np.float64}


def read_idx(path: str) -> np.ndarray:
    """An IDX file (optionally .gz) as an array (reference: MnistManager's
    readers)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        if dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: unknown IDX dtype code {dtype_code:#x}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dt = np.dtype(_IDX_DTYPES[dtype_code]).newbyteorder(">")
        data = np.frombuffer(f.read(), dtype=dt)
    return data.reshape(dims)


def _find_idx(root: str, names: List[str]) -> Optional[str]:
    for n in names:
        for cand in (os.path.join(root, n), os.path.join(root, n + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _synthetic_classification(n: int, n_features: int, n_classes: int, seed: int):
    """Deterministic separable stand-in: a class template plus noise, scaled
    to [0, 1] (the JAX package's, draw for draw)."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_classes, n_features)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n)
    x = templates[y] + 0.3 * rng.normal(size=(n, n_features)).astype(np.float32)
    x = (x - x.min()) / (x.max() - x.min())
    return x.astype(np.float32), y.astype(np.int64)


# the four MNIST archives' sha256 digests (reference: MnistFetcher.java pins
# MD5s of the same files)
MNIST_SHA256 = {
    "train-images-idx3-ubyte.gz":
        "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8f203523609",
    "train-labels-idx1-ubyte.gz":
        "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730e8010255c",
    "t10k-images-idx3-ubyte.gz":
        "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f5a2dbc4e6",
    "t10k-labels-idx1-ubyte.gz":
        "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb259924204aec6",
}


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fetch_mnist(root: Optional[str] = None, base_url: Optional[str] = None,
                checksums: Optional[dict] = None, timeout_s: float = 60.0) -> str:
    """Download and check the four MNIST IDX archives into ``root`` (else
    ``$MNIST_DIR``; one of them must be given) and return it (reference:
    MnistFetcher.java). ``base_url`` defaults to ``$DL4J_TPU_MNIST_URL``,
    else the canonical host. A file already there with the right digest is
    kept, one with a wrong digest replaced; a download whose digest does not
    match ``checksums`` (default ``MNIST_SHA256``) raises ValueError and is
    not written."""
    import urllib.request  # noqa: PLC0415

    root = root or os.environ.get("MNIST_DIR")
    if not root:
        raise ValueError("fetch_mnist needs root= or $MNIST_DIR")
    base = (base_url or os.environ.get("DL4J_TPU_MNIST_URL")
            or "https://ossci-datasets.s3.amazonaws.com/mnist/").rstrip("/")
    digests = checksums if checksums is not None else MNIST_SHA256
    os.makedirs(root, exist_ok=True)
    for name, want in digests.items():
        dest = os.path.join(root, name)
        if os.path.exists(dest):
            if _sha256(dest) == want:
                continue
            os.remove(dest)
        with urllib.request.urlopen(f"{base}/{name}", timeout=timeout_s) as r:
            data = r.read()
        got = hashlib.sha256(data).hexdigest()
        if got != want:
            raise ValueError(f"{name}: checksum mismatch (got {got[:16]}…, want {want[:16]}…)")
        with open(dest, "wb") as f:
            f.write(data)
    return root


def load_mnist(train: bool = True, root: Optional[str] = None):
    """(images [N, 784] float32 in [0, 1], labels [N] int64): the IDX files
    under ``root`` (default ``$MNIST_DIR``) if all are there, else the
    synthetic stand-in (4096 training and 1024 test rows)."""
    root = root or os.environ.get("MNIST_DIR")
    img_names = (["train-images-idx3-ubyte", "train-images.idx3-ubyte"] if train
                 else ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
    lab_names = (["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"] if train
                 else ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
    if root and os.path.isdir(root):
        ip, lp = _find_idx(root, img_names), _find_idx(root, lab_names)
        if ip and lp:
            if not ip.endswith(".gz") and not lp.endswith(".gz"):
                from ..runtime.native_loader import (native_available,  # noqa: PLC0415
                                                     native_idx_read)

                if native_available():
                    images = native_idx_read(ip, scale=255.0).reshape(-1, 784)
                    return images, native_idx_read(lp).astype(np.int64).reshape(-1)
            images = read_idx(ip).reshape(-1, 784).astype(np.float32) / 255.0
            return images, read_idx(lp).astype(np.int64)
    n = 4096 if train else 1024
    return _synthetic_classification(n, 784, 10, seed=0 if train else 1)


class MnistDataSetIterator(NumpyDataSetIterator):
    """MNIST in batches, one-hot labels of 10 classes (reference:
    datasets/iterator/impl/MnistDataSetIterator.java), shuffled by default
    as the JAX package's."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 123, root: Optional[str] = None,
                 num_examples: Optional[int] = None):
        x, y = load_mnist(train=train, root=root)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, np.eye(10, dtype=np.float32)[y], batch, shuffle=shuffle,
                         seed=seed)


# ---------------------------------------------------------------------------
# the bundled corpora: handwritten digits and Iris
# ---------------------------------------------------------------------------

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CORPUS_SHA256 = {
    "digits.csv.gz": "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22",
    "iris.csv": "f13ffa8fdd56fd8e6c8d16d4081a3fbd3114bcd0aae4256c43205169cd9d1449",
}


def _corpus(name: str) -> str:
    """The bundled file ``name``'s path, its digest checked."""
    path = os.path.join(DATA_DIR, name)
    got = _sha256(path)
    if got != CORPUS_SHA256[name]:
        raise ValueError(f"{path}: checksum mismatch (got {got[:16]}…, "
                         f"want {CORPUS_SHA256[name][:16]}…)")
    return path


def load_digits_dataset() -> Tuple[np.ndarray, np.ndarray]:
    """The real handwritten digits: (images [1797, 64] float32 in [0, 1],
    labels [1797] int64), scikit-learn's ``load_digits`` data / 16."""
    with gzip.open(_corpus("digits.csv.gz"), "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return (data[:, :-1] / 16.0).astype(np.float32), data[:, -1].astype(np.int64)


class DigitsDataSetIterator(NumpyDataSetIterator):
    """The digits in batches, one-hot labels of 10 classes: a split of the
    corpus permuted by ``split_seed`` (it is ordered by writer), the first
    ``n_train`` for training and the rest held out; NHWC [8, 8, 1] images
    unless ``flat``."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 123, n_train: int = 1437, flat: bool = False,
                 split_seed: int = 42):
        x, y = load_digits_dataset()
        perm = np.random.default_rng(split_seed).permutation(len(x))
        x, y = x[perm], y[perm]
        sl = slice(None, n_train) if train else slice(n_train, None)
        x, y = x[sl], y[sl]
        if not flat:
            x = x.reshape(-1, 8, 8, 1)
        super().__init__(x, np.eye(10, dtype=np.float32)[y], batch, shuffle=shuffle,
                         seed=seed)


def load_iris() -> Tuple[np.ndarray, np.ndarray]:
    """Fisher's Iris: (features [150, 4] float32, labels [150] int64), as
    scikit-learn's ``load_iris`` (the header row dropped)."""
    data = np.loadtxt(_corpus("iris.csv"), delimiter=",", skiprows=1)
    return data[:, :-1].astype(np.float32), data[:, -1].astype(np.int64)


class IrisDataSetIterator(NumpyDataSetIterator):
    """Iris in batches, one-hot labels of 3 classes, a short last batch kept
    (reference: IrisDataSetIterator)."""

    def __init__(self, batch: int = 150, num_examples: int = 150,
                 shuffle: bool = False, seed: int = 123):
        x, y = load_iris()
        x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, np.eye(3, dtype=np.float32)[y], batch, drop_last=False,
                         shuffle=shuffle, seed=seed)


# ---------------------------------------------------------------------------
# CIFAR-10 (binary batch files), LFW (an image tree), Curves
# ---------------------------------------------------------------------------


def load_cifar10(train: bool = True, root: Optional[str] = None):
    """(images [N, 32, 32, 3] float32 in [0, 1], labels [N] int64) from the
    binary batch files under ``root`` (else ``$CIFAR_DIR``; also in its
    ``cifar-10-batches-bin``), each record a label byte and 3072 bytes of
    channel-planar RGB; else the synthetic stand-in (2048 training, 512 test
    rows)."""
    root = root or os.environ.get("CIFAR_DIR")
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train else ["test_batch.bin"]
    if root and os.path.isdir(root):
        paths = [os.path.join(root, n) for n in names]
        sub = os.path.join(root, "cifar-10-batches-bin")
        if not all(os.path.exists(p) for p in paths) and os.path.isdir(sub):
            paths = [os.path.join(sub, n) for n in names]
        if all(os.path.exists(p) for p in paths):
            raws = [np.fromfile(p, dtype=np.uint8).reshape(-1, 3073) for p in paths]
            x = np.concatenate([r[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                                for r in raws])
            return x.astype(np.float32) / 255.0, np.concatenate(
                [r[:, 0].astype(np.int64) for r in raws])
    x, y = _synthetic_classification(2048 if train else 512, 32 * 32 * 3, 10,
                                     seed=2 if train else 3)
    return x.reshape(-1, 32, 32, 3), y


class CifarDataSetIterator(NumpyDataSetIterator):
    """CIFAR-10 in batches of NHWC images, one-hot labels of 10 classes
    (reference: CifarDataSetIterator)."""

    def __init__(self, batch: int, train: bool = True, shuffle: bool = True,
                 seed: int = 123, root: Optional[str] = None,
                 num_examples: Optional[int] = None):
        x, y = load_cifar10(train=train, root=root)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, np.eye(10, dtype=np.float32)[y], batch, shuffle=shuffle,
                         seed=seed)


class LFWDataSetIterator(DataSetIterator):
    """Labelled Faces in the Wild (reference: LFWDataSetIterator):
    ``root/<person>/<image>`` (else ``$LFW_DIR``) through
    ``ImageRecordReader``, pixels / 255, one class a person; else
    ``num_labels`` synthetic classes of ``examples_per_label`` images. Only
    whole batches."""

    def __init__(self, batch: int, height: int = 64, width: int = 64,
                 channels: int = 3, root: Optional[str] = None,
                 num_labels: int = 10, examples_per_label: int = 8, seed: int = 5):
        self.batch = int(batch)
        root = root or os.environ.get("LFW_DIR")
        if root and os.path.isdir(root) and any(
                os.path.isdir(os.path.join(root, d)) for d in os.listdir(root)):
            from .records import ImageRecordReader  # noqa: PLC0415

            reader = ImageRecordReader(height, width, channels, root=root)
            self._labels = reader.labels
            recs = list(reader)
            self._x = np.stack([np.asarray(r[:-1], np.float32).reshape(height, width, channels)
                                / 255.0 for r in recs])
            self._y = np.eye(len(self._labels), dtype=np.float32)[
                np.asarray([int(r[-1]) for r in recs])]
        else:
            x, y = _synthetic_classification(num_labels * examples_per_label,
                                             height * width * channels, num_labels, seed)
            self._labels = [f"person_{i}" for i in range(num_labels)]
            self._x = x.reshape(-1, height, width, channels)
            self._y = np.eye(num_labels, dtype=np.float32)[y]

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def batch_size(self) -> int:
        return self.batch

    def __iter__(self):
        for s in range(0, len(self._x) - self.batch + 1, self.batch):
            yield DataSet(self._x[s:s + self.batch], self._y[s:s + self.batch])


class CurvesDataSetIterator(NumpyDataSetIterator):
    """Sampled sine curves of random phase and frequency, labels = features,
    for autoencoder targets (reference: CurvesDataSetIterator)."""

    def __init__(self, batch: int, n: int = 1024, dim: int = 784, seed: int = 11):
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 1, dim, dtype=np.float32)
        phase = rng.uniform(0, 2 * np.pi, size=(n, 1)).astype(np.float32)
        freq = rng.uniform(1.0, 4.0, size=(n, 1)).astype(np.float32)
        x = (0.5 + 0.5 * np.sin(2 * np.pi * freq * t[None, :] + phase)).astype(np.float32)
        super().__init__(x, x, batch)
