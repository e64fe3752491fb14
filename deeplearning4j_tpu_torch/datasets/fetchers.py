"""MNIST for ``fit`` (counterpart of the MNIST part of
``deeplearning4j_tpu/datasets/fetchers.py``): the IDX reader, the
synthetic stand-in and ``MnistDataSetIterator``.

``load_mnist`` reads the four IDX files from a local directory (``root``,
else ``$MNIST_DIR``) when they are there, and otherwise returns the JAX
package's deterministic stand-in of the same shape (seed 0 for the
training split, 1 for the test split). It downloads nothing: the JAX
package's ``fetch_mnist`` is not ported, nor its native C++ IDX reader
(``runtime/``), and it reads no directory under ``$HOME``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Optional

import numpy as np

from .iterators import NumpyDataSetIterator

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
