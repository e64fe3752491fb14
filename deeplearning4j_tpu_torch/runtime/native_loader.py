"""ctypes bindings and build of the native data loader (counterpart of
``deeplearning4j_tpu/runtime/native_loader.py``).

The C++ source is the port's own copy, ``runtime/native/dataloader.cpp``.
It is compiled with g++ at first use into ``build/torch_native/`` at the
root of the checkout (``.gitignore`` lists it), under a file name that
carries a hash of the source and the flags, so an edited source builds anew
and concurrent processes never load a half-written library. Nothing builds
at import.

Where the JAX package's loader remembers a failed build and reports the
runtime unavailable, here a failed build raises :class:`NativeCompileError`
at the first native call, with the compiler's standard error (and again at
every later call, without building again). :func:`native_available` keeps
its meaning: True when the library builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
COMPILER = "g++"
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_error: Optional["NativeCompileError"] = None
_lock = threading.Lock()


class NativeCompileError(RuntimeError):
    """The native loader did not build or load; the message carries the
    compiler's standard error."""


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((COMPILER,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libdl4jtorch-{h.hexdigest()[:16]}.so"


def _build(dest: Path) -> None:
    """Compile into a temporary file beside ``dest``, then rename it into
    place (atomic: another process sees the whole library or none)."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=dest.parent)
    os.close(fd)
    cmd = [COMPILER, *CXX_FLAGS, str(SRC), "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeCompileError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise NativeCompileError(
                f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL:
    """The bound library, built first where needed; raises the build's
    error (remembered) where it cannot be had."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            path = lib_path()
            try:
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
            except NativeCompileError as e:
                _error = e
            except OSError as e:
                _error = NativeCompileError(f"loading {path}: {e}")
            else:
                _declare(lib)
                _lib = lib
        if _error is not None:
            raise _error
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    fp = c.POINTER(c.c_float)
    lib.dl4j_csv_read.restype = c.c_int
    lib.dl4j_csv_read.argtypes = [c.c_char_p, c.c_int, c.c_char,
                                  c.POINTER(fp), c.POINTER(c.c_int64),
                                  c.POINTER(c.c_int64)]
    lib.dl4j_idx_read.restype = c.c_int
    lib.dl4j_idx_read.argtypes = [c.c_char_p, c.c_float, c.POINTER(fp),
                                  c.POINTER(c.c_int32), c.POINTER(c.c_int64)]
    lib.dl4j_free.restype = None
    lib.dl4j_free.argtypes = [c.c_void_p]
    lib.dl4j_shuffled_indices.restype = None
    lib.dl4j_shuffled_indices.argtypes = [c.c_int64, c.c_uint64,
                                          c.POINTER(c.c_int64)]
    lib.dl4j_loader_create.restype = c.c_void_p
    lib.dl4j_loader_create.argtypes = [fp, fp, c.c_int64, c.c_int64,
                                       c.c_int64, c.c_int64, c.c_int,
                                       c.c_uint64, c.c_int, c.c_int, c.c_int]
    lib.dl4j_loader_num_batches.restype = c.c_int64
    lib.dl4j_loader_num_batches.argtypes = [c.c_void_p]
    lib.dl4j_loader_next.restype = c.c_int64
    lib.dl4j_loader_next.argtypes = [c.c_void_p, fp, fp]
    lib.dl4j_loader_reset.restype = None
    lib.dl4j_loader_reset.argtypes = [c.c_void_p, c.c_int, c.c_uint64]
    lib.dl4j_loader_destroy.restype = None
    lib.dl4j_loader_destroy.argtypes = [c.c_void_p]


def native_available() -> bool:
    """True when the native library builds (or is built) and loads."""
    try:
        _load()
    except NativeCompileError:
        return False
    return True


def native_csv_read(path: str, skip_lines: int = 0,
                    delimiter: str = ",") -> np.ndarray:
    """Parse a numeric CSV to a float32 [rows, cols] matrix natively; a
    ragged file raises IOError."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.dl4j_csv_read(path.encode(), skip_lines,
                           delimiter.encode()[0:1], ctypes.byref(out),
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"dl4j_csv_read({path}) failed with code {rc}")
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    finally:
        lib.dl4j_free(out)
    return arr.reshape(rows.value, cols.value)


def native_idx_read(path: str, scale: float = 0.0) -> np.ndarray:
    """Read an uncompressed unsigned-byte IDX file natively as float32;
    ``scale`` > 0 divides (255 maps pixels to [0, 1])."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    ndim = ctypes.c_int32()
    dims = (ctypes.c_int64 * 8)()
    rc = lib.dl4j_idx_read(path.encode(), scale, ctypes.byref(out),
                           ctypes.byref(ndim), dims)
    if rc != 0:
        raise IOError(f"dl4j_idx_read({path}) failed with code {rc}")
    shape = tuple(dims[i] for i in range(ndim.value))
    n = int(np.prod(shape)) if shape else 0
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    finally:
        lib.dl4j_free(out)
    return arr.reshape(shape)


def native_shuffled_indices(n: int, seed: int) -> np.ndarray:
    """The loader's permutation of ``range(n)`` for ``seed`` (an epoch's
    order is that of seed + epoch)."""
    lib = _load()
    out = np.empty(int(n), np.int64)
    lib.dl4j_shuffled_indices(int(n), int(seed),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


class NativeDataSetIterator:
    """DataSetIterator over the C++ prefetching loader (reference:
    AsyncDataSetIterator.java:36's consumer thread, natively).

    Worker threads shuffle and gather batches into a native ring of
    ``queue_size`` slots while the card computes; epochs reshuffle with
    seed + epoch. One native consume cursor backs the iterator, so one
    generator may be active at a time; iterating an exhausted epoch starts
    the next (reshuffled), as ``NumpyDataSetIterator`` does. The batches
    are host arrays, so ``fit`` reads them as they come
    (``prefetch_supported`` is False: the loader prefetches itself)."""

    prefetch_supported = False

    def __init__(self, features, labels, batch: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, queue_size: int = 4,
                 workers: int = 2):
        lib = _load()
        if int(batch) < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self._lib = lib
        # the loader borrows these buffers: keep them alive, dense float32
        self._features = np.ascontiguousarray(features, dtype=np.float32)
        self._labels = np.ascontiguousarray(labels, dtype=np.float32)
        if self._features.ndim < 2:
            self._features = self._features.reshape(len(self._features), -1)
        if self._labels.ndim < 2:
            self._labels = self._labels.reshape(len(self._labels), -1)
        if len(self._features) != len(self._labels):
            raise ValueError(f"{len(self._features)} feature rows but "
                             f"{len(self._labels)} label rows")
        self._feature_shape = self._features.shape[1:]
        self._f2 = self._features.reshape(len(self._features), -1)
        self._l2 = self._labels.reshape(len(self._labels), -1)
        self.batch = int(batch)
        self.shuffle = shuffle
        self._epoch = 0
        self._consumed = 0
        self._generation = 0
        self._iterating = False
        fp = ctypes.POINTER(ctypes.c_float)
        self._handle = lib.dl4j_loader_create(
            self._f2.ctypes.data_as(fp), self._l2.ctypes.data_as(fp),
            self._f2.shape[0], self._f2.shape[1], self._l2.shape[1], self.batch,
            1 if shuffle else 0, seed, 1 if drop_last else 0, queue_size, workers)

    def batch_size(self) -> int:
        return self.batch

    def __len__(self) -> int:
        return int(self._lib.dl4j_loader_num_batches(self._handle))

    def reset(self) -> None:
        """Start the next epoch (reshuffled with seed + epoch); a suspended
        generator of the last one ends without draining the new cursor."""
        self._epoch += 1
        self._consumed = 0
        self._generation += 1
        self._iterating = False
        self._lib.dl4j_loader_reset(self._handle, 1 if self.shuffle else 0, self._epoch)

    def __iter__(self):
        if len(self) > 0 and self._consumed >= len(self):
            self.reset()
        if self._iterating:
            raise RuntimeError(
                "NativeDataSetIterator supports one active iterator at a time "
                "(single C++ consume cursor); exhaust or discard the previous "
                "generator (or call reset()) before starting another")
        self._iterating = True
        gen = self._generation
        try:
            yield from self._drain(gen)
        finally:
            if self._generation == gen:
                self._iterating = False

    def _drain(self, gen: int):
        from ..datasets.iterators import DataSet  # noqa: PLC0415

        fp = ctypes.POINTER(ctypes.c_float)
        fcols, lcols = self._f2.shape[1], self._l2.shape[1]
        while self._generation == gen:
            feat = np.empty((self.batch, fcols), np.float32)
            lab = np.empty((self.batch, lcols), np.float32)
            n = self._lib.dl4j_loader_next(self._handle, feat.ctypes.data_as(fp),
                                           lab.ctypes.data_as(fp))
            if n == 0:
                return
            self._consumed += 1
            yield DataSet(feat[:n].reshape((n,) + self._feature_shape), lab[:n])

    def close(self) -> None:
        """Stop the loader's threads and free it; safe to call again."""
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.dl4j_loader_destroy(handle)

    def __del__(self):
        self.close()
