"""Build the port's CUDA kernels with nvcc, bind them with ctypes, launch
them.

Each source ``ops/csrc/<name>.cu`` is compiled on its own into a shared
library with a plain C interface, at first use, into ``build/torch_kernels/``
at the root of the checkout (``.gitignore`` lists it). A library's file name
carries a hash of its source, the headers beside it and the flags, so an
edited source builds anew and an unchanged one is loaded as it is.
:func:`build` starts one nvcc per missing library, all at once.

:func:`bind` declares a C entry's arguments once and keeps the function;
:func:`launch` calls it on the current stream and counts the launch
(:func:`count` counts a launch that the C entry makes beside its own). Both
are on every kernel call's path, so after the first call neither takes the
build lock nor enters a device context it is already in. Nothing here runs
at import: the CPU tests import every module on machines that have no
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# the bound C entries by (library, symbol): filled once each, read without
# a lock (one dict lookup under the GIL)
_FNS: Dict[Tuple[str, str], Callable] = {}
# guards the op modules' launch counters: decode tickers and callers on other
# threads launch concurrently
_COUNT_LOCK = threading.Lock()


def sources() -> Dict[str, Path]:
    """Every kernel source of the port, by library name."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """The nvcc of the CUDA toolkit: on PATH, under $CUDA_HOME, or in the
    toolkit's default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use and "
        "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    nvcc each, all started together. Returns the seconds each build took
    (0.0 for a library that was already built). The compiler's report of
    registers and shared memory goes beside the library as ``.log``."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library of ``name``, built first if it is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


def bind(lib: str, symbol: str, n_ptrs: int, n_ints: int,
         n_floats: int = 0) -> Callable:
    """C entry ``symbol`` of library ``lib``, taking ``n_ptrs`` pointers,
    ``n_ints`` ints, ``n_floats`` floats and the stream, returning a CUDA
    error code. The library is loaded (built first if it is missing) and
    the arguments declared on the first call only."""
    fn = _FNS.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[(lib, symbol)] = fn
    return fn


def launch(counts: Dict[str, int], name: str, fn: Callable, device, *args) -> None:
    """Call ``fn`` with ``args`` (tensors as their pointers, None as null)
    and the current stream of ``device``, inside ``device``'s context only
    when it is not the current device; raise on a launch error, else add
    one to ``counts[name]``."""
    import torch  # noqa: PLC0415 - the build helpers above need no torch

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        err = fn(*ptrs, torch.cuda.current_stream(current).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    count(counts, name)


def count(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``: a launch, made by :func:`launch` or
    inside the C entry it called."""
    with _COUNT_LOCK:
        counts[name] += 1
