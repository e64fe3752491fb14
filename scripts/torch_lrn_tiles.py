#!/usr/bin/env python3
"""Time the LRN kernels (rows 3-4) under other tiles and paths, on one NVIDIA GPU.

    python3 scripts/torch_lrn_tiles.py

Builds copies of ``ops/csrc/lrn.cu`` with other values of its constants
(threads a block ``kThreads``, elements of each input a thread holds a tile
``kElems``, in 16-byte vectors) or with one of ``PATCHES`` applied to its
text into ``build/torch_kernels/lrn_tiles/``, and runs each through the
port's wrappers at AlexNet's two LRN shapes, [128, 56, 56, 96] and [128,
27, 27, 256] with n=5, f32 and bf16: the training forward (y and d), the
serving forward (y alone) and the backward. The variants:

- the source's own (first), and other kThreads x kElems tiles;
- ``fast`` off: the wrapper's plan never says "fast", so AlexNet's n=5
  windows take the general loop over the taps from shared memory and the
  powers a runtime exponent, on the source's own build;
- ``depth2``: a block holds two tiles of vectors, the next tile's loads in
  flight while this tile's sums and powers run, over as many blocks as are
  resident at once;
- ``l2``: every block reads and writes the vectors of one of the first
  ``L2_TILES`` tiles only (its tile modulo L2_TILES), so the inputs and
  outputs stay in L2 and device memory moves almost nothing: the time of
  the SM's work (issue, shared memory, the barrier, L2) on the same data.
  Its outputs are wrong by design and it is not checked.

Checks every other variant against the plain version and prints one JSON
line per run: ms per call of each kernel (two medians of CUDA events around
20 calls in a row, so the card's time and not the host's sets it), the
registers and spills of the entries that shape launches, and the largest
error of each output over its largest element. The card's name and power
limit come first and last.
"""

import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OWN = {"kThreads": 256, "kElems": 8}
L2_TILES = 512

# text replacements of lrn.cu, each (old, new) found exactly once
PATCHES = {
    "depth2": [
        ("  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n"
         "    load_tile<Op, V>(op, geo.head, t, nvec, cur);\n",
         "  if (static_cast<int>(blockIdx.x) < tiles)\n"
         "    load_tile<Op, V>(op, geo.head, blockIdx.x, nvec, cur);\n"
         "  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n"),
        ("    __syncthreads();\n    const int ct = start % geo.C;\n",
         "    __syncthreads();\n    VT nxt[kIn][kVecs];\n"
         "    if (t + gridDim.x < tiles) load_tile<Op, V>(op, geo.head, t + gridDim.x, nvec, nxt);\n"
         "    const int ct = start % geo.C;\n"),
        ("    __syncthreads();\n  }\n}\n",
         "    __syncthreads();\n"
         "    for (int j = 0; j < kIn; ++j)\n"
         "      for (int u = 0; u < kVecs; ++u) cur[j][u] = nxt[j][u];\n  }\n}\n"),
        ("  kernel<<<grid, kThreads, smem, stream>>>(op, geo);\n",
         "  int dev, sms, per_sm;\n"
         "  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||\n"
         "      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=\n"
         "          cudaSuccess ||\n"
         "      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,\n"
         "                                                           smem)) != cudaSuccess)\n"
         "    return err;\n"
         "  if (per_sm * sms > 0 && grid > per_sm * sms) grid = per_sm * sms;\n"
         "  kernel<<<grid, kThreads, smem, stream>>>(op, geo);\n"),
    ],
    "l2": [
        ("    const int q = t * (kThreads * kVecs) + u * kThreads + threadIdx.x;\n",
         f"    const int q = (t % {L2_TILES}) * (kThreads * kVecs) + u * kThreads + threadIdx.x;\n"),
        ("(op.out[j] + geo.head)[t * kTileVecs + q]",
         f"(op.out[j] + geo.head)[(t % {L2_TILES}) * kTileVecs + q]"),
    ],
}

# (name, kThreads, kElems, patch or None, fast allowed)
VARIANTS = [("own", 256, 8, None, True), ("fast_off", 256, 8, None, False),
            ("t256_e16", 256, 16, None, True), ("t128_e8", 128, 8, None, True),
            ("t128_e16", 128, 16, None, True), ("t512_e8", 512, 8, None, True),
            ("depth2", 256, 8, "depth2", True), ("l2", 256, 8, "l2", True),
            ("l2_fast_off", 256, 8, "l2", False)]


def ms_runs(cs, fn):
    """Two medians of the ms a call of ``fn`` takes over 20 calls in a row."""
    return [cs.in_a_row_ms(fn) for _ in range(2)]


def build(variants):
    """One library per distinct source, all nvcc runs at once; returns the
    path of each variant's library."""
    from deeplearning4j_tpu_torch.ops import _build

    out, procs = {}, {}
    for name, threads, elems, patch, _ in variants:
        key = f"{threads}_{elems}_{patch or 'plain'}"
        d = _build.BUILD_DIR / "lrn_tiles" / key
        out[name] = d / "lib.so"
        if key in procs:
            continue
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, d)
        src = d / "lrn.cu"
        text = src.read_text()
        edits = [(f"constexpr int {k} = {v};", f"constexpr int {k} = {new};")
                 for (k, v), new in zip(OWN.items(), (threads, elems))]
        for old, new in edits + PATCHES.get(patch, []):
            if text.count(old) != 1:
                raise RuntimeError(f"{src}: {old!r} found {text.count(old)} times, not once")
            text = text.replace(old, new)
        src.write_text(text)
        procs[key] = (d, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {key}: nvcc exited {proc.returncode}\n{log}")
        (d / "lib.log").write_text(log)
    return out


def registers(path, dtype: str, window: int) -> dict:
    """Registers and spill bytes of the entries a contiguous n=5 launch of
    ``dtype`` takes (lrn_fwd with and without d, lrn_bwd; ``window`` 5 on
    the fast path, 0 on the general one), from the variant's build log."""
    import chip_smoke as cs

    report = cs.ptxas_report((path.parent / "lib.log").read_text())
    names = cs.demangle(report)
    t = "float" if dtype == "float32" else "__nv_bfloat16"
    v = 4 if dtype == "float32" else 8
    keys = {"fwd": f"lrn_fwd<{t}, (bool)1, (int){v}, (int){window}>",
            "serving": f"lrn_fwd<{t}, (bool)0, (int){v}, (int){window}>",
            "bwd": f"lrn_bwd<{t}, (int){v}, (int){window}>"}
    return {k: r for fn, r in report.items() for k, want in keys.items() if want in names[fn]}


def main() -> int:
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build

    lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")
    if not torch.cuda.is_available():
        print("torch_lrn_tiles: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(cs.gpu_line(), flush=True)
    libs = build(VARIANTS)
    args = (cs.LRN_K, cs.LRN_N, cs.LRN_ALPHA, cs.LRN_BETA)
    keys = [("lrn", "dl4j_lrn_fwd"), ("lrn", "dl4j_lrn_bwd")]
    own = (lr.TILE_THREADS, lr.TILE_ELEMS, lr.FAST_N)
    try:
        for dtype in ("float32", "bfloat16"):
            for where, shape in cs.LRN_SHAPES.items():
                x, g = cs.lrn_inputs(torch, shape, dtype, cs.SEED)
                ry, rd = lr.lrn_reference(x, *args)
                rdx = lr.lrn_backward_reference(x, rd, g, *args)
                for name, threads, elems, patch, fast in VARIANTS:
                    lib = ctypes.CDLL(str(libs[name]))
                    for (_, sym), n_ptrs in zip(keys, (3, 4)):
                        fn = getattr(lib, sym)
                        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8
                                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
                        fn.restype = ctypes.c_int
                        _build._FNS[("lrn", sym)] = fn  # the wrappers' entry, this variant's
                    # a window no call takes turns the plan's "fast" off
                    lr.TILE_THREADS, lr.TILE_ELEMS = threads, elems
                    lr.FAST_N = own[2] if fast else 0
                    y, d = lr.lrn_forward(x, *args)
                    ys, _ = lr.lrn_forward(x, *args, with_d=False)
                    dx = lr.lrn_backward(x, rd, g, *args)
                    torch.cuda.synchronize()
                    checked = patch != "l2"
                    err = cs.lrn_readings((y, ys, d, dx), (ry, ry, rd, rdx)) if checked else None
                    ms = {"fwd": ms_runs(cs, lambda: lr.lrn_forward(x, *args)),
                          "serving": ms_runs(cs, lambda: lr.lrn_forward(x, *args,
                                                                        with_d=False)),
                          "bwd": ms_runs(cs, lambda: lr.lrn_backward(x, rd, g, *args))}
                    print(json.dumps({
                        "variant": name, "threads": threads, "elems": elems, "patch": patch,
                        "fast": fast, "dtype": dtype, "layer": where,
                        "shape": list(shape), "ms_runs": ms,
                        "bound_ms": {"fwd": cs.bound_lrn(shape, dtype, False)[0],
                                     "serving": cs.bound_lrn(shape, dtype, False, False)[0],
                                     "bwd": cs.bound_lrn(shape, dtype, True)[0]},
                        "ptxas": registers(libs[name], dtype, lr.FAST_N),
                        "max_err_over_largest": err,
                        "within": (all(e <= cs.LRN_REL[dtype] for e in err.values())
                                   if checked else None)}),
                        flush=True)
    finally:
        for key in keys:
            _build._FNS.pop(key, None)
        lr.TILE_THREADS, lr.TILE_ELEMS, lr.FAST_N = own
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
