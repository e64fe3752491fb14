#!/usr/bin/env python3
"""Time the LSTM backward's dRW product (rows 2, 7 and 9) under other tilings
and splits of R, on one NVIDIA GPU.

    python3 scripts/torch_drw_tiles.py

Builds copies of ``ops/csrc/lstm_seq_bwd.cu`` whose ``lstm_drw.cuh`` has other
values of the product's constants (units ``kDrwM`` and gate columns
``kDrwN`` of dRW a block, warps along the units ``kDrwWarpsM``, ring depth
``kDrwStages``, bytes of a column's r rows in one tile ``kDrwTileBytes``)
into ``build/torch_kernels/drw_tiles/``, runs each through the port's
wrapper ``drw_product`` at the sequence backward's R = 16384 (T=256, B=64)
under 1, 2 and 4 slices of R, and at the cell's R = 64 (one slice), H=512,
f32 and bf16; checks each against the plain version, and prints one JSON
line per run: ms per call (two medians, the host's part included), the
kernels' time on the card a call (10 calls under the profiler; null where
the profiler reported none) and the
largest error over dRW's largest element. The first variant is the
source's own; the wrapper's own choice of slices is marked.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (kDrwM, kDrwN, kDrwWarpsM, kDrwStages, kDrwTileBytes)
VARIANTS = [(128, 128, 2, 4, 128), (128, 64, 2, 4, 128), (64, 128, 2, 4, 128),
            (64, 64, 2, 4, 128), (128, 128, 4, 4, 128), (128, 128, 2, 3, 128),
            (128, 128, 2, 4, 64), (128, 128, 2, 3, 256)]
SLICES = (1, 2, 4)
OWN = {"kDrwM": 128, "kDrwN": 128, "kDrwWarpsM": 2, "kDrwStages": 4, "kDrwTileBytes": 128}


def build(variants):
    """One library per variant, all nvcc runs at once; returns their paths."""
    from deeplearning4j_tpu_torch.ops import _build

    out, procs = {}, {}
    for v in variants:
        d = _build.BUILD_DIR / "drw_tiles" / "_".join(map(str, v))
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, d)
        hdr = d / "lstm_drw.cuh"
        text = hdr.read_text()
        for (name, own), new in zip(OWN.items(), v):
            old = f"constexpr int {name} = {own};"
            if old not in text:
                raise RuntimeError(f"{hdr}: no {old!r} to vary")
            text = text.replace(old, f"constexpr int {name} = {new};")
        hdr.write_text(text)
        out[v] = d / "lib.so"
        procs[v] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "lstm_seq_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {v}: nvcc exited {proc.returncode}\n{log}")
        (out[v].parent / "lib.log").write_text(log)
    return out


def registers(path) -> dict:
    """Registers and spill bytes of each drw_mma instantiation of a
    variant's library, from its build log."""
    import chip_smoke as cs

    report = cs.ptxas_report((path.parent / "lib.log").read_text())
    return {("bf16" if "bfloat16" in fn else "f32"): r for fn, r in report.items()
            if "drw_mma" in fn}


def main() -> int:
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import lstm_sequence as ls

    if not torch.cuda.is_available():
        print("torch_drw_tiles: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    libs = build(VARIANTS)
    H = cs.HIDDEN
    key = ("lstm_seq_bwd", "dl4j_drw_product")
    own_tile, own_slices = ls.DRW_TILE, ls.drw_slices
    try:
        for dtype in ("float32", "bfloat16"):
            for T in (cs.STEPS, 1):
                R = T * cs.BATCH
                h0, ys, dzx = cs.drw_inputs(torch, T, H, dtype, cs.SEED)
                ref = ls.drw_product_reference(h0, ys, dzx)
                chosen = own_slices(R, H)
                for v, path in libs.items():
                    fn = getattr(ctypes.CDLL(str(path)), key[1])
                    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    _build._FNS[key] = fn  # the wrapper's bound entry, this variant's
                    ls.DRW_TILE = v[:2]
                    for slices in SLICES if T > 1 else (1,):
                        ls.drw_slices = lambda R_, H_, s=slices: s  # noqa: E731

                        def call():
                            return ls.drw_product(h0, ys, dzx)

                        got = call()
                        torch.cuda.synchronize()
                        err = float((got.float() - ref.float()).abs().max()
                                    / ref.float().abs().max())
                        ms = [cs.median_ms(call), cs.median_ms(call)]
                        print(json.dumps({
                            "M": v[0], "N": v[1], "warps_m": v[2], "stages": v[3],
                            "tile_bytes": v[4], "slices": slices,
                            "wrapper_slices": slices == chosen, "own_tile": v == VARIANTS[0],
                            "dtype": dtype, "R": R, "H": H, "ms_runs": ms,
                            "ptxas": registers(path)["f32" if dtype == "float32" else "bf16"],
                            "device_ms": cs.kernel_device_ms(torch, call,
                                                             r"drw_mma|drw_reduce"),
                            "max_err_over_largest": err}), flush=True)
    finally:
        _build._FNS.pop(key, None)
        ls.DRW_TILE, ls.drw_slices = own_tile, own_slices
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
