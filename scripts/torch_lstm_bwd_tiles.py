#!/usr/bin/env python3
"""Time the LSTM sequence backward (rows 7 and 9) under other tilings of its
per-step product, on one NVIDIA GPU.

    python3 scripts/torch_lstm_bwd_tiles.py

Builds copies of ``ops/csrc/lstm_seq_bwd.cu`` whose ``lstm_mma.cuh`` has
other values of the product's tile constants (batch rows a block
``kBwdRows``, ring depth ``kStages``, bytes a row of one chunk ``kChunk``)
into ``build/torch_kernels/tiles/``, runs each
through the port's wrapper on the char-RNN's shape (T=256, B=64, H=512, f32
and bf16, unmasked), checks it against the plain version, and prints one
JSON line per variant: ms per call (two medians), the step kernel's, the
dh0 kernel's and the dRW product's time on the card, and the largest error
(dRW and the peephole grads relative to their largest element). The first
variant is the source's own.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (batch rows a block, ring stages, bytes of a row in one chunk)
# (64 rows take 2 stages: 3 of 1 KB chunks pass the 227 KB of shared memory)
VARIANTS = [(16, 4, 1024), (32, 4, 1024), (64, 2, 1024), (16, 3, 1024), (16, 6, 1024),
            (16, 4, 512), (16, 4, 256), (16, 3, 2048)]


def build(variants):
    """One library per variant, all nvcc runs at once; returns their paths."""
    from deeplearning4j_tpu_torch.ops import _build

    out, procs = {}, {}
    for rows, stages, chunk in variants:
        d = _build.BUILD_DIR / "tiles" / f"r{rows}_s{stages}_c{chunk}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, d)
        src, hdr = d / "lstm_seq_bwd.cu", d / "lstm_mma.cuh"
        text = hdr.read_text()
        for old, new in (("kBwdRows = 16;", f"kBwdRows = {rows};"),
                         ("kStages = 4;", f"kStages = {stages};"),
                         ("kChunk = 1024 /", f"kChunk = {chunk} /")):
            if old not in text:
                raise RuntimeError(f"{hdr}: no {old!r} to vary")
            text = text.replace(old, new)
        hdr.write_text(text)
        out[(rows, stages, chunk)] = d / "lib.so"
        procs[(rows, stages, chunk)] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {key}: nvcc exited {proc.returncode}\n{log}")
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import lstm_sequence as ls

    if not torch.cuda.is_available():
        print("torch_lstm_bwd_tiles: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    libs = build(VARIANTS)
    B, H, T = cs.BATCH, cs.HIDDEN, cs.STEPS
    key = ("lstm_seq_bwd", "dl4j_lstm_seq_bwd")
    own = ls.BWD_ROW_BLOCK
    groups = [("step", r"lstm_bwd_step"), ("dh0", r"lstm_bwd_dh"),
              ("drw", r"drw_mma|drw_reduce")]
    try:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            args = cs.seq_inputs(torch, T, B, H, dtype, False, cs.SEED)
            res = tuple(ls.lstm_sequence_train_reference(*args)[:6]) + tuple(args[1:])
            rng = np.random.default_rng(cs.SEED)
            up = [torch.as_tensor(rng.normal(0.0, 0.1, s), dtype=dt, device="cuda")
                  for s in ((T, B, H), (B, H), (B, H))]
            ref = ls.lstm_sequence_backward_reference(*up, *res)
            for (rows, stages, chunk), path in libs.items():
                fn = getattr(ctypes.CDLL(str(path)), key[1])
                fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _build._FNS[key] = fn  # the wrapper's bound entry, this variant's
                ls.BWD_ROW_BLOCK = rows  # its psum row block

                def call():
                    return ls.lstm_sequence_backward(*up, *res)

                got = call()
                torch.cuda.synchronize()
                err = max(float((g.float() - w.float()).abs().max()
                                / (w.float().abs().max() if n >= 3 else 1.0))
                          for n, (g, w) in enumerate(zip(got, ref)))
                ms = [cs.median_ms(call), cs.median_ms(call)]
                prof = cs.profile(torch, call, groups=groups)["groups"]
                print(json.dumps({
                    "rows": rows, "stages": stages, "chunk_bytes": chunk, "dtype": dtype,
                    "T": T, "B": B, "H": H, "ms_runs": ms,
                    "step_us": prof["step"][0] / prof["step"][1] * 1e3,
                    "dh0_us": prof["dh0"][0] * 1e3, "drw_ms": prof["drw"][0],
                    "max_err": err}), flush=True)
    finally:
        _build._FNS.pop(key, None)
        ls.BWD_ROW_BLOCK = own
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
