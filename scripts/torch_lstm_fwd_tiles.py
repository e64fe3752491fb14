#!/usr/bin/env python3
"""Time the LSTM forward step (rows 1, 5, 6 and 8) under other tilings of its
product, on one NVIDIA GPU.

    python3 scripts/torch_lstm_fwd_tiles.py

Builds copies of ``ops/csrc/lstm_seq.cu`` whose ``lstm_mma.cuh`` has other
values of the forward step's tile constants (batch rows a block
``kFwdRows``, hidden units a block ``kFwdUnits``, warps ``kFwdWarps``, ring
depth ``kFwdStages``, bytes of an h row in one chunk ``kFwdChunkBytes``)
into ``build/torch_kernels/fwd_tiles/``, runs each through the port's
wrappers on the char-RNN's shapes (the training forward at T=256, B=64,
H=512, and a decode tick, the masked lean forward at T=1, B=8; f32 and
bf16), checks each against its plain version, and prints one JSON line per
variant and dtype: ms per call (two medians each), the step kernel's time
on the card in each, and the largest error against the plain version. The
first variant is the source's own.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (batch rows a block, hidden units a block, warps, ring stages, bytes of an
# h row in one chunk); each fits the 227 KB of shared memory
VARIANTS = [(16, 16, 8, 4, 512), (32, 16, 8, 4, 512), (16, 8, 4, 4, 512), (32, 8, 8, 4, 512),
            (16, 16, 4, 4, 512), (16, 16, 8, 3, 512), (16, 16, 8, 4, 256),
            (16, 16, 8, 6, 256), (16, 16, 8, 2, 1024)]
CONSTANTS = ("kFwdRows = {};", "kFwdUnits = {};", "kFwdWarps = {};", "kFwdStages = {};",
             "kFwdChunkBytes = {};")
# the entries the wrappers bind, with their pointer and int counts
ENTRIES = {"dl4j_lstm_seq_train_fwd": (15, 6), "dl4j_lstm_seq_lean": (12, 6)}


def build(variants):
    """One library per variant, all nvcc runs at once; returns their paths."""
    from deeplearning4j_tpu_torch.ops import _build

    out, procs = {}, {}
    for var in variants:
        d = _build.BUILD_DIR / "fwd_tiles" / "_".join(map(str, var))
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, d)
        hdr = d / "lstm_mma.cuh"
        text = hdr.read_text()
        for pattern, value, own in zip(CONSTANTS, var, VARIANTS[0]):
            old = pattern.format(own)
            if old not in text:
                raise RuntimeError(f"{hdr}: no {old!r} to vary")
            text = text.replace(old, pattern.format(value))
        hdr.write_text(text)
        out[var] = d / "lib.so"
        procs[var] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "lstm_seq.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for var, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {var}: nvcc exited {proc.returncode}\n{log}")
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import lstm_sequence as ls

    if not torch.cuda.is_available():
        print("torch_lstm_fwd_tiles: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    libs = build(VARIANTS)
    B, H, T = cs.BATCH, cs.HIDDEN, cs.STEPS
    groups = [("step", r"lstm_step_mma")]
    try:
        for dtype in ("float32", "bfloat16"):
            args = cs.seq_inputs(torch, T, B, H, dtype, False, cs.SEED)
            ref = ls.lstm_sequence_train_reference(*args)
            tick = cs.seq_inputs(torch, 1, cs.SLOTS, H, dtype, True, cs.SEED)
            tick_ref = ls.lstm_sequence_masked_reference(*tick)
            for var, path in libs.items():
                lib = ctypes.CDLL(str(path))
                for sym, (n_ptrs, n_ints) in ENTRIES.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
                    _build._FNS[("lstm_seq", sym)] = fn  # the wrapper's entry, this variant's

                def train():
                    return ls.lstm_sequence_train_forward(*args)

                def decode():
                    return ls.fused_lstm_sequence_masked(*tick)

                got, got_tick = train(), decode()
                torch.cuda.synchronize()
                err = max(cs.max_abs(got, ref), cs.max_abs(got_tick, tick_ref))
                prof = cs.profile(torch, train, groups=groups)["groups"]
                tick_prof = cs.profile(torch, lambda: [decode() for _ in range(20)],
                                       groups=groups)["groups"]
                print(json.dumps({
                    "rows": var[0], "units": var[1], "warps": var[2], "stages": var[3],
                    "chunk_bytes": var[4], "dtype": dtype, "T": T, "B": B, "H": H,
                    "train_fwd_ms_runs": [cs.median_ms(train), cs.median_ms(train)],
                    "step_us": prof["step"][0] / prof["step"][1] * 1e3,
                    "decode_tick_ms_runs": [cs.median_ms(decode), cs.median_ms(decode)],
                    "decode_step_us": tick_prof["step"][0] / tick_prof["step"][1] * 1e3,
                    "max_abs_err": err}), flush=True)
    finally:
        for sym in ENTRIES:
            _build._FNS.pop(("lstm_seq", sym), None)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
