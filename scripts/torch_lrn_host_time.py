#!/usr/bin/env python3
"""Time the host's part of a call of the LRN wrappers (rows 3-4) beside a
single call's time and the card's, on one NVIDIA GPU, so that two checkouts
can be compared on one card.

Run it from the root of a checkout: the port's package and ``chip_smoke.py``
(its LRN shapes and seeded inputs) are imported from the working directory,
so the same script times a parent commit unpacked elsewhere:

    python3 scripts/torch_lrn_host_time.py
    (cd /path/to/parent && python3 /path/to/this/scripts/torch_lrn_host_time.py)

At AlexNet's two LRN shapes, f32 and bf16, for the training forward
(``lrn_forward``: y and d), the serving forward (``with_d=False``) and the
backward (``lrn_backward``), it prints one JSON line with, per kernel:
``host_us``, the host's clock over 200 calls with no synchronize between
them, a call's share (the launches queue behind one another, so this is the
Python and the launch alone); ``a_call_ms``, the median of 7 single calls
timed with CUDA events, as ``chip_smoke.py``'s ``time_kernel`` times them
(the host's part delays the kernel's start); and ``in_a_row_ms``, a call's
share of 20 calls in a row between two events (median of 7), the card's
time. Each is taken twice, and the card's name and power limit lead.
"""

import importlib
import json
import os
import statistics
import sys
import time


def host_us(torch, fn, calls: int = 200) -> float:
    """µs of the host's clock a call of ``fn`` over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def events_ms(torch, fn, calls: int, reps: int = 7) -> float:
    """ms a call of ``fn`` over ``calls`` calls between two CUDA events,
    the median of ``reps`` after two warm-up rounds."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_lrn_host_time: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _build

    lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")

    _build.build(["lrn"])
    args = (cs.LRN_K, cs.LRN_N, cs.LRN_ALPHA, cs.LRN_BETA)
    result = {"root": root, "gpu": cs.gpu_line(), "kernels": {}}
    for dtype in ("float32", "bfloat16"):
        for where, shape in cs.LRN_SHAPES.items():
            x, g = cs.lrn_inputs(torch, shape, dtype, cs.SEED)
            _, d = lr.lrn_forward(x, *args)
            calls = {"fwd": lambda: lr.lrn_forward(x, *args),
                     "serving": lambda: lr.lrn_forward(x, *args, with_d=False),
                     "bwd": lambda: lr.lrn_backward(x, d, g, *args)}
            for name, fn in calls.items():
                result["kernels"][f"{name} {dtype} {where}"] = {
                    "host_us": [host_us(torch, fn) for _ in range(2)],
                    "a_call_ms": [events_ms(torch, fn, 1) for _ in range(2)],
                    "in_a_row_ms": [events_ms(torch, fn, 20) for _ in range(2)]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
