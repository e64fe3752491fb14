"""Time GoogLeNet's served ``output()`` on the GPU, so that two checkouts can
be compared on one card.

Run it from the root of a checkout: the port's package and ``chip_smoke.py``
(its configuration, seeded weights and images) are imported from the
working directory, so the same script times a parent commit unpacked
elsewhere:

    python3 scripts/torch_serve_time.py
    (cd /path/to/parent && python3 /path/to/this/scripts/torch_serve_time.py)

Compare two checkouts in one process order on one card (parent, change,
change, parent): hosts differ between machines far more than the card does.
Prints one JSON line: the card's name and power limit, and for f32 and bf16
the ms of each of as many ``output()`` calls of GoogLeNet at B=128
(``googlenet_conf()``, 224x224x3 images; host clock, the copy of the result
to the host included) on the default path with the batch as a host array
and with the batch already on the card (a CUDA tensor), and on the eager
path (``DL4JTPU_INFER=legacy``) with the host array, each after one warm-up
call; and whether the card-tensor request's result equals the host
array's bit for bit.
"""

import argparse
import json
import os
import statistics
import sys
import time


def calls_ms(torch, fn, n: int):
    """ms of each of ``n`` calls of ``fn`` after one warm-up call, each
    ended by a synchronize."""
    fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=20, help="timed calls of each kind")
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_time: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch import googlenet_conf
    from deeplearning4j_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    host = cs.googlenet_params(googlenet_conf(aux_heads=True), cs.SEED)
    x = cs.alexnet_images(cs.GOOG_B, cs.SEED + 8)[0]
    x_card = torch.from_numpy(x).cuda()
    out = {"gpu": cs.gpu_line(), "checkout": os.getcwd(), "B": cs.GOOG_B}
    for dtype in ("float32", "bfloat16"):
        net = cs.googlenet_net(googlenet_conf(dtype=dtype), host)
        same = bool(np.array_equal(net.output(x_card), net.output(x)))
        runs = {"host_batch_ms": calls_ms(torch, lambda: net.output(x), args.calls),
                "card_batch_ms": calls_ms(torch, lambda: net.output(x_card), args.calls)}
        os.environ["DL4JTPU_INFER"] = "legacy"
        try:
            runs["eager_host_batch_ms"] = calls_ms(torch, lambda: net.output(x), args.calls)
        finally:
            del os.environ["DL4JTPU_INFER"]
        out[dtype] = {**runs, "card_equals_host": same,
                      **{k.replace("_ms", "_median_ms"): statistics.median(v)
                         for k, v in runs.items()}}
        del net
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
