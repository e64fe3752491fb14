#!/usr/bin/env python3
"""How many of a profiler window's kernels reach its trace as the process
ages, on the card.

Every 20 s for ``--seconds`` (the card busy with matmuls in between, as a
long run keeps it), one ``torch.profiler`` window: 10 elementwise kernels
launched right after ``start()``, a synchronize, 10 ms idle, ``stop()``;
then the Chrome trace is read back. Prints one JSON line a window: the
process's age, how many of the 10 kernels the trace holds, the launches it
holds (the host's runtime calls), and the kernels' start minus their
launches' (us; negative where a kernel's time reads before its launch).

    python3 scripts/torch_profiler_loss.py [--seconds 420]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def window(torch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16, device="cuda")
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p.start()
        for _ in range(10):
            x.mul_(1.0001)
        torch.cuda.synchronize()
        time.sleep(0.01)
        p.stop()
        path = os.path.join(d, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "Mul" in e["name"]]
    launches = {e["args"].get("correlation"): e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "aunch" in e["name"]}
    lag = [e["ts"] - launches[e["args"]["correlation"]]["ts"] for e in kernels
           if e["args"].get("correlation") in launches]
    return {"kernels_of_10": len(kernels), "launches": len(launches),
            "lag_us_min": min(lag) if lag else None, "lag_us_max": max(lag) if lag else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=420.0)
    args = ap.parse_args()
    import torch

    t0 = time.time()
    while time.time() - t0 < args.seconds:
        print(json.dumps({"age_s": round(time.time() - t0, 1), **window(torch)}), flush=True)
        a = torch.randn(2048, 2048, device="cuda")
        t1 = time.time()
        while time.time() - t1 < 20:
            a = a @ a
            a = a / a.norm()
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
