"""Summarize a Chrome trace written by the port's profiler.

``deeplearning4j_tpu_torch.profiler.trace`` and ``ProfilingListener`` write
``torch.profiler`` traces as Chrome trace JSON (``trace-<pid>-<ns>.json``).
This reads every such file under a directory (or one file), takes the
card's events (CUDA kernels, memcpys and memsets), buckets their time by
the kernel families ``chip_smoke.py`` profiles (the port's hand-written
kernels by row of the kernel table, copies, convolution passes, gemm, max
pool, reductions, elementwise), counts the launches of each hand-written
kernel row, and prints a ranked table: ``total_device_ns``,
``buckets_pct``, ``kernel_launches`` and ``top_ops``, as
``scripts/analyze_trace.py`` does for the JAX package's xplane traces.

A trace taken without a card has no device events; then the host's ATen
operators are bucketed instead (nested operators each count, so shares
overlap), which is what the CPU tests read.

Usage:
  python scripts/torch_analyze_trace.py TRACE_DIR_OR_FILE [--top 25] [--json OUT]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict

# the card's event categories in a torch.profiler Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CAT = "cpu_op"

# the port's hand-written kernels, by kernel-table row, as their __global__
# names read in a trace (ops/csrc/)
KERNEL_ROWS = [
    ("lrn, rows 3-4", r"\blrn_(fwd|bwd)"),
    # the cell and sequence rows share their step and dRW kernels
    ("lstm, rows 1-2 and 5-9",
     r"\blstm_(step|bwd_step|bwd_dh)_mma|\bcell_bwd_gates|\bdrw_(mma|reduce)|\bpeephole_reduce"),
    ("softmax_xent fwd, row 10", r"\bsxent_fwd"),
    ("softmax_xent bwd, row 11", r"\bsxent_bwd"),
    ("adam, row 12", r"\badam_multi"),
    ("flash attention, rows 13-15", r"\bflash_"),
]
# op name -> bucket, first match wins: the rows above, then the library's
# families (chip_smoke.py's ALEX_PROFILE_GROUPS and RES_PROFILE_GROUPS)
BUCKETS = KERNEL_ROWS + [
    ("copies", r"(?i)memcpy|memset|copy|transpose|nchwtonhwc|nhwctonchw"),
    ("convolution fprop", r"(?i)fprop|convolve|\baten::(convolution|conv\dd)\b"),
    ("convolution dgrad", r"(?i)dgrad"),
    ("convolution wgrad", r"(?i)wgrad"),
    ("convolution, cutlass and xmma kernels", r"(?i)cutlass|xmma"),
    ("fft", r"(?i)fft|cf32"),
    ("matmul", r"(?i)gemm|gemv|matmul|\baten::(mm|addmm|bmm|baddbmm)\b"),
    ("max pool", r"(?i)max_pool"),
    ("reductions", r"(?i)reduce|\baten::(sum|mean|amax|max)\b"),
    ("elementwise", r"(?i)elementwise|\baten::(add|mul|sub|div|relu|exp|log|tanh|where)"),
]
_COMPILED = [(label, re.compile(rx)) for label, rx in BUCKETS]


def bucket_of(name: str) -> str:
    for label, pat in _COMPILED:
        if pat.search(name):
            return label
    return "other"


def trace_files(path: str):
    if os.path.isfile(path):
        return [path]
    return sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True))


def _events(path: str):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def analyze(path: str) -> dict:
    files = trace_files(path)
    if not files:
        raise SystemExit(f"no Chrome trace (.json) under {path}")
    device, host = [], []
    for fpath in files:
        for e in _events(fpath):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            if e.get("cat") in DEVICE_CATS:
                device.append(e)
            elif e.get("cat") == HOST_OP_CAT:
                host.append(e)
    events, source = (device, "device") if device else (host, "host_ops")
    if not events:
        raise SystemExit(f"no device or host-operator events in {files}")
    op_ns = defaultdict(float)
    op_count = defaultdict(int)
    for e in events:
        op_ns[e["name"]] += float(e["dur"]) * 1e3  # the trace's unit is us
        op_count[e["name"]] += 1
    total = sum(op_ns.values())
    buckets = defaultdict(float)
    launches = {label: 0 for label, _ in KERNEL_ROWS}
    for name, ns in op_ns.items():
        label = bucket_of(name)
        buckets[label] += ns
        if label in launches:
            launches[label] += op_count[name]
    pct = (lambda v: round(100.0 * v / total, 2)) if total else (lambda v: 0.0)
    return {
        "trace": path,
        "files": files,
        "source": source,
        "total_device_ns": total,
        "buckets_pct": {k: pct(v) for k, v in sorted(buckets.items(), key=lambda kv: -kv[1])},
        "buckets_ns": dict(buckets),
        "kernel_launches": launches,
        "top_ops": [
            {"name": n, "pct": pct(t), "ns": t, "count": op_count[n]}
            for n, t in sorted(op_ns.items(), key=lambda kv: -kv[1])
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    report = analyze(args.trace)
    print(f"events: {report['source']} ({len(report['files'])} file(s))")
    print(f"total time: {report['total_device_ns'] / 1e6:.3f} ms")
    print("\nbuckets:")
    for k, pct in report["buckets_pct"].items():
        print(f"  {k:>40}: {pct:6.2f}%")
    print("\nhand-written kernel launches:")
    for k, n in report["kernel_launches"].items():
        print(f"  {k:>40}: {n}")
    print(f"\ntop {args.top} ops:")
    for op in report["top_ops"][: args.top]:
        print(f"  {op['pct']:6.2f}%  x{op['count']:<5} {op['name'][:120]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(report, top_ops=report["top_ops"][: args.top]), f, indent=2)
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
