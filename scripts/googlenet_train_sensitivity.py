#!/usr/bin/env python3
"""How far GoogLeNet's training moves from a float64 oracle, rightly and
with each wrong version of chip_smoke.py's ``train_googlenet`` phase.

    python3 scripts/googlenet_train_sensitivity.py [--batch 4] [--updates 3]

Trains ``googlenet_conf(dropout=0.0, aux_heads=True)`` (a
ComputationGraph, the three heads' losses summed) on the CPU from
chip_smoke.py's seed weights on its synthetic batch (raw pixel values 0-255,
random labels of 1000 classes, the same for every head), the same batch
for every update, Nesterov at lr 1e-2: in float64 (the oracle), in float32
and in bf16 compute, and each of the last two again with a MergeVertex that
swaps its last two branches and with LRN's backward missing its second
term. For each run it prints the largest of chip_smoke.py's readings
(``train_readings``: each update's loss against the oracle's, each param
tensor's change from the seed params against the oracle's change, after
the first update and after the last), the size of what the phase reads
between the card and the CPU, whose limits must sit above the right runs
and below the faulty ones. About 20 s on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from deeplearning4j_tpu_torch import MultiDataSet, googlenet_conf, params_to_numpy  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import vertices  # noqa: E402

lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")
FAULTS = (None, "merge_branches_swapped", "lrn_bwd_without_second_term")


def train(dtype: str, data, host, updates: int, fault):
    """(losses, params after the first update, params after the last) of
    ``updates`` updates of one batch in ``dtype`` compute ("float64": every
    param and activation in f64, which the port does not offer as a compute
    dtype, so this script widens the float32 one for the run)."""
    wide = dtype == "float64"
    conf = googlenet_conf(dropout=0.0, aux_heads=True,
                          dtype="bfloat16" if dtype == "bfloat16" else "float32")
    saved = dict(multilayer._COMPUTE_DTYPES)
    real_bwd, real_merge = lr.lrn_backward, vertices.MergeVertex.apply
    real_pdt = multilayer.BaseNetwork.params_dtype
    try:
        if wide:
            multilayer._COMPUTE_DTYPES["float32"] = torch.float64
            multilayer.BaseNetwork.params_dtype = property(lambda self: torch.float64)
        if fault == "merge_branches_swapped":
            vertices.MergeVertex.apply = chip_smoke.swapped_merge(torch)
        elif fault == "lrn_bwd_without_second_term":
            lr.lrn_backward = lambda x_, d, g, k, n, a, b: g * d ** float(lr._const(-b, x_.dtype))
        net = chip_smoke.googlenet_net(conf, host, "cpu")
        losses = []
        net.fit(data)
        losses.append(net.score())
        first = params_to_numpy(net)
        for _ in range(updates - 1):
            net.fit(data)
            losses.append(net.score())
        return np.array(losses), first, params_to_numpy(net)
    finally:
        multilayer._COMPUTE_DTYPES.clear()
        multilayer._COMPUTE_DTYPES.update(saved)
        multilayer.BaseNetwork.params_dtype = real_pdt
        lr.lrn_backward, vertices.MergeVertex.apply = real_bwd, real_merge


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=chip_smoke.GOOG_CPU_B)
    ap.add_argument("--updates", type=int, default=chip_smoke.GOOG_UPDATES)
    args = ap.parse_args()
    host = chip_smoke.googlenet_params(googlenet_conf(aux_heads=True), chip_smoke.SEED)
    x, y = chip_smoke.alexnet_images(args.batch, chip_smoke.SEED + 9)
    oracle = train("float64", MultiDataSet([x.astype(np.float64)], [y] * 3), host,
                   args.updates, None)
    print(json.dumps({"run": "float64", "losses": oracle[0].tolist()}), flush=True)
    for dtype in ("float32", "bfloat16"):
        for fault in FAULTS:
            run = train(dtype, MultiDataSet([x], [y] * 3), host, args.updates, fault)
            print(json.dumps({"run": dtype, "fault": fault, "losses": run[0].tolist(),
                              **chip_smoke.train_readings(run, oracle, host)}), flush=True)


if __name__ == "__main__":
    main()
