#!/usr/bin/env python3
"""How far AlexNet's training moves from a float64 oracle, rightly and with
LRN's backward wrong.

    python3 scripts/alexnet_train_sensitivity.py [--batch 8] [--updates 3]

Trains ``alexnet_conf(dropout=0.0)`` on the CPU from chip_smoke.py's seed
weights (N(0, 0.01), zero biases) on its synthetic batch (raw pixel values
0-255, random labels of 1000 classes), the same batch for every update,
Nesterov at lr 1e-2, in float64 (the oracle), in float32 and in bf16
compute, and each of the last two again with LRN's backward missing its
second term (dx = g * d^-beta). For each run it prints the losses and, after
the first update and after the last, each param tensor's change from the
seed params, |change - oracle's change| / |oracle's change|, the size of the
readings chip_smoke.py's ``train_alexnet`` takes between the card and the
CPU, whose limits must sit above the right runs and below the faulty ones.
A few minutes on the CPU.
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
from deeplearning4j_tpu_torch import MultiLayerNetwork, alexnet_conf, load_jax_params  # noqa: E402
from deeplearning4j_tpu_torch import params_to_numpy  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer  # noqa: E402

lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")


def train(dtype: str, x, y, host, updates: int, fault: bool):
    """(losses, params after the first update, params after the last) of
    ``updates`` updates of one batch in ``dtype`` compute ("float64": every
    param and activation in f64, which the port does not offer as a compute
    dtype, so this script widens the float32 one for the run)."""
    wide = dtype == "float64"
    conf = alexnet_conf(dropout=0.0, dtype="bfloat16" if dtype == "bfloat16" else "float32")
    saved = dict(multilayer._COMPUTE_DTYPES)
    real_bwd = lr.lrn_backward
    try:
        if wide:
            multilayer._COMPUTE_DTYPES["float32"] = torch.float64
        if fault:
            lr.lrn_backward = lambda x_, d, g, k, n, a, b: g * d ** float(lr._const(-b, x_.dtype))
        net = load_jax_params(MultiLayerNetwork(conf, device="cpu"), host)
        if wide:
            for layer in net.layer_params:
                for k in list(layer.keys()):
                    layer[k] = torch.nn.Parameter(layer[k].detach().double())
        losses = []
        net.fit((x.astype(np.float64) if wide else x, y))
        losses.append(net.score())
        first = params_to_numpy(net)
        for _ in range(updates - 1):
            net.fit((x, y))
            losses.append(net.score())
        return np.array(losses), first, params_to_numpy(net)
    finally:
        multilayer._COMPUTE_DTYPES.clear()
        multilayer._COMPUTE_DTYPES.update(saved)
        lr.lrn_backward = real_bwd


def readings(run, oracle, host) -> dict:
    out = {"losses": run[0].tolist()}
    for name, j in (("first_change_rel", 1), ("change_rel", 2)):
        out[name] = {f"{i}.{k}": float(np.linalg.norm(p[k] - q[k])
                                       / np.linalg.norm(q[k] - p0[k].astype(np.float32)))
                     for i, (p, q, p0) in enumerate(zip(run[j], oracle[j], host)) for k in p}
    out["loss_rel"] = float(np.max(np.abs(run[0] - oracle[0]) / np.abs(oracle[0])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=chip_smoke.ALEX_CPU_B)
    ap.add_argument("--updates", type=int, default=chip_smoke.ALEX_UPDATES)
    args = ap.parse_args()
    host = chip_smoke.alexnet_params(alexnet_conf(), chip_smoke.SEED)
    x, y = chip_smoke.alexnet_images(args.batch, chip_smoke.SEED + 6)
    oracle = train("float64", x, y, host, args.updates, False)
    print(json.dumps({"run": "float64", "losses": oracle[0].tolist()}), flush=True)
    for dtype in ("float32", "bfloat16"):
        for fault in (False, True):
            r = readings(train(dtype, x, y, host, args.updates, fault), oracle, host)
            print(json.dumps({"run": dtype, "lrn_bwd_without_second_term": fault,
                              "max_first_change_rel": max(r["first_change_rel"].values()),
                              "max_change_rel": max(r["change_rel"].values()), **r}),
                  flush=True)


if __name__ == "__main__":
    main()
