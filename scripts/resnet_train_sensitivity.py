#!/usr/bin/env python3
"""How far ResNet-50's training moves from a float64 oracle, rightly and
with each wrong version of chip_smoke.py's ``train_resnet50`` phase.

    python3 scripts/resnet_train_sensitivity.py [--batch 4] [--updates 3] [--lr 0.1]

Trains ``resnet50_conf()`` (a ComputationGraph of 174 vertices, 53 of them
BatchNormalization) on the CPU from chip_smoke.py's seed weights on its
synthetic batch (raw pixel values 0-255, random labels of 1000 classes),
the same batch for every update, SGD at ``--lr`` (the conf's 0.1 by
default): in float64 (the oracle), in float32 and in bf16 compute, and
each of the last two again under each of the phase's wrong versions
(``chip_smoke.RES_FAULTS``: BN's running variance unbiased, its decay the
wrong way round, eval-mode BN on the batch's stats, a residual add that
drops its shortcut). For each run it prints chip_smoke.py's readings
(``resnet_readings``) against the oracle: the size of what the phase reads
between the card and the CPU, whose limits must sit above the right runs
and below the faulty ones. For the right runs it also prints how the first
update's change is spread over the 161 param tensors (median, 90th
percentile, largest), each later update's loss, and the forward at the
seed params: the pooled features (the output layer's input, train-mode
BN) against the oracle's, whole and their part that differs from image
to image. Some minutes on the CPU, and some GiB at ``--batch 16``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from deeplearning4j_tpu_torch import UpdaterConfig, resnet50_conf  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer  # noqa: E402


def conf_of(dtype: str, lr: float):
    return resnet50_conf(dtype="bfloat16" if dtype == "bfloat16" else "float32",
                         updater=UpdaterConfig(updater="sgd", learning_rate=lr))


class widened:
    """In "float64", every param and activation of the float32 conf in
    f64, which the port does not offer as a compute dtype (the running
    stats then update in f64); otherwise nothing."""

    def __init__(self, dtype: str):
        self.wide = dtype == "float64"

    def __enter__(self):
        self.saved = dict(multilayer._COMPUTE_DTYPES)
        self.real_pdt = multilayer.BaseNetwork.params_dtype
        if self.wide:
            multilayer._COMPUTE_DTYPES["float32"] = torch.float64
            multilayer.BaseNetwork.params_dtype = property(lambda self: torch.float64)

    def __exit__(self, *exc):
        multilayer._COMPUTE_DTYPES.clear()
        multilayer._COMPUTE_DTYPES.update(self.saved)
        multilayer.BaseNetwork.params_dtype = self.real_pdt


def train(dtype: str, batch, host, updates: int, lr: float, fault):
    """chip_smoke.resnet_train_run of ``updates`` updates in ``dtype``
    compute on the CPU."""
    with widened(dtype):
        return chip_smoke.resnet_train_run(conf_of(dtype, lr), host, batch, "cpu", fault,
                                           updates)


def pooled_features(dtype: str, x, host) -> np.ndarray:
    """The output layer's input (the average pool over the last stage) of
    the train-mode forward at the seed params, as f64 [B, 2048]."""
    with widened(dtype):
        net = chip_smoke.resnet_net(conf_of(dtype, 0.1), host, device="cpu")
        with torch.no_grad():
            acts = net._activations(net._cast_params(), [net._input(x)], train=True)[0]
    return acts["avgpool"].double().numpy()


def spread(run, oracle, host) -> dict:
    """The first update's change of each param tensor against the
    oracle's (chip_smoke.train_readings' per-tensor reading), over the
    tensors, and every update's loss against the oracle's."""
    seed, mine, theirs = (chip_smoke.named_tensors(p) for p in (host, run["first"],
                                                                oracle["first"]))
    rel = np.array([np.linalg.norm(mine[k].astype(np.float64) - q)
                    / np.linalg.norm(q - seed[k]) for k, q in theirs.items()])
    return {"first_change_median": float(np.median(rel)),
            "first_change_p90": float(np.quantile(rel, 0.9)),
            "first_change_max": float(rel.max()),
            "loss_rel_by_update": (np.abs(run["losses"] - oracle["losses"])
                                   / np.abs(oracle["losses"])).tolist()}


def feature_error(feats, ref) -> dict:
    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return {"features_rel": rel(feats, ref),
            "per_image_part_rel": rel(feats - feats.mean(0), ref - ref.mean(0))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=chip_smoke.RES_CPU_B)
    ap.add_argument("--updates", type=int, default=chip_smoke.RES_UPDATES)
    ap.add_argument("--lr", type=float, default=0.1)
    args = ap.parse_args()
    host = chip_smoke.resnet_params(resnet50_conf(), chip_smoke.SEED)
    x, y = chip_smoke.alexnet_images(args.batch, chip_smoke.SEED + 12)
    oracle = train("float64", (x.astype(np.float64), y), host, args.updates, args.lr, None)
    ref_feats = pooled_features("float64", x.astype(np.float64), host)
    print(json.dumps({"run": "float64", "batch": args.batch, "lr": args.lr,
                      "losses": oracle["losses"].tolist(),
                      "per_image_part_of_features": float(
                          np.linalg.norm(ref_feats - ref_feats.mean(0))
                          / np.linalg.norm(ref_feats))}), flush=True)
    for dtype in ("float32", "bfloat16"):
        for fault in (None, *chip_smoke.RES_FAULTS):
            run = train(dtype, (x, y), host, args.updates, args.lr, fault)
            extra = {}
            if fault is None:
                extra = {**spread(run, oracle, host),
                         **feature_error(pooled_features(dtype, x, host), ref_feats)}
            print(json.dumps({"run": dtype, "fault": fault, "losses": run["losses"].tolist(),
                              **chip_smoke.resnet_readings(run, oracle, host), **extra}),
                  flush=True)


if __name__ == "__main__":
    main()
