#!/usr/bin/env python3
"""VGG16's fine-tuning updates at a given learning rate, on the card and on
the CPU, side by side.

The net and its data are ``chip_smoke.py``'s keras_import phase's: the
weights-only 'th' archive written from the smoke's seed and loaded by
``TrainedModels.load`` on each device, Nesterov at the zoo configuration's
momentum. The updates are the phase's: one fit at B=2, then four at B=32
(the card's net served twice at B=64 first, as in the phase); then five
more fits at B=2 alone from freshly loaded weights. For each learning rate
and device, one JSON line: each fit's loss (of the forward before its
update), whether every param is finite after it, the largest |param|, and
the loss after the last update.

    python3 scripts/torch_vgg16_lr_check.py [--lrs 0.01 0.001]

Needs a CUDA device; TF32 off, as in the smoke.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loss_of(torch, net, x, y) -> float:
    """Mean categorical cross-entropy of ``net.output(x)`` against one-hot
    ``y``, in float64 on the host."""
    import numpy as np

    p = np.asarray(net.output(x), dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(-(y * np.log(np.clip(p, 1e-300, None))).sum(-1).mean())


def run(torch, cs, path, device, lr, batches, serve) -> dict:
    from deeplearning4j_tpu_torch.modelimport import TrainedModels

    net = TrainedModels.load("VGG16", path, device=device)
    net.conf.updater["learning_rate"] = lr
    if serve is not None:
        net.output(serve)
        net.output(serve)
    rec = cs.LossRecorder()
    net.set_listeners(rec)
    finite, largest, t0 = [], [], time.perf_counter()
    for b in batches:
        net.fit(b)
        leaves = [t.detach() for p in net.layer_params for t in p.values()]
        finite.append(bool(all(torch.isfinite(t).all() for t in leaves)))
        largest.append(float(max(t.abs().max() for t in leaves)))
    net.set_listeners()
    x, y = batches[-1]
    return {"losses": [float(v) for v in rec.losses], "params_finite": finite,
            "max_abs_param": largest, "loss_after": loss_of(torch, net, x, y),
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+", default=[0.01, 0.001])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_vgg16_lr_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = smoke()
    from deeplearning4j_tpu_torch.ops import _build

    _build.build()
    print(cs.gpu_line(), flush=True)
    W = cs.keras_writer()
    xs, _ = cs.vgg16_images(cs.VGG_SERVE_B, cs.SEED + 91)
    _, y2 = cs.vgg16_images(cs.VGG_CPU_B, cs.SEED + 92)
    x2 = xs[:cs.VGG_CPU_B]
    xt, yt = cs.vgg16_images(cs.VGG_TRAIN_B, cs.SEED + 93)
    sequences = {"smoke: 1 at B=2, 4 at B=32": [(x2, y2)] + [(xt, yt)] * 4,
                 "5 at B=2": [(x2, y2)] * 5}
    with tempfile.TemporaryDirectory(prefix="vgg16_lr_") as tmp:
        path = os.path.join(tmp, "vgg16_weights_th_dim_ordering.h5")
        W.write_h5(path, W.keras_weights_archive([a for _, a in cs.vgg16_th_layers(cs.SEED + 90)]))
        for lr in args.lrs:
            for what, batches in sequences.items():
                for device in ("cuda", "cpu"):
                    serve = xs if device == "cuda" and what.startswith("smoke") else None
                    out = run(torch, cs, path, device, lr, batches, serve)
                    print(json.dumps({"lr": lr, "sequence": what, "device": device, **out}),
                          flush=True)
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
