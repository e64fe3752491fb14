#!/usr/bin/env python
"""Does torch's default precision hold the port's f32 convolutions to the
smoke's limits? Run it on the card, from the root of a checkout:

    python3 scripts/torch_tf32_probe.py

A fresh process that sets no TF32 flag, so torch's defaults stand
(``torch.backends.cudnn.allow_tf32`` True, ``cuda.matmul.allow_tf32``
False), runs ``chip_smoke.py``'s first f32 ResNet-50 update (B=4, the
conf's lr 0.1; ``resnet_readings`` against the CPU at
``RES_TRAIN_LIMITS["float32"]``) and its first VGG16 update (the zoo
conf read from a seeded 'th' archive, B=2 at ``VGG_LR``; ``train_readings``
at ``KERAS_LIMITS["vgg16_train"]``, and the served output of the same two
images at ``KERAS_LIMITS["vgg16_vs_cpu"]``), in three legs on the card,
each against the same CPU run:

- ``defaults``: the port as it is, under torch's defaults;
- ``plain_defaults``: the port's convolutions put back to plain
  ``F.conv2d`` (how the port ran before it computed f32 convolutions in
  f32 whatever the flags), under torch's defaults;
- ``plain_tf32_off``: the same plain convolutions with both TF32 flags
  off, as ``chip_smoke.py`` sets them.

Prints one JSON line a leg with each reading, its limit and whether the
leg is within its limits, the TF32 flags it ran under, and whether its
first-update params are the ``plain_tf32_off`` leg's bit for bit; then the
card's name and power limit, and a last JSON line with the verdict. Exits
1 when ``defaults`` misses a limit. Needs the card and about 2 minutes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_tf32_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    from deeplearning4j_tpu_torch import (MultiLayerNetwork, load_jax_params, params_to_numpy,
                                          resnet50_conf)
    from deeplearning4j_tpu_torch.modelimport import TrainedModels
    from deeplearning4j_tpu_torch.nn.layers import convolution as pconv
    from deeplearning4j_tpu_torch.ops import _build

    defaults = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    t_start = time.perf_counter()
    _build.build()
    exact_conv = pconv.conv

    def plain_conv(x, w, b, stride, padding, dilation=None, groups=1):
        n = x.dim() - 2
        fn = torch.nn.functional.conv2d if n == 2 else torch.nn.functional.conv1d
        return fn(x, w, b, stride=stride, padding=padding,
                  dilation=1 if dilation is None else dilation, groups=groups)

    legs = {"defaults": (exact_conv, True), "plain_defaults": (plain_conv, True),
            "plain_tf32_off": (plain_conv, False)}

    def run_legs(card_run):
        out = {}
        for leg, (fn, tf32) in legs.items():
            pconv.conv = fn
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32 and defaults["matmul_allow_tf32"]
            try:
                out[leg] = card_run()
            finally:
                pconv.conv = exact_conv
                torch.backends.cudnn.allow_tf32 = defaults["cudnn_allow_tf32"]
                torch.backends.cuda.matmul.allow_tf32 = defaults["matmul_allow_tf32"]
            out[leg]["flags"] = {"cudnn_allow_tf32": tf32,
                                 "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        return out

    def same_bits(a, b) -> bool:
        a, b = cs.named_tensors(a), cs.named_tensors(b)
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    # ---- ResNet-50, the first f32 update (train_resnet50's compared run)
    lim = cs.RES_TRAIN_LIMITS["float32"]
    conf = resnet50_conf(dtype="float32")
    host = cs.resnet_params(conf, cs.SEED)
    small = cs.alexnet_images(cs.RES_CPU_B, cs.SEED + 12)
    ref = cs.resnet_train_run(conf, host, small, "cpu")

    def resnet_leg():
        run = cs.resnet_train_run(conf, host, small, "cuda")
        readings = cs.resnet_readings(run, ref, host)
        held = {k: readings[k] for k in lim}
        return {"readings": held, "first": run["first"],
                "within": cs.within_limits(readings, lim)}

    resnet = run_legs(resnet_leg)
    del ref
    cs.gc_collect(torch)

    # ---- VGG16, the first Nesterov update at B=2 (keras_vgg16's)
    klim = cs.KERAS_LIMITS
    W = cs.keras_writer()
    with tempfile.TemporaryDirectory() as tmp:
        layers = cs.vgg16_th_layers(cs.SEED + 90)
        path = os.path.join(tmp, "vgg16_weights_th_dim_ordering.h5")
        W.write_h5(path, W.keras_weights_archive([arrs for _, arrs in layers]))
        del layers
        base = TrainedModels.load("VGG16", path)
    vconf = base.conf
    vconf.updater["learning_rate"] = cs.VGG_LR
    vhost = params_to_numpy(base)
    del base
    cs.gc_collect(torch)
    x2 = cs.vgg16_images(cs.VGG_SERVE_B, cs.SEED + 91)[0][:cs.VGG_CPU_B]
    _, y2 = cs.vgg16_images(cs.VGG_CPU_B, cs.SEED + 92)
    cpu = load_jax_params(MultiLayerNetwork(vconf, device="cpu"), vhost)
    cpu_logp = np.log(cpu.output(x2).astype(np.float64))
    vref = cs.train_run(torch, cpu, [(x2, y2)])
    del cpu

    def vgg_leg():
        net = load_jax_params(MultiLayerNetwork(vconf), vhost)
        served = cs.logp_err(net.output(x2), cpu_logp)
        first = cs.train_run(torch, net, [(x2, y2)])
        train = cs.train_readings(first, vref, vhost)
        del net
        cs.gc_collect(torch)
        return {"readings": {"vs_cpu": served, **{k: train[k] for k in klim["vgg16_train"]}},
                "first": first[1],
                "within": served <= klim["vgg16_vs_cpu"]
                and cs.within_limits(train, klim["vgg16_train"])}

    vgg = run_legs(vgg_leg)

    verdict = {}
    for model, legs_out, limits in (
            ("resnet50", resnet, lim),
            ("vgg16", vgg, {"vs_cpu": klim["vgg16_vs_cpu"], **klim["vgg16_train"]})):
        for leg, r in legs_out.items():
            r["bits_as_plain_tf32_off"] = same_bits(r["first"], legs_out["plain_tf32_off"]["first"])
            print(json.dumps({"probe": model, "leg": leg, "flags": r["flags"],
                              "readings": r["readings"], "limits": limits,
                              "within": r["within"],
                              "first_update_bits_as_plain_tf32_off":
                                  r["bits_as_plain_tf32_off"]}), flush=True)
            verdict[f"{model}_{leg}"] = r["within"]
    print(cs.gpu_line(), flush=True)
    ok = verdict["resnet50_defaults"] and verdict["vgg16_defaults"]
    print(json.dumps({"ok": ok, "torch_defaults": defaults, "within": verdict,
                      "seconds": time.perf_counter() - t_start,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
