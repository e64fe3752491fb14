"""Where ``fit(stage_on_device=4)`` from host batches spends the host's time,
on the GPU: ResNet-50 (B=128, f32 and bf16, ``chip_smoke.py``'s seeded
weights and images, 3 distinct host batches in turn) over epochs of 9 and
36 batches, and the char-RNN recipe on both LSTM routes (``chip_smoke.py``'s
``staged_resnet50`` and ``staged_recipe`` paths, standard backprop) over its
8 ragged batches.

Run it from the root of a checkout (the port's package and ``chip_smoke.py``
are imported from the working directory):

    python3 scripts/torch_staged_fit_time.py

TF32 is off, as in ``chip_smoke.py``. Each net first trains one staged epoch
(its steps are captured), then each case is timed over ``--epochs`` calls
of ``fit``, each one epoch. Prints the card's name and power limit, then one
JSON line a case: the ms per update of each call, the replayed ms per update
of the same windows already on the card, and the host's milliseconds a call
in each part of the staged loop, summed over the call: ``plan`` (the stager
reading and stacking the batches: ``BucketedStager.plan``), ``start_copy``
(pinning a window into the ring and queueing its copy; ``pin`` is the
pinning alone), ``start`` (queueing a window's replays) and ``finish``
(waiting for a window's losses, then its listeners). The timers wrap those
functions in this process only.
"""

import argparse
import collections
import json
import os
import sys
import time


def wrap(owner, name, key, totals, static=False):
    """Add the seconds of each call of ``owner.name`` to ``totals[key]``."""
    real = getattr(owner, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            totals[key] += time.perf_counter() - t0

    setattr(owner, name, staticmethod(timed) if static else timed)


def wrap_plan(bucketing, totals):
    """Add the seconds of each step of the stager's plan to totals["plan"]."""
    real = bucketing.BucketedStager.plan

    def plan(self, items, normalize, stageable=None):
        events = real(self, items, normalize, stageable)
        while True:
            t0 = time.perf_counter()
            try:
                event = next(events)
            except StopIteration:
                return
            finally:
                totals["plan"] += time.perf_counter() - t0
            yield event

    bucketing.BucketedStager.plan = plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3, help="timed calls of fit a case")
    args = ap.parse_args()
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_staged_fit_time: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch import (DataSet, ListDataSetIterator, MultiLayerNetwork,
                                          char_rnn, load_jax_params, resnet50_conf)
    from deeplearning4j_tpu_torch.datasets import bucketing, iterators
    from deeplearning4j_tpu_torch.nn import multilayer
    from deeplearning4j_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    _build.build()
    totals = collections.defaultdict(float)
    wrap_plan(bucketing, totals)
    wrap(iterators.DevicePrefetchIterator, "start_copy", "start_copy", totals)
    wrap(iterators.DevicePrefetchIterator, "_pin", "pin", totals, static=True)
    wrap(multilayer.BaseNetwork, "_start_window", "start", totals)
    wrap(multilayer.BaseNetwork, "_finish_window", "finish", totals)

    def case(name, net, batches, card_windows):
        """Time ``fit`` over ``batches`` staged, then the same windows on
        the card through fit_on_device."""
        calls = []
        for _ in range(args.epochs):
            totals.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator(batches), stage_on_device=cs.STAGED_K)
            torch.cuda.synchronize()
            calls.append({"ms_per_update": (time.perf_counter() - t0) * 1e3 / len(batches),
                          "host_ms": {k: v * 1e3 for k, v in totals.items()}})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y, fm, lm, n in card_windows:
            net.fit_on_device(x, y, steps=n, features_masks=fm, labels_masks=lm,
                              real_batches=n)
        torch.cuda.synchronize()
        replayed = (time.perf_counter() - t0) * 1e3 / len(batches)
        print(json.dumps({"case": name, "updates": len(batches), "calls": calls,
                          "replayed_on_card_ms_per_update": replayed}), flush=True)

    def on_card(a):
        return None if a is None else torch.as_tensor(a, device=cs.DEVICE)

    def windows_on_card(net, batches):
        stager = bucketing.BucketedStager(cs.STAGED_K, pad_examples=net._pad_examples_ok())
        return [(on_card(w.features[0]), on_card(w.labels[0]),
                 on_card(None if w.features_masks is None else w.features_masks[0]),
                 on_card(None if w.labels_masks is None else w.labels_masks[0]), w.n_real)
                for kind, w in stager.plan(batches, net._normalize) if kind == "window"]

    conf = char_rnn(cs.VOCAB, cs.HIDDEN, cs.LAYERS)
    conf.backprop_type = "standard"  # the staged loop takes no TBPTT
    host = cs.char_rnn_params(conf, cs.SEED)
    batches = cs.staged_recipe_batches()
    for route in ("seqfused", "fusedcell"):
        net = load_jax_params(MultiLayerNetwork(conf, lstm_variant=route), host)
        net.fit(ListDataSetIterator(batches), stage_on_device=cs.STAGED_K)
        case(f"recipe_{route}", net, batches, windows_on_card(net, batches))
        del net
        cs.gc_collect(torch)
    res_host = cs.resnet_params(resnet50_conf(), cs.SEED)
    images = [cs.alexnet_images(cs.RES_B, cs.SEED + 60 + i) for i in range(3)]
    for dtype in ("float32", "bfloat16"):
        net = cs.resnet_net(resnet50_conf(dtype=dtype), res_host)
        for n in (9, 36):
            batches = [DataSet(*images[i % 3]) for i in range(n)]
            if n == 9:
                net.fit(ListDataSetIterator(batches), stage_on_device=cs.STAGED_K)
            case(f"resnet50_{dtype}_{n}", net, batches, windows_on_card(net, batches))
        del net
        cs.gc_collect(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
