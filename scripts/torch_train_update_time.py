"""Time the training updates of chip_smoke.py's attention net and char-RNN
recipe, the char-RNN's SGD update and its ``output()``, on the GPU, so that
two checkouts can be compared on one card.

Run it from the root of a checkout: the port's package and ``chip_smoke.py``
(its configurations, seeded weights and data) are imported from the working
directory, so the same script times a parent commit unpacked elsewhere:

    python3 scripts/torch_train_update_time.py
    (cd /path/to/parent && python3 /path/to/this/scripts/torch_train_update_time.py)

Compare two checkouts in one process order on one card (parent, change,
change, parent): hosts differ between machines far more than the card does.
Prints one JSON line: the card's name and power limit, and for f32 and bf16
the ms per update of each timed epoch of ``fit`` over the attention net's
bucketed batches (B=4, T 2048 and 4096, 2 updates an epoch) and over the
char-RNN recipe's (B=64, T 128 and 256 in TBPTT(50), 9 updates an epoch),
after one warm-up epoch; the ms of each of as many ``output()`` calls of
the char-RNN at B=64, T=256 (host clock, the copies to and from the card
included, as ``chip_smoke.py``'s ``time_output``), and, in f32 only, of as
many standard (full-sequence) SGD updates of it at B=64, T=256 (each a
``fit`` of one batch), each after one warm-up call; and the ms of each of as
many AlexNet updates (``alexnet_conf()``, B=128, ``chip_smoke.py``'s seeded
weights and images) with the batch already on the card, f32 and bf16, after
one warm-up update: the path of the LRN kernels (rows 3-4).
"""

import argparse
import json
import os
import sys
import time


def epochs_ms(torch, net, it, updates: int, n: int):
    """ms per update of each of ``n`` timed epochs of ``net.fit(it)``."""
    net.fit(it)  # warm-up: kernels loaded, allocator filled
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / updates)
    return out


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=5, help="timed epochs of each net")
    args = ap.parse_args()
    root = os.getcwd()
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_update_time: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch import (BucketingSequenceIterator, MultiLayerNetwork,
                                          alexnet_conf, char_rnn, load_jax_params)
    from deeplearning4j_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["lstm_seq", "lstm_seq_bwd", "softmax_xent", "adam", "flash_attn",
                  "flash_attn_bwd", "lrn"])
    attn_it = BucketingSequenceIterator(cs.attention_text(4, 4, 1024, 2048, 4096, cs.SEED + 4),
                                        batch=cs.ATTN_B, boundaries=cs.ATTN_BUCKETS)
    rnn_it = BucketingSequenceIterator(cs.recipe_sequences(), batch=cs.BATCH,
                                       boundaries=cs.RECIPE_BUCKETS)
    rnn_updates = sum(-(-ds.features.shape[1] // cs.TBPTT) for ds in rnn_it)
    result = {"root": root, "gpu": cs.gpu_line(), "epochs": args.epochs,
              "attention_ms_per_update": {}, "char_rnn_recipe_ms_per_update": {},
              "char_rnn_output_ms": {}, "char_rnn_sgd_standard_ms_per_update": {},
              "alexnet_batch_on_card_ms_per_update": {}}
    rng = np.random.default_rng(cs.SEED)
    x = cs.one_hot(rng.integers(0, cs.VOCAB, (cs.BATCH, cs.STEPS)), cs.VOCAB)
    sgd_batches = cs.char_batches(args.epochs + 1, cs.SEED + 1)
    alex_host = cs.alexnet_params(alexnet_conf(), cs.SEED)
    alex_batch = tuple(torch.as_tensor(a, device="cuda")
                       for a in cs.alexnet_images(cs.ALEX_B, cs.SEED + 7))
    for dtype in ("float32", "bfloat16"):
        net = load_jax_params(MultiLayerNetwork(cs.attention_conf(dtype)),
                              cs.attention_params(cs.SEED))
        result["attention_ms_per_update"][dtype] = epochs_ms(
            torch, net, attn_it, len(list(attn_it)), args.epochs)
        conf = char_rnn(cs.VOCAB, cs.HIDDEN, cs.LAYERS, dtype=dtype)
        net = load_jax_params(MultiLayerNetwork(conf), cs.char_rnn_params(conf, cs.SEED))
        result["char_rnn_recipe_ms_per_update"][dtype] = epochs_ms(
            torch, net, rnn_it, rnn_updates, args.epochs)
        result["char_rnn_output_ms"][dtype] = calls_ms(torch, lambda: net.output(x),
                                                       args.epochs)
        if dtype == "float32":
            conf = char_rnn(cs.VOCAB, cs.HIDDEN, cs.LAYERS, tbptt_length=cs.TBPTT, dtype=dtype)
            conf.updater = {"updater": "sgd", "learning_rate": cs.LR}
            conf.backprop_type = "standard"
            net = load_jax_params(MultiLayerNetwork(conf), cs.char_rnn_params(conf, cs.SEED))
            it = iter(sgd_batches)
            result["char_rnn_sgd_standard_ms_per_update"][dtype] = calls_ms(
                torch, lambda: net.fit(next(it)), args.epochs)
        net = load_jax_params(MultiLayerNetwork(alexnet_conf(dtype=dtype)), alex_host)
        result["alexnet_batch_on_card_ms_per_update"][dtype] = calls_ms(
            torch, lambda: net.fit(alex_batch), args.epochs)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
