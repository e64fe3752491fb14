#!/usr/bin/env python3
"""Run chip_smoke.py's slice 24 phases (nlp_word2vec,
nlp_paragraph_vectors_glove, graph_deepwalk, w2v_sentiment) on the CPU at
their full sizes, with every pin at 0, and print what each reads: the
planted-topic recalls, the held-out accuracies and the community recall
from which the smoke's pins (W2V_RECALL_PIN, PV_PIN, GLOVE_RECALL_PIN,
DW_RECALL_PIN, SENT_PIN) are set. Then the order drift: the head fits that
the smoke holds card against CPU (Word2Vec, GloVe, DeepWalk) with each
row's contributions summed in the reverse order against the usual order,
the change that a different order of summation alone makes (the card's
``index_put_(accumulate=True)`` sums a row after a sort of the row ids),
beside the smoke's limits (W2V_TABLE_REL, GLOVE_REL, DW_REL).

    python3 scripts/nlp_cpu_pins.py [--phases word2vec,pv_glove,deepwalk,sentiment]
                                    [--threads 4]

Takes about 10 minutes with all phases at 4 threads.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def on_the_cpu(smoke, torch):
    """Point the smoke at the CPU: its DEVICE, the port's default device,
    CUDA-event timing and the profiler (both read the host's clock here)."""
    from deeplearning4j_tpu_torch.graph_embeddings import deepwalk
    from deeplearning4j_tpu_torch.nlp import glove, sequence_vectors
    from deeplearning4j_tpu_torch.nn import multilayer

    smoke.DEVICE = "cpu"
    real = multilayer.resolve_device

    def cpu_device(device):
        return real("cpu" if str(device).startswith("cuda") else device)

    for mod in (multilayer, sequence_vectors, glove, deepwalk):
        mod.resolve_device = cpu_device
    for name in ("synchronize", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.memory_allocated = torch.cuda.max_memory_allocated = lambda *a, **k: 0

    def host_ms(fn, reps=7, warmup=2):
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def host_profile(torch_, fn, top=6, groups=None):
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
        return dict(wall_ms=wall, device_busy_ms=None, idle_share=None, top_kernels=[])

    smoke.median_ms = host_ms
    smoke.profile = host_profile


@contextlib.contextmanager
def reversed_sums(torch):
    """Each row's contributions summed in the reverse order, in the
    SequenceVectors steps and in GloVe's."""
    from deeplearning4j_tpu_torch.nlp import glove
    from deeplearning4j_tpu_torch.nlp import sequence_vectors as sv

    real = sv.apply_rows, glove._adagrad_rows

    def apply_reversed(table, buf, idx, contrib, lr):
        return real[0](table, buf, torch.flip(idx, [0]), torch.flip(contrib, [0]), lr)

    def adagrad_reversed(p, s, buf, idx, contrib, lr, eps):
        return real[1](p, s, buf, torch.flip(idx, [0]), torch.flip(contrib, [0]), lr, eps)

    sv.apply_rows, glove._adagrad_rows = apply_reversed, adagrad_reversed
    try:
        yield
    finally:
        sv.apply_rows, glove._adagrad_rows = real


def order_drift(smoke, torch, corpus) -> dict:
    """The head fits of the smoke's card-against-CPU checks (Word2Vec,
    GloVe, DeepWalk) with reversed sums against the usual ones: max |err|
    over each table's largest element."""
    import numpy as np

    from deeplearning4j_tpu_torch.graph_embeddings import (DeepWalk, Graph,
                                                           RandomWalkIterator)
    from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec

    sents = corpus["sentences"]
    edges, _ = smoke.sbm_edges(smoke.SEED + 63)
    graph = Graph(smoke.DW_VERTICES)
    for a, b in edges:
        graph.add_edge(int(a), int(b))
    it = RandomWalkIterator(graph, smoke.DW["walk_length"], seed=smoke.SEED)
    walks = [it.next_walk() for _ in range(smoke.DW_CPU_WALKS)]
    glove = dict(smoke.GLOVE, epochs=smoke.GLOVE_CPU_EPOCHS)
    fits = {
        "word2vec": lambda: Word2Vec(device="cpu", **smoke.W2V).fit(
            sents[:smoke.W2V_CPU_SENTENCES]).lookup,
        "glove": lambda: Glove(device="cpu", **glove).fit(
            sents[:smoke.GLOVE_CPU_SENTENCES]).lookup,
        "deepwalk": lambda: DeepWalk(device="cpu", seed=smoke.SEED, **smoke.DW).fit_walks(
            graph, walks)}
    out = {}
    for name, fit in fits.items():
        usual = fit()
        with reversed_sums(torch):
            rev = fit()
        if name == "deepwalk":
            out[name] = {"vectors": float(np.abs(rev.vectors - usual.vectors).max()
                                          / np.abs(usual.vectors).max())}
        else:
            out[name] = {k: float(np.abs(getattr(rev, k) - getattr(usual, k)).max()
                                  / np.abs(getattr(usual, k)).max())
                         for k in ("syn0", "syn1", "syn1neg")
                         if getattr(usual, k) is not None and np.abs(getattr(usual, k)).max()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="word2vec,pv_glove,deepwalk,sentiment",
                    help="comma-separated; 'none' runs the order drift alone")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch

    import chip_smoke as smoke
    torch.set_num_threads(args.threads)
    on_the_cpu(smoke, torch)
    for name in ("W2V_RECALL_PIN", "GLOVE_RECALL_PIN", "DW_RECALL_PIN", "SENT_PIN"):
        setattr(smoke, name, 0.0)
    smoke.PV_PIN = {"dbow": 0.0, "dm": 0.0}
    phases = args.phases.split(",")
    card = "cpu"
    model = corpus = None
    if "word2vec" in phases or "pv_glove" in phases or "sentiment" in phases:
        model, corpus, _ = smoke.phase_nlp_word2vec(torch, card)
    if "pv_glove" in phases:
        smoke.phase_nlp_paragraph_vectors_glove(torch, corpus, card)
    if "deepwalk" in phases:
        smoke.phase_graph_deepwalk(torch, card)
    if "sentiment" in phases:
        try:
            smoke.phase_w2v_sentiment(torch, model, card)
        except AssertionError as e:  # the CPU runs the kernels' plain versions: no launch
            if str(e) != "w2v_sentiment failed its checks: ['launches']":
                raise
    drift = order_drift(smoke, torch, corpus or smoke.nlp_corpus(smoke.SEED + 60))
    print(json.dumps({"phase": "order_drift", "reversed_vs_usual": drift,
                      "limits": {"word2vec": smoke.W2V_TABLE_REL, "glove": smoke.GLOVE_REL,
                                 "deepwalk": smoke.DW_REL}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
