"""Distributed embedding training (counterpart of
``deeplearning4j_tpu/nlp/distributed.py``; reference: dl4j-spark-nlp,
SURVEY.md §2.4 "Spark NLP": driver counts vocab via accumulators, broadcasts
the Huffman tree, trains skip-gram per partition, and syncs params by
map-side combine — Word2Vec.java:61 train:130, First/SecondIterationFunction).

The vocab/Huffman build happens once (driver role); each "partition" trains
on its own COPY of the embedding tables through the same device steps, one
after another on the model's one device; the tables are then averaged back
in numpy — the reference's per-partition-then-combine semantics."""

from __future__ import annotations

import copy
from typing import List

import numpy as np

from .sequence_vectors import Sequence
from .word2vec import Word2Vec


class DistributedWord2Vec(Word2Vec):
    """Partitioned word2vec with parameter averaging.

    ``workers`` plays the role of Spark partitions: the corpus splits
    round-robin; every partition trains from the current master tables and
    the results average back after each pass (one 'training round' =
    executeTraining on one split, ParameterAveragingTrainingMaster parity).
    """

    def __init__(self, *, workers: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.workers = max(1, int(workers))

    def fit(self, data) -> "DistributedWord2Vec":
        data = list(data)
        if data and isinstance(data[0], str):
            seqs = self._sentences_to_sequences(data)
        else:
            seqs = [s if isinstance(s, Sequence) else Sequence(elements=list(s))
                    for s in data]
        if self.vocab is None:
            self.build_vocab(seqs)

        shards: List[List[Sequence]] = [[] for _ in range(self.workers)]
        for i, s in enumerate(seqs):
            shards[i % self.workers].append(s)
        shards = [s for s in shards if s]

        outer_epochs = self.epochs
        for _ in range(outer_epochs):
            syn0_acc = np.zeros_like(self.lookup.syn0)
            syn1_acc = None if not self.use_hs else np.zeros_like(self.lookup.syn1)
            neg_acc = (None if self.negative <= 0
                       else np.zeros_like(self.lookup.syn1neg))
            for shard in shards:
                worker = self._spawn_worker()
                worker.fit(shard)
                syn0_acc += worker.lookup.syn0
                if syn1_acc is not None:
                    syn1_acc += worker.lookup.syn1
                if neg_acc is not None:
                    neg_acc += worker.lookup.syn1neg
            n = len(shards)
            self.lookup.syn0 = syn0_acc / n
            if syn1_acc is not None:
                self.lookup.syn1 = syn1_acc / n
            if neg_acc is not None:
                self.lookup.syn1neg = neg_acc / n
        return self

    def _spawn_worker(self) -> Word2Vec:
        """Replica sharing vocab/Huffman (broadcast) with copied tables."""
        worker = Word2Vec(
            layer_size=self.layer_size, window=self.window,
            min_word_frequency=self.min_word_frequency,
            negative=self.negative, use_hs=self.use_hs, epochs=1,
            learning_rate=self.learning_rate,
            min_learning_rate=self.min_learning_rate,
            subsampling=self.subsampling, batch_size=self.batch_size,
            seed=self.seed,
            elements_algo=self.elements_algo,
            sequence_algo=self.sequence_algo,
            train_elements=self.train_elements,
            tokenizer_factory=self.tokenizer_factory, device=self.device,
        )
        worker.vocab = self.vocab
        worker._codes_arr = self._codes_arr
        worker._points_arr = self._points_arr
        worker._max_code = self._max_code
        worker._code_mask = self._code_mask
        worker.lookup = copy.copy(self.lookup)
        worker.lookup.syn0 = self.lookup.syn0.copy()
        if self.use_hs:
            worker.lookup.syn1 = self.lookup.syn1.copy()
        if self.negative > 0:
            worker.lookup.syn1neg = self.lookup.syn1neg.copy()
        return worker
