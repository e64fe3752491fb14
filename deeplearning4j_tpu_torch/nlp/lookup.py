"""In-memory embedding lookup table + similarity queries.

Reference: models/embeddings/inmemory/InMemoryLookupTable.java (734 LoC:
syn0/syn1/syn1neg tables, unigram negative-sampling table, resetWeights) and
reader/impl/BasicModelUtils.java (wordsNearest / similarity). Tables are numpy
on the host between fits (training moves them to the model's device for the
length of a ``fit``; see sequence_vectors.py); queries are numpy on the host.
A copy of ``deeplearning4j_tpu/nlp/lookup.py``: ``syn0`` is drawn from
``np.random.default_rng(seed)``, so both packages start from the same
tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .vocab import VocabCache


class InMemoryLookupTable:
    def __init__(self, vocab: VocabCache, vector_length: int, seed: int = 12345,
                 negative: float = 0.0, use_hs: bool = True):
        self.vocab = vocab
        self.vector_length = int(vector_length)
        self.seed = seed
        self.negative = negative
        self.use_hs = use_hs
        n = vocab.num_words()
        rng = np.random.default_rng(seed)
        # reference resetWeights: U(-0.5, 0.5)/vectorLength
        self.syn0 = ((rng.random((n, self.vector_length)) - 0.5) / self.vector_length).astype(
            np.float32
        )
        self.syn1 = np.zeros((n, self.vector_length), np.float32) if use_hs else None
        self.syn1neg = (
            np.zeros((n, self.vector_length), np.float32) if negative > 0 else None
        )
        self._neg_table: Optional[np.ndarray] = None

    # ---- negative-sampling unigram table (reference: makeTable, power 0.75) ----
    def make_negative_table(self, table_size: int = 100_000, power: float = 0.75) -> np.ndarray:
        counts = np.array([vw.count for vw in self.vocab.vocab_words()], np.float64)
        probs = counts**power
        probs /= probs.sum()
        self._neg_table = np.repeat(
            np.arange(len(counts)), np.maximum((probs * table_size).astype(int), 1)
        )
        return self._neg_table

    def sample_negatives(self, rng: np.random.Generator, shape) -> np.ndarray:
        if self._neg_table is None:
            self.make_negative_table()
        return self._neg_table[rng.integers(0, len(self._neg_table), size=shape)]

    # ---- queries (reference: BasicModelUtils) ----
    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        return None if idx < 0 else self.syn0[idx]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.vector(a), self.vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom > 0 else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        if isinstance(word_or_vec, str):
            v = self.vector(word_or_vec)
            if v is None:
                return []
            exclude = tuple(exclude) + (word_or_vec,)
        else:
            v = np.asarray(word_or_vec, np.float32)
        norms = np.linalg.norm(self.syn0, axis=1) * max(np.linalg.norm(v), 1e-12)
        sims = (self.syn0 @ v) / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for idx in order:
            w = self.vocab.word_at_index(int(idx))
            if w in exclude:
                continue
            out.append(w)
            if len(out) >= top_n:
                break
        return out
