"""GloVe: co-occurrence counting + weighted least-squares embedding
(counterpart of ``deeplearning4j_tpu/nlp/glove.py``).

Reference: models/glove/Glove.java (438) + AbstractCoOccurrences.java (640) and
the GloVe learning algorithm (embeddings/learning/impl/elements/GloVe.java):
window-weighted co-occurrence counts (1/distance), then AdaGrad on
  f(X_ij)(wᵢ·w̃ⱼ + bᵢ + b̃ⱼ - log X_ij)²  with f(x)=(x/x_max)^α clipped at 1.

Co-occurrences accumulate in a host dict (sparse, one pass), as in the JAX
module, which also gives the draws: ``w``, then ``w̃``, then each epoch's
permutation, from ``default_rng(seed)``; the last partial batch is dropped.
The optimization runs on the model's device as plain tensor ops, the
gradient in closed form: ``d = 2 f(X) diff`` (``fx * diff`` doubled, as
autodiff of ``fx * diff * diff`` gives it), then ``d w̃ⱼ`` for ``wᵢ``, ``d wᵢ``
for ``w̃ⱼ`` and ``d`` for both biases, summed per row before AdaGrad squares
them. AdaGrad's accumulators start at ones. A row without a gradient in a
batch keeps its parameters and accumulator exactly under the JAX module's
dense update (its gradient is 0), so only the batch's rows are updated.
``log X`` enters in f32, as the JAX module's does with x64 off.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..nn.multilayer import resolve_device
from .lookup import InMemoryLookupTable
from .sequence_vectors import Sequence, _as_sequence, accumulate_rows
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class AbstractCoOccurrences:
    """Reference: glove/AbstractCoOccurrences.java — symmetric, 1/distance
    weighting within the window."""

    def __init__(self, vocab: VocabCache, window: int = 15, symmetric: bool = True):
        self.vocab = vocab
        self.window = window
        self.symmetric = symmetric
        self.counts: Dict[Tuple[int, int], float] = defaultdict(float)

    def fit(self, sequences: Iterable[Sequence]) -> "AbstractCoOccurrences":
        for s in sequences:
            idxs = [
                self.vocab.index_of(w) for w in s.elements if self.vocab.contains_word(w)
            ]
            n = len(idxs)
            for i in range(n):
                for j in range(max(0, i - self.window), i):
                    w = 1.0 / (i - j)
                    a, b = idxs[i], idxs[j]
                    self.counts[(a, b)] += w
                    if self.symmetric:
                        self.counts[(b, a)] += w
        return self

    def as_arrays(self):
        keys = np.array(list(self.counts.keys()), np.int32).reshape(-1, 2)
        vals = np.array(list(self.counts.values()), np.float32)
        return keys[:, 0], keys[:, 1], vals


def _adagrad_rows(p, s, buf, idx, contrib, lr: float, eps: float) -> None:
    """AdaGrad on the rows ``idx`` of ``p`` (accumulator ``s``), the
    contributions summed per row first in ``buf`` (zero again after)."""
    accumulate_rows(buf, idx, contrib)
    g = buf.index_select(0, idx)
    s_new = s.index_select(0, idx) + g * g
    s.index_copy_(0, idx, s_new)
    p.index_copy_(0, idx, p.index_select(0, idx) - lr * g / torch.sqrt(s_new + eps))
    buf.index_fill_(0, idx, 0.0)


def glove_step(params, state, bufs, i, j, fx, log_x, lr: float, eps: float = 1e-8) -> None:
    """One AdaGrad step on ``sum fx (w_i . w̃_j + b_i + b̃_j - log_x)^2`` over
    the batch's pairs (i, j), in place on ``params`` (w, w̃, b, b̃) and
    ``state``; ``bufs`` are zero tensors of their shapes."""
    w, wt, b, bt = params
    wi, wj = w.index_select(0, i), wt.index_select(0, j)
    diff = (wi * wj).sum(-1) + b.index_select(0, i) + bt.index_select(0, j) - log_x
    d = fx * diff
    d = d + d
    for p, s, buf, idx, contrib in zip(params, state, bufs, (i, j, i, j),
                                       (d[:, None] * wj, d[:, None] * wi, d, d)):
        _adagrad_rows(p, s, buf, idx, contrib, lr, eps)


class Glove:
    """Reference: models/glove/Glove.java Builder — xMax, alpha, learningRate,
    epochs, layerSize, windowSize, minWordFrequency. ``device`` defaults to
    the card; without CUDA it raises unless ``device="cpu"``."""

    def __init__(
        self,
        layer_size: int = 100,
        window: int = 15,
        min_word_frequency: int = 1,
        epochs: int = 25,
        learning_rate: float = 0.05,
        x_max: float = 100.0,
        alpha: float = 0.75,
        batch_size: int = 4096,
        symmetric: bool = True,
        seed: int = 12345,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.seed = seed
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None

    def _to_sequences(self, data) -> List[Sequence]:
        data = list(data)
        if data and isinstance(data[0], str):
            return [
                Sequence(elements=self.tokenizer_factory.create(s).get_tokens())
                for s in data
            ]
        return [_as_sequence(s) for s in data]

    def fit(self, data) -> "Glove":
        seqs = self._to_sequences(data)
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(
            (s.elements for s in seqs)
        )
        co = AbstractCoOccurrences(self.vocab, self.window, self.symmetric).fit(seqs)
        rows, cols, xs = co.as_arrays()
        if len(xs) == 0:
            raise ValueError("empty co-occurrence matrix (vocab/window too small?)")
        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.default_rng(self.seed)
        dev = self.device
        w = torch.tensor((rng.random((V, D)) - 0.5).astype(np.float32) / D, device=dev)
        wt = torch.tensor((rng.random((V, D)) - 0.5).astype(np.float32) / D, device=dev)
        params = (w, wt, torch.zeros(V, device=dev), torch.zeros(V, device=dev))
        # AdaGrad accumulators (reference: GloVe.java uses AdaGrad per element)
        state = tuple(torch.ones_like(t) for t in params)
        bufs = tuple(torch.zeros_like(t) for t in params)
        log_x = np.log(np.maximum(xs, 1e-12)).astype(np.float32)
        fx = np.minimum((xs / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        n = len(xs)
        B = min(self.batch_size, n)
        for _ in range(self.epochs):
            order = rng.permutation(n)
            for k in range(0, n - B + 1, B):
                sel = order[k : k + B]
                glove_step(params, state, bufs, *(
                    torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)
                    for a in (rows[sel].astype(np.int64), cols[sel].astype(np.int64),
                              fx[sel], log_x[sel])), self.learning_rate)
        # final vectors: w + w̃ (standard GloVe practice)
        self.lookup = InMemoryLookupTable(self.vocab, D, seed=self.seed, use_hs=False,
                                          negative=1)
        self.lookup.syn0 = (params[0] + params[1]).cpu().numpy().copy()
        return self

    # ---- queries ----
    def get_word_vector(self, word: str):
        return self.lookup.vector(word)

    def similarity(self, a: str, b: str) -> float:
        return self.lookup.similarity(a, b)

    def words_nearest(self, word, top_n: int = 10):
        return self.lookup.words_nearest(word, top_n)
