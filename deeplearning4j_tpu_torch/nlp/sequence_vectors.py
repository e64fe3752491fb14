"""SequenceVectors: the generic embedding trainer (counterpart of
``deeplearning4j_tpu/nlp/sequence_vectors.py``).

Reference: models/sequencevectors/SequenceVectors.java (fit :193-313,
trainSequence :315) with pluggable learning algorithms
(embeddings/learning/impl/elements/SkipGram.java:31 learnSequence:150,
CBOW.java; sequence algorithms DBOW.java, DM.java).

The host side is the JAX module's, call for call: ``fit``'s permutation of
the sequences, the subsampling draws, one reduced-window draw per position,
the flush at ``batch_size`` and the negatives drawn from ``self._rng``
inside the flush (``batch_size`` rows of them, as the JAX module draws for
its padded batch). So the stream of training examples is the JAX module's
for the same seed, and the trained tables can be held against its tables.
The examples are kept as rows of source ids and packed into one int64
array a batch (sources, their count, the target, the negatives), which
crosses to the device in one copy; the last partial batch is not padded.

On the device all four algorithms share two steps, plain tensor ops with
the gradients written in closed form (no autograd):

- HS (:func:`hs_step`): the masked mean ``h`` of the source rows (over
  ``max(mask sum, 1)``) against the target's Huffman points,
  ``loss = sum softplus(-(1 - 2c) u) * code_mask`` with ``u = h . syn1[p]``;
  ``dloss/du = -(1 - 2c) sigmoid(-(1 - 2c) u) * code_mask``.
- NEG (:func:`neg_step`): ``h`` against one positive and K sampled
  negatives, ``loss = softplus(-pos) + sum softplus(neg) * [neg != tgt]``
  (a negative that equals the target is skipped, word2vec's convention);
  ``dloss/dpos = -sigmoid(-pos)``, ``dloss/dneg = sigmoid(neg) * [neg != tgt]``.

Both tables' gradients come from the tables before the step. Each table's
update is ``table - lr * (summed gradient)``, the contributions to a row
summed first (accumulated into a zeroed buffer), then written back to the
touched rows alone (a row without a contribution keeps its value, as under
the JAX module's dense update). With HS and NEG both on, the NEG step reads
the ``syn0`` that the HS step wrote. A row's contributions are summed on
the CPU in their order, on the card with atomics in any order, so two runs
on the card may part by ulps, which SGD carries on through a fit.

SkipGram = S=1 source (center word) per context target; CBOW = S=2*window+1
slots (context mean) per center target; DBOW = S=1 source (doc label row);
DM = context + doc label rows averaged. Subsampling, reduced windows, and
linear lr decay follow the reference/word2vec conventions.
"""

from __future__ import annotations

import itertools
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..nn.multilayer import resolve_device
from .lookup import InMemoryLookupTable
from .vocab import Huffman, VocabCache, VocabConstructor, VocabWord

logger = logging.getLogger(__name__)


@dataclass
class Sequence:
    """Reference: models/sequencevectors/sequence/Sequence.java."""

    elements: List[str]
    labels: List[str] = field(default_factory=list)


def _as_sequence(s) -> Sequence:
    if isinstance(s, Sequence):
        return s
    return Sequence(elements=list(s))


def rows_of(table, idx):
    """``table[idx]`` through ``index_select`` (on the CPU, advanced
    indexing and ``index_add_`` go through a parallel loop that costs
    milliseconds a call when other processes hold the cores)."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


def accumulate_rows(buf, idx, contrib) -> None:
    """``buf[idx[i]] += contrib[i]`` for every i, duplicates summed: on the
    card by ``index_add_`` (atomics; ``index_put_``'s sorted accumulation
    runs the duplicates of a row one after another, and every HS example
    shares the root's row), on the CPU by ``index_put_(accumulate=True)``
    (in order)."""
    if buf.is_cuda:
        buf.index_add_(0, idx, contrib)
    else:
        buf.index_put_((idx,), contrib, accumulate=True)


def _source_mean(syn0, src, src_mask):
    """(h [B, D], the mean's divisor [B, 1]): the masked mean of the source
    rows, over max(mask sum, 1)."""
    m = src_mask[..., None]
    denom = torch.clamp(m.sum(1), min=1.0)
    return (rows_of(syn0, src) * m).sum(1) / denom, denom


def _syn0_rows(grad_h, denom, src, src_mask):
    """(row ids, contributions) of the source rows' gradient: dloss/dh
    through the masked mean."""
    contrib = (grad_h / denom)[:, None, :] * src_mask[..., None]
    return src.reshape(-1), contrib.reshape(-1, grad_h.shape[-1])


def apply_rows(table, buf, idx, contrib, lr: float) -> None:
    """``table[r] -= lr * (sum of the contributions to r)`` for each row r
    in ``idx``, in place. ``buf`` is a zero tensor of ``table``'s shape; it
    holds the sums for the call (:func:`accumulate_rows`) and is zero again
    after it. Duplicate ids write the same value."""
    accumulate_rows(buf, idx, contrib)
    g = buf.index_select(0, idx)
    table.index_copy_(0, idx, table.index_select(0, idx) - lr * g)
    buf.index_fill_(0, idx, 0.0)


def hs_step(syn0, syn1, bufs, src, src_mask, points, codes, code_mask, lr: float) -> None:
    """One hierarchical-softmax update of ``syn0`` and ``syn1`` in place
    (``bufs``: their zero buffers). ``src`` [B, S] and ``src_mask`` [B, S];
    ``points``, ``codes`` and ``code_mask`` [B, L], the targets' rows."""
    h, denom = _source_mean(syn0, src, src_mask)
    node = rows_of(syn1, points)  # [B, L, D]
    u = torch.bmm(node, h[:, :, None])[..., 0]  # [B, L]
    sign = 1.0 - 2.0 * codes
    g = -sign * torch.sigmoid(-sign * u) * code_mask  # dloss/du
    grad_h = torch.bmm(g[:, None, :], node)[:, 0]
    d1 = (g[..., None] * h[:, None, :]).reshape(-1, h.shape[-1])
    i0, d0 = _syn0_rows(grad_h, denom, src, src_mask)
    apply_rows(syn1, bufs[1], points.reshape(-1), d1, lr)
    apply_rows(syn0, bufs[0], i0, d0, lr)


def neg_step(syn0, syn1neg, bufs, src, src_mask, tgt, negs, lr: float) -> None:
    """One negative-sampling update of ``syn0`` and ``syn1neg`` in place:
    the target ``tgt`` [B] as the positive, ``negs`` [B, K] as negatives,
    a negative equal to its target skipped."""
    h, denom = _source_mean(syn0, src, src_mask)
    pos_vec = rows_of(syn1neg, tgt)  # [B, D]
    neg_vec = rows_of(syn1neg, negs)  # [B, K, D]
    pos = (h * pos_vec).sum(-1)
    neg = torch.bmm(neg_vec, h[:, :, None])[..., 0]  # [B, K]
    g_pos = -torch.sigmoid(-pos)
    g_neg = torch.sigmoid(neg) * (negs != tgt[:, None]).to(h.dtype)
    grad_h = g_pos[:, None] * pos_vec + torch.bmm(g_neg[:, None, :], neg_vec)[:, 0]
    D = h.shape[-1]
    d1 = torch.cat([g_pos[:, None] * h, (g_neg[..., None] * h[:, None, :]).reshape(-1, D)])
    i0, d0 = _syn0_rows(grad_h, denom, src, src_mask)
    apply_rows(syn1neg, bufs[1], torch.cat([tgt, negs.reshape(-1)]), d1, lr)
    apply_rows(syn0, bufs[0], i0, d0, lr)


def pack_sources(rows, S: int):
    """([n, S] int64 source ids, zero-padded; [n] their counts) of example
    rows, each a sequence of at most S ids."""
    n = len(rows)
    lens = np.fromiter(map(len, rows), np.int64, n)
    src = np.zeros((n, S), np.int64)
    if S == 1:
        src[:, 0] = np.fromiter((r[0] for r in rows), np.int64, n)
    else:
        src[np.arange(S) < lens[:, None]] = np.fromiter(
            itertools.chain.from_iterable(rows), np.int64, int(lens.sum()))
    return src, lens


class SequenceVectors:
    """Reference API surface: SequenceVectors.Builder → layerSize, windowSize,
    minWordFrequency, negativeSample, useHierarchicSoftmax, epochs,
    learningRate/minLearningRate, sampling (subsampling), batchSize, seed.
    ``device`` defaults to the card; without CUDA it raises unless
    ``device="cpu"``."""

    def __init__(
        self,
        layer_size: int = 100,
        window: int = 5,
        min_word_frequency: int = 1,
        negative: int = 0,
        use_hs: bool = True,
        epochs: int = 1,
        learning_rate: float = 0.025,
        min_learning_rate: float = 1e-4,
        subsampling: float = 0.0,
        batch_size: int = 512,
        seed: int = 12345,
        elements_algo: str = "skipgram",  # skipgram | cbow | none
        sequence_algo: Optional[str] = None,  # dbow | dm | None
        train_elements: bool = True,
        progress_log_every_s: float = 10.0,
        device="cuda",
    ):
        if negative <= 0 and not use_hs:
            raise ValueError("need hierarchical softmax and/or negative sampling")
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = int(negative)
        self.use_hs = use_hs
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.subsampling = subsampling
        self.batch_size = batch_size
        self.seed = seed
        self.elements_algo = elements_algo
        self.sequence_algo = sequence_algo
        self.train_elements = train_elements
        self.progress_log_every_s = progress_log_every_s
        self.last_words_per_sec: Optional[float] = None

        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None
        self._rng = np.random.default_rng(seed)
        self._max_code = 0
        self._codes_arr: Optional[np.ndarray] = None
        self._points_arr: Optional[np.ndarray] = None
        self._code_mask: Optional[np.ndarray] = None
        self._dev: Optional[dict] = None

    # ------------------------------------------------------------- vocab init
    def build_vocab(self, sequences: Iterable) -> None:
        seqs = [_as_sequence(s) for s in sequences]
        cache = VocabConstructor(self.min_word_frequency).build_vocab(
            (s.elements for s in seqs)
        )
        # ParagraphVectors labels become vocab rows too (reference: labels are
        # special SequenceElements in the same lookup table)
        for s in seqs:
            for lab in s.labels:
                if not cache.contains_word(lab):
                    vw = VocabWord(word=lab, count=1)
                    vw.is_label = True
                    cache.add_token(vw)
                else:
                    cache.word_for(lab).is_label = True
        self.vocab = cache
        if self.use_hs:
            Huffman(cache.vocab_words()).build()
            self._pack_codes()
        self.lookup = InMemoryLookupTable(
            cache, self.layer_size, seed=self.seed,
            negative=self.negative, use_hs=self.use_hs,
        )
        if self.negative > 0:
            self.lookup.make_negative_table()

    def _pack_codes(self) -> None:
        """The vocab's Huffman codes and points as [V, L] arrays (L the
        longest code) with the code mask."""
        words = self.vocab.vocab_words()
        self._max_code = max((len(vw.codes) for vw in words), default=1)
        V, L = self.vocab.num_words(), self._max_code
        self._codes_arr = np.zeros((V, L), np.float32)
        self._points_arr = np.zeros((V, L), np.int32)
        self._code_mask = np.zeros((V, L), np.float32)
        for vw in words:
            n = len(vw.codes)
            self._codes_arr[vw.index, :n] = vw.codes
            self._points_arr[vw.index, :n] = vw.points
            self._code_mask[vw.index, :n] = 1.0

    def _current_lr(self, words_seen: int, total_words: int) -> float:
        """Linear decay to min_learning_rate (word2vec convention); shared
        by the training flush and the progress log so they cannot drift."""
        return max(
            self.min_learning_rate,
            self.learning_rate * (1.0 - words_seen / max(total_words, 1)),
        )

    # ---------------------------------------------------------------- training
    def fit(self, sequences: Iterable) -> "SequenceVectors":
        seqs = [_as_sequence(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seqs)
        total_words = sum(len(s.elements) for s in seqs) * self.epochs
        words_seen = 0
        seqs_seen = 0
        # periodic progress (reference: SequenceVectors.java:1157 —
        # "Words vectorized so far ... Seq/sec ... Words/sec ...
        # learningRate"); also kept on the instance for programmatic use
        t_start = time.perf_counter()
        next_log = t_start + self.progress_log_every_s
        self.last_words_per_sec = None

        # training examples: rows of source ids, and their targets
        src_buf: List = []
        tgt_buf: List[int] = []

        def flush(final: bool = False):
            while len(tgt_buf) >= self.batch_size or (final and tgt_buf):
                take = min(self.batch_size, len(tgt_buf))
                lr = self._current_lr(words_seen, total_words)
                self._device_step(src_buf[:take], tgt_buf[:take], lr)
                del src_buf[:take], tgt_buf[:take]

        self._ensure_device_tables()
        try:
            for epoch in range(self.epochs):
                order = self._rng.permutation(len(seqs))
                for si in order:
                    s = seqs[si]
                    self._generate_examples(s, src_buf, tgt_buf)
                    words_seen += len(s.elements)
                    seqs_seen += 1
                    flush()
                    now = time.perf_counter()
                    if now >= next_log:
                        elapsed = max(now - t_start, 1e-9)
                        self.last_words_per_sec = words_seen / elapsed
                        lr = self._current_lr(words_seen, total_words)
                        logger.info(
                            "Epoch: [%d]; Words vectorized so far: [%d]; "
                            "Sequences so far: [%d]; Seq/sec: [%.2f]; "
                            "Words/sec: [%.2f]; learningRate: [%g]",
                            epoch, words_seen, seqs_seen,
                            seqs_seen / elapsed, self.last_words_per_sec, lr)
                        next_log = now + self.progress_log_every_s
            flush(final=True)
        finally:
            self._sync_tables()
        elapsed = max(time.perf_counter() - t_start, 1e-9)
        self.last_words_per_sec = words_seen / elapsed
        return self

    def _num_sources(self) -> int:
        if self.elements_algo == "cbow" or self.sequence_algo == "dm":
            return 2 * self.window + 1  # context slots (+doc row for DM)
        return 1

    def _subsample_keep(self, vw: VocabWord) -> bool:
        if self.subsampling <= 0:
            return True
        freq = vw.count / max(self.vocab.total_word_count, 1)
        prob = (math.sqrt(freq / self.subsampling) + 1) * self.subsampling / freq
        return self._rng.random() < prob

    def _generate_examples(self, s: Sequence, src_buf, tgt_buf) -> int:
        """Host-side example generation (reference: SkipGram/CBOW.learnSequence
        window iteration with reduced window b): the JAX module's examples,
        in its order, from the same draws."""
        vocab = self.vocab
        idxs = [
            vocab.word_for(w).index
            for w in s.elements
            if vocab.contains_word(w) and self._subsample_keep(vocab.word_for(w))
        ]
        label_idxs = [vocab.index_of(l) for l in s.labels if vocab.contains_word(l)]
        S = self._num_sources()
        count0 = len(tgt_buf)
        skipgram = self.train_elements and self.elements_algo == "skipgram"
        cbow = self.train_elements and self.elements_algo == "cbow"
        dm = self.sequence_algo == "dm" and bool(label_idxs)
        rng, window = self._rng, self.window

        n = len(idxs)
        for pos in range(n):
            b = int(rng.integers(1, window + 1))  # reduced window
            ctx = idxs[max(0, pos - b):pos] + idxs[pos + 1:min(n, pos + b + 1)]
            if skipgram:
                src_buf.extend([(idxs[pos],)] * len(ctx))
                tgt_buf.extend(ctx)
            elif cbow:
                if not ctx:
                    continue
                src_buf.append(ctx[:S])
                tgt_buf.append(idxs[pos])
            if dm:
                both = (ctx + label_idxs)[:S]
                if both:
                    src_buf.append(both)
                    tgt_buf.append(idxs[pos])
        if self.sequence_algo == "dbow" and label_idxs:
            for li in label_idxs:
                src_buf.extend([(li,)] * n)
                tgt_buf.extend(idxs)
        return len(tgt_buf) - count0

    # ---- device step ----
    def _ensure_device_tables(self):
        """The tables (copies) and their zero buffers on the model's device,
        with the Huffman arrays, for the length of a ``fit``."""
        if self._dev is not None:
            return
        dev = self.device

        def put(a):
            return torch.tensor(a, device=dev)

        self._dev = {"syn0": put(self.lookup.syn0)}
        self._dev["syn0_buf"] = torch.zeros_like(self._dev["syn0"])
        if self.use_hs:
            self._dev["syn1"] = put(self.lookup.syn1)
            self._dev["syn1_buf"] = torch.zeros_like(self._dev["syn1"])
            self._dev["points"] = put(self._points_arr.astype(np.int64))
            self._dev["codes"] = put(self._codes_arr)
            self._dev["code_mask"] = put(self._code_mask)
        if self.negative > 0:
            self._dev["syn1neg"] = put(self.lookup.syn1neg)
            self._dev["syn1neg_buf"] = torch.zeros_like(self._dev["syn1neg"])

    def _device_step(self, rows, tgt, lr: float) -> None:
        """One batch: the HS step, then the NEG step on the syn0 it wrote."""
        d = self._dev
        S, K, B = self._num_sources(), self.negative, len(tgt)
        src, lens = pack_sources(rows, S)
        ints = np.empty((B, S + 2 + K), np.int64)
        ints[:, :S] = src
        ints[:, S] = lens
        ints[:, S + 1] = tgt
        if K > 0:
            # the JAX module draws negatives for its batch padded to batch_size
            ints[:, S + 2:] = self.lookup.sample_negatives(
                self._rng, (self.batch_size, K))[:B]
        t = torch.from_numpy(ints).to(self.device, non_blocking=True)
        src_t, tgt_t = t[:, :S], t[:, S + 1]
        src_mask = (torch.arange(S, device=self.device) < t[:, S, None]).to(torch.float32)
        lr = float(np.float32(lr))
        if self.use_hs:
            hs_step(d["syn0"], d["syn1"], (d["syn0_buf"], d["syn1_buf"]), src_t, src_mask,
                    rows_of(d["points"], tgt_t), rows_of(d["codes"], tgt_t),
                    rows_of(d["code_mask"], tgt_t), lr)
        if K > 0:
            neg_step(d["syn0"], d["syn1neg"], (d["syn0_buf"], d["syn1neg_buf"]), src_t,
                     src_mask, tgt_t, t[:, S + 2:], lr)

    def _sync_tables(self):
        """Copies of the device tables back into the lookup table: on the
        CPU ``tensor.numpy()`` is a view, which a later in-place step would
        rewrite."""
        if self._dev is None:
            return
        self.lookup.syn0 = self._dev["syn0"].cpu().numpy().copy()
        if self.use_hs:
            self.lookup.syn1 = self._dev["syn1"].cpu().numpy().copy()
        if self.negative > 0:
            self.lookup.syn1neg = self._dev["syn1neg"].cpu().numpy().copy()
        self._dev = None

    # --------------------------------------------------------------- queries
    def get_word_vector(self, word: str):
        return self.lookup.vector(word)

    def similarity(self, a: str, b: str) -> float:
        return self.lookup.similarity(a, b)

    def words_nearest(self, word, top_n: int = 10) -> List[str]:
        return self.lookup.words_nearest(word, top_n)

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)
