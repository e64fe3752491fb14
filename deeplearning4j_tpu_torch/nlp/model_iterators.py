"""NLP → DataSet iterators for neural models.

Reference (SURVEY.md §2.5): iterator/CnnSentenceDataSetIterator.java
(sentences → padded word-vector tensors for sentence-classification CNNs)
and Word2VecDataSetIterator (sentences → sequence tensors labelled per
sentence). Every batch is padded to ``max_length`` with masks carrying the real
lengths. A copy of ``deeplearning4j_tpu/nlp/model_iterators.py`` that yields
the port's ``DataSet``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..datasets.iterators import DataSet, DataSetIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class CnnSentenceDataSetIterator(DataSetIterator):
    """Sentences → word-vector image tensors (reference:
    CnnSentenceDataSetIterator.java:475).

    Output ``format``:
    - "cnn": [B, max_length, vec_size, 1] NHWC (the reference's NCHW
      [B,1,len,vec] transposed to NHWC)
    - "rnn": [B, max_length, vec_size] + features_mask
    Labels are one-hot over ``labels`` order.
    """

    def __init__(self, sentences: Sequence[Tuple[str, str]], word_vectors,
                 batch: int, max_length: int = 32, format: str = "cnn",
                 labels: Optional[List[str]] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.data = list(sentences)  # (sentence, label)
        self.word_vectors = word_vectors
        self.batch = int(batch)
        self.max_length = int(max_length)
        self.format = format
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.labels = labels or sorted({lab for _, lab in self.data})
        self._label_idx = {lab: i for i, lab in enumerate(self.labels)}
        self.vec_size = int(np.asarray(self._vector_or_none("the", probe=True)).shape[-1])

    def _vector_or_none(self, word: str, probe: bool = False):
        wv = self.word_vectors
        vec = None
        if hasattr(wv, "get_word_vector"):
            vec = wv.get_word_vector(word)
        elif hasattr(wv, "vector"):
            vec = wv.vector(word)
        if vec is None and probe:
            # probe path: derive dimensionality from the lookup table
            for attr in ("lookup", "lookup_table"):
                syn0 = getattr(getattr(wv, attr, None), "syn0", None)
                if syn0 is not None:
                    return np.zeros(syn0.shape[1], np.float32)
            syn0 = getattr(wv, "syn0", None)
            if syn0 is not None:
                return np.zeros(syn0.shape[1], np.float32)
            raise ValueError("cannot infer word-vector dimensionality")
        return vec

    def batch_size(self) -> int:
        return self.batch

    def _encode(self, sentence: str) -> Tuple[np.ndarray, int]:
        toks = self.tokenizer_factory.create(sentence).get_tokens()
        vecs = []
        for t in toks:
            v = self._vector_or_none(t)
            if v is not None:
                vecs.append(np.asarray(v, np.float32))
            if len(vecs) == self.max_length:
                break
        out = np.zeros((self.max_length, self.vec_size), np.float32)
        if vecs:
            out[: len(vecs)] = np.stack(vecs)
        return out, len(vecs)

    def __iter__(self):
        n_labels = len(self.labels)
        buf_x, buf_len, buf_y = [], [], []
        for sentence, label in self.data:
            enc, ln = self._encode(sentence)
            buf_x.append(enc)
            buf_len.append(ln)
            y = np.zeros(n_labels, np.float32)
            y[self._label_idx[label]] = 1.0
            buf_y.append(y)
            if len(buf_x) == self.batch:
                yield self._assemble(buf_x, buf_len, buf_y)
                buf_x, buf_len, buf_y = [], [], []
        if buf_x:
            yield self._assemble(buf_x, buf_len, buf_y)

    def _assemble(self, xs, lens, ys) -> DataSet:
        x = np.stack(xs)  # [B, T, D]
        mask = np.zeros((len(xs), self.max_length), np.float32)
        for i, ln in enumerate(lens):
            mask[i, :ln] = 1.0
        y = np.stack(ys)
        if self.format == "cnn":
            return DataSet(x[..., None], y)  # [B, T, D, 1] NHWC
        return DataSet(x, y, features_mask=mask)


class Word2VecDataSetIterator(DataSetIterator):
    """Labelled sentences → [B,T,D] sequences with the label at the LAST
    real timestep (reference: Word2VecDataSetIterator: per-sentence labels
    aligned for RnnOutputLayer + labels mask)."""

    def __init__(self, sentences: Sequence[Tuple[str, str]], word_vectors,
                 batch: int, max_length: int = 32,
                 labels: Optional[List[str]] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self._cnn = CnnSentenceDataSetIterator(
            sentences, word_vectors, batch, max_length, format="rnn",
            labels=labels, tokenizer_factory=tokenizer_factory,
        )

    @property
    def labels(self) -> List[str]:
        return self._cnn.labels

    def batch_size(self) -> int:
        return self._cnn.batch

    def __iter__(self):
        n_labels = len(self._cnn.labels)
        for ds in self._cnn:
            B, T, _ = ds.features.shape
            labels_seq = np.zeros((B, T, n_labels), np.float32)
            labels_mask = np.zeros((B, T), np.float32)
            for i in range(B):
                n_real = int(ds.features_mask[i].sum())
                if n_real == 0:
                    continue  # all-OOV sentence: contributes no loss
                last = n_real - 1
                labels_seq[i, last] = ds.labels[i]
                labels_mask[i, last] = 1.0
            yield DataSet(ds.features, labels_seq,
                          features_mask=ds.features_mask,
                          labels_mask=labels_mask)
