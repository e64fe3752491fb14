"""Text vectorizers + inverted index + moving window.

Reference (SURVEY.md §2.5 "Text pipeline"): bagofwords/vectorizer/
(BagOfWordsVectorizer, TfidfVectorizer over a VocabCache), text/invertedindex/
(InMemoryLookupCache-backed index), text/movingwindow/ (Windows.windows
context extraction). Host-side by design; the produced matrices feed device
training like any other DataSet features.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class BaseTextVectorizer:
    """Shared vocab scan (reference: BaseTextVectorizer.fit building the
    VocabCache through a corpus pass)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Optional[Iterable[str]] = None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = int(min_word_frequency)
        self.stop_words = set(stop_words) if stop_words is not None else set()
        self.vocab: Dict[str, int] = {}
        self.doc_freq: Counter = Counter()
        self.n_docs = 0

    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def fit(self, documents: Iterable[str]) -> "BaseTextVectorizer":
        counts: Counter = Counter()
        self.doc_freq = Counter()
        self.n_docs = 0
        for doc in documents:
            toks = self._tokens(doc)
            counts.update(toks)
            self.doc_freq.update(set(toks))
            self.n_docs += 1
        self.vocab = {
            w: i
            for i, (w, c) in enumerate(
                sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            )
            if c >= self.min_word_frequency
        }
        return self

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        docs = list(documents)
        return self.fit(docs).transform(docs)


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term counts (reference: bagofwords/vectorizer/BagOfWordsVectorizer)."""

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(documents), len(self.vocab)), np.float32)
        for i, doc in enumerate(documents):
            for tok in self._tokens(doc):
                j = self.vocab.get(tok)
                if j is not None:
                    out[i, j] += 1.0
        return out


class TfidfVectorizer(BaseTextVectorizer):
    """tf·idf with idf = log(N / df) (reference: TfidfVectorizer uses the
    lucene-style formulation over VocabCache docAppearedIn counts)."""

    def idf(self, word: str) -> float:
        df = self.doc_freq.get(word, 0)
        if df == 0 or self.n_docs == 0:
            return 0.0
        return math.log(self.n_docs / df)

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(documents), len(self.vocab)), np.float32)
        for i, doc in enumerate(documents):
            toks = self._tokens(doc)
            if not toks:
                continue
            counts = Counter(toks)
            for tok, c in counts.items():
                j = self.vocab.get(tok)
                if j is not None:
                    tf = c / len(toks)
                    out[i, j] = tf * self.idf(tok)
        return out


class InvertedIndex:
    """word → [(doc_id, positions)] (reference: text/invertedindex/InvertedIndex
    SPI; the in-memory impl)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self._postings: Dict[str, Dict[int, List[int]]] = defaultdict(dict)
        self._docs: List[str] = []

    def add_document(self, text: str) -> int:
        doc_id = len(self._docs)
        self._docs.append(text)
        toks = self.tokenizer_factory.create(text).get_tokens()
        for pos, tok in enumerate(toks):
            self._postings[tok].setdefault(doc_id, []).append(pos)
        return doc_id

    def documents(self, word: str) -> List[int]:
        return sorted(self._postings.get(word, {}).keys())

    def positions(self, word: str, doc_id: int) -> List[int]:
        return list(self._postings.get(word, {}).get(doc_id, []))

    def document_text(self, doc_id: int) -> str:
        return self._docs[doc_id]

    def num_documents(self) -> int:
        return len(self._docs)

    def search(self, *words: str) -> List[int]:
        """Doc ids containing ALL the words (conjunctive query)."""
        if not words:
            return []
        sets = [set(self.documents(w)) for w in words]
        return sorted(set.intersection(*sets)) if all(sets) else []


def windows(tokens: Sequence[str], window_size: int = 5,
            pad_token: str = "<PAD>") -> List[List[str]]:
    """Centered moving windows over a token stream (reference:
    text/movingwindow/Windows.windows): one window per token, padded at the
    edges, length exactly ``window_size`` (odd sizes center exactly)."""
    half = window_size // 2
    padded = [pad_token] * half + list(tokens) + [pad_token] * half
    return [padded[i : i + window_size] for i in range(len(tokens))]
