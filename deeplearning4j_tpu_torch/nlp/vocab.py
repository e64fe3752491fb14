"""Vocabulary: VocabWord, cache, constructor, Huffman coding.

Reference: models/word2vec/wordstore/VocabConstructor.java (corpus scan +
min-freq pruning), inmemory/AbstractCache.java (vocab cache),
models/word2vec/Huffman.java:34 (Huffman tree for hierarchical softmax;
maxCodeLength 40).
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence


@dataclass
class VocabWord:
    """Reference: models/word2vec/VocabWord.java — word + frequency + Huffman
    code/points for hierarchical softmax."""

    word: str
    count: int = 1
    index: int = -1
    codes: List[int] = field(default_factory=list)   # Huffman code bits
    points: List[int] = field(default_factory=list)  # inner-node indices
    is_label: bool = False  # ParagraphVectors doc labels


class VocabCache:
    """Reference: wordstore/inmemory/AbstractCache.java."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    def add_token(self, vw: VocabWord) -> None:
        existing = self._words.get(vw.word)
        if existing is not None:
            existing.count += vw.count
        else:
            vw.index = len(self._by_index)
            self._words[vw.word] = vw
            self._by_index.append(vw)
        self.total_word_count += vw.count

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.count if vw else 0

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, idx: int) -> str:
        return self._by_index[idx].word

    def num_words(self) -> int:
        return len(self._by_index)

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def remove_below(self, min_count: int) -> None:
        """Min-frequency pruning + reindex (reference: VocabConstructor
        truncateVocabulary)."""
        kept = [vw for vw in self._by_index if vw.count >= min_count or vw.is_label]
        self._by_index = kept
        self._words = {vw.word: vw for vw in kept}
        for i, vw in enumerate(kept):
            vw.index = i
        self.total_word_count = sum(vw.count for vw in kept)


class VocabConstructor:
    """Corpus scan → pruned vocab (reference: VocabConstructor.java — the
    reference's parallel scan threads are unnecessary at Python/numpy speeds
    for the scan; counting is a Counter pass)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build_vocab(self, sequences: Iterable[Sequence[str]],
                    cache: Optional[VocabCache] = None) -> VocabCache:
        cache = cache or VocabCache()
        counts: Counter = Counter()
        for seq in sequences:
            counts.update(seq)
        # insert in frequency order (stable vocab indices, matches the
        # reference's frequency-sorted lookup table layout)
        for word, n in counts.most_common():
            cache.add_token(VocabWord(word=word, count=n))
        cache.remove_below(self.min_word_frequency)
        return cache


class Huffman:
    """Huffman tree over word frequencies (reference: Huffman.java:34;
    MAX_CODE_LENGTH=40). Assigns ``codes``/``points`` to each VocabWord for
    hierarchical softmax."""

    MAX_CODE_LENGTH = 40

    def __init__(self, words: List[VocabWord]):
        self.words = words

    def build(self) -> None:
        n = len(self.words)
        if n == 0:
            return
        if n == 1:
            self.words[0].codes = [0]
            self.words[0].points = [0]
            return
        # heap of (count, tiebreak, node_id); leaves 0..n-1, internal n..2n-2
        heap = [(vw.count, i, i) for i, vw in enumerate(self.words)]
        heapq.heapify(heap)
        parent = {}
        bit = {}
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a], bit[a] = next_id, 0
            parent[b], bit[b] = next_id, 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, vw in enumerate(self.words):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(bit[node])
                points.append(parent[node] - n)  # inner-node index in [0, n-1)
                node = parent[node]
            codes.reverse()
            points.reverse()
            if len(codes) > self.MAX_CODE_LENGTH:
                raise ValueError(f"Huffman code longer than {self.MAX_CODE_LENGTH}")
            vw.codes = codes
            vw.points = points
