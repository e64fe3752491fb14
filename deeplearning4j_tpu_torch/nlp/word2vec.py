"""Word2Vec facade over SequenceVectors (counterpart of
``deeplearning4j_tpu/nlp/word2vec.py``).

Reference: models/word2vec/Word2Vec.java (610 LoC) — a thin configuration
facade wiring SentenceIterator + TokenizerFactory into the SequenceVectors
engine (SURVEY.md §3.6 call stack).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from .sentence_iterator import SentenceIterator, CollectionSentenceIterator
from .sequence_vectors import Sequence, SequenceVectors
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class Word2Vec(SequenceVectors):
    """Usage parity with the reference Builder:

        w2v = Word2Vec(layer_size=100, window=5, negative=5, use_hs=False)
        w2v.tokenizer_factory = DefaultTokenizerFactory()
        w2v.fit_sentences(sentence_iterator_or_list)

    It trains on the card unless given ``device="cpu"``.
    """

    def __init__(self, *, tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Iterable[str] = (), **kwargs):
        kwargs.setdefault("elements_algo", "skipgram")
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = set(stop_words)

    def _tokenize(self, sentence: str) -> List[str]:
        toks = self.tokenizer_factory.create(sentence).get_tokens()
        if self.stop_words:
            toks = [t for t in toks if t not in self.stop_words]
        return toks

    def _sentences_to_sequences(self, sentences) -> List[Sequence]:
        if isinstance(sentences, SentenceIterator):
            it = iter(sentences)
        elif isinstance(sentences, (list, tuple)) and sentences and isinstance(
            sentences[0], str
        ):
            it = iter(CollectionSentenceIterator(sentences))
        else:
            it = iter(sentences)
        return [Sequence(elements=self._tokenize(s)) for s in it]

    def fit_sentences(self, sentences) -> "Word2Vec":
        """Reference: Word2Vec.fit() after setSentenceIterator."""
        return self.fit(self._sentences_to_sequences(sentences))

    # fit() accepts pre-tokenized sequences (engine behavior) or raw strings
    def fit(self, data) -> "Word2Vec":
        data = list(data)
        if data and isinstance(data[0], str):
            return super().fit(self._sentences_to_sequences(data))
        return super().fit(data)
