"""Sentence/document iterator SPIs (reference: deeplearning4j-nlp
text/sentenceiterator/ — SentenceIterator, BasicLineIterator,
CollectionSentenceIterator, LabelAware* — SURVEY.md §2.5)."""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    """Reference: sentenceiterator/SentenceIterator.java."""

    def __init__(self):
        self.pre_processor: Optional[SentencePreProcessor] = None

    def set_pre_processor(self, pre: SentencePreProcessor) -> None:
        self.pre_processor = pre

    def _apply(self, s: str) -> str:
        return self.pre_processor.pre_process(s) if self.pre_processor else s

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    """Reference: CollectionSentenceIterator.java."""

    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._sentences = list(sentences)
        self._idx = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._idx]
        self._idx += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._idx < len(self._sentences)

    def reset(self) -> None:
        self._idx = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference: BasicLineIterator.java)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._f = None
        self._next = None
        self.reset()

    def reset(self) -> None:
        if self._f:
            self._f.close()
        self._f = open(self.path, encoding="utf-8")
        self._advance()

    def _advance(self):
        line = self._f.readline()
        self._next = line.rstrip("\n") if line else None

    def has_next(self) -> bool:
        return self._next is not None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._apply(s)


class LabelledDocument:
    """Reference: documentiterator/LabelledDocument.java."""

    def __init__(self, content: str, labels: Optional[List[str]] = None):
        self.content = content
        self.labels = labels or []


class LabelAwareIterator:
    """Reference: documentiterator/LabelAwareIterator.java — documents with
    labels, the ParagraphVectors input."""

    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionLabelAwareIterator(LabelAwareIterator):
    def __init__(self, docs: Iterable[LabelledDocument]):
        self._docs = list(docs)

    def __iter__(self):
        return iter(self._docs)
