"""UIMA analyzer tier in miniature: sentence segmentation + POS-filtered
tokenization, pure Python.

Reference (SURVEY.md §2.5): deeplearning4j-nlp-uima exposes exactly three
capabilities through its UIMA/ClearTK pipeline —
``UimaSentenceIterator.java`` (sentence segmentation),
``UimaTokenizer.java`` (tokenization), and ``PosUimaTokenizer.java``
(POS-filtered tokens: any token whose tag is not allowed becomes "NONE", or
is stripped). Same approach as ``nlp/japanese.py``'s kuromoji miniature: the
*architecture* (annotator pipeline → sentence spans → tokens → tags →
filter) is implemented for real with rule-based components instead of the
vendored OpenNLP models, and the factory seam accepts a user-supplied
tagger/segmenter where model-backed quality is needed.

Scope, stated plainly: the segmenter handles abbreviations, initials,
decimals, ellipses and trailing quotes/brackets; the tagger is a
closed-class lexicon + suffix-rule tagger emitting the Penn tags the
reference's filter sets use (NN*, VB*, JJ*, RB, CD, IN, DT, PRP, CC, UH).
It is deterministic and dictionary-free — not a trained model.
"""

from __future__ import annotations

import re
from typing import Collection, Iterable, List, Optional

from .sentence_iterator import SentenceIterator
from .tokenization import TokenPreProcess, Tokenizer, TokenizerFactory

# ---------------------------------------------------------------- sentences

_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "e.g",
    "i.e", "fig", "no", "al", "inc", "ltd", "co", "corp", "dept", "est",
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept", "oct",
    "nov", "dec", "u.s", "u.k", "a.m", "p.m",
}

_BOUNDARY = re.compile(r'([.?!]+)(["\')\]]*)(\s+|$)')


def segment_sentences(text: str) -> List[str]:
    """Sentence spans (reference: UimaSentenceIterator's SentenceAnnotator).

    A [.?!] run ends a sentence unless the preceding token is a known
    abbreviation, a single-letter initial ("J."), or part of a number
    ("3.14" never matches — no following whitespace)."""
    sentences: List[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        prev = text[start:m.start()].rstrip()
        last_word = prev.split()[-1].lower() if prev.split() else ""
        last_word = last_word.lstrip('("\'')
        if m.group(1) == ".":
            if last_word in _ABBREV or re.fullmatch(r"[a-z]", last_word):
                continue  # abbreviation or initial: not a boundary
        end = m.end() - len(m.group(3)) if m.group(3) else m.end()
        s = text[start:end].strip()
        if s:
            sentences.append(s)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


class UimaSentenceIterator(SentenceIterator):
    """Segment documents into sentences (reference: UimaSentenceIterator.java
    — iterate documents, yield one sentence at a time)."""

    def __init__(self, documents: Iterable[str], segmenter=segment_sentences):
        super().__init__()
        # segment ONCE: documents are immutable after construction, and
        # SentenceIterator.__iter__ resets — re-running the regex scan per
        # pass would make every epoch re-segment the whole corpus
        self._sentences = [s for d in documents for s in segmenter(d)]
        self._idx = 0

    def reset(self) -> None:
        self._idx = 0

    def has_next(self) -> bool:
        return self._idx < len(self._sentences)

    def next_sentence(self) -> str:
        s = self._sentences[self._idx]
        self._idx += 1
        return self._apply(s)


# -------------------------------------------------------------------- tags

_CLOSED_CLASS = {
    # determiners
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "each": "DT", "every": "DT", "some": "DT",
    "any": "DT", "no": "DT",
    # pronouns
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "us": "PRP", "them": "PRP",
    # prepositions / subordinators
    "of": "IN", "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
    "with": "IN", "from": "IN", "to": "TO", "as": "IN", "into": "IN",
    "over": "IN", "under": "IN", "after": "IN", "before": "IN", "if": "IN",
    "because": "IN", "while": "IN", "than": "IN",
    # conjunctions
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "yet": "CC",
    # auxiliaries / copulas / modals
    "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD", "be": "VB",
    "been": "VBN", "being": "VBG", "am": "VBP", "do": "VBP", "does": "VBZ",
    "did": "VBD", "have": "VBP", "has": "VBZ", "had": "VBD", "will": "MD",
    "would": "MD", "can": "MD", "could": "MD", "should": "MD", "may": "MD",
    "might": "MD", "must": "MD", "not": "RB",
}

_NOUN_SUFFIX = ("tion", "sion", "ness", "ment", "ity", "ance", "ence", "ship",
                "ism", "er", "or", "ist")
_ADJ_SUFFIX = ("ous", "ful", "able", "ible", "ive", "al", "ic", "less", "ish")


def pos_tag(tokens: List[str]) -> List[str]:
    """Closed-class + suffix-rule Penn tags (miniature PoStagger.java slot)."""
    tags: List[str] = []
    for i, tok in enumerate(tokens):
        low = tok.lower()
        if not tok:
            tags.append("SYM")  # tolerate empty tokens from naive splits
        elif low in _CLOSED_CLASS:
            tags.append(_CLOSED_CLASS[low])
        elif re.fullmatch(r"[-+]?\d[\d,.]*", tok):
            tags.append("CD")
        elif not tok[0].isalnum():
            tags.append("SYM")
        elif i > 0 and tok[0].isupper():
            tags.append("NNP")
        elif low.endswith("ly"):
            tags.append("RB")
        elif low.endswith("ing"):
            tags.append("VBG")
        elif low.endswith("ed"):
            tags.append("VBD")
        elif tags and tags[-1] in ("TO", "MD"):
            tags.append("VB")
        elif low.endswith(_NOUN_SUFFIX):
            tags.append("NN")  # before JJ/NNS so derivational nouns win
        elif low.endswith(_ADJ_SUFFIX):
            tags.append("JJ")
        elif low.endswith("s") and not low.endswith("ss") and len(low) > 3:
            tags.append("NNS")
        else:
            tags.append("NN")
    return tags


def _tag_matches(tag: str, allowed: Collection[str]) -> bool:
    """Reference filter semantics: allowed entries match exactly or as a
    prefix class ("NN" allows NN/NNS/NNP)."""
    return any(tag == a or tag.startswith(a) for a in allowed)


# internal . and , stay inside a token only when a word character follows
# ("3.14", "U.S.A"); a trailing sentence period tokenizes separately
_WORD = re.compile(r"[A-Za-z0-9](?:[\w'-]|[.,](?=\w))*|[^\sA-Za-z0-9]")


class PosUimaTokenizer(Tokenizer):
    """POS-filtered tokenizer (reference: PosUimaTokenizer.java): tokens
    whose tag is not in ``allowed_pos_tags`` become "NONE" (or are stripped
    with ``strip_nones=True``), preserving positions for window models."""

    def __init__(self, text: str, allowed_pos_tags: Collection[str],
                 strip_nones: bool = False,
                 pre_processor: Optional[TokenPreProcess] = None,
                 tagger=pos_tag):
        raw = _WORD.findall(text)
        tags = tagger(raw)
        if len(tags) != len(raw):
            raise ValueError(
                f"tagger returned {len(tags)} tags for {len(raw)} tokens — "
                "a custom tagger must tag every token"
            )
        # preprocess the SURVIVING tokens here, then bypass the base class's
        # per-token preprocessing: a downstream preprocessor would mangle the
        # "NONE" sentinel (e.g. lowercase it) and could empty a token, which
        # get_tokens() drops — both break position-preserving semantics
        toks = []
        for t, g in zip(raw, tags):
            if not _tag_matches(g, allowed_pos_tags):
                toks.append("NONE")
                continue
            if pre_processor is not None:
                t = pre_processor.pre_process(t)
            toks.append(t if t else "NONE")
        if strip_nones:
            toks = [t for t in toks if t != "NONE"]
        super().__init__(toks, None)


class PosUimaTokenizerFactory(TokenizerFactory):
    """Factory seam (reference: PosUimaTokenizerFactory.java). A custom
    ``tagger`` (e.g. a model-backed one) drops in without code changes."""

    def __init__(self, allowed_pos_tags: Collection[str],
                 strip_nones: bool = False, tagger=pos_tag):
        super().__init__()
        self.allowed_pos_tags = list(allowed_pos_tags)
        self.strip_nones = strip_nones
        self.tagger = tagger

    def create(self, text: str) -> Tokenizer:
        return PosUimaTokenizer(text, self.allowed_pos_tags,
                                strip_nones=self.strip_nones,
                                pre_processor=self._pre, tagger=self.tagger)


class UimaTokenizerFactory(TokenizerFactory):
    """Plain UIMA tokenization seam (reference: UimaTokenizerFactory.java):
    sentence-aware word tokenization, no POS filtering."""

    def create(self, text: str) -> Tokenizer:
        toks: List[str] = []
        for s in segment_sentences(text):
            toks.extend(_WORD.findall(s))
        return Tokenizer(toks, self._pre)
