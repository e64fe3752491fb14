"""Stemming token pre-processor.

Reference slot: deeplearning4j-nlp-uima's StemmerAnnotator/SnowballStemmer
pipeline (SURVEY.md §2.5 "UIMA ... tokenization/POS/stemming"). UIMA is a JVM
framework, so the port keeps the *capability* — stemming as a
TokenPreProcess plugin — via a self-contained Porter stemmer (Porter 1980,
the standard public algorithm), composable with any TokenizerFactory.
"""

from __future__ import annotations

from .tokenization import TokenPreProcess

_VOWELS = set("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences (the 'm' of Porter's [C](VC)^m[V] form)."""
    m = 0
    prev_v = False
    for i in range(len(stem)):
        v = not _is_consonant(stem, i)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in "wxy")


class PorterStemmer:
    """Porter (1980) stemming algorithm, steps 1a-5b."""

    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w
        w = self._step1a(w)
        w = self._step1b(w)
        w = self._step1c(w)
        w = self._step2(w)
        w = self._step3(w)
        w = self._step4(w)
        w = self._step5(w)
        return w

    def _step1a(self, w: str) -> str:
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith("ies"):
            return w[:-2]
        if w.endswith("ss"):
            return w
        if w.endswith("s"):
            return w[:-1]
        return w

    def _step1b(self, w: str) -> str:
        if w.endswith("eed"):
            stem = w[:-3]
            return w[:-1] if _measure(stem) > 0 else w
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                return w + "e"
            if _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
                return w[:-1]
            if _measure(w) == 1 and _cvc(w):
                return w + "e"
        return w

    def _step1c(self, w: str) -> str:
        if w.endswith("y") and _has_vowel(w[:-1]):
            return w[:-1] + "i"
        return w

    _STEP2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"),
    ]

    def _step2(self, w: str) -> str:
        for suffix, repl in self._STEP2:
            if w.endswith(suffix):
                stem = w[: -len(suffix)]
                return stem + repl if _measure(stem) > 0 else w
        return w

    _STEP3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]

    def _step3(self, w: str) -> str:
        for suffix, repl in self._STEP3:
            if w.endswith(suffix):
                stem = w[: -len(suffix)]
                return stem + repl if _measure(stem) > 0 else w
        return w

    _STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
              "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
              "ive", "ize"]

    def _step4(self, w: str) -> str:
        for suffix in self._STEP4:
            if w.endswith(suffix):
                stem = w[: -len(suffix)]
                if _measure(stem) > 1:
                    return stem
                return w
        if w.endswith("ion"):
            stem = w[:-3]
            if _measure(stem) > 1 and stem and stem[-1] in "st":
                return stem
        return w

    def _step5(self, w: str) -> str:
        if w.endswith("e"):
            stem = w[:-1]
            m = _measure(stem)
            if m > 1 or (m == 1 and not _cvc(stem)):
                w = stem
        if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
            w = w[:-1]
        return w


class StemmingPreprocessor(TokenPreProcess):
    """TokenPreProcess plugin applying Porter stemming (set on any tokenizer
    factory via set_token_pre_processor, like the reference's UIMA stemming
    annotator in a pipeline)."""

    def __init__(self):
        self._stemmer = PorterStemmer()

    def pre_process(self, token: str) -> str:
        return self._stemmer.stem(token)
