"""Tokenizer SPIs (reference: deeplearning4j-nlp text/tokenization/ —
TokenizerFactory, DefaultTokenizer, NGramTokenizerFactory, CommonPreprocessor,
EndingPreProcessor — SURVEY.md §2.5 "Text pipeline")."""

from __future__ import annotations

import re
from typing import List, Optional


class TokenPreProcess:
    """Reference: tokenization/tokenizer/TokenPreProcess.java."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/specials (reference: CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class EndingPreProcessor(TokenPreProcess):
    """Crude suffix stemmer (reference: EndingPreProcessor.java: strips s/ed/
    ing/ly endings)."""

    def pre_process(self, token: str) -> str:
        t = token
        if t.endswith("s") and not t.endswith("ss"):
            t = t[:-1]
        if t.endswith("ed"):
            t = t[:-2]
        if t.endswith("ing"):
            t = t[:-3]
        if t.endswith("ly"):
            t = t[:-2]
        return t


class Tokenizer:
    """Reference: tokenization/tokenizer/Tokenizer.java."""

    def __init__(self, tokens: List[str], pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre_processor
        self._idx = 0

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._idx]
        self._idx += 1
        return self._pre.pre_process(tok) if self._pre else tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    """Reference: tokenization/tokenizerfactory/TokenizerFactory.java."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenization (reference: DefaultTokenizerFactory.java)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Token n-grams (reference: NGramTokenizerFactory.java: min/max n,
    space-joined)."""

    def __init__(self, min_n: int = 1, max_n: int = 2,
                 base: Optional[TokenizerFactory] = None):
        super().__init__()
        self.min_n, self.max_n = min_n, max_n
        self.base = base or DefaultTokenizerFactory()

    def create(self, text: str) -> Tokenizer:
        toks = self.base.create(text).get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i : i + n]))
        return Tokenizer(out, self._pre)
