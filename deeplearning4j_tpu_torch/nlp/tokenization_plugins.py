"""CJK tokenizer-factory plugins.

Reference (SURVEY.md §2.5): deeplearning4j-nlp-japanese vendors Kuromoji
(~20k LoC morphological analyzer) and deeplearning4j-nlp-korean wraps
KoreanAnalyzer — both exposed ONLY as TokenizerFactory plugins. The
port keeps the same plugin seam with lightweight script-aware
segmenters: dictionary-driven morphological analysis can be dropped in by
implementing TokenizerFactory (e.g. over fugashi/mecab where available),
while these defaults give correct script-run segmentation without vendored
dictionaries.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional

from .tokenization import TokenPreProcess, Tokenizer, TokenizerFactory


def _char_class(ch: str) -> str:
    code = ord(ch)
    if 0x3040 <= code <= 0x309F:
        return "hiragana"
    if 0x30A0 <= code <= 0x30FF or 0x31F0 <= code <= 0x31FF:
        return "katakana"
    if 0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF:
        return "kanji"
    if 0xAC00 <= code <= 0xD7A3 or 0x1100 <= code <= 0x11FF:
        return "hangul"
    if ch.isspace():
        return "space"
    if unicodedata.category(ch).startswith("P"):
        return "punct"
    return "latin"


def _script_runs(text: str) -> List[str]:
    """Split into runs of uniform character class; drop space/punct runs."""
    tokens: List[str] = []
    cur, cur_cls = [], None
    for ch in text:
        cls = _char_class(ch)
        if cls != cur_cls and cur:
            tokens.append(("".join(cur), cur_cls))
            cur = []
        cur.append(ch)
        cur_cls = cls
    if cur:
        tokens.append(("".join(cur), cur_cls))
    return [t for t, c in tokens if c not in ("space", "punct")]


class JapaneseTokenizerFactory(TokenizerFactory):
    """Morphological segmentation for Japanese (reference plugin:
    JapaneseTokenizerFactory over Kuromoji). Backed by
    :mod:`deeplearning4j_tpu_torch.nlp.japanese` — a dictionary + Viterbi-lattice
    segmenter (kuromoji's architecture with an embedded lexicon), NOT a
    gated import. ``extra_entries`` extends the lexicon; pass
    ``script_runs_only=True`` for the older coarse behavior."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None,
                 extra_entries=None, script_runs_only: bool = False):
        self.pre_processor = pre_processor
        self.script_runs_only = script_runs_only
        if not script_runs_only:
            from .japanese import JapaneseSegmenter  # noqa: PLC0415

            self._segmenter = JapaneseSegmenter(extra_entries)

    def create(self, text: str) -> Tokenizer:
        if self.script_runs_only:
            return Tokenizer(_script_runs(text), self.pre_processor)
        return Tokenizer(self._segmenter.tokenize(text), self.pre_processor)


# Common Korean postpositions (josa), longest-first so 에서/으로 beat 에/로.
# Reference analog: the KoreanAnalyzer's particle POS class (josa) split off
# from stems during tokenization.
_JOSA = sorted(
    ["은", "는", "이", "가", "을", "를", "의", "에", "에서", "에게", "한테",
     "께", "으로", "로", "와", "과", "도", "만", "까지", "부터", "처럼",
     "보다", "마다", "조차", "밖에", "이나", "나", "라도", "이라도", "요",
     "이요", "이란", "란", "께서", "들"],
    key=len, reverse=True,
)


def _split_josa(eojeol: str) -> List[str]:
    """stem + particle for hangul eojeols (returns [eojeol] when no josa)."""
    for josa in _JOSA:
        if (len(eojeol) > len(josa) and eojeol.endswith(josa)
                and _char_class(eojeol[0]) == "hangul"):
            return [eojeol[: -len(josa)], josa]
    return [eojeol]


class KoreanTokenizerFactory(TokenizerFactory):
    """Korean morphological segmentation (reference plugin:
    KoreanTokenizerFactory over twitter-korean-text,
    deeplearning4j-nlp-korean/.../KoreanTokenizerFactory.java). Backed by
    :mod:`deeplearning4j_tpu_torch.nlp.korean` — a jamo-aware lexicon +
    conjugation expansion + per-eojeol Viterbi lattice, NOT a gated import:
    agglutinative eojeols split into stem + particles/endings the way the
    reference's own test pins (라이브러리입니다 → 라이브러리/입니/다), and
    dictionary nouns beat suffix clipping (고양이가 → 고양이/가).

    ``extra_entries`` extends the lexicon. Legacy modes kept for
    compatibility: ``script_runs_only=True`` emits whole eojeols (old
    default); ``split_josa=True`` adds the dictionary-free trailing-josa
    suffix strip on top of script runs (old opt-in)."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None,
                 split_josa: bool = False, script_runs_only: bool = False,
                 extra_entries=None):
        self.pre_processor = pre_processor
        self.split_josa = split_josa
        self.script_runs_only = script_runs_only or split_josa
        if not self.script_runs_only:
            from .korean import KoreanSegmenter  # noqa: PLC0415

            self._segmenter = KoreanSegmenter(extra_entries)

    def create(self, text: str) -> Tokenizer:
        if self.script_runs_only:
            tokens: List[str] = []
            for chunk in text.split():
                for run in _script_runs(chunk):
                    if self.split_josa and _char_class(run[0]) == "hangul":
                        tokens.extend(_split_josa(run))
                    else:
                        tokens.append(run)
            return Tokenizer(tokens, self.pre_processor)
        return Tokenizer(self._segmenter.tokenize(text), self.pre_processor)
