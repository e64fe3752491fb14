"""Japanese morphological segmenter: dictionary + Viterbi lattice.

Reference: deeplearning4j-nlp-japanese vendors Kuromoji
(com/atilika/kuromoji/**, ~20k LoC) whose core is exactly this architecture —
a lexicon with per-entry costs, a connection-cost matrix over part-of-speech
pairs, unknown-word candidates generated by character class, and a Viterbi
search for the min-cost path through the word lattice
(kuromoji/viterbi/ViterbiBuilder.java + ViterbiSearcher.java). This is that
algorithm in miniature: a compact embedded lexicon of high-frequency
morphemes (particles, auxiliaries, common verbs/nouns) instead of the IPADIC
binary, and class-based unknown-word handling so arbitrary kanji/katakana
compounds still segment sensibly. Pure Python, no vendored dictionary, no
gated imports (VERDICT round-2 task 8).

The classic test: すもももももももものうち →
すもも / も / もも / も / もも / の / うち — only the lattice search gets
this right; greedy longest-match does not.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# Lexicon. (surface, POS, cost) — costs are small integers standing in for
# kuromoji's -log-frequency word costs: frequent grammar words are cheap,
# content words moderate; unknown words (below) are expensive and grow with
# length, so known decompositions win when they exist.
# ---------------------------------------------------------------------------

PARTICLE = "particle"
AUX = "aux"          # auxiliary verbs & polite endings
VERB = "verb"
ADJ = "adj"
NOUN = "noun"
PRONOUN = "pronoun"
ADV = "adv"
CONJ = "conj"
PREFIX = "prefix"
SUFFIX = "suffix"
SYMBOL = "symbol"
UNK = "unk"

_LEXICON: List[Tuple[str, str, int]] = []


def _add(pos: str, cost: int, *surfaces: str) -> None:
    for s in surfaces:
        _LEXICON.append((s, pos, cost))


# case particles / binding particles / conjunctive particles
_add(PARTICLE, 1, "は", "が", "を", "に", "へ", "と", "で", "も", "の", "や",
     "か", "ね", "よ", "な", "ぞ", "わ", "さ", "し", "ば")
_add(PARTICLE, 2, "から", "まで", "より", "など", "だけ", "ほど", "くらい",
     "ぐらい", "ながら", "ので", "のに", "けど", "けれど", "けれども", "とか",
     "でも", "しか", "こそ", "ずつ", "について", "として", "によって",
     "では", "には", "へは", "とは", "かも")
# auxiliaries & polite machinery
_add(AUX, 1, "です", "ます", "だ", "た", "て", "ない", "ん", "う", "よう",
     "れる", "られる", "せる", "させる", "たい", "そう", "らしい", "べき")
_add(AUX, 2, "でした", "ました", "ません", "でしょう", "ましょう", "だった",
     "ください", "なかった", "たかった", "ている", "ていた", "ています",
     "ていました", "である", "であった", "います", "いました", "いません",
     "いる", "いた", "ある", "あった", "あります", "ありました", "ありません",
     "なる", "なった", "なります", "できる", "できます", "できた")
# common verbs (dictionary + frequent inflected/te-forms)
_add(VERB, 2, "する", "した", "して", "します", "しました", "行く", "行き",
     "行った", "行って", "行きます", "来る", "来た", "来て", "来ます", "きた",
     "見る", "見た", "見て", "見ます", "食べる", "食べた", "食べて", "食べます",
     "飲む", "飲んだ", "飲んで", "読む", "読んだ", "読んで", "書く", "書いた",
     "書いて", "聞く", "聞いた", "聞いて", "話す", "話した", "話して",
     "言う", "言った", "言って", "思う", "思った", "思って", "知る", "知って",
     "住む", "住んで", "働く", "働いて", "買う", "買った", "買って",
     "使う", "使って", "作る", "作った", "作って", "持つ", "持って",
     "分かる", "分かった", "わかる", "わかった", "学ぶ", "学んで")
# adjectives
_add(ADJ, 2, "良い", "いい", "よい", "悪い", "大きい", "小さい", "新しい",
     "古い", "高い", "安い", "早い", "遅い", "暑い", "寒い", "楽しい",
     "嬉しい", "美しい", "難しい", "易しい", "簡単", "きれい", "元気", "好き",
     "嫌い", "大切", "大丈夫")
# pronouns / common nouns
_add(PRONOUN, 2, "私", "僕", "俺", "君", "あなた", "彼", "彼女", "誰", "何",
     "これ", "それ", "あれ", "どれ", "ここ", "そこ", "あそこ", "どこ",
     "わたし", "ぼく")
_add(NOUN, 2, "人", "日本", "日本語", "英語", "東京", "東京都", "京都",
     "大阪", "学生", "先生", "会社", "会社員", "学校", "大学", "家", "うち",
     "犬", "猫", "本", "水", "お茶", "山", "川", "海", "空", "雨", "雪",
     "時間", "今日", "明日", "昨日", "今", "朝", "昼", "夜", "年", "月",
     "日", "週", "時", "分", "秒", "国", "町", "街", "道", "駅", "車",
     "電車", "飛行機", "映画", "音楽", "写真", "電話", "手紙", "料理",
     "朝ご飯", "昼ご飯", "晩ご飯", "ご飯", "もも", "すもも", "桃", "友達",
     "友人", "家族", "父", "母", "子供", "名前", "仕事", "言葉", "話",
     "心", "手", "目", "口", "足", "頭", "顔", "声", "力", "気", "物",
     "者", "事", "こと", "もの", "ところ", "とき", "ため", "よう", "そう",
     "はず", "つもり", "みんな", "全部", "少し", "たくさん")
_add(ADV, 2, "とても", "すごく", "もっと", "ちょっと", "まだ", "もう",
     "いつも", "時々", "たぶん", "きっと", "ぜひ", "やはり", "やっぱり",
     "すぐ", "ゆっくり", "一緒に", "初めて", "また", "まず", "つい")
_add(CONJ, 2, "そして", "しかし", "でも", "だから", "それで", "また",
     "または", "つまり", "ところで", "さらに")
_add(PREFIX, 2, "お", "ご", "御")
_add(SUFFIX, 1, "さん", "様", "君", "ちゃん", "たち", "達", "的", "化",
     "者", "員", "家", "語", "人", "県", "市", "区", "町", "村", "都",
     "府", "駅", "屋", "中", "後", "前", "内", "外", "上", "下")

_DICT: Dict[str, List[Tuple[str, int]]] = {}
for _s, _p, _c in _LEXICON:
    _DICT.setdefault(_s, []).append((_p, _c))
_MAX_WORD = max(len(s) for s in _DICT)


# ---------------------------------------------------------------------------
# Character classes for unknown-word candidates
# (kuromoji: CharacterDefinition + UnknownDictionary).
# ---------------------------------------------------------------------------


def char_class(ch: str) -> str:
    code = ord(ch)
    if 0x3040 <= code <= 0x309F:
        return "hiragana"
    if 0x30A0 <= code <= 0x30FF or 0x31F0 <= code <= 0x31FF or ch == "ー":
        return "katakana"
    if 0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF or ch in "々〆ヶ":
        return "kanji"
    if ch.isdigit() or 0xFF10 <= code <= 0xFF19:
        return "num"
    if ch.isspace():
        return "space"
    if ch.isalpha():
        return "latin"
    return "symbol"


# cost per extra character of an unknown run, by class — katakana runs are
# usually one loanword (cheap to keep whole); kanji runs often decompose
# (expensive, so dictionary splits win)
_UNK_BASE = {"kanji": 6, "katakana": 4, "hiragana": 7, "latin": 4,
             "num": 3, "symbol": 8}
_UNK_PER_CHAR = {"kanji": 3, "katakana": 1, "hiragana": 3, "latin": 1,
                 "num": 1, "symbol": 4}

# connection costs over POS pairs (kuromoji: ConnectionCosts binary matrix).
# Negative = favored transition.
_CONN: Dict[Tuple[str, str], int] = {
    (NOUN, PARTICLE): -3, (PRONOUN, PARTICLE): -3, (UNK, PARTICLE): -2,
    (PARTICLE, NOUN): -2, (PARTICLE, PRONOUN): -2, (PARTICLE, VERB): -2,
    (PARTICLE, UNK): -1, (PARTICLE, ADV): -1, (PARTICLE, ADJ): -1,
    (VERB, AUX): -3, (ADJ, AUX): -2, (NOUN, AUX): -1, (AUX, AUX): -1,
    (PREFIX, NOUN): -2, (NOUN, SUFFIX): -2, (UNK, SUFFIX): -2,
    (PARTICLE, PARTICLE): 2, (NOUN, NOUN): 1, (AUX, NOUN): 1,
    (VERB, NOUN): 1, (VERB, VERB): 2,
}


class Morpheme(NamedTuple):
    surface: str
    pos: str
    start: int


class JapaneseSegmenter:
    """Min-cost lattice segmentation (kuromoji ViterbiSearcher in miniature).

    ``extra_entries``: optional [(surface, pos, cost)] to extend the lexicon
    (the seam where a full IPADIC-scale dictionary drops in).
    """

    def __init__(self, extra_entries: Optional[List[Tuple[str, str, int]]] = None):
        if extra_entries:
            self._dict = {k: list(v) for k, v in _DICT.items()}
            self._max_word = _MAX_WORD
            for s, p, c in extra_entries:
                self._dict.setdefault(s, []).append((p, c))
                self._max_word = max(self._max_word, len(s))
        else:
            self._dict = _DICT
            self._max_word = _MAX_WORD

    def _candidates(self, text: str, i: int) -> List[Tuple[str, str, int]]:
        """(surface, pos, word_cost) candidates starting at i."""
        out: List[Tuple[str, str, int]] = []
        for ln in range(1, min(self._max_word, len(text) - i) + 1):
            surf = text[i : i + ln]
            for pos, cost in self._dict.get(surf, ()):
                out.append((surf, pos, cost))
        # unknown-word candidate: the maximal same-class run (and its first
        # character alone, so the lattice can split at class-internal
        # boundaries the dictionary knows about)
        cls = char_class(text[i])
        if cls != "space":
            j = i + 1
            while j < len(text) and char_class(text[j]) == cls:
                j += 1
            run = text[i:j]
            base = _UNK_BASE.get(cls, 8)
            per = _UNK_PER_CHAR.get(cls, 3)
            seen = {s for s, _, _ in out}
            if run not in seen:
                out.append((run, UNK, base + per * (len(run) - 1)))
            if len(run) > 1 and run[0] not in seen:
                out.append((run[0], UNK, base))
        return out

    def segment(self, text: str) -> List[Morpheme]:
        """Viterbi over the word lattice; whitespace resets the path.

        DP state is (position, POS of the preceding word): connection costs
        are POS-dependent, so keeping one best path per position would
        silently drop parses whose locally-worse prefix enables a cheaper
        transition (kuromoji's lattice nodes likewise carry their POS)."""
        n = len(text)
        INF = float("inf")
        best: List[dict] = [dict() for _ in range(n + 1)]
        back: List[dict] = [dict() for _ in range(n + 1)]
        best[0][""] = 0.0
        for i in range(n):
            if not best[i]:
                continue
            if text[i].isspace():  # free skip, path cost unchanged
                for prev, base in best[i].items():
                    if base < best[i + 1].get(prev, INF):
                        best[i + 1][prev] = base
                        back[i + 1][prev] = (i, prev, "")
                continue
            cands = self._candidates(text, i)
            for prev, base in best[i].items():
                for surf, pos, wcost in cands:
                    j = i + len(surf)
                    cost = base + wcost + _CONN.get((prev, pos), 0)
                    if cost < best[j].get(pos, INF):
                        best[j][pos] = cost
                        back[j][pos] = (i, prev, surf)
        # reconstruct from the cheapest final state
        out: List[Morpheme] = []
        if not best[n]:  # unreachable (shouldn't happen): whole text unknown
            return [Morpheme(text, UNK, 0)]
        pos = min(best[n], key=best[n].get)
        j = n
        while j > 0:
            i, prev, surf = back[j][pos]
            if surf:
                out.append(Morpheme(surf, pos, i))
            j, pos = i, prev
        out.reverse()
        return out

    def tokenize(self, text: str, keep_symbols: bool = False) -> List[str]:
        return [m.surface for m in self.segment(text)
                if keep_symbols or not all(char_class(c) == "symbol" for c in m.surface)]
