"""The port's host tokenizer modules (``nlp/tokenization_plugins.py``,
``japanese.py``, ``korean.py``, ``uima_analyzers.py``) against the JAX
package's: the cases of ``tests/test_nlp_extras.py`` for those modules, each
run through both packages with the tokens, tags, sentences and morphemes
equal (and equal to what that test expects), and a seeded mixed-script
corpus (hangul, kana, kanji, latin, digits, punctuation, spaces) through
every factory and segmenter of both.
"""

import numpy as np
import pytest

import deeplearning4j_tpu.nlp as jn
import deeplearning4j_tpu.nlp.japanese as jja
import deeplearning4j_tpu.nlp.korean as jko
from deeplearning4j_tpu.nlp.tokenization import CommonPreprocessor as JaxCommon

import deeplearning4j_tpu_torch.nlp as pn
import deeplearning4j_tpu_torch.nlp.japanese as pja
import deeplearning4j_tpu_torch.nlp.korean as pko
from deeplearning4j_tpu_torch.nlp.tokenization import CommonPreprocessor as PortCommon

PACKAGES = {"jax": (jn, jja, jko, JaxCommon), "port": (pn, pja, pko, PortCommon)}


def ja_script_runs(nlp, ja, ko, common):
    return nlp.JapaneseTokenizerFactory(script_runs_only=True).create(
        "私はJAXが好きです。").get_tokens()


def ja_morphological(nlp, ja, ko, common):
    tf = nlp.JapaneseTokenizerFactory()
    return [tf.create(s).get_tokens() for s in (
        "すもももももももものうち", "私は学生です", "昨日映画を見ました",
        "コンピュータで日本語を学んでいます", "2024年に東京へ行きます。")]


def ja_segmenter(nlp, ja, ko, common):
    seg = ja.JapaneseSegmenter()
    seg2 = ja.JapaneseSegmenter(extra_entries=[("深層学習", "noun", 2)])
    return ([(m.surface, m.pos, m.start) for m in seg.segment("私は学生です")],
            [m.surface for m in seg2.segment("深層学習を学んでいます")],
            seg.tokenize("私は 学生です"))


def ko_tokenizer(nlp, ja, ko, common):
    tf = nlp.KoreanTokenizerFactory()
    return [tf.create(s).get_tokens() for s in (
        "안녕하세요 JAX 세계!", "세계 최초의 상용 수준 오픈소스 딥러닝 라이브러리입니다")]


def ko_morphology(nlp, ja, ko, common):
    seg = ko.KoreanSegmenter()
    seg2 = ko.KoreanSegmenter(extra_entries=[("텐서플로", "noun", 2)])
    return ([seg.tokenize(s) for s in ("학교에서 친구를 만났다", "고양이가 물을 마셨다",
                                       "책이 있습니다")],
            [(m.surface, m.pos) for w in ("학생입니다", "책이다", "학생이다", "물이다")
             for m in seg.segment(w)],
            ko.has_batchim("책"), ko.has_batchim("과"), ko.decompose("한"),
            ko.compose(*ko.decompose("한")), seg2.tokenize("텐서플로를 씁니다"))


def ko_josa_splitting(nlp, ja, ko, common):
    tf = nlp.KoreanTokenizerFactory(split_josa=True)
    return tf.create("학교에서 친구를 만났다").get_tokens(), tf.create("이").get_tokens()


def uima_sentences(nlp, ja, ko, common):
    text = ("Dr. Smith arrived at 3.14 p.m. yesterday. He met J. K. "
            "Rowling (no relation). Was it planned? Nobody knew!")
    it = nlp.UimaSentenceIterator(["One sentence. Two sentences here.", "Second document!"])
    got = list(it)
    it.reset()
    return nlp.segment_sentences(text), got, it.has_next(), it.next_sentence()


def uima_pos_filter(nlp, ja, ko, common):
    f = nlp.PosUimaTokenizerFactory(allowed_pos_tags=["NN", "VB"])
    stripped = nlp.PosUimaTokenizerFactory(allowed_pos_tags=["NN"], strip_nones=True)
    pre = nlp.PosUimaTokenizerFactory(allowed_pos_tags=["NN"])
    pre.set_token_pre_processor(common())
    custom = nlp.PosUimaTokenizerFactory(allowed_pos_tags=["NN"],
                                         tagger=lambda toks: ["NN"] * len(toks))
    return (f.create("The quick dogs quickly chased the ball").get_tokens(),
            stripped.create("The government of the people").get_tokens(),
            pre.create("The Dog chased the Ball").get_tokens(),
            custom.create("a b c").get_tokens())


def uima_tagger(nlp, ja, ko, common):
    return (nlp.pos_tag("The illumination quickly faded to darkness in 42 ways".split()),
            nlp.pos_tag("a  b".split(" ")),
            nlp.UimaTokenizerFactory().create("Hello world. Bye now.").get_tokens())


# what tests/test_nlp_extras.py expects, where it pins the whole output
EXPECTED = {
    "ja_morphological": lambda got: got[:3] == [
        ["すもも", "も", "もも", "も", "もも", "の", "うち"], ["私", "は", "学生", "です"],
        ["昨日", "映画", "を", "見", "ました"]],
    "ja_segmenter": lambda got: got[0] == [("私", "pronoun", 0), ("は", "particle", 1),
                                           ("学生", "noun", 2), ("です", "aux", 4)],
    "ko_tokenizer": lambda got: got[1] == ["세계", "최초", "의", "상용", "수준", "오픈소스",
                                           "딥", "러닝", "라이브러리", "입니", "다"],
    "ko_morphology": lambda got: got[0][0] == ["학교", "에서", "친구", "를", "만났", "다"],
    "ko_josa_splitting": lambda got: got[1] == ["이"],
    "uima_sentences": lambda got: got[0] == [
        "Dr. Smith arrived at 3.14 p.m. yesterday.", "He met J. K. Rowling (no relation).",
        "Was it planned?", "Nobody knew!"],
    "uima_pos_filter": lambda got: got[1] == ["government", "people"] and got[3] == [
        "a", "b", "c"],
    "uima_tagger": lambda got: got[0] == ["DT", "NN", "RB", "VBD", "TO", "VB", "IN", "CD",
                                          "NNS"] and len(got[1]) == 3,
}

CASES = {f.__name__: f for f in (ja_script_runs, ja_morphological, ja_segmenter, ko_tokenizer,
                                 ko_morphology, ko_josa_splitting, uima_sentences,
                                 uima_pos_filter, uima_tagger)}


@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax(name):
    want = CASES[name](*PACKAGES["jax"])
    got = CASES[name](*PACKAGES["port"])
    assert got == want
    if name in EXPECTED:
        assert EXPECTED[name](got)


def test_bad_tagger_length_raises_as_jax():
    msgs = []
    for nlp, *_ in PACKAGES.values():
        f = nlp.PosUimaTokenizerFactory(allowed_pos_tags=["NN"], tagger=lambda t: ["NN"])
        with pytest.raises(ValueError, match="tagger returned") as e:
            f.create("one two three")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def mixed_corpus(n=120, seed=25):
    """Seeded strings over hangul syllables, hiragana, katakana, kanji,
    latin words, digits, punctuation and spaces."""
    rng = np.random.default_rng(seed)
    pools = [lambda: chr(0xAC00 + int(rng.integers(0, 11172))),
             lambda: chr(0x3041 + int(rng.integers(0, 0x56))),
             lambda: chr(0x30A1 + int(rng.integers(0, 0x5A))),
             lambda: chr(0x4E00 + int(rng.integers(0, 0x5200))),
             lambda: "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 4)),
             lambda: str(int(rng.integers(0, 1000))),
             lambda: "。、.,!?()"[int(rng.integers(0, 8))],
             lambda: " "]
    weights = np.array([4, 2, 1, 1, 2, 1, 1, 2], float)
    return ["".join(pools[int(rng.choice(len(pools), p=weights / weights.sum()))]()
                    for _ in range(int(rng.integers(1, 40)))) for _ in range(n)]


def corpus_outputs(nlp, ja, ko, common, corpus):
    factories = [nlp.JapaneseTokenizerFactory(), nlp.JapaneseTokenizerFactory(
        script_runs_only=True), nlp.KoreanTokenizerFactory(),
        nlp.KoreanTokenizerFactory(split_josa=True), nlp.UimaTokenizerFactory(),
        nlp.PosUimaTokenizerFactory(allowed_pos_tags=["NN", "VB", "CD"])]
    out = [[f.create(s).get_tokens() for s in corpus] for f in factories]
    jseg, kseg = ja.JapaneseSegmenter(), ko.KoreanSegmenter()
    out.append([[(m.surface, m.pos) for m in jseg.segment(s)] for s in corpus])
    out.append([[(m.surface, m.pos) for m in kseg.segment(s)] for s in corpus])
    out.append([nlp.segment_sentences(s) for s in corpus])
    out.append([nlp.pos_tag(s.split()) for s in corpus])
    return out


def test_mixed_script_corpus_matches_jax():
    corpus = mixed_corpus()
    want = corpus_outputs(*PACKAGES["jax"], corpus)
    got = corpus_outputs(*PACKAGES["port"], corpus)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"output {i}"
    kseg = pko.KoreanSegmenter()
    for s in corpus:  # the lattices partition the text, in the port too
        for seg in (kseg, pja.JapaneseSegmenter()):
            assert "".join(seg.tokenize(s, keep_symbols=True)) == s.replace(" ", "")
