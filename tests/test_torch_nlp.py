"""The port's NLP stack (``deeplearning4j_tpu_torch/nlp``) against the JAX
package's on the same numpy inputs, on ``device="cpu"``.

The host tier is a copy: tokens, sentences, vocab, Huffman codes and
points (ties included), ``syn0``'s draw, the negative table and
``sample_negatives`` equal JAX's exactly, as do the vectorizers' and the
sentence iterators' arrays. The engine keeps JAX's host side call for call,
so both packages train on the same stream of examples, and the generator's
state after ``fit`` is the same. The tables after ``fit`` are held at
``TABLE_REL`` of each table's largest element: the device steps compute the
same function with the products and sums in another order (read here: 3e-7
and less). The C text and binary files are byte-equal for the same tables,
and the zip's ``config.json`` and ``vocab.json`` too (``tables.npz`` holds
equal arrays; a zip's bytes carry the time it was written).
"""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
import deeplearning4j_tpu.nlp as jn  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
import deeplearning4j_tpu_torch.nlp as pn  # noqa: E402

PORT = Path(pn.__file__).resolve().parents[1]
TABLE_REL = 2e-6
LOSS_RTOL = 1e-5  # the LSTM classifier's losses (f32, JAX with x64 off)
PARAM_REL = 1e-5

WORDS = [f"w{i}" for i in range(40)]


def corpus(n=60, length=12, seed=0):
    """Sentences of Zipf-ish words with three repeated labels."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    sents = [[WORDS[i] for i in rng.choice(len(WORDS), length, p=p / p.sum())]
             for _ in range(n)]
    return sents, [[f"L{i % 3}"] for i in range(n)]


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def assert_tables_close(pm, jm):
    for name in ("syn0", "syn1", "syn1neg"):
        want = getattr(jm.lookup, name)
        got = getattr(pm.lookup, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert got.dtype == np.float32, name
            assert rel(got, want) <= TABLE_REL, (name, rel(got, want))


# ---------------------------------------------------------------- host tier
def test_tokens_sentences_and_vectorizers_equal_jaxs(tmp_path):
    text = "The quick brown fox's jumping, (hopelessly) over 3.14 walls; running quickly!"
    for make in (lambda m: m.DefaultTokenizerFactory(),
                 lambda m: m.NGramTokenizerFactory(1, 3)):
        for pre in (None, "CommonPreprocessor", "EndingPreProcessor", "StemmingPreprocessor"):
            toks = []
            for m in (jn, pn):
                f = make(m)
                if pre:
                    f.set_token_pre_processor(getattr(m, pre)())
                toks.append(f.create(text).get_tokens())
            assert toks[0] == toks[1], pre
    assert pn.STOP_WORDS == jn.STOP_WORDS
    words = ["caresses", "ponies", "relational", "hopefully", "generalization"]
    assert ([pn.PorterStemmer().stem(w) for w in words]
            == [jn.PorterStemmer().stem(w) for w in words])
    path = tmp_path / "lines.txt"
    path.write_text("one line\nsecond line here\n\nlast")
    assert list(pn.BasicLineIterator(str(path))) == list(jn.BasicLineIterator(str(path)))
    assert (list(pn.CollectionSentenceIterator(["a b", "c"]))
            == list(jn.CollectionSentenceIterator(["a b", "c"])))
    docs = ["the cat sat on the mat", "the dog sat on the log", "cats and dogs are animals"]
    for name, kw in (("BagOfWordsVectorizer", {"stop_words": jn.STOP_WORDS}),
                     ("TfidfVectorizer", {})):
        got = getattr(pn, name)(**kw).fit(docs)
        want = getattr(jn, name)(**kw).fit(docs)
        assert got.vocab == want.vocab
        np.testing.assert_array_equal(got.transform(docs), want.transform(docs))
    ji, pi = jn.InvertedIndex(), pn.InvertedIndex()
    for d in docs:
        assert pi.add_document(d) == ji.add_document(d)
    assert pi.search("sat", "dog") == ji.search("sat", "dog")
    assert pi.positions("the", 0) == ji.positions("the", 0)
    assert pn.windows(docs[0].split(), 5) == jn.windows(docs[0].split(), 5)


def test_vocab_huffman_lookup_and_negatives_equal_jaxs():
    # counts with ties: the heap's tiebreak decides codes and points
    sents = [["a"] * 4 + ["b"] * 4 + ["c"] * 2 + ["d"] * 2 + ["e", "f", "g"]] * 3
    caches = [m.VocabConstructor(1).build_vocab(sents) for m in (jn, pn)]
    for c in caches:
        (jn if c is caches[0] else pn).Huffman(c.vocab_words()).build()
    assert ([(w.word, w.count, w.index, w.codes, w.points) for w in caches[1].vocab_words()]
            == [(w.word, w.count, w.index, w.codes, w.points) for w in caches[0].vocab_words()])
    tables = [m.InMemoryLookupTable(c, 7, seed=3, negative=2)
              for m, c in zip((jn, pn), caches)]
    np.testing.assert_array_equal(tables[1].syn0, tables[0].syn0)
    np.testing.assert_array_equal(tables[1].make_negative_table(1000),
                                  tables[0].make_negative_table(1000))
    draws = [t.sample_negatives(np.random.default_rng(5), (6, 3)) for t in tables]
    np.testing.assert_array_equal(draws[1], draws[0])
    assert tables[1].words_nearest("a", 3) == tables[0].words_nearest("a", 3)
    assert tables[1].similarity("a", "c") == tables[0].similarity("a", "c")


# ---------------------------------------------------------------- the engine
CONFIGS = {
    "skipgram_hs": dict(use_hs=True, negative=0),
    "skipgram_neg": dict(use_hs=False, negative=3),
    "skipgram_both": dict(use_hs=True, negative=3),
    "cbow": dict(use_hs=True, negative=2, elements_algo="cbow"),
    "dbow": dict(use_hs=True, negative=2, elements_algo="none", sequence_algo="dbow",
                 train_elements=False),
    "dm": dict(use_hs=True, negative=2, elements_algo="none", sequence_algo="dm",
               train_elements=False),
    "subsampling": dict(use_hs=True, negative=2, subsampling=1e-2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sequence_vectors_tables_follow_jax(name):
    """Two epochs, batches of 64 with a partial last one: every table at
    TABLE_REL and the generator's next draw equal (the same draws)."""
    sents, labels = corpus()
    kw = dict(layer_size=16, window=3, batch_size=64, epochs=2, seed=7, **CONFIGS[name])
    jm = jn.SequenceVectors(**kw).fit([jn.Sequence(s, l) for s, l in zip(sents, labels)])
    pm = pn.SequenceVectors(device="cpu", **kw).fit(
        [pn.Sequence(s, l) for s, l in zip(sents, labels)])
    assert pm.vocab.words() == jm.vocab.words()
    assert_tables_close(pm, jm)
    assert pm._rng.random() == jm._rng.random()


def test_word2vec_sentences_stop_words_and_queries_follow_jax():
    sents = [" ".join(s) for s in corpus(seed=1)[0]]
    kw = dict(layer_size=12, window=2, negative=2, batch_size=32, seed=3,
              stop_words=["w0"])
    jm = jn.Word2Vec(**kw).fit_sentences(jn.CollectionSentenceIterator(sents))
    pm = pn.Word2Vec(device="cpu", **kw).fit_sentences(pn.CollectionSentenceIterator(sents))
    assert not pm.has_word("w0") and pm.vocab.words() == jm.vocab.words()
    assert_tables_close(pm, jm)
    assert pm.words_nearest("w1", 5) == jm.words_nearest("w1", 5)


def test_glove_follows_jax():
    """GloVe's w + w̃ after 3 epochs. JAX runs with x64 off, its default: the
    tests' global x64 would take its step into float64 wherever an input is
    float64."""
    sents = corpus(n=40, length=10, seed=2)[0]
    kw = dict(layer_size=10, window=4, epochs=3, batch_size=50, seed=4)
    with jax.enable_x64(False):
        jm = jn.Glove(**kw).fit(sents)
    pm = pn.Glove(device="cpu", **kw).fit(sents)
    assert pm.vocab.words() == jm.vocab.words()
    assert pm.lookup.syn0.dtype == np.float32
    assert rel(pm.lookup.syn0, jm.lookup.syn0) <= TABLE_REL
    co = [m.AbstractCoOccurrences(c, 4).fit([m.Sequence(s) for s in sents]).as_arrays()
          for m, c in ((jn, jm.vocab), (pn, pm.vocab))]
    for a, b in zip(*co):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo,hs", [("dbow", True), ("dm", False)])
def test_paragraph_vectors_and_infer_vector_follow_jax(algo, hs):
    sents, labels = corpus(n=30, seed=3)
    docs = [(" ".join(s), l) for s, l in zip(sents, labels)]
    kw = dict(sequence_algo=algo, layer_size=12, window=2, batch_size=64, seed=9,
              use_hs=hs, negative=0 if hs else 3)
    jm = jn.ParagraphVectors(**kw).fit_documents([jn.LabelledDocument(t, l) for t, l in docs])
    pm = pn.ParagraphVectors(device="cpu", **kw).fit_documents(
        [pn.LabelledDocument(t, l) for t, l in docs])
    assert_tables_close(pm, jm)
    # the same frozen tables on both sides: infer_vector's 30 steps alone
    pm.lookup = jm.lookup
    for text in (docs[0][0], "w1 w2 w3 w1", "unseen words only"):
        want = jm.infer_vector(text)
        assert np.abs(pm.infer_vector(text) - want).max() <= TABLE_REL * np.abs(want).max()
    assert pm.predict(docs[1][0]) == jm.predict(docs[1][0])


def test_distributed_word2vec_follows_jax():
    sents = corpus(n=40, seed=4)[0]
    kw = dict(workers=3, layer_size=12, window=2, negative=2, batch_size=32, seed=5, epochs=2)
    jm = jn.DistributedWord2Vec(**kw).fit(sents)
    pm = pn.DistributedWord2Vec(device="cpu", **kw).fit(sents)
    assert_tables_close(pm, jm)


# ---------------------------------------------------------------- formats
def test_formats_both_ways_between_the_packages(tmp_path):
    """A JAX-trained model's tables written by each package: the C text and
    binary files byte-equal, the zip's members equal; each package reads the
    other's; a JAX zip restored into the port trains on as JAX's does."""
    sents, _ = corpus(n=30, seed=6)
    jm = jn.Word2Vec(layer_size=8, window=2, negative=2, batch_size=32, seed=1).fit(sents)
    pm = pn.Word2Vec(device="cpu", layer_size=8, window=2, negative=2, batch_size=32, seed=1)
    pm.vocab, pm.lookup = jm.vocab, jm.lookup
    for ext, writer in (("txt", "write_word_vectors"), ("bin", "write_binary_model")):
        a, b = tmp_path / f"jax.{ext}", tmp_path / f"port.{ext}"
        getattr(jn, writer)(jm.lookup, str(a))
        getattr(pn, writer)(jm.lookup, str(b))
        assert a.read_bytes() == b.read_bytes(), ext
    for reader, ext, exact in (("load_txt_vectors", "txt", False),
                               ("read_binary_model", "bin", True)):
        for src in ("jax", "port"):
            got = getattr(pn, reader)(str(tmp_path / f"{src}.{ext}"))
            want = getattr(jn, reader)(str(tmp_path / f"{src}.{ext}"))
            assert got.vocab.words() == want.vocab.words()
            np.testing.assert_array_equal(got.syn0, want.syn0)
            if exact:
                np.testing.assert_array_equal(got.syn0, jm.lookup.syn0)
            else:
                assert np.abs(got.syn0 - jm.lookup.syn0).max() <= 5e-7 + 1e-8
    zj, zp = tmp_path / "jax.zip", tmp_path / "port.zip"
    jn.write_sequence_vectors(jm, str(zj))
    pn.write_sequence_vectors(pm, str(zp))
    with zipfile.ZipFile(zj) as a, zipfile.ZipFile(zp) as b:
        assert a.namelist() == b.namelist()
        for member in ("config.json", "vocab.json"):
            assert a.read(member) == b.read(member), member
        assert json.loads(b.read("config.json"))["class"] == "Word2Vec"
    restored = {"port": pn.read_sequence_vectors(str(zj), device="cpu"),
                "jax": jn.read_sequence_vectors(str(zp))}
    for name in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_array_equal(getattr(restored["port"].lookup, name),
                                      getattr(jm.lookup, name))
        np.testing.assert_array_equal(getattr(restored["jax"].lookup, name),
                                      getattr(jm.lookup, name))
    more = sents[:10]
    jback = jn.read_sequence_vectors(str(zj))
    assert_tables_close(restored["port"].fit(more), jback.fit(more))


# ---------------------------------------------------------------- iterators
def _vectors(tmp_path):
    """One lookup table read by both packages from one C text file."""
    sents, _ = corpus(n=30, seed=8)
    jm = jn.Word2Vec(layer_size=6, window=2, batch_size=32, seed=2).fit(sents)
    path = str(tmp_path / "v.txt")
    jn.write_word_vectors(jm.lookup, path)
    return jn.load_txt_vectors(path), pn.load_txt_vectors(path)


def _reviews(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = [WORDS[k] for k in rng.integers(0, len(WORDS), rng.integers(1, 12))]
        if i % 5 == 0:
            toks.append("oov_word")
        out.append((" ".join(toks), ("neg", "pos")[i % 2]))
    out.append(("only unknown words", "pos"))  # an all-OOV review: no label step
    return out


@pytest.mark.parametrize("kind", ["cnn", "rnn", "word2vec"])
def test_sentence_iterators_arrays_equal_jaxs(tmp_path, kind):
    jv, pv = _vectors(tmp_path)
    data = _reviews(11, seed=1)
    if kind == "word2vec":
        its = [m.Word2VecDataSetIterator(data, v, batch=4, max_length=8)
               for m, v in ((jn, jv), (pn, pv))]
    else:
        its = [m.CnnSentenceDataSetIterator(data, v, batch=4, max_length=8, format=kind)
               for m, v in ((jn, jv), (pn, pv))]
    got, want = list(its[1]), list(its[0])
    assert len(got) == len(want) == 3
    assert its[1].labels == its[0].labels
    for g, w in zip(got, want):
        assert isinstance(g, pt.DataSet)
        for field in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if b is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)


def test_word2vec_fed_lstm_classifier_follows_jax(tmp_path):
    """Word2VecDataSetIterator into GravesLSTM -> RnnOutputLayer (softmax,
    MCXENT), Adam with ClipElementWiseAbsoluteValue and l2: three updates'
    losses and the params after them. JAX runs with x64 off (Adam)."""
    jv, pv = _vectors(tmp_path)
    data = _reviews(11, seed=2)
    layers = [dj.GravesLSTM(n_in=6, n_out=8, activation="tanh", l2=1e-5),
              dj.RnnOutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent", l2=1e-5)]
    conf = dj.MultiLayerConfiguration(
        layers=layers, input_type=dj.InputType.recurrent(6),
        updater=dj.UpdaterConfig(updater="adam", learning_rate=2e-2,
                                 gradient_normalization="ClipElementWiseAbsoluteValue",
                                 gradient_normalization_threshold=1.0), seed=3)
    jnet = dj.MultiLayerNetwork(conf).init()
    jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jnet.params),
              force=True)
    pnet = pt.load_jax_params(
        pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(conf.to_json()),
                             device="cpu"),
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    jl, pl = [], []
    batches = zip(jn.Word2VecDataSetIterator(data, jv, batch=4, max_length=8),
                  pn.Word2VecDataSetIterator(data, pv, batch=4, max_length=8))
    for jb, pb in batches:
        with jax.enable_x64(False):
            jnet.fit(JaxDataSet(jb.features, jb.labels, jb.features_mask, jb.labels_mask))
        jl.append(float(jnet.score()))
        pnet.fit(pb)
        pl.append(pnet.score())
    assert len(pl) == 3
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for mine, theirs in zip(pt.params_to_numpy(pnet), jnet.params):
        for k in theirs:
            assert rel(mine[k], np.asarray(theirs[k], np.float32)) <= PARAM_REL, k


# ---------------------------------------------------------------- the package
@pytest.mark.parametrize("make", [
    lambda: pn.SequenceVectors(), lambda: pn.Word2Vec(), lambda: pn.ParagraphVectors(),
    lambda: pn.Glove(), lambda: pn.DistributedWord2Vec()],
    ids=["SequenceVectors", "Word2Vec", "ParagraphVectors", "Glove", "DistributedWord2Vec"])
def test_default_device_is_the_card(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_nlp_and_graph_modules_are_scanned_and_load_without_jax():
    """The no-JAX scan (``tests/test_torch_lstm_seq.py``) covers every new
    module; importing both packages loads neither JAX nor the JAX package."""
    scanned = set(PORT.rglob("*.py"))
    names = ["tokenization", "stopwords", "stemming", "sentence_iterator", "vocab", "lookup",
             "sequence_vectors", "word2vec", "paragraph_vectors", "glove", "distributed",
             "serialization", "vectorizers", "model_iterators", "__init__"]
    for n in names:
        assert PORT / "nlp" / f"{n}.py" in scanned, n
    for n in ("graph", "walks", "loader", "deepwalk", "__init__"):
        assert PORT / "graph_embeddings" / f"{n}.py" in scanned, n
    code = ("import sys; import deeplearning4j_tpu_torch.nlp, "
            "deeplearning4j_tpu_torch.graph_embeddings; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
