"""The PyTorch port's record readers and record iterators against the JAX
package.

Files written to ``tmp_path`` (CSV rows, one CSV file per sequence, ``.npy``
and PNG images under label directories, text lines) and records built from
a seeded numpy draw are read by both packages: every record, every batch's
arrays and masks, and every record's metadata must be equal. Each
sequence alignment (``ALIGN_START``, ``ALIGN_END``, ``EQUAL_LENGTH``) is
covered, with the error ``EQUAL_LENGTH`` raises on sequences of different
lengths.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from deeplearning4j_tpu.datasets import record_iterators as jri  # noqa: E402
from deeplearning4j_tpu.datasets import records as jrec  # noqa: E402

from deeplearning4j_tpu_torch.datasets import record_iterators as pri  # noqa: E402
from deeplearning4j_tpu_torch.datasets import records as prec  # noqa: E402
from test_torch_datasets import assert_same_batches  # noqa: E402


def _records_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def _csv(path, rows):
    path.write_text("\n".join(",".join(str(v) for v in r) for r in rows) + "\n")
    return str(path)


def _iris_like(tmp_path, n=13, seed=0):
    """A CSV of 4 float features, a class index 0-2 and a header line."""
    rng = np.random.default_rng(seed)
    rows = [[f"{v:.3f}" for v in rng.normal(size=4)] + [int(rng.integers(0, 3))]
            for _ in range(n)]
    return _csv(tmp_path / "data.csv", [["a", "b", "c", "d", "label"]] + rows)


# ------------------------------------------------------------------ readers
def test_csv_reader_coerces_skips_and_splits_as_jax(tmp_path):
    path = _csv(tmp_path / "mixed.csv", [["x", "y", "name"], [1, 2.5, " ann "], [],
                                         [3, -4e-3, "bob"]])
    for kw in ({}, {"skip_lines": 1}):
        _records_equal(prec.CSVRecordReader(path, **kw), jrec.CSVRecordReader(path, **kw))
    semi = tmp_path / "semi.csv"
    semi.write_text("1;2;3\n4;5;six\n")
    _records_equal(prec.CSVRecordReader(str(semi), delimiter=";"),
                   jrec.CSVRecordReader(str(semi), delimiter=";"))
    assert list(prec.CSVRecordReader(str(semi), delimiter=";"))[1] == [4.0, 5.0, "six"]


def test_line_and_collection_readers_match_jax(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("first line\n\nthird, with a comma\n")
    _records_equal(prec.LineRecordReader(str(p)), jrec.LineRecordReader(str(p)))
    recs = [[1.0, 2.0], ["a", 3]]
    _records_equal(prec.CollectionRecordReader(recs), jrec.CollectionRecordReader(recs))
    seqs = [[[1, 2], [3, 4]], [[5, 6]]]
    _records_equal(prec.CollectionSequenceRecordReader(seqs),
                   jrec.CollectionSequenceRecordReader(seqs))


def test_metadata_names_each_record_and_reloads_it(tmp_path):
    path = _iris_like(tmp_path)
    p, j = prec.CSVRecordReader(path, skip_lines=1), jrec.CSVRecordReader(path, skip_lines=1)
    pm = list(p.iter_with_metadata())
    jm = list(j.iter_with_metadata())
    assert [(r, m.index, m.source) for r, m in pm] == [(r, m.index, m.source) for r, m in jm]
    assert pm[0][1].source == path and repr(pm[2][1]) == repr(jm[2][1])
    assert pm[4][1].load() == pm[4][0]
    assert p.load_from_metadata([pm[7][1], pm[1][1]]) == [pm[7][0], pm[1][0]]
    assert pm[3][1] == prec.RecordMetaData(3, path) and len({pm[3][1], pm[3][1]}) == 1
    with pytest.raises(KeyError, match="not found"):
        p.load_from_metadata([prec.RecordMetaData(99, path)])
    with pytest.raises(ValueError, match="no reader"):
        prec.RecordMetaData(0, "x").load()
    coll = prec.CollectionRecordReader([[1], [2]])
    assert [m.source for _, m in coll.iter_with_metadata()] == ["CollectionRecordReader"] * 2
    assert coll.labels is None


def _sequence_files(tmp_path, lengths, width=3, seed=1, name="seq"):
    rng = np.random.default_rng(seed)
    d = tmp_path / name
    d.mkdir()
    for k, t in enumerate(lengths):
        rows = [[f"{v:.4f}" for v in rng.normal(size=width - 1)] + [int(rng.integers(0, 4))]
                for _ in range(t)]
        _csv(d / f"{k:03d}.csv", rows)
    (d / ".hidden").write_text("not a sequence")
    return str(d)


def test_csv_sequence_reader_reads_a_directory_or_a_list(tmp_path):
    d = _sequence_files(tmp_path, [3, 5, 2])
    _records_equal(prec.CSVSequenceRecordReader(d), jrec.CSVSequenceRecordReader(d))
    r = prec.CSVSequenceRecordReader(d)
    assert [len(s) for s in r] == [3, 5, 2]
    paths = list(reversed(r.paths))
    _records_equal(prec.CSVSequenceRecordReader(paths), jrec.CSVSequenceRecordReader(paths))


def _image_tree(tmp_path, fmt):
    rng = np.random.default_rng(2)
    for label in ("cat", "dog"):
        (tmp_path / label).mkdir()
        for k in range(3):
            img = rng.integers(0, 256, (5, 4, 3)).astype(np.uint8)
            if fmt == "npy":
                np.save(tmp_path / label / f"{k}.npy", img.astype(np.float32))
            else:
                from PIL import Image

                Image.fromarray(img).save(tmp_path / label / f"{k}.png")
    return str(tmp_path)


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_image_reader_matches_jax(tmp_path, fmt):
    if fmt == "png":
        pytest.importorskip("PIL")
    root = _image_tree(tmp_path, fmt)
    p, j = prec.ImageRecordReader(5, 4, 3, root=root), jrec.ImageRecordReader(5, 4, 3, root=root)
    assert p.labels == j.labels == ["cat", "dog"]
    _records_equal(p, j)
    assert list(p)[4][-1] == 1.0 and list(p)[0].shape == (61,)
    paths = [f"{root}/dog/0.{fmt}"]
    _records_equal(prec.ImageRecordReader(5, 4, 3, paths=paths),
                   jrec.ImageRecordReader(5, 4, 3, paths=paths))
    _records_equal(prec.ImageRecordReader(5, 4, 3, root=root, append_label=False),
                   jrec.ImageRecordReader(5, 4, 3, root=root, append_label=False))
    if fmt == "npy":  # PIL resizes a decoded image; an array must fit as it is
        with pytest.raises(ValueError, match="shape"):
            list(prec.ImageRecordReader(4, 4, 3, root=root))
    with pytest.raises(ValueError, match="root= or paths="):
        prec.ImageRecordReader(5, 4, 3)


# ---------------------------------------------------------- record iterators
@pytest.mark.parametrize("kw", [{"label_index": 4, "num_classes": 3},
                                {"label_index": 4, "num_classes": 3, "collect_metadata": True},
                                {"label_index": 1, "label_index_to": 2},
                                {"label_index": 0, "regression": True},
                                {}])
def test_record_reader_iterator_matches_jax(tmp_path, kw):
    path = _iris_like(tmp_path)
    p = pri.RecordReaderDataSetIterator(prec.CSVRecordReader(path, skip_lines=1), 5, **kw)
    j = jri.RecordReaderDataSetIterator(jrec.CSVRecordReader(path, skip_lines=1), 5, **kw)
    assert p.batch_size() == 5
    got = list(p)
    assert [g.num_examples() for g in got] == [5, 5, 3]
    assert_same_batches(got, j)
    p.reset()
    assert_same_batches(p, j)
    if kw.get("collect_metadata"):
        assert [m.index for m in got[1].example_metadata] == [5, 6, 7, 8, 9]


def test_record_reader_iterator_takes_image_records(tmp_path):
    root = _image_tree(tmp_path, "npy")
    kw = {"label_index": 60, "num_classes": 2, "collect_metadata": True}
    assert_same_batches(
        pri.RecordReaderDataSetIterator(prec.ImageRecordReader(5, 4, 3, root=root), 4, **kw),
        jri.RecordReaderDataSetIterator(jrec.ImageRecordReader(5, 4, 3, root=root), 4, **kw))


SEQ_LENGTHS = [4, 7, 2, 7, 5]


@pytest.mark.parametrize("kw", [{"label_index": 2, "num_classes": 4},
                                {"label_index": 2, "regression": True},
                                {}])
def test_sequence_iterator_one_reader_matches_jax(tmp_path, kw):
    """Each step split at ``label_index``; sequences of 4, 7, 2, 7, 5 steps
    in batches of 2 padded to the longest with masks."""
    d = _sequence_files(tmp_path, SEQ_LENGTHS)
    p = pri.SequenceRecordReaderDataSetIterator(prec.CSVSequenceRecordReader(d), 2, **kw)
    j = jri.SequenceRecordReaderDataSetIterator(jrec.CSVSequenceRecordReader(d), 2, **kw)
    got = list(p)
    assert [g.features.shape[:2] for g in got] == [(2, 7), (2, 7), (1, 5)]
    assert got[2].features_mask is None  # one full-length sequence needs no mask
    np.testing.assert_array_equal(got[0].features_mask.sum(1), [4, 7])
    assert_same_batches(got, j)
    p.reset()
    assert_same_batches(p, j)


@pytest.mark.parametrize("alignment", ["align_start", "align_end", "equal_length"])
@pytest.mark.parametrize("one_hot", [True, False])
def test_sequence_iterator_two_readers_align_as_jax(tmp_path, alignment, one_hot):
    """Features of 4, 7, 2, 7, 5 steps; labels of the same lengths
    (``EQUAL_LENGTH``) or one step each (many-to-one, start or end)."""
    d = _sequence_files(tmp_path, SEQ_LENGTHS, name="f")
    equal = alignment == "equal_length"
    lab = _sequence_files(tmp_path, SEQ_LENGTHS if equal else [1] * 5, width=1, seed=2,
                          name="l")
    kw = {"alignment": alignment, "num_classes": 4 if one_hot else None}

    def make(mod, rmod):
        return mod.SequenceRecordReaderDataSetIterator(
            rmod.CSVSequenceRecordReader(d), 3, labels_reader=rmod.CSVSequenceRecordReader(lab),
            **kw)

    got = list(make(pri, prec))
    assert_same_batches(got, make(jri, jrec))
    assert got[0].labels.shape[-1] == (4 if one_hot else 1)
    if not equal:
        steps = got[0].labels_mask.argmax(1)
        want = [0, 0, 0] if alignment == "align_start" else [6, 6, 6]
        np.testing.assert_array_equal(steps, want)
        assert pri.ALIGN_START == jri.ALIGN_START and pri.ALIGN_END == jri.ALIGN_END


def test_equal_length_raises_on_different_lengths_as_jax(tmp_path):
    d = _sequence_files(tmp_path, SEQ_LENGTHS, name="f")
    lab = _sequence_files(tmp_path, [4, 6, 2, 7, 5], width=1, name="l")
    for mod, rmod in ((pri, prec), (jri, jrec)):
        it = mod.SequenceRecordReaderDataSetIterator(
            rmod.CSVSequenceRecordReader(d), 2, labels_reader=rmod.CSVSequenceRecordReader(lab),
            alignment=mod.EQUAL_LENGTH)
        with pytest.raises(ValueError, match="EQUAL_LENGTH alignment but lengths differ"):
            list(it)


def test_multi_reader_iterator_matches_jax(tmp_path):
    a = _iris_like(tmp_path, n=9, seed=3)
    rng = np.random.default_rng(4)
    recs = [[float(v) for v in rng.normal(size=3)] + [int(rng.integers(0, 5))]
            for _ in range(9)]

    def make(mod, rmod):
        return (mod.RecordReaderMultiDataSetIterator(4)
                .add_reader("csv", rmod.CSVRecordReader(a, skip_lines=1))
                .add_reader("mem", rmod.CollectionRecordReader(recs))
                .add_input("csv", 0, 3).add_input("mem", 0, 2).add_input("mem")
                .add_output_one_hot("csv", 4, 3).add_output("mem", 3))

    p = make(pri, prec)
    assert p.batch_size() == 4
    got = list(p)
    assert [g.num_examples() for g in got] == [4, 4, 1]
    assert [f.shape[1] for f in got[0].features] == [4, 3, 4]
    assert_same_batches(got, make(jri, jrec))
    p.reset()
    assert_same_batches(p, make(jri, jrec))
