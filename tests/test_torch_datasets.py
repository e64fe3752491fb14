"""The PyTorch port's datasets tier against the JAX package: the
``DataSetIterator`` family, normalizers, ``.npz`` export, the fetchers
and the bundled corpora.

The same numpy arrays (drawn from a seed) or the same files (written to
``tmp_path``) go through both packages; every batch's arrays, masks and
metadata must be equal. Normalizer statistics are held at 1e-6 relative
(they are the same float64 operations, so they agree exactly here). The
digits and Iris arrays must equal scikit-learn's bit for bit, and a
tampered bundled file must raise. ``fetch_mnist`` is held on a local
``file://`` mirror, as the JAX package's test does.
"""

import gzip
import hashlib
import os
import shutil
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from deeplearning4j_tpu.datasets import export as jexport  # noqa: E402
from deeplearning4j_tpu.datasets import fetchers as jfetch  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.datasets import normalizers as jnorm  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets import export as pexport  # noqa: E402
from deeplearning4j_tpu_torch.datasets import fetchers as pfetch  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as pit  # noqa: E402
from deeplearning4j_tpu_torch.datasets import normalizers as pnorm  # noqa: E402

REL = 1e-6


def _meta_key(m):
    return None if m is None else (m.index, m.source) if hasattr(m, "source") else m


def assert_same_batch(got, want):
    """Two DataSets or MultiDataSets (of either package) hold equal arrays,
    masks and metadata."""
    assert type(got).__name__ == type(want).__name__
    fields = (("features", "labels", "features_masks", "labels_masks")
              if type(want).__name__ == "MultiDataSet"
              else ("features", "labels", "features_mask", "labels_mask"))
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b), f
            for x, y in zip(a, b):
                assert (x is None) == (y is None), f
                if y is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert (a is None) == (b is None), f
            if b is not None:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    gm, wm = got.example_metadata, want.example_metadata
    assert (gm is None) == (wm is None)
    if wm is not None:
        assert [_meta_key(m) for m in gm] == [_meta_key(m) for m in wm]


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert_same_batch(a, b)


def _arrays(seed, n=23, f=5, c=3, t=None):
    rng = np.random.default_rng(seed)
    shape = (n, f) if t is None else (n, t, f)
    x = rng.normal(size=shape).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n if t is None else (n, t))]
    return x, y


def _dataset(pkg, seed, masks=False, meta=False, n=23):
    x, y = _arrays(seed, n=n, t=4 if masks else None)
    rng = np.random.default_rng(seed + 1)
    fm = (rng.random((n, 4)) > 0.3).astype(np.float32) if masks else None
    lm = (rng.random((n, 4)) > 0.3).astype(np.float32) if masks else None
    md = [f"record-{i}" for i in range(n)] if meta else None
    return pkg.DataSet(x, y, fm, lm, md)


# ---------------------------------------------------------------- DataSet
@pytest.mark.parametrize("masks,meta", [(False, False), (True, True), (False, True)])
def test_dataset_split_and_shuffle_match_jax(masks, meta):
    jd, pd = _dataset(jit_, 3, masks, meta), _dataset(pit, 3, masks, meta)
    for a, b in zip(pd.split_test_and_train(9), jd.split_test_and_train(9)):
        assert_same_batch(a, b)
    assert_same_batch(pd.shuffle(seed=11), jd.shuffle(seed=11))
    assert pd.split_test_and_train(9)[0].num_examples() == 9


def test_multidataset_carries_metadata_and_as_multi_keeps_it():
    pd = _dataset(pit, 4, masks=True, meta=True)
    m = pit.as_multi(pd)
    assert m.example_metadata == pd.example_metadata
    assert m.features_masks[0] is pd.features_mask
    assert pit.MultiDataSet([pd.features], [pd.labels], example_metadata=["a"]) \
        .example_metadata == ["a"]


# --------------------------------------------------------------- iterators
def test_every_iterator_is_a_dataset_iterator_with_jax_names():
    names = ("ListDataSetIterator", "NumpyDataSetIterator", "ExistingDataSetIterator",
             "MultipleEpochsIterator", "SamplingDataSetIterator", "IteratorDataSetIterator",
             "ReconstructionDataSetIterator", "IteratorMultiDataSetIterator",
             "BucketingSequenceIterator")
    for n in names:
        assert issubclass(getattr(pit, n), pit.DataSetIterator), n
        assert getattr(pit, n).prefetch_supported is getattr(jit_, n).prefetch_supported
    base = pit.DataSetIterator()
    base.reset()
    with pytest.raises(NotImplementedError):
        iter(base)
    with pytest.raises(NotImplementedError):
        base.batch_size()


def test_as_iterator_wraps_single_batches_in_a_list_iterator():
    x, y = _arrays(0)
    for pkg, ds in ((pit, pit.DataSet(x, y)), (pit, (x, y))):
        it = pkg.as_iterator(ds)
        assert isinstance(it, pit.ListDataSetIterator) and len(it) == 1
        assert it.batch_size() == 23
    gen = iter([pit.DataSet(x, y)])
    assert pit.as_iterator(gen) is gen
    assert_same_batches(pit.as_iterator((x, y)), jit_.as_iterator((x, y)))


def test_list_and_existing_iterators_match_jax():
    dss = {pkg: [_dataset(pkg, s, masks=True, meta=True) for s in range(3)]
           for pkg in (pit, jit_)}
    pl, jl = pit.ListDataSetIterator(dss[pit]), jit_.ListDataSetIterator(dss[jit_])
    assert len(pl) == len(jl) == 3 and pl.batch_size() == jl.batch_size()
    assert_same_batches(pl, jl)
    assert pit.ListDataSetIterator([]).batch_size() == 0
    pe, je = pit.ExistingDataSetIterator(dss[pit]), jit_.ExistingDataSetIterator(dss[jit_])
    assert pe.batch_size() == je.batch_size() == 0
    assert_same_batches(pe, je)


@pytest.mark.parametrize("shuffle", [False, True])
def test_multiple_epochs_iterator_replays_with_reset(shuffle):
    x, y = _arrays(1, n=20)
    p = pit.MultipleEpochsIterator(3, pit.NumpyDataSetIterator(x, y, 6, shuffle=shuffle,
                                                               seed=2))
    j = jit_.MultipleEpochsIterator(3, jit_.NumpyDataSetIterator(x, y, 6, shuffle=shuffle,
                                                                 seed=2))
    assert p.batch_size() == j.batch_size() == 6
    got = list(p)
    assert len(got) == 9
    assert_same_batches(got, j)
    assert_same_batches(p, j)  # a second pass draws the next epochs' orders, as JAX


def test_sampling_iterator_draws_jax_rows():
    x, y = _arrays(2, n=17)
    p = pit.SamplingDataSetIterator(pit.DataSet(x, y), batch=5, total_batches=4, seed=9)
    j = jit_.SamplingDataSetIterator(jit_.DataSet(x, y), batch=5, total_batches=4, seed=9)
    assert p.batch_size() == 5
    assert_same_batches(p, j)
    assert_same_batches(p, p)  # the same draws on every pass


@pytest.mark.parametrize("with_meta", ["all", "some", "none"])
def test_iterator_dataset_iterator_rebatches_single_examples(with_meta):
    x, y = _arrays(3, n=11)

    def examples(pkg):
        for i in range(11):
            meta = ([f"m{i}"] if with_meta == "all" or (with_meta == "some" and i % 2)
                    else None)
            yield pkg.DataSet(x[i], y[i], example_metadata=meta)

    p = pit.IteratorDataSetIterator(examples(pit), 4)
    assert p.batch_size() == 4
    got = list(p)
    assert [g.num_examples() for g in got] == [4, 4]  # the short tail is left out
    assert_same_batches(got, jit_.IteratorDataSetIterator(examples(jit_), 4))


def test_reconstruction_iterator_matches_jax():
    dss = {pkg: [_dataset(pkg, s, masks=True, meta=True) for s in range(2)]
           for pkg in (pit, jit_)}
    p = pit.ReconstructionDataSetIterator(pit.ListDataSetIterator(dss[pit]))
    j = jit_.ReconstructionDataSetIterator(jit_.ListDataSetIterator(dss[jit_]))
    p.reset()
    assert p.batch_size() == 23
    got = list(p)
    assert_same_batches(got, j)
    np.testing.assert_array_equal(got[0].labels, dss[pit][0].features)
    np.testing.assert_array_equal(got[0].labels_mask, dss[pit][0].features_mask)


def _multi(pkg, seed, n, masked, meta):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 2)).astype(np.float32)
    b = rng.normal(size=(n, 4)).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return pkg.MultiDataSet(
        [a, b], [lab],
        features_masks=[(rng.random((n, 3)) > 0.4).astype(np.float32), None] if masked
        else None,
        labels_masks=None,
        example_metadata=[f"s{seed}-{i}" for i in range(n)] if meta else None)


@pytest.mark.parametrize("batch", [1, 4, 7, 40])
def test_iterator_multidataset_iterator_splits_and_merges_as_jax(batch):
    """Sources of 3, 5, 2 and 6 rows, masked and not, with and without
    metadata, re-batched to ``batch`` rows: overflows split, unmasked
    members merged as ones."""
    spec = [(0, 3, True, True), (1, 5, False, False), (2, 2, True, False), (3, 6, False, True)]

    def src(pkg):
        return [_multi(pkg, *s) for s in spec]

    p = pit.IteratorMultiDataSetIterator(src(pit), batch)
    assert p.batch_size() == batch
    got = list(p)
    assert sum(g.num_examples() for g in got) == 16
    assert all(g.num_examples() == batch for g in got[:-1])
    assert_same_batches(got, jit_.IteratorMultiDataSetIterator(src(jit_), batch))
    with pytest.raises(ValueError, match="batch must be"):
        pit.IteratorMultiDataSetIterator([], 0)


def test_bucketing_iterator_is_a_dataset_iterator_with_its_batch():
    rng = np.random.default_rng(4)
    seqs = [(rng.normal(size=(t, 3)), np.eye(2)[rng.integers(0, 2, t)])
            for t in (5, 9, 30, 3)]
    p = pit.BucketingSequenceIterator(seqs, 2, boundaries=(8, 32))
    j = jit_.BucketingSequenceIterator(seqs, 2, boundaries=(8, 32))
    assert p.batch_size() == j.batch_size() == 2
    assert_same_batches(p, j)


# ------------------------------------------------------------- normalizers
def _stats(n):
    return {k: np.asarray(v) for k, v in vars(n).items() if isinstance(v, np.ndarray)}


def _assert_same_stats(pn, jn):
    ps, js = _stats(pn), _stats(jn)
    assert set(ps) == set(js) and ps
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], rtol=REL, atol=0, err_msg=k)


def _norm_iter(pkg, seed=5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(50, 3, 4)) * [1.0, 10.0, 0.1, 3.0] + [5.0, -2.0, 0.0, 100.0])
    return pkg.NumpyDataSetIterator(x.astype(np.float32), np.zeros((50, 2), np.float32), 7,
                                    drop_last=False)


@pytest.mark.parametrize("name", ["NormalizerStandardize", "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler"])
def test_normalizer_statistics_transform_and_revert_match_jax(name):
    args = {"NormalizerMinMaxScaler": (-1.0, 2.0), "ImagePreProcessingScaler": (0.0, 1.0, 50.0)}
    pn = getattr(pnorm, name)(*args.get(name, ())).fit(_norm_iter(pit))
    jn = getattr(jnorm, name)(*args.get(name, ())).fit(_norm_iter(jit_))
    if name != "ImagePreProcessingScaler":
        _assert_same_stats(pn, jn)
    ds = next(iter(_norm_iter(pit, seed=6)))
    ds.example_metadata = list(range(ds.num_examples()))
    out, jout = pn.transform(ds), jn.transform(jit_.DataSet(ds.features, ds.labels,
                                                            example_metadata=list(range(7))))
    np.testing.assert_allclose(out.features, jout.features, rtol=REL, atol=1e-6)
    assert out.example_metadata == ds.example_metadata
    np.testing.assert_allclose(pn.revert(out).features, ds.features, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pn.preprocess(ds).features, out.features)


def test_standardize_streaming_merge_equals_one_pass():
    """Chan's merge over batches of 7 (the last of 1) gives the whole set's
    mean and std, in both packages alike."""
    pn = pnorm.NormalizerStandardize().fit(_norm_iter(pit))
    whole = np.concatenate([ds.features for ds in _norm_iter(pit)]).reshape(50, -1)
    whole = whole.astype(np.float64)
    np.testing.assert_allclose(pn.mean, whole.mean(0), rtol=1e-12)
    np.testing.assert_allclose(pn.std, whole.std(0), rtol=1e-12)
    one = pnorm.NormalizerStandardize().fit(pit.DataSet(whole.astype(np.float32),
                                                        np.zeros((50, 2))))
    np.testing.assert_allclose(pn.std, one.std, rtol=REL)
    with pytest.raises(ValueError, match="saw no data"):
        pnorm.NormalizerStandardize().fit([])
    with pytest.raises(ValueError, match="saw no data"):
        pnorm.NormalizerMinMaxScaler().fit([])
    with pytest.raises(NotImplementedError):
        pnorm.DataNormalization().revert(None)


def test_combined_preprocessor_fits_stages_in_order_and_round_trips_json():
    def combined(mod):
        return mod.CombinedPreProcessor(mod.ImagePreProcessingScaler(0.0, 1.0, 10.0),
                                        mod.NormalizerStandardize(),
                                        mod.NormalizerMinMaxScaler(-1.0, 1.0))

    pc, jc = combined(pnorm).fit(_norm_iter(pit)), combined(jnorm).fit(_norm_iter(jit_))
    for a, b in zip(pc.preprocessors, jc.preprocessors):
        if not isinstance(a, pnorm.ImagePreProcessingScaler):
            _assert_same_stats(a, b)
    assert pc.to_json() == jc.to_json()
    for text in (pc.to_json(), jc.to_json()):  # each package reads the other's JSON
        back = pnorm.DataNormalization.from_json(text)
        assert back.to_json() == pc.to_json()
    ds = next(iter(_norm_iter(pit, seed=8)))
    np.testing.assert_allclose(pnorm.DataNormalization.from_json(jc.to_json())
                               .transform(ds).features,
                               jc.transform(jit_.DataSet(ds.features, ds.labels)).features,
                               rtol=REL, atol=1e-6)
    np.testing.assert_allclose(pc.revert(pc.transform(ds)).features, ds.features,
                               rtol=1e-4, atol=1e-4)
    for name in ("NormalizerStandardize", "NormalizerMinMaxScaler"):
        p = getattr(pnorm, name)().fit(_norm_iter(pit))
        assert p.to_json() == getattr(jnorm, name)().fit(_norm_iter(jit_)).to_json()
        assert pnorm.DataNormalization.from_json(p.to_json()).to_json() == p.to_json()


def test_normalizing_iterator_matches_jax_and_resets_its_base():
    pn = pnorm.NormalizerStandardize().fit(_norm_iter(pit))
    jn = jnorm.NormalizerStandardize().fit(_norm_iter(jit_))
    p = pnorm.NormalizingIterator(_norm_iter(pit), pn)
    assert p.batch_size() == 7
    p.reset()
    got = list(p)
    want = list(jnorm.NormalizingIterator(_norm_iter(jit_), jn))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.features, b.features, rtol=REL, atol=1e-6)


# ------------------------------------------------------------------ export
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_exported_files_load_in_the_other_package(tmp_path, writer):
    batches = {pkg: [_dataset(pkg, s, masks=s == 1, n=6) for s in range(3)]
               for pkg in (pit, jit_)}
    w, wit = (pexport, pit) if writer == "port" else (jexport, jit_)
    r, rit = (jexport, jit_) if writer == "port" else (pexport, pit)
    paths = w.export_datasets(batches[wit], str(tmp_path / "out"), prefix="b")
    assert [os.path.basename(p) for p in paths] == [f"b_{i:06d}.npz" for i in range(3)]
    for p, ds in zip(paths, batches[rit]):
        assert_same_batch(r.load_dataset(p), ds)
    fr = r.FileDataSetIterator(str(tmp_path / "out"))
    assert len(fr) == 3 and fr.batch_size() == 6
    assert_same_batches(fr, batches[rit])


def test_file_iterator_shuffles_and_stripes_as_jax(tmp_path):
    paths = pexport.export_datasets([_dataset(pit, s, n=3) for s in range(7)], str(tmp_path))
    for kw in ({"shuffle": True, "seed": 3}, {"process_index": 1, "process_count": 3}):
        p, j = pexport.FileDataSetIterator(paths, **kw), jexport.FileDataSetIterator(paths, **kw)
        assert p.paths == j.paths
        for _ in range(2):  # the shuffle moves with the epoch
            assert_same_batches(p, j)
    assert pexport.FileDataSetIterator([]).batch_size() == 0


# --------------------------------------------------------- bundled corpora
def test_digits_and_iris_equal_sklearn_bit_for_bit():
    sk = pytest.importorskip("sklearn.datasets")
    x, y = pfetch.load_digits_dataset()
    d = sk.load_digits()
    assert x.dtype == np.float32 and y.dtype == np.int64 and x.shape == (1797, 64)
    np.testing.assert_array_equal(x, (d.data / 16.0).astype(np.float32))
    np.testing.assert_array_equal(y, d.target)
    jx, jy = jfetch.load_digits_dataset()
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    x, y = pfetch.load_iris()
    d = sk.load_iris()
    assert x.dtype == np.float32 and x.shape == (150, 4)
    np.testing.assert_array_equal(x, d.data.astype(np.float32))
    np.testing.assert_array_equal(y, d.target)
    jx, jy = jfetch.load_iris()
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    assert len(np.unique(pfetch.load_digits_dataset()[0])) == 17  # real scans, /16


@pytest.mark.parametrize("name", ["digits.csv.gz", "iris.csv"])
def test_bundled_files_have_their_digests_and_a_tampered_one_raises(tmp_path, monkeypatch,
                                                                    name):
    real = os.path.join(pfetch.DATA_DIR, name)
    with open(real, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == pfetch.CORPUS_SHA256[name]
    fake = tmp_path / "data"
    shutil.copytree(pfetch.DATA_DIR, fake)
    raw = bytearray((fake / name).read_bytes())
    raw[-2] ^= 1
    (fake / name).write_bytes(bytes(raw))
    monkeypatch.setattr(pfetch, "DATA_DIR", str(fake))
    load = pfetch.load_digits_dataset if name.startswith("digits") else pfetch.load_iris
    with pytest.raises(ValueError, match="checksum mismatch"):
        load()
    (fake / name).unlink()
    with pytest.raises(FileNotFoundError):
        load()


@pytest.mark.parametrize("kw", [{"train": True}, {"train": False, "shuffle": False},
                                {"train": True, "flat": True, "n_train": 100, "seed": 4}])
def test_digits_iterator_draws_jax_batches(kw):
    p, j = pfetch.DigitsDataSetIterator(batch=32, **kw), jfetch.DigitsDataSetIterator(
        batch=32, **kw)
    for _ in range(2):
        assert_same_batches(p, j)


def test_iris_iterator_keeps_the_short_batch_as_jax():
    for kw in ({"batch": 50}, {"batch": 64, "num_examples": 140, "shuffle": True}):
        p, j = pfetch.IrisDataSetIterator(**kw), jfetch.IrisDataSetIterator(**kw)
        assert len(p) == len(j)
        assert_same_batches(p, j)
    assert [d.num_examples() for d in pfetch.IrisDataSetIterator(batch=64)] == [64, 64, 22]


# ------------------------------------------------- CIFAR, LFW, Curves, MNIST
def test_cifar10_reads_binary_batches_as_jax(tmp_path):
    rng = np.random.default_rng(7)
    sub = tmp_path / "cifar-10-batches-bin"
    sub.mkdir()
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rec = rng.integers(0, 256, (3, 3073)).astype(np.uint8)
        rec[:, 0] = rng.integers(0, 10, 3)
        rec.tofile(sub / name)
    for train in (True, False):
        x, y = pfetch.load_cifar10(train=train, root=str(tmp_path))
        jx, jy = jfetch.load_cifar10(train=train, root=str(tmp_path))
        assert x.shape == ((15 if train else 3), 32, 32, 3)
        assert x.tobytes() == jx.tobytes() and np.array_equal(y, jy)
    assert_same_batches(pfetch.CifarDataSetIterator(4, root=str(tmp_path), num_examples=12),
                        jfetch.CifarDataSetIterator(4, root=str(tmp_path), num_examples=12))


def test_cifar10_and_lfw_stand_ins_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("CIFAR_DIR", raising=False)
    monkeypatch.delenv("LFW_DIR", raising=False)
    none = str(tmp_path / "absent")
    for train in (True, False):
        x, y = pfetch.load_cifar10(train=train)
        jx, jy = jfetch.load_cifar10(train=train, root=none)
        assert x.tobytes() == jx.tobytes() and np.array_equal(y, jy)
    p = pfetch.LFWDataSetIterator(8, height=8, width=6, num_labels=3, examples_per_label=5)
    j = jfetch.LFWDataSetIterator(8, height=8, width=6, root=none, num_labels=3,
                                  examples_per_label=5)
    assert p.labels == j.labels and p.batch_size() == 8
    assert_same_batches(p, j)


def test_lfw_reads_an_image_tree_as_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    for person in ("ann", "bob", "cy"):
        (tmp_path / person).mkdir()
        for k in range(3):
            np.save(tmp_path / person / f"{k}.npy",
                    rng.integers(0, 256, (6, 5, 3)).astype(np.float32))
    monkeypatch.setenv("LFW_DIR", str(tmp_path))
    p = pfetch.LFWDataSetIterator(4, height=6, width=5)
    j = jfetch.LFWDataSetIterator(4, height=6, width=5, root=str(tmp_path))
    assert p.labels == j.labels == ["ann", "bob", "cy"]
    assert_same_batches(p, j)


def test_curves_match_jax():
    assert_same_batches(pfetch.CurvesDataSetIterator(32, n=100, dim=50),
                        jfetch.CurvesDataSetIterator(32, n=100, dim=50))


def _idx_gz(path, arr):
    dims = struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim) + dims + arr.astype(">u1").tobytes())


def _mirror(tmp_path, tamper=False):
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    rng = np.random.default_rng(0)
    files = {"train-images-idx3-ubyte.gz": rng.integers(0, 255, (12, 28, 28)),
             "train-labels-idx1-ubyte.gz": rng.integers(0, 9, (12,)),
             "t10k-images-idx3-ubyte.gz": rng.integers(0, 255, (4, 28, 28)),
             "t10k-labels-idx1-ubyte.gz": rng.integers(0, 9, (4,))}
    sums = {}
    for name, arr in files.items():
        _idx_gz(str(mirror / name), arr.astype(np.uint8))
        sums[name] = hashlib.sha256((mirror / name).read_bytes()).hexdigest()
    if tamper:
        name = "train-images-idx3-ubyte.gz"
        (mirror / name).write_bytes(b"corrupted" + (mirror / name).read_bytes())
    return f"file://{mirror}", sums


def test_fetch_mnist_verifies_caches_and_loads(tmp_path):
    url, sums = _mirror(tmp_path)
    root = str(tmp_path / "data")
    assert pfetch.fetch_mnist(root=root, base_url=url, checksums=sums) == root
    for train, n in ((True, 12), (False, 4)):
        x, y = pfetch.load_mnist(train=train, root=root)
        jx, jy = jfetch.load_mnist(train=train, root=root)
        assert x.shape == (n, 784) and np.array_equal(x, jx) and np.array_equal(y, jy)
    for f in (tmp_path / "mirror").iterdir():  # a second fetch reads its cache
        f.unlink()
    pfetch.fetch_mnist(root=root, base_url=url, checksums=sums)


def test_fetch_mnist_rejects_a_tampered_file_and_replaces_a_stale_one(tmp_path):
    url, sums = _mirror(tmp_path, tamper=True)
    root = tmp_path / "data"
    with pytest.raises(ValueError, match="checksum mismatch"):
        pfetch.fetch_mnist(root=str(root), base_url=url, checksums=sums)
    assert not (root / "train-images-idx3-ubyte.gz").exists()
    (tmp_path / "good").mkdir()
    url, sums = _mirror(tmp_path / "good")
    (root / "t10k-labels-idx1-ubyte.gz").write_bytes(b"stale")
    pfetch.fetch_mnist(root=str(root), base_url=url, checksums=sums)
    assert hashlib.sha256((root / "t10k-labels-idx1-ubyte.gz").read_bytes()).hexdigest() == \
        sums["t10k-labels-idx1-ubyte.gz"]


def test_fetch_mnist_needs_a_directory_and_pins_jax_digests(monkeypatch):
    monkeypatch.delenv("MNIST_DIR", raising=False)
    with pytest.raises(ValueError, match="root"):
        pfetch.fetch_mnist()
    assert pfetch.MNIST_SHA256 == jfetch.MNIST_SHA256


def test_package_exports_match_jax_but_the_async_and_bucketing_names():
    import deeplearning4j_tpu.datasets as jd

    import deeplearning4j_tpu_torch.datasets as pd

    # the async, device-prefetching and bucketing names came with slice 17:
    # every name of the JAX package's is exported now
    assert set(pd.__all__) == set(jd.__all__)
    for n in pd.__all__:
        assert getattr(pd, n) is not None
    assert pt.DigitsDataSetIterator is pfetch.DigitsDataSetIterator
