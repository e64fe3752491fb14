"""Data normalizers (counterpart of
``deeplearning4j_tpu/datasets/normalizers.py``; reference: ND4J's
DataNormalization).

``fit`` gathers statistics on the host in one streaming pass (Chan et al.'s
parallel merge of mean and variance, batch by batch); ``transform`` is a
numpy op on each batch before it goes to the device. Normalizers round-trip
through JSON in the JAX package's form. ``NormalizingIterator`` applies one
to every batch of an iterator, metadata carried.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .iterators import DataSet, DataSetIterator


class DataNormalization:
    """SPI: fit(iterator) → transform(DataSet) (reference: ND4J DataNormalization)."""

    def fit(self, data) -> "DataNormalization":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def preprocess(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    def revert(self, ds: DataSet) -> DataSet:
        """Inverse of transform (reference: DataNormalization.revertFeatures).
        Concrete normalizers override; stateless ones may be irreversible."""
        raise NotImplementedError(f"{type(self).__name__} has no revert()")

    # -- persistence ----------------------------------------------------
    def _to_dict(self) -> dict:
        d = {k: v.tolist() if isinstance(v, np.ndarray) else v
             for k, v in self.__dict__.items()}
        d["@type"] = type(self).__name__
        return d

    def to_json(self) -> str:
        return json.dumps(self._to_dict())

    @staticmethod
    def _from_dict(d: dict) -> "DataNormalization":
        d = dict(d)
        if d.get("@type") == "CombinedPreProcessor":
            return CombinedPreProcessor(*(
                DataNormalization._from_dict(p) for p in d["preprocessors"]
            ))
        cls = {c.__name__: c for c in (
            NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler
        )}[d.pop("@type")]
        obj = cls.__new__(cls)
        for k, v in d.items():
            setattr(obj, k, np.asarray(v, np.float64) if isinstance(v, list) else v)
        return obj

    @staticmethod
    def from_json(s: str) -> "DataNormalization":
        return DataNormalization._from_dict(json.loads(s))


def _batches(data):
    if isinstance(data, DataSet):
        return [data]
    return data


class NormalizerStandardize(DataNormalization):
    """Zero-mean unit-variance per feature (reference: NormalizerStandardize)."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data) -> "NormalizerStandardize":
        count, mean, m2 = 0, None, None
        for ds in _batches(data):
            x = ds.features.reshape(ds.features.shape[0], -1).astype(np.float64)
            b_count = x.shape[0]
            b_mean = x.mean(axis=0)
            b_m2 = ((x - b_mean) ** 2).sum(axis=0)
            if mean is None:
                count, mean, m2 = b_count, b_mean, b_m2
            else:  # Chan parallel merge
                delta = b_mean - mean
                tot = count + b_count
                mean = mean + delta * (b_count / tot)
                m2 = m2 + b_m2 + delta**2 * (count * b_count / tot)
                count = tot
        if mean is None:
            raise ValueError("fit() saw no data")
        self.mean = mean
        self.std = np.sqrt(np.maximum(m2 / max(count, 1), 1e-12))
        return self

    def transform(self, ds: DataSet) -> DataSet:
        shape = ds.features.shape
        x = ds.features.reshape(shape[0], -1)
        x = (x - self.mean) / self.std
        return DataSet(x.reshape(shape).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask, ds.example_metadata)

    def revert(self, ds: DataSet) -> DataSet:
        shape = ds.features.shape
        x = ds.features.reshape(shape[0], -1) * self.std + self.mean
        return DataSet(x.reshape(shape).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask, ds.example_metadata)


class NormalizerMinMaxScaler(DataNormalization):
    """Scale features to [lo, hi] (reference: NormalizerMinMaxScaler)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo = float(lo)
        self.hi = float(hi)
        self.min: Optional[np.ndarray] = None
        self.max: Optional[np.ndarray] = None

    def fit(self, data) -> "NormalizerMinMaxScaler":
        mn = mx = None
        for ds in _batches(data):
            x = ds.features.reshape(ds.features.shape[0], -1).astype(np.float64)
            b_mn, b_mx = x.min(axis=0), x.max(axis=0)
            mn = b_mn if mn is None else np.minimum(mn, b_mn)
            mx = b_mx if mx is None else np.maximum(mx, b_mx)
        if mn is None:
            raise ValueError("fit() saw no data")
        self.min, self.max = mn, mx
        return self

    def transform(self, ds: DataSet) -> DataSet:
        shape = ds.features.shape
        x = ds.features.reshape(shape[0], -1)
        rng = np.maximum(self.max - self.min, 1e-12)
        x = (x - self.min) / rng * (self.hi - self.lo) + self.lo
        return DataSet(x.reshape(shape).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask, ds.example_metadata)

    def revert(self, ds: DataSet) -> DataSet:
        """Inverse transform (reference: NormalizerMinMaxScaler.revertFeatures)."""
        shape = ds.features.shape
        x = ds.features.reshape(shape[0], -1).astype(np.float64)
        rng = np.maximum(self.max - self.min, 1e-12)
        x = (x - self.lo) / (self.hi - self.lo) * rng + self.min
        return DataSet(x.reshape(shape).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask, ds.example_metadata)


class ImagePreProcessingScaler(DataNormalization):
    """Pixel scaling [0,255] → [lo,hi] without a fit pass (reference:
    ImagePreProcessingScaler)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0, max_pixel: float = 255.0):
        self.lo = float(lo)
        self.hi = float(hi)
        self.max_pixel = float(max_pixel)

    def fit(self, data) -> "ImagePreProcessingScaler":
        return self

    def transform(self, ds: DataSet) -> DataSet:
        x = ds.features / self.max_pixel * (self.hi - self.lo) + self.lo
        return DataSet(x.astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask, ds.example_metadata)

    def revert(self, ds: DataSet) -> DataSet:
        x = (ds.features - self.lo) / (self.hi - self.lo) * self.max_pixel
        return DataSet(x.astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask, ds.example_metadata)


class CombinedPreProcessor(DataNormalization):
    """Apply several preprocessors in order (reference:
    CombinedPreProcessor.java builder). fit() fits each stage on the
    previous stages' OUTPUT; transform() chains forward, revert() unwinds
    in reverse."""

    def __init__(self, *preprocessors: DataNormalization):
        self.preprocessors = list(preprocessors)

    def fit(self, data) -> "CombinedPreProcessor":
        # each stage must see the PREVIOUS stages' output, or its statistics
        # describe data it will never receive at transform time. Streaming:
        # later stages fit on a generator of transformed batches (no
        # materialization); multi-stage fit re-iterates `data`, so iterators
        # are reset() between passes — a one-shot generator works only for a
        # single stage (the inner fit raises "saw no data" otherwise).
        def transformed(chain):
            for ds in _batches(data):
                for q in chain:
                    ds = q.transform(ds)
                yield ds

        for i, p in enumerate(self.preprocessors):
            if i > 0 and hasattr(data, "reset"):
                data.reset()
            if i == 0:
                p.fit(data)
            else:
                p.fit(transformed(self.preprocessors[:i]))
        return self

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def revert(self, ds):
        for p in reversed(self.preprocessors):
            ds = p.revert(ds)
        return ds

    # -- persistence: nested, unlike the flat-__dict__ base implementation
    def _to_dict(self) -> dict:
        return {
            "@type": "CombinedPreProcessor",
            "preprocessors": [p._to_dict() for p in self.preprocessors],
        }


class NormalizingIterator(DataSetIterator):
    """Wrap an iterator so every batch passes through a normalizer (the
    reference attaches normalizers via DataSetIterator.setPreProcessor)."""

    def __init__(self, base: DataSetIterator, normalizer: DataNormalization):
        self.base = base
        self.normalizer = normalizer

    def batch_size(self):
        return self.base.batch_size()

    def reset(self):
        self.base.reset()

    def __iter__(self):
        for ds in self.base:
            yield self.normalizer.transform(ds)
