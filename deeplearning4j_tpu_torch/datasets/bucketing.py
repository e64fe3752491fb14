"""Shape bucketing and padded staging (counterpart of
``deeplearning4j_tpu/datasets/bucketing.py``): ragged data stays on the
staged path (``fit(stage_on_device=K)``, each window one replayed captured
step per update).

Host numpy only; its output is the JAX package's stager's, array for array:

- **Batch-dim padding.** A batch smaller than its group's size pads up with
  zero rows; a labels mask (and a features mask for sequence data) marks the
  padding. Losses normalize by the mask sum, so a padded batch's loss and
  gradients equal the unpadded batch's on the real rows. Cross-example
  layers (BatchNormalization) couple rows through batch statistics: such
  models pass ``pad_examples=False``.
- **Time-dim bucketing.** Variable-length sequence batches pad the time
  axis up to power-of-two boundaries (masked steps hold the recurrent state
  and add no loss), so an epoch of ragged sequences needs O(log max_T)
  captured steps, not one per length.
- **Window padding.** A trailing group of j < stage batches pads its window
  with never-executed dummy slots up to the power-of-two bucket of j; the
  real batch count goes to ``fit_on_device`` as ``real_batches``.

Mask synthesis is exact: an all-ones mask turns a mean loss into sum/count
with the same count, so full batches given synthesized masks and padded
batches sharing one window keep the unpadded loss trajectory on the real
elements (float32 tolerance; dropout draws differ in shape, so dropout is
equivalent in distribution, not bit for bit). The JAX package's flight
recorder events of bucket transitions are telemetry and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..runtime.compile_manager import next_pow2

__all__ = [
    "PaddedWindow",
    "BucketedStager",
    "bucket_length",
    "pad_batch_arrays",
    "pad_inference_batch",
    "next_pow2",
]


def bucket_length(t: int, boundaries: Optional[Sequence[int]] = None) -> int:
    """Smallest bucket boundary >= t. Default boundaries: powers of two.
    Explicit ``boundaries`` follow ``pad_to_bucket``'s contract (raise when
    t exceeds the largest)."""
    if boundaries is None:
        return next_pow2(t)
    for b in sorted(int(b) for b in boundaries):
        if t <= b:
            return b
    raise ValueError(
        f"sequence length {t} exceeds the largest bucket {max(boundaries)}; "
        "add a larger boundary or truncate"
    )


def _pad_axis(arr: np.ndarray, axis: int, target: int) -> np.ndarray:
    if arr.shape[axis] == target:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, pad)


def _padded_mask(mask: Optional[np.ndarray], b: int, t: Optional[int],
                 target_b: int, target_t: Optional[int]) -> np.ndarray:
    """Extend/synthesize a mask: ones over the real [b, t] region (or the
    given mask's values there), zeros over padding. ``t``/``target_t`` None
    => per-example ([B]) mask."""
    if target_t is None:
        out = np.zeros((target_b,), np.float32)
        if mask is None:
            out[:b] = 1.0
        else:
            out[:b] = np.asarray(mask, np.float32).reshape(b)
        return out
    out = np.zeros((target_b, target_t), np.float32)
    if mask is None:
        out[:b, :t] = 1.0
    else:
        m = np.asarray(mask, np.float32)
        out[: m.shape[0], : m.shape[1]] = m
    return out


def _pad_one(arr: np.ndarray, mask: Optional[np.ndarray],
             target_b: int, target_t: Optional[int], want_mask: bool):
    """Pad one array's batch (and, for >=3-D, time) axis; return
    ``(padded, mask)`` where the mask covers exactly the real region when
    ``want_mask`` (else None)."""
    arr = np.asarray(arr)
    b = arr.shape[0]
    t = arr.shape[1] if arr.ndim == 3 else None
    tt = target_t if t is not None else None
    out = _pad_axis(arr, 0, target_b)
    if tt is not None:
        out = _pad_axis(out, 1, tt)
    if not want_mask:
        return out, None
    return out, _padded_mask(mask, b, t, target_b, tt)


def pad_batch_arrays(features: np.ndarray, labels: np.ndarray,
                     features_mask: Optional[np.ndarray],
                     labels_mask: Optional[np.ndarray],
                     target_b: int, target_t: Optional[int] = None):
    """Pad one (features, labels, masks) batch to ``target_b`` rows (and
    ``target_t`` timesteps for 3-D sequence arrays). Returns
    ``(features, labels, features_mask, labels_mask)``; masks are
    synthesized/extended whenever padding exists or a mask was already
    present (features mask only for sequence features), else None. Dtypes
    are preserved; padding is zeros."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    padded = (
        features.shape[0] != target_b
        or (target_t is not None and features.ndim == 3
            and features.shape[1] != target_t)
        or (target_t is not None and labels.ndim == 3
            and labels.shape[1] != target_t)
    )
    with_masks = padded or features_mask is not None or labels_mask is not None
    out_f, fm = _pad_one(
        features, features_mask, target_b, target_t,
        want_mask=with_masks and (features.ndim == 3
                                  or features_mask is not None))
    out_l, lm = _pad_one(labels, labels_mask, target_b, target_t,
                         want_mask=with_masks)
    return out_f, out_l, fm, lm


def pad_inference_batch(features: np.ndarray,
                        features_mask: Optional[np.ndarray],
                        target_b: int, target_t: Optional[int] = None):
    """Pad a features-only batch for the inference fast path.

    The training stager pads (features, labels) pairs and leans on
    mask-normalized losses for exactness; inference has no labels, so
    exactness comes from two facts instead: rows are independent through
    every layer except BatchNormalization (callers with BN keep the exact
    row count), and masked trailing timesteps hold recurrent state,
    contribute nothing to attention scores, and drop out of mask-aware
    pooling. The caller slices the padded rows/steps off the output.

    Returns ``(features, features_mask)``. Sequence (3-D) features ALWAYS
    carry a mask out — synthesized all-ones over the real region when none
    came in — so a pow2-exact length and a padded length share one variant
    per bucket (mask presence is part of a captured step's signature).
    Pure row padding of mask-less 2-D input stays mask-less: row
    independence makes a mask redundant and a second variant wasteful.
    """
    features = np.asarray(features)
    b = features.shape[0]
    t = features.shape[1] if features.ndim == 3 else None
    tt = target_t if t is not None else None
    want_mask = features_mask is not None or tt is not None
    out, mask = _pad_one(features, features_mask, target_b, tt, want_mask)
    return out, mask


@dataclass
class _Member:
    """One batch, normalized to per-position lists (MultiDataSet shape;
    plain DataSets are single-position)."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: List[Optional[np.ndarray]]
    labels_masks: List[Optional[np.ndarray]]

    @property
    def batch(self) -> int:
        return int(np.asarray(self.features[0]).shape[0])


@dataclass
class PaddedWindow:
    """A staged window: per-position stacked arrays ``[K, B, ...]`` plus the
    real batch count (``n_real`` <= K; slots beyond it are dummy padding the
    device loop never indexes)."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]]
    labels_masks: Optional[List[Optional[np.ndarray]]]
    n_real: int


class BucketedStager:
    """Group a batch stream into uniform staged windows (see module doc).

    ``plan(items, normalize, stageable)`` yields ``("window", PaddedWindow)``
    and ``("batch", original_item)`` events in stream order. With
    ``pad_examples`` off (cross-example models) only exact-size batches
    group — the window-padding of trailing groups stays on, since dummy
    slots never execute. With ``bucketing`` off entirely the planner
    reproduces the legacy behavior: full uniform groups stage, everything
    ragged falls back per batch.
    """

    def __init__(self, stage: int, *, bucketing: bool = True,
                 pad_examples: bool = True,
                 time_boundaries: Optional[Sequence[int]] = None):
        if int(stage) < 2:
            raise ValueError(f"stage must be >= 2, got {stage}")
        self.stage = int(stage)
        self.bucketing = bool(bucketing)
        self.pad_examples = bool(pad_examples) and self.bucketing
        self.time_boundaries = time_boundaries
        # real-vs-staged byte accounting across every window built
        self._padding = {"windows": 0, "batches": 0,
                         "real_bytes": 0, "staged_bytes": 0}

    def padding_stats(self) -> dict:
        """Cumulative padding accounting: staged bytes (what the device
        loop will touch, dummy window slots excluded: they never execute)
        against the real data's bytes, and the padding fraction."""
        out = dict(self._padding)
        out["padding_fraction"] = (
            1.0 - out["real_bytes"] / out["staged_bytes"]
            if out["staged_bytes"] else 0.0)
        return out

    # ---------------------------------------------------------- signatures
    def _time_bucket(self, member: _Member) -> Optional[int]:
        ts = [np.asarray(a).shape[1] for a in member.features + member.labels
              if np.asarray(a).ndim == 3]
        if not ts:
            return None
        t = max(ts)
        return bucket_length(t, self.time_boundaries) if self.bucketing else t

    def _signature(self, member: _Member, leader_b: Optional[int]):
        """Group-compatibility key. None = the member cannot join a group
        led by ``leader_b``. The key is (target_b, time bucket, per-position
        trailing dims + dtypes [time normalized to its bucket], and — in
        legacy exact mode — mask presence)."""
        t_bucket = self._time_bucket(member)
        b = member.batch
        target_b = b if leader_b is None else leader_b
        if b > target_b:
            return None
        if b != target_b and not self.pad_examples:
            return None

        def trailing(a):
            a = np.asarray(a)
            dims = list(a.shape[1:])
            if a.ndim == 3:
                dims[0] = t_bucket
            return (tuple(dims), str(a.dtype))

        sig = (
            target_b, t_bucket,
            tuple(trailing(a) for a in member.features),
            tuple(trailing(a) for a in member.labels),
        )
        if not self.bucketing:
            sig += (
                tuple(m is not None for m in member.features_masks),
                tuple(m is not None for m in member.labels_masks),
            )
        return sig

    # -------------------------------------------------------------- window
    def _build_window(self, group: List[_Member], target_b: int,
                      target_t: Optional[int]) -> PaddedWindow:
        any_pad = any(
            m.batch != target_b
            or any(np.asarray(a).ndim == 3
                   and np.asarray(a).shape[1] != target_t
                   for a in m.features + m.labels)
            for m in group
        )
        any_mask = any(
            mm is not None
            for m in group for mm in m.features_masks + m.labels_masks
        )
        with_masks = any_pad or any_mask

        def stack_position(arrays, masks, is_labels: bool):
            """Pad + stack one input/output position across the group."""
            seq = np.asarray(arrays[0]).ndim == 3
            want_mask = with_masks and (
                is_labels or seq or any(m is not None for m in masks)
            )
            padded = [
                _pad_one(a, m, target_b, target_t, want_mask)
                for a, m in zip(arrays, masks)
            ]
            stacked = np.stack([p[0] for p in padded])
            mask = np.stack([p[1] for p in padded]) if want_mask else None
            return stacked, mask

        feats, fmasks, labs, lmasks = [], [], [], []
        for i in range(len(group[0].features)):
            a, m = stack_position([g.features[i] for g in group],
                                  [g.features_masks[i] for g in group],
                                  is_labels=False)
            feats.append(a)
            fmasks.append(m)
        for i in range(len(group[0].labels)):
            a, m = stack_position([g.labels[i] for g in group],
                                  [g.labels_masks[i] for g in group],
                                  is_labels=True)
            labs.append(a)
            lmasks.append(m)

        n_real = len(group)
        # padding accounting: staged = what the loop will execute (real
        # slots only: dummy window slots are never indexed), real = the data
        # as the stream delivered it
        self._padding["windows"] += 1
        self._padding["batches"] += n_real
        self._padding["staged_bytes"] += sum(
            int(a.nbytes) for a in feats + labs)
        self._padding["real_bytes"] += sum(
            int(np.asarray(a).nbytes)
            for m in group for a in m.features + m.labels)
        window = self.stage if n_real == self.stage else min(
            self.stage, next_pow2(n_real))

        if window > n_real:
            # dummy slots: zeros the staged loop never indexes (it cycles
            # over the real batch count)
            def extend(stacked):
                if stacked is None:
                    return None
                extra = np.zeros((window - n_real,) + stacked.shape[1:],
                                 stacked.dtype)
                return np.concatenate([stacked, extra])

            feats = [extend(a) for a in feats]
            labs = [extend(a) for a in labs]
            fmasks = [extend(a) for a in fmasks]
            lmasks = [extend(a) for a in lmasks]

        return PaddedWindow(
            features=feats,
            labels=labs,
            features_masks=(fmasks if any(m is not None for m in fmasks)
                            else None),
            labels_masks=(lmasks if any(m is not None for m in lmasks)
                          else None),
            n_real=n_real,
        )

    # ---------------------------------------------------------------- plan
    def plan(self, items, normalize, stageable=None):
        """Yield ("window", PaddedWindow) / ("batch", item) events in stream
        order. ``normalize(item)`` returns ``(features_list, labels_list,
        fmask_list, lmask_list)`` or None when the item must train per-batch
        (e.g. TBPTT sequences); ``stageable(item)`` may veto staging."""
        group: List[_Member] = []
        originals: List = []
        sig = None

        def flush() -> List:
            nonlocal group, originals, sig
            if not group:
                return []
            if self.bucketing or len(group) == self.stage:
                events = [("window", self._build_window(group, sig[0],
                                                        sig[1]))]
            else:
                # legacy mode straggler group: fall back per batch
                events = [("batch", o) for o in originals]
            group, originals, sig = [], [], None
            return events

        for item in items:
            member = None
            if stageable is None or stageable(item):
                norm = normalize(item)
                if norm is not None:
                    member = _Member(*norm)
            if member is None:
                yield from flush()
                yield ("batch", item)
                continue
            s = self._signature(member, sig[0] if group else None)
            if group and s != sig:
                yield from flush()
                s = self._signature(member, None)
            sig = s
            group.append(member)
            originals.append(item)
            if len(group) == self.stage:
                yield from flush()
        yield from flush()
