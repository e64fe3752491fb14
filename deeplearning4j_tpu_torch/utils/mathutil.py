"""Math and sequence utilities (counterpart of
``deeplearning4j_tpu/utils/mathutil.py``; reference: util/MathUtils.java,
util/Viterbi.java, util/TimeSeriesUtils.java, berkeley/SloppyMath.java).
Host numpy helpers: MathUtils, SloppyMath's log-add, Viterbi decoding and
TimeSeriesUtils."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------- MathUtils

def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def entropy(probs: Sequence[float]) -> float:
    """Shannon entropy in nats (reference: MathUtils.entropy)."""
    return float(-sum(p * math.log(p) for p in probs if p > 0))


def information_gain(parent: Sequence[float],
                     children: Sequence[Tuple[float, Sequence[float]]]) -> float:
    """H(parent) - Σ w_i·H(child_i)."""
    return entropy(parent) - sum(w * entropy(c) for w, c in children)


def ssum(x: Sequence[float]) -> float:
    return float(np.sum(np.asarray(x, np.float64)))


def sum_of_squares(x: Sequence[float]) -> float:
    return float(np.sum(np.square(np.asarray(x, np.float64))))


def normalize(x, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Min-max rescale to [lo, hi] (reference: MathUtils.normalize)."""
    a = np.asarray(x, np.float64)
    rng = a.max() - a.min()
    if rng == 0:
        return np.full_like(a, lo)
    return (a - a.min()) / rng * (hi - lo) + lo


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def manhattan_distance(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum())


def next_power_of_2(n: int) -> int:
    return 1 if n <= 1 else 2 ** math.ceil(math.log2(n))


# ------------------------------------------------------------- SloppyMath

def log_add(log_a: float, log_b: float) -> float:
    """log(exp(a)+exp(b)) without overflow (reference: SloppyMath.logAdd)."""
    if log_a == -math.inf:
        return log_b
    if log_b == -math.inf:
        return log_a
    hi, lo = max(log_a, log_b), min(log_a, log_b)
    return hi + math.log1p(math.exp(lo - hi))


def log_add_all(values: Sequence[float]) -> float:
    out = -math.inf
    for v in values:
        out = log_add(out, v)
    return out


# ----------------------------------------------------------------- Viterbi

def viterbi(log_start: np.ndarray, log_transition: np.ndarray,
            log_emission: np.ndarray) -> Tuple[List[int], float]:
    """Most likely state path (reference: util/Viterbi.java, generalized to
    standard HMM decoding).

    log_start [S]; log_transition [S,S] (from→to); log_emission [T,S].
    Returns (path, log_prob).
    """
    T, S = log_emission.shape
    delta = log_start + log_emission[0]
    back = np.zeros((T, S), np.int64)
    for t in range(1, T):
        scores = delta[:, None] + log_transition  # [from, to]
        back[t] = np.argmax(scores, axis=0)
        delta = scores[back[t], np.arange(S)] + log_emission[t]
    path = [int(np.argmax(delta))]
    for t in range(T - 1, 0, -1):
        path.append(int(back[t, path[-1]]))
    path.reverse()
    return path, float(np.max(delta))


# ---------------------------------------------------------- TimeSeriesUtils

def reshape_time_series_mask_to_vector(mask: np.ndarray) -> np.ndarray:
    """[B,T] → [B*T, 1] (reference: TimeSeriesUtils.reshapeTimeSeriesMaskToVector)."""
    return np.asarray(mask).reshape(-1, 1)


def reshape_vector_to_time_series_mask(vec: np.ndarray, batch: int) -> np.ndarray:
    return np.asarray(vec).reshape(batch, -1)


def moving_average(series: np.ndarray, n: int) -> np.ndarray:
    """Trailing n-point moving average (reference: MathUtils.weightedValues
    family / TimeSeriesUtils.movingAverage)."""
    a = np.asarray(series, np.float64)
    c = np.cumsum(np.insert(a, 0, 0.0))
    return (c[n:] - c[:-n]) / n


def pad_time_series(x: np.ndarray, length: int, value: float = 0.0,
                    align_end: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Pad [B,T,F] to [B,length,F]; returns (padded, mask [B,length])."""
    B, T, F = x.shape
    if T > length:
        raise ValueError(f"series length {T} > target {length}")
    out = np.full((B, length, F), value, x.dtype)
    mask = np.zeros((B, length), np.float32)
    off = length - T if align_end else 0
    out[:, off : off + T] = x
    mask[:, off : off + T] = 1.0
    return out, mask


def last_time_step(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-example final unmasked step [B,F] (reference:
    TimeSeriesUtils.pullLastTimeSteps). Works for align-start AND align-end
    masks: picks the LAST set index, not count-1."""
    m = np.asarray(mask)
    T = m.shape[1]
    idx = np.where(m.any(axis=1), T - 1 - np.argmax(m[:, ::-1], axis=1), 0)
    return np.asarray(x)[np.arange(x.shape[0]), idx]
