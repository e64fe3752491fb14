"""Local response normalization (counterpart of
``deeplearning4j_tpu/nn/layers/normalization.py``).

``LocalResponseNormalization`` normalizes over the trailing (NHWC channel)
axis through ``ops.lrn``: the hand-written kernels of ``ops/csrc/lrn.cu`` on
the card, their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ... import ops
from .base import LATER, BaseLayer, register_layer

LATER.update(
    BatchNormalization="it waits for the ResNet slice of the port (ROADMAP.md Queue 1)")


@register_layer
@dataclass
class LocalResponseNormalization(BaseLayer):
    """Cross-channel LRN (reference: LocalResponseNormalization.java defaults
    k=2, n=5, alpha=1e-4, beta=0.75): y = x / (k + alpha*sum_n x^2)^beta.
    No params."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        y = ops.lrn(x, k=self.k, n=self.n, alpha=self.alpha, beta=self.beta)
        return self._activate(y), state
