"""Pooling layers (counterpart of ``deeplearning4j_tpu/nn/layers/pooling.py``).

``SubsamplingLayer`` pools NHWC images through the NCHW view that
``F.max_pool2d`` and ``F.avg_pool2d`` take (channels-last in memory, no
copy). The JAX package's ``lax.reduce_window`` pads max pooling with -inf and
sum pooling with 0, and avg divides each window's sum by the count of its
real elements; torch's own padding is symmetric only, so any padding is
applied by ``F.pad`` first (none in truncate mode without padding, which is
AlexNet's), and avg over padding divides by counts pooled from ones. Max
pooling's gradient goes to the first largest element of each window in
row-major order, in both packages (``tests/test_torch_cnn_layers.py``).
``GlobalPoolingLayer`` reduces the spatial axes of an image or the time
axis of a sequence, masked steps left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ..conf.inputs import InputType
from .base import BaseLayer, register_layer
from .convolution import _pair, _same_pads, conv_output_size, nchw, nhwc, pad_nchw


@register_layer
@dataclass
class SubsamplingLayer(BaseLayer):
    """Max, avg or sum spatial pooling over NHWC images (reference:
    SubsamplingLayer.java). No params."""

    pooling_type: str = "max"  # max | avg | sum
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"

    def __post_init__(self):
        self.kernel = _pair(self.kernel)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def get_output_type(self, it: InputType) -> InputType:
        oh = conv_output_size(it.height, self.kernel[0], self.stride[0], self.padding[0],
                              self.convolution_mode)
        ow = conv_output_size(it.width, self.kernel[1], self.stride[1], self.padding[1],
                              self.convolution_mode)
        return InputType.convolutional(oh, ow, it.channels)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        if self.pooling_type not in ("max", "avg", "sum"):
            raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
        h, w = x.shape[1], x.shape[2]
        if self.convolution_mode == "same":
            pads = (_same_pads(h, self.kernel[0], self.stride[0]),
                    _same_pads(w, self.kernel[1], self.stride[1]))
        else:
            pads = ((self.padding[0],) * 2, (self.padding[1],) * 2)
        xc = nchw(x)
        if self.pooling_type == "max":
            out = F.max_pool2d(pad_nchw(xc, pads, float("-inf")), self.kernel, self.stride)
            return nhwc(out), state
        # the window sums; avg divides them by the count of real elements
        out = F.avg_pool2d(pad_nchw(xc, pads), self.kernel, self.stride, divisor_override=1)
        if self.pooling_type == "avg":
            ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
            out = out / F.avg_pool2d(pad_nchw(ones, pads), self.kernel, self.stride,
                                     divisor_override=1)
        return nhwc(out), state


@register_layer
@dataclass
class GlobalPoolingLayer(BaseLayer):
    """Pools the spatial axes of NHWC images or the time axis of sequences
    away (reference: GlobalPoolingLayer.java): [B,H,W,C] -> [B,C], [B,T,F]
    -> [B,F], by max, avg, sum or pnorm. A [B, T] mask leaves masked steps
    out of a sequence's reduction (reference: MaskedReductionUtil). No
    params."""

    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2

    def get_output_type(self, it: InputType) -> InputType:
        if it.kind == "cnn":
            return InputType.feed_forward(it.channels)
        return InputType.feed_forward(it.size)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        kind = self.pooling_type
        if kind not in ("max", "avg", "sum", "pnorm"):
            raise ValueError(f"Unknown pooling type '{kind}'")
        dims = (1, 2) if x.dim() == 4 else (1,)
        if mask is not None and x.dim() == 3:
            m = mask.reshape(mask.shape[0], mask.shape[1], 1).to(x.dtype)
            if kind == "max":
                return torch.amax(torch.where(m > 0, x, float("-inf")), dim=dims), state
            if kind == "avg":
                return (torch.sum(x * m, dim=dims)
                        / torch.clamp(torch.sum(m, dim=dims), min=1.0)), state
            x = x * m
        elif kind == "max":
            return torch.amax(x, dim=dims), state
        elif kind == "avg":
            return torch.mean(x, dim=dims), state
        if kind == "sum":
            return torch.sum(x, dim=dims), state
        return torch.sum(torch.abs(x) ** self.pnorm, dim=dims) ** (1.0 / self.pnorm), state
