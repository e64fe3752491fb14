"""Convolution and padding layers (counterpart of
``deeplearning4j_tpu/nn/layers/convolution.py``): ``ConvolutionLayer``,
``Convolution1DLayer`` over [B, T, F] sequences and ``ZeroPaddingLayer``.

Activations are NHWC at the API boundary and between layers, as in the JAX
package; params keep its layout, ``W`` [kh, kw, in, out] (HWIO) and ``b``
[out], so checkpoints and ``load_jax_params`` carry them unchanged. Inside
``apply`` the NHWC activation is handed to ``F.conv2d`` as its NCHW view,
which is channels-last in memory (no copy), and the weight is permuted to
OIHW and copied channels-last, one small copy per call. The JAX package
computes the convolution with XLA, outside any Pallas kernel, so it stays a
library call here. ConvolutionMode's output-size rules (strict, truncate,
same) are the JAX package's; Same pads asymmetrically, low side
``total//2``, which ``F.conv2d``'s symmetric ``padding`` cannot express, so
asymmetric pads are applied by ``F.pad`` first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ..conf.inputs import InputType
from .base import BaseLayer, Params, maybe_dropout, register_layer

Pads = Tuple[Tuple[int, int], Tuple[int, int]]  # ((top, bottom), (left, right))


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def conv_output_size(size: int, k: int, s: int, p: int, mode: str, dilation: int = 1) -> int:
    """Output spatial size under the reference's ConvolutionMode rules
    (ConvolutionUtils.getOutputSize). Raises where the output would be empty,
    where strict mode does not divide, and for Same with explicit padding."""
    k_eff = k + (k - 1) * (dilation - 1)
    if mode == "same":
        if p:
            raise ValueError(
                "ConvolutionMode=same ignores explicit padding; set padding=0 "
                f"(got padding={p})")
        out = -(-size // s)  # ceil(size / stride)
    elif mode == "strict":
        if (size - k_eff + 2 * p) % s != 0:
            raise ValueError(
                f"ConvolutionMode=strict: (in={size} - k={k_eff} + 2*p={p}) not divisible "
                f"by stride {s}")
        out = (size - k_eff + 2 * p) // s + 1
    else:  # truncate: floor
        out = (size - k_eff + 2 * p) // s + 1
    if out < 1:
        raise ValueError(
            f"Convolution/pooling output size is {out} (input={size}, kernel={k}, "
            f"stride={s}, padding={p}, dilation={dilation}, mode={mode}): input too "
            "small for this layer stack")
    return out


def _same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """Asymmetric Same padding, low = total//2 (XLA's 'SAME', the
    reference's rule)."""
    k_eff = k + (k - 1) * (dilation - 1)
    out = -(-size // s)
    total = max((out - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (channels-last in memory: no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (contiguous where x is channels-last)."""
    return x.permute(0, 2, 3, 1)


def pad_nchw(x: torch.Tensor, pads: Pads, value: float = 0.0) -> torch.Tensor:
    """x [N, C, H, W] padded by ``pads`` with ``value`` (x itself where all
    pads are 0)."""
    (top, bottom), (left, right) = pads
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


@register_layer
@dataclass
class ConvolutionLayer(BaseLayer):
    """2D convolution over NHWC images (reference:
    nn/conf/layers/ConvolutionLayer.java). Params: W [kh, kw, in, out]
    (HWIO), b [out]. Weight-init fans follow the reference: fan_in =
    in*kh*kw, fan_out = out*kh*kw / stride area."""

    n_in: int = 0  # channels; inferred when 0
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"  # reference default (ConvolutionMode.Truncate)
    has_bias: bool = True

    def __post_init__(self):
        self.kernel = _pair(self.kernel)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def get_output_type(self, it: InputType) -> InputType:
        if it.kind != "cnn":
            raise ValueError(f"ConvolutionLayer expects CNN input, got {it.kind}")
        oh = conv_output_size(it.height, self.kernel[0], self.stride[0], self.padding[0],
                              self.convolution_mode, self.dilation[0])
        ow = conv_output_size(it.width, self.kernel[1], self.stride[1], self.padding[1],
                              self.convolution_mode, self.dilation[1])
        return InputType.convolutional(oh, ow, self.n_out)

    def init_params(self, gen, it: InputType) -> Params:
        n_in = self.n_in or it.channels
        kh, kw = self.kernel
        fan_in = n_in * kh * kw
        fan_out = self.n_out * kh * kw / (self.stride[0] * self.stride[1])
        p = {"W": self._init_weight(gen, (kh, kw, n_in, self.n_out), fan_in, fan_out)}
        if self.has_bias:
            p["b"] = self._init_bias((self.n_out,))
        return p

    def pads(self, h: int, w: int) -> Pads:
        """((top, bottom), (left, right)) for an h x w input."""
        if self.convolution_mode == "same":
            return (_same_pads(h, self.kernel[0], self.stride[0], self.dilation[0]),
                    _same_pads(w, self.kernel[1], self.stride[1], self.dilation[1]))
        return ((self.padding[0],) * 2, (self.padding[1],) * 2)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        x = maybe_dropout(x, self.dropout, train, generator)
        (top, bottom), (left, right) = pads = self.pads(x.shape[1], x.shape[2])
        xc = nchw(x)
        if top == bottom and left == right:  # symmetric: conv2d pads without a copy
            padding = (top, left)
        else:
            xc, padding = pad_nchw(xc, pads), (0, 0)
        w = params["W"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        z = F.conv2d(xc, w, params["b"] if self.has_bias else None, stride=self.stride,
                     padding=padding, dilation=self.dilation)
        return self._activate(nhwc(z)), state



@register_layer
@dataclass
class Convolution1DLayer(BaseLayer):
    """1D convolution over [B, T, F] sequences (reference:
    Convolution1DLayer). Params: W [kernel, in, out] (WIO), b [out]; modes
    as ``ConvolutionLayer``'s, "same" by default (asymmetric pads, low side
    total//2). The features mask is not applied, as in the JAX package."""

    n_in: int = 0
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "same"
    has_bias: bool = True

    def get_output_type(self, it: InputType) -> InputType:
        t = it.timesteps
        if t is not None:
            t = conv_output_size(t, self.kernel, self.stride, self.padding, self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def init_params(self, gen, it: InputType) -> Params:
        n_in = self.n_in or it.size
        fan_in = n_in * self.kernel
        fan_out = self.n_out * self.kernel / self.stride
        p = {"W": self._init_weight(gen, (self.kernel, n_in, self.n_out), fan_in, fan_out)}
        if self.has_bias:
            p["b"] = self._init_bias((self.n_out,))
        return p

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        x = maybe_dropout(x, self.dropout, train, generator)
        if self.convolution_mode == "same":
            lo, hi = _same_pads(x.shape[1], self.kernel, self.stride)
        else:
            lo = hi = self.padding
        xc = x.transpose(1, 2)  # [B, F, T]
        if lo != hi:
            xc, lo = F.pad(xc, (lo, hi)), 0
        z = F.conv1d(xc, params["W"].permute(2, 1, 0), params["b"] if self.has_bias else None,
                     stride=self.stride, padding=lo)
        return self._activate(z.transpose(1, 2)), state


@register_layer
@dataclass
class ZeroPaddingLayer(BaseLayer):
    """Zero padding of NHWC images, top, bottom, left and right (reference:
    nn/conf/layers/ZeroPaddingLayer); no params."""

    pad_top: int = 0
    pad_bottom: int = 0
    pad_left: int = 0
    pad_right: int = 0

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(it.height + self.pad_top + self.pad_bottom,
                                       it.width + self.pad_left + self.pad_right, it.channels)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        return F.pad(x, (0, 0, self.pad_left, self.pad_right, self.pad_top,
                         self.pad_bottom)), state
