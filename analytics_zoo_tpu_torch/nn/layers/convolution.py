"""Convolution and pooling layers (port of
``analytics_zoo_tpu/nn/layers/convolution.py``): Convolution1D,
Convolution2D, MaxPooling2D, GlobalMaxPooling1D, GlobalAveragePooling2D.

The data layout is NHWC and conv kernels are HWIO, as in the JAX package.
SAME padding is TF-style (``lax.padtype_to_pads``): the extra pixel of an
odd total goes to the bottom/right, so asymmetric pads go through
``F.pad`` (torch's ``padding=`` is symmetric). A float conv runs through
``F.conv2d`` on an NCHW view of the NHWC tensor (the JAX package's
``lax.conv_general_dilated`` has no Pallas kernel either); a packed conv
runs the int8 conv (``ops/int8.py``: K6 on the card). Convolution1D
(the TextClassifier's encoder) takes (B, steps, dim) with a (length, in,
out) kernel and runs ``F.conv1d`` on the transposed view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.int8 import int8_conv2d
from ...ops.int8_fused import conv_pads
from ..activations import get_activation
from ..module import Layer, as_compute, get_initializer
from .core import Int8Kernel


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _out_hw(padding, hw, k_hw, strides):
    if padding == "SAME":
        return tuple(-(-h // s) for h, s in zip(hw, strides))
    return tuple((h - k) // s + 1 for h, k, s in zip(hw, k_hw, strides))


def _nchw_padded(x: torch.Tensor, pads):
    """The NCHW view of NHWC ``x`` and the symmetric padding left for
    ``F.conv2d``, after ``F.pad`` took an asymmetric one."""
    xc = x.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return xc, (pt, pl)
    return F.pad(xc, (pl, pr, pt, pb)), (0, 0)


class Convolution2D(Int8Kernel, Layer):
    """2D conv, NHWC; ``border_mode`` 'valid' | 'same'."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), init="glorot_uniform", bias_init="zeros",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = _pair(subsample)
        self.padding = border_mode.upper()
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.bias_init = get_initializer(bias_init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        self.kernel = nn.Parameter(self.init(
            gen, (kh, kw, input_shape[-1], self.filters)))
        if self.use_bias:
            self.bias = nn.Parameter(self.bias_init(gen, (self.filters,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        if self.is_int8:
            y = int8_conv2d(x, self.packed_kernel, strides=self.strides,
                            padding=self.padding)
        else:
            pads = conv_pads(self.padding, x.shape[1:3], self.kernel_size,
                             self.strides)
            xc, sym = _nchw_padded(x, pads)
            w = self.kernel.to(x.dtype).permute(3, 2, 0, 1)     # OIHW
            y = F.conv2d(xc, w, stride=self.strides,
                         padding=sym).permute(0, 2, 3, 1)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        return _out_hw(self.padding, (h, w), self.kernel_size,
                       self.strides) + (self.filters,)


class Convolution1D(Layer):
    """1D conv over (B, steps, dim); ``border_mode`` 'valid' | 'same'
    (TF-style SAME: the extra step of an odd total pad goes last)."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 init="glorot_uniform", bias_init="zeros",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = int(filter_length)
        self.stride = int(subsample_length)
        self.padding = border_mode.upper()
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.bias_init = get_initializer(bias_init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.kernel = nn.Parameter(self.init(
            gen, (self.kernel_size, input_shape[-1], self.filters)))
        if self.use_bias:
            self.bias = nn.Parameter(self.bias_init(gen, (self.filters,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        xc = x.transpose(1, 2)                               # (B, dim, steps)
        if self.padding == "SAME":
            n = x.shape[1]
            out = -(-n // self.stride)
            total = max((out - 1) * self.stride + self.kernel_size - n, 0)
            xc = F.pad(xc, (total // 2, total - total // 2))
        w = self.kernel.to(x.dtype).permute(2, 1, 0)         # (out, in, K)
        y = F.conv1d(xc, w, stride=self.stride).transpose(1, 2)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        steps, _ = input_shape
        if self.padding == "SAME":
            out = -(-steps // self.stride)
        else:
            out = (steps - self.kernel_size) // self.stride + 1
        return (out, self.filters)


class MaxPooling2D(Layer):
    """Max pooling, NHWC; SAME pads with -inf (``reduce_window``'s init)."""

    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None \
            else self.pool_size
        self.padding = border_mode.upper()

    def apply(self, x):
        (pt, pb), (pl, pr) = conv_pads(self.padding, x.shape[1:3],
                                       self.pool_size, self.strides)
        xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb),
                   value=float("-inf"))
        return F.max_pool2d(xc, self.pool_size,
                            self.strides).permute(0, 2, 3, 1)

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return _out_hw(self.padding, (h, w), self.pool_size,
                       self.strides) + (c,)


class GlobalAveragePooling2D(Layer):
    """Mean over H and W. The sum runs in float64, where it is exact for
    any order in practice, so the card and the CPU give the same bits: the
    int8 head quantizes this output per row, and a one-ulp difference there
    flips codes (JAX's f32 mean differs by at most about one ulp)."""

    def apply(self, x):
        return x.double().mean(dim=(1, 2)).to(x.dtype)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class GlobalMaxPooling1D(Layer):
    """Max over the steps of (B, steps, dim)."""

    def apply(self, x):
        return x.amax(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


__all__ = ["Convolution1D", "Convolution2D", "GlobalAveragePooling2D",
           "GlobalMaxPooling1D", "MaxPooling2D"]
