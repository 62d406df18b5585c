"""Convolution and pooling layers (port of
``analytics_zoo_tpu/nn/layers/convolution.py``): Convolution1D/2D,
DepthwiseConv2D, Max/AveragePooling1D/2D, the global poolings,
UpSampling2D and ZeroPadding2D.

The data layout is NHWC and conv kernels are HWIO, as in the JAX package.
SAME padding is TF-style (``lax.padtype_to_pads``): the extra pixel of an
odd total goes to the bottom/right, so asymmetric pads go through
``F.pad`` (torch's ``padding=`` is symmetric). A float conv runs through
``F.conv2d`` on an NCHW view of the NHWC tensor (the JAX package's
``lax.conv_general_dilated`` has no Pallas kernel either); a packed conv
runs the int8 conv (``ops/int8.py``: K6 on the card). Convolution1D
(the TextClassifier's encoder) takes (B, steps, dim) with a (length, in,
out) kernel and runs ``F.conv1d`` on the transposed view.
DepthwiseConv2D (the MobileNets' block) is JAX's grouped
``conv_general_dilated(feature_group_count=C)``: ``F.conv2d(groups=C)``
over the (kh, kw, 1, C·mult) kernel, whose output channel ``c·mult + j``
reads input channel ``c`` in both. It has no int8 form: the JAX package
packs only the layers whose ``apply`` is ``Dense.apply`` or
``Convolution2D.apply``, and so does the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.int8 import int8_conv2d
from ...ops.int8_fused import conv_pads
from ..activations import get_activation
from ..module import Layer, as_compute, get_initializer, zeros_init
from .core import Int8Kernel


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def out_spatial(padding, spatial, window, strides):
    """The output's spatial dims: ceil(d / s) for SAME, else VALID's."""
    if padding == "SAME":
        return tuple(-(-d // s) for d, s in zip(spatial, strides))
    return tuple((d - k) // s + 1 for d, k, s in zip(spatial, window,
                                                     strides))


def pad_spatial(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Channels-last ``x`` (B, *spatial, C) padded on its spatial dims."""
    flat = [0, 0]
    for lo, hi in reversed(tuple(pads)):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def pool(x: torch.Tensor, kind: str, window, strides, padding: str):
    """Max or average pooling of channels-last ``x`` over its n spatial
    dims, as JAX's ``reduce_window``: SAME pads with the reduction's
    identity (-inf, 0), and the average divides by the whole window."""
    n = len(window)
    pads = conv_pads(padding, x.shape[1:1 + n], window, strides)
    xp = pad_spatial(x, pads, float("-inf") if kind == "max" else 0.0)
    to_cf = (0, n + 1) + tuple(range(1, n + 1))
    to_cl = (0,) + tuple(range(2, n + 2)) + (1,)
    fn = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
          ("max", 3): F.max_pool3d, ("avg", 1): F.avg_pool1d,
          ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}[(kind, n)]
    return fn(xp.permute(to_cf), tuple(window),
              tuple(strides)).permute(to_cl)


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
        return out_spatial(self.padding, (h, w), self.kernel_size,
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


class _Pool2D(Layer):
    """Pooling over H and W of NHWC input; ``strides`` default to the
    window."""

    kind = "max"

    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None \
            else self.pool_size
        self.padding = border_mode.upper()

    def apply(self, x):
        return pool(x, self.kind, self.pool_size, self.strides, self.padding)

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return out_spatial(self.padding, (h, w), self.pool_size,
                       self.strides) + (c,)


class MaxPooling2D(_Pool2D):
    """Max pooling, NHWC; SAME pads with -inf (``reduce_window``'s init)."""


class AveragePooling2D(_Pool2D):
    """Average pooling, NHWC; SAME pads with zeros, and every window
    divides by its full size, as JAX's ``reduce_window`` sum does."""

    kind = "avg"


class _Pool1D(Layer):
    """Pooling over the steps of (B, steps, dim)."""

    kind = "max"

    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pool_length = int(pool_length)
        self.stride = int(stride) if stride is not None else self.pool_length
        self.padding = border_mode.upper()

    def apply(self, x):
        return pool(x, self.kind, (self.pool_length,), (self.stride,),
                    self.padding)

    def compute_output_shape(self, input_shape):
        steps, c = input_shape
        return out_spatial(self.padding, (steps,), (self.pool_length,),
                            (self.stride,)) + (c,)


class MaxPooling1D(_Pool1D):
    pass


class AveragePooling1D(_Pool1D):
    kind = "avg"


class GlobalAveragePooling2D(Layer):
    """Mean over H and W. At inference the sum runs in float64, where it
    is exact for any order in practice, so the card and the CPU give the
    same bits: the int8 head quantizes this output per row, and a one-ulp
    difference there flips codes (JAX's f32 mean differs by at most about
    one ulp). A training step keeps to f32, as JAX's does."""

    def apply(self, x):
        if self.training:
            return x.mean(dim=(1, 2))
        return x.double().mean(dim=(1, 2)).to(x.dtype)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class GlobalMaxPooling1D(Layer):
    """Max over the steps of (B, steps, dim)."""

    def apply(self, x):
        return x.amax(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class GlobalAveragePooling1D(Layer):
    """Mean over the steps of (B, steps, dim)."""

    def apply(self, x):
        return x.mean(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class GlobalMaxPooling2D(Layer):
    """Max over H and W."""

    def apply(self, x):
        return x.amax(dim=(1, 2))

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class UpSampling2D(Layer):
    """Repeat each row ``size[0]`` and each column ``size[1]`` times."""

    def __init__(self, size=(2, 2), name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.size = _pair(size)

    def apply(self, x):
        return x.repeat_interleave(self.size[0], dim=1).repeat_interleave(
            self.size[1], dim=2)

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return (h * self.size[0], w * self.size[1], c)


class ZeroPadding2D(Layer):
    """``padding`` = (rows, cols) of zeros on both sides."""

    def __init__(self, padding=(1, 1), name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pad = _pair(padding)

    def apply(self, x):
        ph, pw = self.pad
        return pad_spatial(x, ((ph, ph), (pw, pw)))

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return (h + 2 * self.pad[0], w + 2 * self.pad[1], c)


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor, strides,
                     padding) -> torch.Tensor:
    """NHWC ``x`` through the HWIO ``(kh, kw, 1, C·mult)`` kernel, one
    group a channel (JAX's ``feature_group_count=C``)."""
    pads = conv_pads(padding, x.shape[1:3], kernel.shape[:2], strides)
    xc, sym = _nchw_padded(x, pads)
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)          # (C·mult, 1, kh, kw)
    return F.conv2d(xc, w, stride=tuple(strides), padding=sym,
                    groups=x.shape[-1]).permute(0, 2, 3, 1)


class DepthwiseConv2D(Layer):
    """Depthwise 2D conv, NHWC: ``depth_multiplier`` filters a channel;
    SAME by default, no bias by default."""

    def __init__(self, kernel_size=(3, 3), depth_multiplier: int = 1,
                 border_mode: str = "same", subsample=(1, 1),
                 activation=None, init="glorot_uniform",
                 use_bias: bool = False, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.kernel_size = _pair(kernel_size)
        self.depth_multiplier = int(depth_multiplier)
        self.padding = border_mode.upper()
        self.strides = _pair(subsample)
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        out = input_shape[-1] * self.depth_multiplier
        self.kernel = nn.Parameter(self.init(gen, (kh, kw, 1, out)))
        if self.use_bias:
            self.bias = nn.Parameter(zeros_init((out,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        y = depthwise_conv2d(x, self.kernel, self.strides, self.padding)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return out_spatial(self.padding, (h, w), self.kernel_size,
                       self.strides) + (c * self.depth_multiplier,)


__all__ = ["AveragePooling1D", "AveragePooling2D", "Convolution1D",
           "Convolution2D", "DepthwiseConv2D", "GlobalAveragePooling1D",
           "GlobalAveragePooling2D", "GlobalMaxPooling1D",
           "GlobalMaxPooling2D", "MaxPooling1D", "MaxPooling2D",
           "UpSampling2D", "ZeroPadding2D", "depthwise_conv2d", "out_spatial",
           "pad_spatial", "pool"]
