"""Extended convolution, pooling and resampling layers (port of
``analytics_zoo_tpu/nn/layers/conv_extended.py``).

Channels are last everywhere (NWC, NHWC, NDHWC) and kernels keep the JAX
layouts (WIO, HWIO, DHWIO), so the bridge loads them as they are. Each
conv runs ``F.conv1d/2d/3d`` on a channels-first view (JAX's
``conv_general_dilated`` has no Pallas kernel either), SAME padding TF's
(the extra pixel high, through ``F.pad``). Where torch's ready-made op
computes something else, the layer says so and does the JAX arithmetic:

- ``Deconvolution2D`` is JAX's ``conv_transpose(padding="VALID")`` with
  ``transpose_kernel=False``: a stride-dilated input convolved with the
  HWIO kernel as it is, which is ``F.conv_transpose2d`` over the kernel
  flipped in H and W, its I/O kept (``(I, O, kh, kw)`` is what
  ``conv_transpose2d`` reads). Its output is ``in · s + max(k - s, 0)``
  a dim: where the stride exceeds the kernel, JAX's VALID padding adds
  ``s - k`` zero rows (bias only) at the end, ``output_padding`` here;
- ``ResizeBilinear`` keeps the legacy TF1 coordinates ``src = i · in /
  out`` (``align_corners=False``) or ``i · (in - 1) / (out - 1)``, which
  ``F.interpolate``'s half-pixel centres are not;
- ``LRN2D`` and ``WithinChannelLRN2D`` sum squares over a window with XLA
  SAME padding, ``(n - 1) // 2`` low and ``n // 2`` high, which
  ``F.local_response_norm`` pads the other way for an even ``n``.

None of these layers has an int8 form: the JAX package packs only
``Dense`` and ``Convolution2D``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..activations import get_activation
from ..module import Layer, as_compute, get_initializer, zeros_init
from ...ops.int8_fused import conv_pads
from .convolution import (_pair, depthwise_conv2d, out_spatial, pad_spatial,
                          pool)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_nd(x: torch.Tensor, kernel: torch.Tensor, strides, padding,
            dilation=None) -> torch.Tensor:
    """Channels-last ``x`` (B, *spatial, C) through the (*window, I, O)
    kernel: ``padding`` "SAME"/"VALID" (over the dilated window) or
    explicit (low, high) pairs."""
    n = kernel.dim() - 2
    dilation = tuple(dilation or (1,) * n)
    window = tuple((k - 1) * d + 1 for k, d in zip(kernel.shape[:n],
                                                  dilation))
    xp = pad_spatial(x, conv_pads(padding, x.shape[1:1 + n], window,
                                  strides))
    to_cf = (0, n + 1) + tuple(range(1, n + 1))
    to_cl = (0,) + tuple(range(2, n + 2)) + (1,)
    w = kernel.to(x.dtype).permute((n + 1, n) + tuple(range(n)))
    return _CONV[n](xp.permute(to_cf), w, stride=tuple(strides),
                    dilation=dilation).permute(to_cl)


class _ConvBase(Layer):
    """The shared bias and activation tail of the conv layers."""

    def _build_kernel(self, gen, shape, n_out):
        self.kernel = nn.Parameter(self.init(gen, shape))
        if self.use_bias:
            self.bias = nn.Parameter(zeros_init(n_out))
        self.built = True

    def _finish(self, y, dtype):
        if self.use_bias:
            y = y + self.bias.to(dtype)
        return self.activation(y)


class Convolution3D(_ConvBase):
    """3D conv over (B, D1, D2, D3, C), DHWIO kernel."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, activation=None, border_mode: str = "valid",
                 subsample=(1, 1, 1), init="glorot_uniform",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = (int(kernel_dim1), int(kernel_dim2),
                            int(kernel_dim3))
        self.strides = _triple(subsample)
        self.padding = border_mode.upper()
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        self._build_kernel(gen, self.kernel_size + (input_shape[-1],
                                                    self.filters),
                           (self.filters,))

    def apply(self, x):
        x = as_compute(x)
        return self._finish(conv_nd(x, self.kernel, self.strides,
                                    self.padding), x.dtype)

    def compute_output_shape(self, input_shape):
        return out_spatial(self.padding, input_shape[:-1], self.kernel_size,
                            self.strides) + (self.filters,)


class Deconvolution2D(_ConvBase):
    """Transposed 2D conv, VALID: output ``(in - 1) · stride + kernel``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), init="glorot_uniform",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = _pair(subsample)
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        self._build_kernel(gen, (kh, kw, input_shape[-1], self.filters),
                           (self.filters,))

    def apply(self, x):
        x = as_compute(x)
        # (kh, kw, I, O) flipped in H and W, as (I, O, kh, kw)
        w = self.kernel.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
        extra = tuple(max(s - k, 0) for k, s in zip(self.kernel_size,
                                                    self.strides))
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=self.strides,
                               output_padding=extra).permute(0, 2, 3, 1)
        return self._finish(y, x.dtype)

    def compute_output_shape(self, input_shape):
        return tuple(d * s + max(k - s, 0) for d, k, s in zip(
            input_shape[:2], self.kernel_size, self.strides)) + (
                self.filters,)


class SeparableConvolution2D(_ConvBase):
    """A depthwise conv (``depth_multiplier`` filters a channel) then a
    1x1 pointwise conv, one bias after both."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), depth_multiplier: int = 1,
                 init="glorot_uniform", use_bias: bool = True, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = _pair(subsample)
        self.padding = border_mode.upper()
        self.depth_multiplier = int(depth_multiplier)
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        mid = input_shape[-1] * self.depth_multiplier
        self.depthwise_kernel = nn.Parameter(self.init(gen, (kh, kw, 1,
                                                             mid)))
        self.pointwise_kernel = nn.Parameter(self.init(
            gen, (1, 1, mid, self.filters)))
        if self.use_bias:
            self.bias = nn.Parameter(zeros_init((self.filters,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        y = depthwise_conv2d(x, self.depthwise_kernel, self.strides,
                             self.padding)
        y = conv_nd(y, self.pointwise_kernel, (1, 1), "VALID")
        return self._finish(y, x.dtype)

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        return out_spatial(self.padding, (h, w), self.kernel_size,
                            self.strides) + (self.filters,)


class AtrousConvolution2D(_ConvBase):
    """Dilated 2D conv: ``atrous_rate`` is the kernel dilation."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), atrous_rate=(1, 1),
                 border_mode: str = "valid", init="glorot_uniform",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = _pair(subsample)
        self.rate = _pair(atrous_rate)
        self.padding = border_mode.upper()
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        self._build_kernel(gen, (kh, kw, input_shape[-1], self.filters),
                           (self.filters,))

    def apply(self, x):
        x = as_compute(x)
        return self._finish(conv_nd(x, self.kernel, self.strides,
                                    self.padding, self.rate), x.dtype)

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        window = tuple((k - 1) * r + 1 for k, r in zip(self.kernel_size,
                                                       self.rate))
        return out_spatial(self.padding, (h, w), window,
                            self.strides) + (self.filters,)


class AtrousConvolution1D(_ConvBase):
    """Dilated 1D conv over (B, steps, dim)."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, atrous_rate: int = 1,
                 border_mode: str = "valid", init="glorot_uniform",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = int(filter_length)
        self.stride = int(subsample_length)
        self.rate = int(atrous_rate)
        self.padding = border_mode.upper()
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        self._build_kernel(gen, (self.kernel_size, input_shape[-1],
                                 self.filters), (self.filters,))

    def apply(self, x):
        x = as_compute(x)
        return self._finish(conv_nd(x, self.kernel, (self.stride,),
                                    self.padding, (self.rate,)), x.dtype)

    def compute_output_shape(self, input_shape):
        k = (self.kernel_size - 1) * self.rate + 1
        return out_spatial(self.padding, input_shape[:1], (k,),
                            (self.stride,)) + (self.filters,)


class ShareConvolution2D(_ConvBase):
    """2D conv with explicit ``(pad_h, pad_w)`` zero padding on both
    sides; ``propagate_back=False`` stops the gradient to the input."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), pad_h: int = 0,
                 pad_w: int = 0, propagate_back: bool = True,
                 init="glorot_uniform", use_bias: bool = True, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = _pair(subsample)
        self.pad = (int(pad_h), int(pad_w))
        self.propagate_back = bool(propagate_back)
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        self._build_kernel(gen, (kh, kw, input_shape[-1], self.filters),
                           (self.filters,))

    def apply(self, x):
        x = as_compute(x)
        if not self.propagate_back:
            x = x.detach()
        ph, pw = self.pad
        return self._finish(conv_nd(x, self.kernel, self.strides,
                                    ((ph, ph), (pw, pw))), x.dtype)

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        kh, kw = self.kernel_size
        sh, sw = self.strides
        ph, pw = self.pad
        return ((h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1,
                self.filters)


class LocallyConnected2D(_ConvBase):
    """A 2D conv with its own weights at each output position (VALID):
    the (kh, kw, C) patches concatenated in that order, times a (OH, OW,
    kh·kw·C, F) kernel."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), init="glorot_uniform",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        if border_mode.lower() != "valid":
            raise ValueError("LocallyConnected2D only supports border_mode="
                             "'valid'")
        self.filters = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = _pair(subsample)
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def _out_hw(self, input_shape):
        return out_spatial("VALID", input_shape[:2], self.kernel_size,
                            self.strides)

    def build(self, input_shape, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        oh, ow = self._out_hw(input_shape)
        self._build_kernel(gen, (oh, ow, kh * kw * input_shape[-1],
                                 self.filters), (oh, ow, self.filters))

    def apply(self, x):
        x = as_compute(x)
        kh, kw = self.kernel_size
        sh, sw = self.strides
        oh, ow = self._out_hw(tuple(x.shape[1:]))
        patches = [x[:, i:i + oh * sh:sh, j:j + ow * sw:sw, :]
                   for i in range(kh) for j in range(kw)]
        p = torch.cat(patches, dim=-1)
        y = torch.einsum("bhwk,hwkf->bhwf", p, self.kernel.to(x.dtype))
        return self._finish(y, x.dtype)

    def compute_output_shape(self, input_shape):
        return self._out_hw(input_shape) + (self.filters,)


class LocallyConnected1D(_ConvBase):
    """A 1D conv with its own weights at each output step."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, init="glorot_uniform",
                 use_bias: bool = True, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.filters = int(nb_filter)
        self.kernel_size = int(filter_length)
        self.stride = int(subsample_length)
        self.activation = get_activation(activation)
        self.init = get_initializer(init)
        self.use_bias = use_bias

    def _out_len(self, steps):
        return (steps - self.kernel_size) // self.stride + 1

    def build(self, input_shape, gen: torch.Generator) -> None:
        steps, in_ch = input_shape
        ol = self._out_len(steps)
        self._build_kernel(gen, (ol, self.kernel_size * in_ch, self.filters),
                           (ol, self.filters))

    def apply(self, x):
        x = as_compute(x)
        ol, s = self._out_len(x.shape[1]), self.stride
        p = torch.cat([x[:, i:i + ol * s:s, :]
                       for i in range(self.kernel_size)], dim=-1)
        y = torch.einsum("blk,lkf->blf", p, self.kernel.to(x.dtype))
        return self._finish(y, x.dtype)

    def compute_output_shape(self, input_shape):
        return (self._out_len(input_shape[0]), self.filters)


class Cropping1D(Layer):
    """Crop (left, right) steps from (B, steps, dim)."""

    def __init__(self, cropping=(1, 1), name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.cropping = _pair(cropping)

    def apply(self, x):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]

    def compute_output_shape(self, input_shape):
        steps, c = input_shape
        return (steps - sum(self.cropping), c)


class Cropping2D(Layer):
    """Crop ((top, bottom), (left, right)) from (B, H, W, C)."""

    def __init__(self, cropping=((0, 0), (0, 0)), name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.h_crop = tuple(cropping[0])
        self.w_crop = tuple(cropping[1])

    def apply(self, x):
        (t, b), (l, r) = self.h_crop, self.w_crop
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return (h - sum(self.h_crop), w - sum(self.w_crop), c)


class Cropping3D(Layer):
    """Crop the three spatial dims of (B, D1, D2, D3, C)."""

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.crops = tuple(tuple(c) for c in cropping)

    def apply(self, x):
        (a1, b1), (a2, b2), (a3, b3) = self.crops
        return x[:, a1:x.shape[1] - b1, a2:x.shape[2] - b2,
                 a3:x.shape[3] - b3, :]

    def compute_output_shape(self, input_shape):
        d1, d2, d3, c = input_shape
        return tuple(d - sum(cr) for d, cr in zip((d1, d2, d3),
                                                  self.crops)) + (c,)


class ZeroPadding1D(Layer):
    def __init__(self, padding=1, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pad = _pair(padding)

    def apply(self, x):
        return pad_spatial(x, (self.pad,))

    def compute_output_shape(self, input_shape):
        steps, c = input_shape
        return (steps + sum(self.pad), c)


class ZeroPadding3D(Layer):
    def __init__(self, padding=(1, 1, 1), name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pad = _triple(padding)

    def apply(self, x):
        return pad_spatial(x, tuple((p, p) for p in self.pad))

    def compute_output_shape(self, input_shape):
        d1, d2, d3, c = input_shape
        return (d1 + 2 * self.pad[0], d2 + 2 * self.pad[1],
                d3 + 2 * self.pad[2], c)


class UpSampling1D(Layer):
    def __init__(self, length: int = 2, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.length = int(length)

    def apply(self, x):
        return x.repeat_interleave(self.length, dim=1)

    def compute_output_shape(self, input_shape):
        steps, c = input_shape
        return (steps * self.length, c)


class UpSampling3D(Layer):
    def __init__(self, size=(2, 2, 2), name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.size = _triple(size)

    def apply(self, x):
        for d, s in enumerate(self.size):
            x = x.repeat_interleave(s, dim=d + 1)
        return x

    def compute_output_shape(self, input_shape):
        d1, d2, d3, c = input_shape
        return (d1 * self.size[0], d2 * self.size[1], d3 * self.size[2], c)


class _Pool3D(Layer):
    kind = "max"

    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 border_mode="valid", name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.pool_size = _triple(pool_size)
        self.strides = _triple(strides) if strides is not None \
            else self.pool_size
        self.padding = border_mode.upper()

    def apply(self, x):
        return pool(x, self.kind, self.pool_size, self.strides, self.padding)

    def compute_output_shape(self, input_shape):
        return out_spatial(self.padding, input_shape[:-1], self.pool_size,
                            self.strides) + (input_shape[-1],)


class MaxPooling3D(_Pool3D):
    pass


class AveragePooling3D(_Pool3D):
    kind = "avg"


class GlobalMaxPooling3D(Layer):
    def apply(self, x):
        return x.amax(dim=(1, 2, 3))

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class GlobalAveragePooling3D(Layer):
    def apply(self, x):
        return x.mean(dim=(1, 2, 3))

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class ResizeBilinear(Layer):
    """Bilinear resize of (B, H, W, C) with TF1's legacy coordinates
    (module docstring)."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.out_h = int(output_height)
        self.out_w = int(output_width)
        self.align_corners = bool(align_corners)

    def _src_coords(self, out_size: int, in_size: int, device):
        if self.align_corners and out_size > 1:
            scale = (in_size - 1) / (out_size - 1)
        else:
            scale = in_size / out_size
        src = torch.arange(out_size, dtype=torch.float32,
                           device=device) * scale
        lo = torch.floor(src).to(torch.int64).clamp(0, in_size - 1)
        hi = (lo + 1).clamp(0, in_size - 1)
        frac = (src - lo.float()).clamp(0.0, 1.0)
        return lo, hi, frac

    def apply(self, x):
        x = as_compute(x)
        h, w = x.shape[1], x.shape[2]
        ylo, yhi, yf = self._src_coords(self.out_h, h, x.device)
        xlo, xhi, xf = self._src_coords(self.out_w, w, x.device)
        yf = yf[None, :, None, None].to(x.dtype)
        xf = xf[None, None, :, None].to(x.dtype)
        top, bot = x[:, ylo], x[:, yhi]
        top = top[:, :, xlo] * (1 - xf) + top[:, :, xhi] * xf
        bot = bot[:, :, xlo] * (1 - xf) + bot[:, :, xhi] * xf
        return top * (1 - yf) + bot * yf

    def compute_output_shape(self, input_shape):
        return (self.out_h, self.out_w, input_shape[-1])


def _window_sum(sq: torch.Tensor, window) -> torch.Tensor:
    """The sum of channels-last ``sq`` over a stride-1 window of the
    trailing dims ``window`` covers (the leading ones 1), XLA SAME."""
    pads = [((k - 1) // 2, k // 2) for k in window]
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    p = F.pad(sq, flat)
    for d, k in enumerate(window):
        dim = sq.dim() - len(window) + d
        p = p.unfold(dim, k, 1).sum(dim=-1)
    return p


class LRN2D(Layer):
    """Cross-channel local response normalisation: ``x / (k + alpha / n ·
    Σ x²) ** beta``, the sum over ``n`` neighbouring channels."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.alpha, self.k, self.beta, self.n = (float(alpha), float(k),
                                                 float(beta), int(n))

    def apply(self, x):
        x = as_compute(x)
        window_sum = _window_sum(x * x, (self.n,))
        return x / (self.k + (self.alpha / self.n) * window_sum) ** self.beta


class WithinChannelLRN2D(Layer):
    """Within-channel LRN over a ``size`` x ``size`` spatial window:
    ``x / (1 + alpha / size² · Σ x²) ** beta``."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.size, self.alpha, self.beta = int(size), float(alpha), float(beta)

    def apply(self, x):
        x = as_compute(x)
        sq = (x * x).permute(0, 3, 1, 2)            # the window on H, W
        window_sum = _window_sum(sq, (self.size, self.size)).permute(
            0, 2, 3, 1)
        return x / (1.0 + (self.alpha / (self.size * self.size))
                    * window_sum) ** self.beta


__all__ = ["AtrousConvolution1D", "AtrousConvolution2D", "AveragePooling3D",
           "Convolution3D", "Cropping1D", "Cropping2D", "Cropping3D",
           "Deconvolution2D", "GlobalAveragePooling3D", "GlobalMaxPooling3D",
           "LRN2D", "LocallyConnected1D", "LocallyConnected2D",
           "MaxPooling3D", "ResizeBilinear", "SeparableConvolution2D",
           "ShareConvolution2D", "UpSampling1D", "UpSampling3D",
           "WithinChannelLRN2D", "ZeroPadding1D", "ZeroPadding3D", "conv_nd"]
