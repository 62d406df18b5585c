"""Elementwise and table layers (port of
``analytics_zoo_tpu/nn/layers/elementwise.py``): the constant and
pointwise maths layers, the learnable pointwise ``Mul``/``CAdd``/``CMul``/
``Scale``, the threshold family, the shape and table layers (``GetShape``,
``Max``, ``SelectTable``, ``SplitTensor``, ``Expand``), ``GaussianSampler``,
``KerasLayerWrapper``, ``ERF`` and ``MM``.

``dim``/``size`` arguments exclude the batch dim, as the Keras wrappers'
do. ``CAdd`` takes ``b_regularizer`` and ``CMul`` ``w_regularizer``, each
over its one tensor, into the training loss. ``GaussianSampler`` draws
``prng.normal`` from its key in training (JAX's bits within about an
ulp) and is the mean at inference.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..module import Layer, as_compute, call_layer
from ..regularizers import get_regularizer
from .core import normal_draw


class AddConstant(Layer):
    def __init__(self, constant: float, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.constant = float(constant)

    def apply(self, x):
        return x + self.constant


class MulConstant(Layer):
    def __init__(self, constant: float, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.constant = float(constant)

    def apply(self, x):
        return x * self.constant


class Exp(Layer):
    def apply(self, x):
        return torch.exp(as_compute(x))


class Log(Layer):
    def apply(self, x):
        return torch.log(as_compute(x))


class Power(Layer):
    """``(shift + scale · x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.power, self.scale, self.shift = (float(power), float(scale),
                                              float(shift))

    def apply(self, x):
        return (self.shift + self.scale * as_compute(x)) ** self.power


class Sqrt(Layer):
    def apply(self, x):
        return torch.sqrt(as_compute(x))


class Square(Layer):
    def apply(self, x):
        x = as_compute(x)
        return x * x


class Negative(Layer):
    def apply(self, x):
        return -x


class Identity(Layer):
    def apply(self, x):
        return x


class Mul(Layer):
    """One learnable scalar factor ``weight``."""

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.weight = nn.Parameter(torch.ones((1,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        return x * self.weight.to(x.dtype)


class CAdd(Layer):
    """A learnable ``bias`` of shape ``size``, broadcast-added."""

    def __init__(self, size: Sequence[int], b_regularizer=None, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.size = tuple(int(s) for s in size)
        self.b_regularizer = get_regularizer(b_regularizer)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.bias = nn.Parameter(torch.zeros(self.size))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        return x + self.bias.to(x.dtype)


class CMul(Layer):
    """A learnable ``weight`` of shape ``size``, broadcast-multiplied."""

    def __init__(self, size: Sequence[int], w_regularizer=None, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.size = tuple(int(s) for s in size)
        self.w_regularizer = get_regularizer(w_regularizer)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.weight = nn.Parameter(torch.ones(self.size))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        return x * self.weight.to(x.dtype)

    def regularization(self):
        if self.w_regularizer is None:
            return 0.0
        return self.w_regularizer(self.weight)


class Scale(Layer):
    """CMul then CAdd: ``x · weight + bias``, both of shape ``size``."""

    def __init__(self, size: Sequence[int], name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.size = tuple(int(s) for s in size)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.weight = nn.Parameter(torch.ones(self.size))
        self.bias = nn.Parameter(torch.zeros(self.size))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Threshold(Layer):
    """``x`` where ``x > th``, else ``v``."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.th, self.v = float(th), float(v)

    def apply(self, x):
        x = as_compute(x)
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class BinaryThreshold(Layer):
    """1 where ``x > value``, else 0, in x's dtype."""

    def __init__(self, value: float = 1e-6, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.value = float(value)

    def apply(self, x):
        x = as_compute(x)
        return (x > self.value).to(x.dtype)


class HardTanh(Layer):
    """``clip(x, min_value, max_value)``."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.min_value, self.max_value = float(min_value), float(max_value)

    def apply(self, x):
        return torch.clamp(as_compute(x), self.min_value, self.max_value)


class HardShrink(Layer):
    """``x`` where ``|x| > value``, else 0."""

    def __init__(self, value: float = 0.5, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.value = float(value)

    def apply(self, x):
        x = as_compute(x)
        return torch.where(x.abs() > self.value, x, torch.zeros_like(x))


class SoftShrink(Layer):
    """``x - v`` above ``v``, ``x + v`` below ``-v``, else 0."""

    def __init__(self, value: float = 0.5, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.value = float(value)

    def apply(self, x):
        x = as_compute(x)
        v, zero = self.value, torch.zeros_like(x)
        return (torch.where(x > v, x - v, zero)
                + torch.where(x < -v, x + v, zero))


class GetShape(Layer):
    """The input's shape (batch dim included) as a 1-D int32 tensor."""

    def apply(self, x):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)

    def compute_output_shape(self, input_shape):
        return (len(input_shape) + 1,)


class Max(Layer):
    """The max over (non-batch) ``dim``, or its int32 argmax when
    ``return_value`` is false."""

    def __init__(self, dim: int, return_value: bool = True, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dim = int(dim)
        self.return_value = bool(return_value)

    def apply(self, x):
        if self.return_value:
            return x.amax(dim=self.dim + 1)
        return x.argmax(dim=self.dim + 1).to(torch.int32)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)


class SelectTable(Layer):
    """Element ``index`` (0-based) of a list input."""

    def __init__(self, index: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.index = int(index)

    def apply(self, x):
        return x[self.index]

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[self.index])


class SplitTensor(Layer):
    """``num`` equal chunks along (non-batch) ``dim``, as a list."""

    def __init__(self, dim: int, num: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dim, self.num = int(dim), int(num)

    def apply(self, x):
        size = x.shape[self.dim + 1]
        if size % self.num:
            raise ValueError(f"{self.name}: dim of size {size} does not "
                             f"split into {self.num}")
        return list(x.split(size // self.num, dim=self.dim + 1))

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape[self.dim] //= self.num
        return [tuple(shape)] * self.num


class Expand(Layer):
    """Broadcast size-1 dims to ``tgt_sizes`` (batch dim included; -1
    keeps a dim)."""

    def __init__(self, tgt_sizes: Sequence[int], name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.tgt_sizes = tuple(int(s) for s in tgt_sizes)

    def apply(self, x):
        tgt = tuple(x.shape[i] if s == -1 else s
                    for i, s in enumerate(self.tgt_sizes))
        return x.expand(tgt)

    def compute_output_shape(self, input_shape):
        return tuple(self.tgt_sizes[1:])


class GaussianSampler(Layer):
    """``mean + exp(log_var / 2) · N(0, 1)`` from ``[mean, log_var]`` in
    training (the VAE reparameterisation); the mean at inference."""

    takes_rng = True

    def __init__(self, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.training = False

    def apply(self, x, rng=None):
        mean, log_var = x
        if not self.training:
            return mean
        if rng is None:
            raise ValueError(f"{self.name}: sampling in training mode needs "
                             f"rng")
        eps = normal_draw(rng, mean.shape, mean.device).to(mean.dtype)
        return mean + torch.exp(0.5 * log_var) * eps

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[0])


class KerasLayerWrapper(Layer):
    """A port ``Layer`` or a bare callable ``fn(x)`` as a layer: a wrapped
    layer's parameters are this layer's own (the JAX tree has no extra
    level), and it is built, trained and handed its key through here."""

    def __init__(self, module, output_shape_fn: Optional[Callable] = None,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.output_shape_fn = output_shape_fn
        if isinstance(module, Layer):
            object.__setattr__(self, "module", module)
            object.__setattr__(self, "fn", None)
            object.__setattr__(self, "_parameters", module._parameters)
            object.__setattr__(self, "_buffers", module._buffers)
            object.__setattr__(self, "_modules", module._modules)
            self.takes_rng = module.takes_rng
        else:
            object.__setattr__(self, "module", None)
            object.__setattr__(self, "fn", module)

    def build(self, input_shape, gen: torch.Generator) -> None:
        if self.module is not None:
            self.module.build(input_shape, gen)
            self.module.built = True
        self.built = True

    def train(self, mode: bool = True):
        super().train(mode)
        if self.module is not None:
            self.module.train(mode)         # not a child: set its mode too
        return self

    def regularization(self):
        return 0.0 if self.module is None else self.module.regularization()

    def apply(self, x, rng=None):
        if self.module is not None:
            return call_layer(self.module, x, rng)
        return self.fn(x)

    def compute_output_shape(self, input_shape):
        if self.output_shape_fn is not None:
            return self.output_shape_fn(input_shape)
        if self.module is not None:
            return self.module.compute_output_shape(input_shape)
        return input_shape


class ERF(Layer):
    """The Gauss error function."""

    def apply(self, x):
        return torch.erf(x)


class MM(Layer):
    """The batched product of a two-tensor input ``[a, b]``;
    ``trans_a``/``trans_b`` transpose the last two dims first."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.trans_a, self.trans_b = bool(trans_a), bool(trans_b)

    def apply(self, x):
        a, b = x
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def compute_output_shape(self, input_shape):
        sa, sb = [list(s) for s in input_shape]
        if self.trans_a:
            sa[-1], sa[-2] = sa[-2], sa[-1]
        if self.trans_b:
            sb[-1], sb[-2] = sb[-2], sb[-1]
        return tuple(sa[:-1] + [sb[-1]])


__all__ = ["AddConstant", "BinaryThreshold", "CAdd", "CMul", "ERF", "Exp",
           "Expand", "GaussianSampler", "GetShape", "HardShrink", "HardTanh",
           "Identity", "KerasLayerWrapper", "Log", "MM", "Max", "Mul",
           "MulConstant", "Negative", "Power", "Scale", "SelectTable",
           "SoftShrink", "SplitTensor", "Sqrt", "Square", "Threshold"]
