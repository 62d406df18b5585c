"""Parametric and advanced activation layers (port of
``analytics_zoo_tpu/nn/layers/advanced_activations.py``): LeakyReLU, ELU,
ThresholdedReLU, Softmax, PReLU, SReLU, RReLU and SpatialDropout1D/2D/3D.

Channels are last, so per-channel parameters lie on the trailing axis.
The random layers draw JAX's bits from the key a container hands them
(``common/prng.py``): RReLU's slopes are ``prng.uniform(key, x.shape,
lower, upper)``, a spatial dropout's mask is one ``prng.bernoulli`` per
(sample, channel), shared over the spatial dims. Both start in inference
mode, where RReLU's slope is the mean ``(lower + upper) / 2`` and a
spatial dropout is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...common import prng
from ..activations import elu, leaky_relu
from ..module import Layer, as_compute, get_initializer
from .core import dropout, global_draw


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.alpha = float(alpha)

    def apply(self, x):
        return leaky_relu(as_compute(x), self.alpha)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.alpha = float(alpha)

    def apply(self, x):
        return elu(as_compute(x), self.alpha)


class ThresholdedReLU(Layer):
    """``x`` where ``x > theta``, else 0."""

    def __init__(self, theta: float = 1.0, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.theta = float(theta)

    def apply(self, x):
        x = as_compute(x)
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class Softmax(Layer):
    """Softmax over the last axis."""

    def apply(self, x):
        return torch.softmax(as_compute(x), dim=-1)


class PReLU(Layer):
    """A learnable leaky slope ``alpha``: one shared (``n_output_plane``
    0) or one a channel, starting at 0.25."""

    def __init__(self, n_output_plane: int = 0, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.n_output_plane = int(n_output_plane)

    def build(self, input_shape, gen: torch.Generator) -> None:
        n = self.n_output_plane if self.n_output_plane > 0 else 1
        self.alpha = nn.Parameter(torch.full((n,), 0.25))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class SReLU(Layer):
    """S-shaped ReLU: ``t_r + a_r (x - t_r)`` at or above ``t_r``, ``t_l +
    a_l (x - t_l)`` at or below ``t_l``, ``x`` between; four learnable
    tensors of the input's non-batch shape, ``shared_axes`` (1-indexed)
    collapsed to 1."""

    def __init__(self, t_left_init="zeros", a_left_init="glorot_uniform",
                 t_right_init="glorot_uniform", a_right_init="ones",
                 shared_axes: Optional[Sequence[int]] = None, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.t_left_init = get_initializer(t_left_init)
        self.a_left_init = get_initializer(a_left_init)
        self.t_right_init = get_initializer(t_right_init)
        self.a_right_init = get_initializer(a_right_init)
        self.shared_axes = tuple(shared_axes) if shared_axes else ()

    def build(self, input_shape, gen: torch.Generator) -> None:
        shape = tuple(1 if (i + 1) in self.shared_axes else s
                      for i, s in enumerate(input_shape))
        self.t_left = nn.Parameter(self.t_left_init(gen, shape))
        self.a_left = nn.Parameter(self.a_left_init(gen, shape))
        self.t_right = nn.Parameter(self.t_right_init(gen, shape))
        self.a_right = nn.Parameter(self.a_right_init(gen, shape))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        tl, al = self.t_left.to(x.dtype), self.a_left.to(x.dtype)
        tr, ar = self.t_right.to(x.dtype), self.a_right.to(x.dtype)
        y = torch.where(x >= tr, tr + ar * (x - tr), x)
        return torch.where(x <= tl, tl + al * (x - tl), y)


class RReLU(Layer):
    """Randomised leaky ReLU: negative slopes drawn from U(lower, upper)
    an element in training, their mean at inference."""

    takes_rng = True

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.lower, self.upper = float(lower), float(upper)
        self.training = False

    def apply(self, x, rng=None):
        x = as_compute(x)
        if self.training:
            if rng is None:
                raise ValueError(f"{self.name}: needs rng in training mode")
            a = global_draw(lambda k, s, d: prng.uniform(
                k, s, self.lower, self.upper, device=d), rng, x.shape,
                x.device).to(x.dtype)
        else:
            a = torch.tensor((self.lower + self.upper) / 2, dtype=x.dtype,
                             device=x.device)
        return torch.where(x >= 0, x, a * x)


class _SpatialDropout(Layer):
    """Drop whole feature maps: one mask value a (sample, channel),
    shared over the spatial dims."""

    takes_rng = True
    n_spatial = 1

    def __init__(self, p: float = 0.5, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.rate = float(p)
        self.training = False

    def apply(self, x, rng=None):
        if not self.training or self.rate <= 0.0:
            return x
        if rng is None:
            raise ValueError(f"{self.name}: needs rng in training mode")
        mask_shape = ((x.shape[0],) + (1,) * self.n_spatial
                      + (x.shape[-1],))
        return dropout(x, self.rate, rng, mask_shape)


class SpatialDropout1D(_SpatialDropout):
    n_spatial = 1


class SpatialDropout2D(_SpatialDropout):
    n_spatial = 2


class SpatialDropout3D(_SpatialDropout):
    n_spatial = 3


__all__ = ["ELU", "LeakyReLU", "PReLU", "RReLU", "SReLU", "Softmax",
           "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D",
           "ThresholdedReLU"]
