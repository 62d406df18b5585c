"""LayerNormalization and BatchNormalization (port of
``nn/layers/normalization.py``).

BatchNormalization is ported in inference mode: its moving statistics are
buffers (``moving_mean``, ``moving_var``; the JAX state tree), and a module
in training mode raises, since batch statistics and their update are not
ported (ROADMAP Queue 1, item 11).
"""

from __future__ import annotations

import torch
from torch import nn

from ..module import Layer, ones_init, zeros_init


class LayerNormalization(nn.Module):
    """LayerNorm over the last axis: statistics in f32, cast back to the
    input dtype. Parameters keep the JAX names ``gamma``/``beta``."""

    def __init__(self, dim: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(ones_init((dim,)).to(device))
        self.beta = nn.Parameter(zeros_init((dim,)).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.gamma + self.beta
        return y.to(x.dtype)


class BatchNormalization(Layer):
    """BatchNorm over the channel (last) axis, inference mode:
    ``(x - moving_mean) / sqrt(moving_var + eps) * gamma + beta`` in f32,
    cast back to x's dtype."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, scale: bool = True, center: bool = True,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = axis
        self.scale = scale
        self.center = center

    def _axis(self, ndim: int) -> int:
        return self.axis if self.axis >= 0 else ndim + self.axis

    def build(self, input_shape, gen: torch.Generator) -> None:
        full = (None,) + tuple(input_shape)
        shape = (full[self._axis(len(full))],)
        if self.scale:
            self.gamma = nn.Parameter(ones_init(shape))
        if self.center:
            self.beta = nn.Parameter(zeros_init(shape))
        self.register_buffer("moving_mean", torch.zeros(shape))
        self.register_buffer("moving_var", torch.ones(shape))
        self.built = True

    def apply(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNormalization in training mode (batch statistics and "
                "the moving-average update) is not ported: ROADMAP Queue 1, "
                "item 11. Call .eval() for inference")
        bshape = [1] * x.dim()
        bshape[self._axis(x.dim())] = x.shape[self._axis(x.dim())]
        # the per-channel 1/sqrt in float64, rounded once, where JAX has
        # an f32 rsqrt: the card's and the CPU's f32 versions differ by an
        # ulp on some channels, and in an int8 network that one ulp flips
        # codes that cascade (measured: 1.65e-3 in the probabilities of
        # ResNet-50); the elementwise steps below are exact IEEE on both
        inv = torch.reciprocal(torch.sqrt(
            (self.moving_var + self.epsilon).double())).float()
        y = (x.float() - self.moving_mean.reshape(bshape)) * inv.reshape(
            bshape)
        if self.scale:
            y = y * self.gamma.reshape(bshape)
        if self.center:
            y = y + self.beta.reshape(bshape)
        return y.to(x.dtype)


__all__ = ["BatchNormalization", "LayerNormalization"]
