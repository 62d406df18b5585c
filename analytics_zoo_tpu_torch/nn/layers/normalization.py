"""LayerNormalization (port of ``nn/layers/normalization.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..module import ones_init, zeros_init


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


__all__ = ["LayerNormalization"]
