"""Activations (port of ``nn/activations.py``): every name of the JAX
table.

``analytics_zoo_tpu.nn.activations.gelu`` is ``jax.nn.gelu``, whose default
is the tanh approximation; torch's default gelu is the exact erf form, which
differs by about 1e-3. The port therefore asks for ``approximate="tanh"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``clip(0.2 x + 0.5, 0, 1)``: the recurrent layers' default gate."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` (torch's softplus
    returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.abs(x) + 1)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


def selu(x: torch.Tensor) -> torch.Tensor:
    return torch.selu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01
               ) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS = {"linear": linear, "identity": linear, "relu": relu,
               "relu6": relu6, "sigmoid": sigmoid,
               "hard_sigmoid": hard_sigmoid, "tanh": tanh,
               "softmax": softmax, "log_softmax": log_softmax,
               "softplus": softplus, "softsign": softsign, "elu": elu,
               "selu": selu, "gelu": gelu, "leaky_relu": leaky_relu,
               "leakyrelu": leaky_relu, "swish": swish, "silu": swish}


def get_activation(name):
    """The activation for ``name`` (case-insensitive); ``None`` is linear,
    a callable passes through."""
    if name is None:
        return linear
    if callable(name):
        return name
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"activation {name!r} is not ported yet; known: "
                         f"{sorted(ACTIVATIONS)}") from None


__all__ = ["ACTIVATIONS", "elu", "gelu", "get_activation", "hard_sigmoid",
           "leaky_relu", "linear", "log_softmax", "relu", "relu6", "selu",
           "sigmoid", "softmax", "softplus", "softsign", "swish", "tanh"]
