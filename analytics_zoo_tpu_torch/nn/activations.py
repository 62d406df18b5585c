"""Activations used by the ported layers (port of ``nn/activations.py``).

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


ACTIVATIONS = {"linear": linear, "identity": linear, "relu": relu,
               "sigmoid": sigmoid, "hard_sigmoid": hard_sigmoid,
               "tanh": tanh, "softmax": softmax, "gelu": gelu}


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


__all__ = ["ACTIVATIONS", "gelu", "get_activation", "hard_sigmoid",
           "linear", "relu", "sigmoid", "softmax", "tanh"]
