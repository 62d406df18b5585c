"""Activations used by the ported layers.

``analytics_zoo_tpu.nn.activations.gelu`` is ``jax.nn.gelu``, whose default
is the tanh approximation; torch's default gelu is the exact erf form, which
differs by about 1e-3. The port therefore asks for ``approximate="tanh"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def get_activation(name):
    if callable(name):
        return name
    if name == "gelu":
        return gelu
    raise ValueError(f"activation {name!r} is not ported yet; known: gelu")


__all__ = ["gelu", "get_activation"]
