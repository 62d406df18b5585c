"""Weight regularizers (port of ``analytics_zoo_tpu/nn/regularizers.py``).

A regularizer is any ``fn(tensor) -> scalar``. A layer's
``w_regularizer``/``b_regularizer`` enter its ``regularization()``
(``nn/module.py::Layer``), which the containers sum over their layers and
the Estimator adds to each micro-batch's training loss, where the JAX
step adds it: a differentiable part of the loss, not a weight-decay pass.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def _abs(p: torch.Tensor) -> torch.Tensor:
    """``|p|`` with JAX's gradient: 1 at zero (torch's ``abs`` gives 0
    there, and a bias starts at zero)."""
    return torch.where(p >= 0, p, -p)


class L1:
    def __init__(self, l1: float = 0.01):
        self.l1 = float(l1)

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        return self.l1 * torch.sum(_abs(p))


class L2:
    def __init__(self, l2: float = 0.01):
        self.l2 = float(l2)

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        return self.l2 * torch.sum(p * p)


class L1L2:
    def __init__(self, l1: float = 0.01, l2: float = 0.01):
        self.l1, self.l2 = float(l1), float(l2)

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        return self.l1 * torch.sum(_abs(p)) + self.l2 * torch.sum(p * p)


def get_regularizer(reg: Union[None, str, Callable]) -> Optional[Callable]:
    """``None`` or a callable as it is; ``"l1"``, ``"l2"``, ``"l1l2"``
    (``"l1_l2"``) at the default strengths."""
    if reg is None or callable(reg):
        return reg
    key = reg.lower()
    if key == "l1":
        return L1()
    if key == "l2":
        return L2()
    if key in ("l1l2", "l1_l2"):
        return L1L2()
    raise ValueError(f"unknown regularizer {reg!r}; use 'l1'|'l2'|'l1l2' or "
                     "a callable")


__all__ = ["L1", "L1L2", "L2", "get_regularizer"]
