"""Search-space primitives (port of ``automl/space.py``, numpy, copied):
the rebuild's ``ray.tune.choice/uniform/...``.

Samplers are tiny picklable objects sampled with a
``numpy.random.Generator``, so a search is deterministic given a seed and
draws the JAX package's configs exactly.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence

import numpy as np


class Sampler:
    def sample(self, rng: np.random.Generator):  # pragma: no cover - interface
        raise NotImplementedError


class Choice(Sampler):
    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    def __repr__(self):
        return f"Choice({self.values})"


class Uniform(Sampler):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    def __repr__(self):
        return f"Uniform({self.low}, {self.high})"


class LogUniform(Sampler):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


class QUniform(Sampler):
    """Uniform quantized to multiples of ``q`` (tune.quniform parity)."""

    def __init__(self, low: float, high: float, q: float = 1.0):
        self.low, self.high, self.q = float(low), float(high), float(q)

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return float(np.round(v / self.q) * self.q)


class RandInt(Sampler):
    def __init__(self, low: int, high: int):
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


class GridSearch:
    """Marks a dimension as exhaustively enumerated (tune.grid_search parity)."""

    def __init__(self, values: Sequence):
        self.values = list(values)


def grid_product(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand all GridSearch dims into the cross-product of partial configs."""
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    if not grid_keys:
        return [{}]
    combos = itertools.product(*[space[k].values for k in grid_keys])
    return [dict(zip(grid_keys, c)) for c in combos]


def sample_config(space: Dict[str, Any], rng: np.random.Generator,
                  fixed: Dict[str, Any] = None) -> Dict[str, Any]:
    """Draw one concrete config: samplers sampled, grid dims must be in ``fixed``."""
    out = {}
    for k, v in space.items():
        if fixed and k in fixed:
            out[k] = fixed[k]
        elif isinstance(v, Sampler):
            out[k] = v.sample(rng)
        elif isinstance(v, GridSearch):
            raise ValueError(f"grid dim {k!r} must be pre-expanded (see grid_product)")
        else:
            out[k] = v
    if fixed:
        for k, v in fixed.items():
            out.setdefault(k, v)
    return out


__all__ = ["Choice", "GridSearch", "LogUniform", "QUniform", "RandInt",
           "Sampler", "Uniform", "grid_product", "sample_config"]
