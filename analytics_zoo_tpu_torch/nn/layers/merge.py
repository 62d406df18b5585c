"""Merge (port of ``analytics_zoo_tpu/nn/layers/merge.py``): every mode
of the JAX layer (``concat``, ``sum``, ``mul``, ``ave``, ``max``,
``min``, ``dot``, ``cos``) and the functional helper ``merge``."""

from __future__ import annotations

import torch

from ..module import Layer

_MODES = ("concat", "sum", "mul", "ave", "max", "min", "dot", "cos")


class Merge(Layer):
    """Merge a list of inputs: ``concat`` (``concat_axis`` 0-indexed over
    the non-batch dims), the elementwise ``sum``, ``mul``, ``ave``,
    ``max`` and ``min``, or over two inputs the last-axis ``dot`` and
    cosine (``cos``, each norm plus 1e-8), as (B, ..., 1)."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        mode = mode.lower()
        if mode not in _MODES:
            raise ValueError(f"unknown merge mode {mode!r}")
        self.mode = mode
        self.concat_axis = concat_axis

    def apply(self, xs):
        if not isinstance(xs, (list, tuple)) or len(xs) < 2:
            raise ValueError("Merge needs a list of >= 2 inputs")
        mode = self.mode
        if mode == "concat":
            axis = self.concat_axis if self.concat_axis < 0 \
                else self.concat_axis + 1
            return torch.cat(list(xs), dim=axis)
        if mode in ("dot", "cos"):
            a, b = xs
            if mode == "cos":
                a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
                         + 1e-8)
                b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True)
                         + 1e-8)
            return torch.sum(a * b, dim=-1, keepdim=True)
        op = {"sum": torch.add, "ave": torch.add, "mul": torch.mul,
              "max": torch.maximum, "min": torch.minimum}[mode]
        out = xs[0]
        for x in xs[1:]:
            out = op(out, x)
        return out / len(xs) if mode == "ave" else out

    def compute_output_shape(self, input_shapes):
        shapes = [tuple(s) for s in input_shapes]
        if self.mode == "concat":
            axis = self.concat_axis if self.concat_axis >= 0 \
                else len(shapes[0]) + self.concat_axis
            out = list(shapes[0])
            out[axis] = sum(s[axis] for s in shapes)
            return tuple(out)
        if self.mode in ("dot", "cos"):
            return (1,)
        return shapes[0]


def merge(inputs, mode: str = "sum", concat_axis: int = -1, name=None):
    """Functional-graph helper: ``merge([a, b], mode="concat")``."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(list(inputs))


__all__ = ["Merge", "merge"]
