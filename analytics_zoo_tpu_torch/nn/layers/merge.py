"""Merge (port of ``analytics_zoo_tpu/nn/layers/merge.py``): the modes
``sum`` and ``concat`` that the ported backbones and NeuralCF use, and
the functional helper ``merge``."""

from __future__ import annotations

import torch

from ..module import Layer

_PORTED = ("concat", "sum")
_MODES = ("concat", "sum", "mul", "ave", "max", "min", "dot", "cos")


class Merge(Layer):
    """Merge a list of inputs: ``concat`` (``concat_axis`` 0-indexed over
    the non-batch dims) or ``sum``."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        mode = mode.lower()
        if mode not in _MODES:
            raise ValueError(f"unknown merge mode {mode!r}")
        if mode not in _PORTED:
            raise NotImplementedError(
                f"merge mode {mode!r} is not ported (ported: {_PORTED}; the "
                f"rest is ROADMAP Queue 1, item 11)")
        self.mode = mode
        self.concat_axis = concat_axis

    def apply(self, xs):
        if not isinstance(xs, (list, tuple)) or len(xs) < 2:
            raise ValueError("Merge needs a list of >= 2 inputs")
        if self.mode == "concat":
            axis = self.concat_axis if self.concat_axis < 0 \
                else self.concat_axis + 1
            return torch.cat(list(xs), dim=axis)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    def compute_output_shape(self, input_shapes):
        shapes = [tuple(s) for s in input_shapes]
        if self.mode == "concat":
            axis = self.concat_axis if self.concat_axis >= 0 \
                else len(shapes[0]) + self.concat_axis
            out = list(shapes[0])
            out[axis] = sum(s[axis] for s in shapes)
            return tuple(out)
        return shapes[0]


def merge(inputs, mode: str = "sum", concat_axis: int = -1, name=None):
    """Functional-graph helper: ``merge([a, b], mode="concat")``."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(list(inputs))


__all__ = ["Merge", "merge"]
