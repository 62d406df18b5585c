"""In-memory dataset of array trees (port of ``data/featureset.py``).

The parts the training path needs: ``FeatureSet(data)`` /
:meth:`FeatureSet.from_numpy`, the per-epoch permutation
:meth:`~FeatureSet.shuffle_indices` — the JAX package's own
``default_rng(seed + epoch * 1_000_003)``, so a shuffled epoch visits the
examples in the JAX order — and :meth:`~FeatureSet.batches`, a synchronous
loader that drops the remainder batch in training. Batches are host numpy
arrays; the Estimator moves them to the card.

Not ported yet: the disk and PMEM tiers, multi-host sharding, the byte,
TFRecord, DataFrame and generator constructors, and the background
prefetch loader (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


class FeatureSet:
    """An immutable in-memory dataset of array trees sharing a leading
    dimension."""

    def __init__(self, data, memory_type: str = "DRAM", seed: int = 0):
        if memory_type != "DRAM":
            raise NotImplementedError(
                f"memory_type {memory_type!r}: only DRAM is ported (the disk "
                f"and PMEM tiers are ROADMAP Queue 1, item 12)")
        leaves = _tree_leaves(data)
        if not leaves:
            raise ValueError("empty FeatureSet")
        n = leaves[0].shape[0]
        if any(leaf.shape[0] != n for leaf in leaves):
            raise ValueError("all arrays must share the leading dimension")
        self.memory_type = memory_type
        self.seed = seed
        self.data = data
        self._n_total = n

    @classmethod
    def from_numpy(cls, x, y=None, **kw) -> "FeatureSet":
        """Build from feature array(s) and optional label array(s)."""
        data = (x,) if y is None else (x, y)
        return cls(data, **kw)

    def size(self) -> int:
        return self._n_total

    def __len__(self) -> int:
        return self._n_total

    def shuffle_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch * 1_000_003)
        return rng.permutation(self._n_total)

    def num_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self._n_total // batch_size
        return math.ceil(self._n_total / batch_size)

    def batches(self, batch_size: int, *, epoch: int = 0,
                shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator:
        """Yield every batch of the epoch as a tree of numpy arrays, in the
        epoch's shuffled order (or in order), remainder dropped unless
        ``drop_remainder=False``."""
        idx = (self.shuffle_indices(epoch) if shuffle
               else np.arange(self._n_total))
        for b in range(self.num_batches(batch_size, drop_remainder)):
            sel = idx[b * batch_size:(b + 1) * batch_size]
            if not shuffle:
                lo, hi = b * batch_size, b * batch_size + len(sel)
                yield _tree_map(lambda a: a[lo:hi], self.data)
            else:
                yield _tree_map(lambda a: np.asarray(a)[sel], self.data)


__all__ = ["FeatureSet"]
