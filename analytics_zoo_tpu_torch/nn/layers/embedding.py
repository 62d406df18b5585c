"""Embedding layers (port of ``analytics_zoo_tpu/nn/layers/embedding.py``):
``Embedding``, ``FusedPairEmbedding``, ``SparseEmbedding``,
``WordEmbedding`` and ``load_glove_table``.

A lookup is ``F.embedding`` over the table: a gather forward, and a
backward whose gradient comes out in the table's dtype (bf16 under mixed
precision; the Estimator casts it up to f32 before the optimizer, as the
JAX step does). Parameters keep the JAX names: ``embeddings`` (a
parameter, or a buffer when the table is frozen, where the JAX package
keeps it in the state tree).

Ids must lie in the table: ``[0, input_dim)`` for ``Embedding``, and the
1-based ``[0, user_count)`` / ``[0, item_count)`` of ``FusedPairEmbedding``
(NeuralCF allocates ``count + 1`` rows for its 1-based ids). ``jnp.take``
fills an out-of-range id; on the card ``F.embedding`` stops the stream with
a device-side assert instead. No host check guards this, since it would
wait for the card on every step: in-range ids are the caller's contract.

A layer marked by ``parallel.embedding_sharding.shard_embedding_tables``
(its ``table_sharding``) whose table holds this rank's block of rows (the
Estimator places it) looks up through ``sharded_gather``: the model-
parallel exchange, zero rows for out-of-range ids. While its table is
still whole it takes the plain gather.

Over ``tp`` (the ``"embeddings"`` rule of ``TP_RULES``) a table is
vocab-parallel: the Estimator places its rows over tp and puts the layer
in tp mode (``tp_mesh``, ``parallel/placement.py``); tp ranks see the same
batch, so a lookup is the replicated-batch exchange of ``sharded_gather``
over ``tp``: the rows this rank owns, then one ``psum``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..module import Layer, get_initializer, param_dtype


class _VocabParallel:
    """A table whose rows a tp rank may hold (module docstring)."""

    #: the mesh whose ``tp`` axis the rows are placed over, or None
    tp_mesh = None

    def tp_compute_dims(self, tp: int):
        return {"embeddings": (0, None)}


def _ids(x) -> torch.Tensor:
    """Integer ids as a tensor (int32 and int64 pass through)."""
    x = torch.as_tensor(x)
    if x.dtype in (torch.int32, torch.int64):
        return x
    return x.to(torch.int64)


def _lookup(layer, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if layer.tp_mesh is not None:
        from ...parallel.embedding_sharding import sharded_gather

        return sharded_gather(table, ids, layer.tp_mesh, "tp",
                              shard_batch=False)
    ts = getattr(layer, "table_sharding", None)
    if ts is not None:
        from ...parallel.embedding_sharding import (sharded_gather,
                                                    table_rows)

        n = ts.mesh.shape.get(ts.axis, 1)
        if n > 1 and table.shape[0] * n == table_rows(layer):
            return sharded_gather(table, ids, ts.mesh, ts.axis,
                                  shard_batch=ts.shard_batch)
    return F.embedding(ids, table)


class Embedding(_VocabParallel, Layer):
    """Lookup table ``(input_dim, output_dim)``; input is int ids ``(B,
    ...)``, output ``(B, ..., output_dim)``. ``weights``: a pretrained
    table; ``trainable=False`` keeps the table as a buffer."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 weights: Optional[np.ndarray] = None, trainable: bool = True,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init = get_initializer(init)
        self.pretrained = weights
        self.trainable = trainable

    def build(self, input_shape, gen: torch.Generator) -> None:
        shape = (self.input_dim, self.output_dim)
        if self.pretrained is not None:
            table = torch.as_tensor(np.asarray(self.pretrained)).to(
                param_dtype())
            if tuple(table.shape) != shape:
                raise ValueError(f"pretrained weights {tuple(table.shape)} "
                                 f"!= {shape}")
        else:
            table = self.init(gen, shape)
        if self.trainable:
            self.embeddings = nn.Parameter(table)
        else:
            self.register_buffer("embeddings", table)
        self.built = True

    def apply(self, x):
        return _lookup(self, self.embeddings, _ids(x))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class FusedPairEmbedding(_VocabParallel, Layer):
    """All of NeuralCF's embedding tables in one gather.

    The four logical tables (mlp_user, mlp_item, mf_user, mf_item) live in
    one ``(user_count + item_count, W)`` table, the item rows offset by
    ``user_count``, so a ``(B, 2)`` batch of ``[user, item]`` ids embeds
    with a single lookup. Row layout: ``[mlp section (max(user_mlp_dim,
    item_mlp_dim) columns) | mf section (mf_dim columns)]``. Output:
    ``[user_mlp | item_mlp | mf_user * mf_item]`` of width ``user_mlp_dim +
    item_mlp_dim + mf_dim`` (``mf_dim=0``: the MLP part only), in the
    table's dtype."""

    def __init__(self, user_count: int, item_count: int,
                 user_mlp_dim: int, item_mlp_dim: int, mf_dim: int = 0,
                 init="normal", name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.user_mlp_dim = int(user_mlp_dim)
        self.item_mlp_dim = int(item_mlp_dim)
        self.mf_dim = int(mf_dim)
        self.init = get_initializer(init)
        self._mlp_width = max(self.user_mlp_dim, self.item_mlp_dim)

    @property
    def width(self) -> int:
        return self._mlp_width + self.mf_dim

    def build(self, input_shape, gen: torch.Generator) -> None:
        rows = self.user_count + self.item_count
        self.embeddings = nn.Parameter(self.init(gen, (rows, self.width)))
        self.built = True

    def apply(self, x):
        ids = _ids(x)                                   # (B, 2)
        flat = torch.stack((ids[:, 0], ids[:, 1] + self.user_count), dim=1)
        rows = _lookup(self, self.embeddings, flat)     # (B, 2, W)
        u, i = rows[:, 0, :], rows[:, 1, :]
        parts = [u[:, :self.user_mlp_dim], i[:, :self.item_mlp_dim]]
        if self.mf_dim:
            parts.append(u[:, self._mlp_width:] * i[:, self._mlp_width:])
        return torch.cat(parts, dim=-1)

    def compute_output_shape(self, input_shape):
        return (self.user_mlp_dim + self.item_mlp_dim + self.mf_dim,)


class SparseEmbedding(Embedding):
    """The reference's SparseEmbedding: the same lookup and gradient (an
    alias, as in the JAX package)."""


class WordEmbedding(Embedding):
    """Frozen pretrained word-embedding table (GloVe)."""

    def __init__(self, input_dim: int, output_dim: int,
                 weights: Optional[np.ndarray] = None, name=None,
                 input_shape=None):
        super().__init__(input_dim, output_dim, weights=weights,
                         trainable=False, name=name, input_shape=input_shape)

    @staticmethod
    def from_glove(path: str, word_index: dict, output_dim: int = 100):
        """A frozen table from a GloVe text file and a word index."""
        table = load_glove_table(path, word_index, output_dim)
        return WordEmbedding(table.shape[0], output_dim, weights=table)


def load_glove_table(path: str, word_index: dict, output_dim: int,
                     randomize_unknown: bool = False,
                     normalize: bool = False) -> np.ndarray:
    """Parse a GloVe text file into a ``(vocab, output_dim)`` f32 table
    (numpy, the JAX package's draws for unknown words).

    ``randomize_unknown`` draws unknown rows from U(-0.25, 0.25) (row 0
    zero) instead of N(0, 0.05); ``normalize`` L2-normalizes every row.
    Raises if no vector of the file has width ``output_dim``.
    """
    vocab = max(word_index.values()) + 1
    rng = np.random.RandomState(0)
    if randomize_unknown:
        table = rng.uniform(-0.25, 0.25, (vocab, output_dim)).astype("float32")
        table[0] = 0.0
    else:
        table = rng.normal(0, 0.05, (vocab, output_dim)).astype("float32")
    matched, widths = 0, set()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            w, vec = parts[0], parts[1:]
            widths.add(len(vec))
            if w in word_index and len(vec) == output_dim:
                table[word_index[w]] = np.asarray(vec, dtype="float32")
                matched += 1
    if matched == 0:
        raise ValueError(
            f"no embedding in {path} matched output_dim={output_dim} "
            f"(file vector widths seen: {sorted(widths)}) for the given "
            f"word_index")
    if normalize:
        norms = np.linalg.norm(table, axis=1, keepdims=True)
        table = table / np.where(norms == 0, 1.0, norms)
    return table


__all__ = ["Embedding", "FusedPairEmbedding", "SparseEmbedding",
           "WordEmbedding", "load_glove_table"]
