"""Row-sharded embedding tables with a model-parallel gather (port of
``parallel/embedding_sharding.py``).

A table is sharded by ROWS over a mesh axis: rank r holds the contiguous
rows ``owned_row_range(rows, n, r)`` (the Estimator places them from a
``param_sharding`` rule whose spec is ``P(axis, None)``). In training,
where each rank holds its block of the batch, a lookup is

    all-gather(ids)  →  owner-rank partial gather  →  reduce-scatter(rows)

so every rank sees the whole batch's ids, gathers the rows it owns (zeros
elsewhere), and one tiled ``psum_scatter`` both sums the partials (each id
has one owner, so the sum is an exact select) and hands each rank its
batch block back. The backward is its transpose: the row gradients are
all-gathered and scatter-added into the LOCAL rows only, so no rank ever
holds a dense ``(vocab, embed)`` gradient. With a replicated batch
(evaluation, serving on a training mesh) each rank gathers its owned rows
for the whole batch and one ``psum`` rebuilds the replicated rows.

Out-of-range ids come back as ZERO rows (no rank owns them), unlike a plain
gather. Marking is per layer instance (:func:`shard_embedding_tables`): a
serving copy of the same architecture keeps the plain gather.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import comm
from .sharding import P, path_keys

__all__ = [
    "TableSharding", "owned_row_range", "pad_rows", "row_shard_spec",
    "shard_embedding_tables", "sharded_gather", "sharded_table_layers",
]


class TableSharding(NamedTuple):
    """A marked layer's layout: the mesh, the row axis and whether the
    training exchange (batch-sharded ids) applies."""

    mesh: Any
    axis: str = "dp"
    shard_batch: bool = True


def pad_rows(rows: int, n_shards: int) -> int:
    """The smallest row count >= ``rows`` divisible by ``n_shards``."""
    return -(-int(rows) // n_shards) * n_shards


def owned_row_range(rows: int, n_shards: int, shard: int) -> Tuple[int, int]:
    """The global ``[lo, hi)`` rows ``shard`` owns."""
    per = rows // n_shards
    return shard * per, (shard + 1) * per


def row_shard_spec(shape, mesh, axis: str = "dp") -> P:
    """``P(axis, None)`` when the rows divide the axis, else replicated."""
    n = mesh.shape.get(axis, 1)
    if len(shape) == 2 and n > 1 and shape[0] % n == 0:
        return P(axis, None)
    return P(*([None] * len(shape)))


def _owned_partial(local_table, all_ids, lo: int):
    loc = all_ids - lo
    ok = (loc >= 0) & (loc < local_table.shape[0])
    part = F.embedding(torch.where(ok, loc, torch.zeros_like(loc)),
                       local_table)
    return torch.where(ok[:, None], part,
                       torch.zeros((), dtype=part.dtype, device=part.device))


def sharded_gather(table: torch.Tensor, ids, mesh, axis: str = "dp", *,
                   shard_batch: bool = True) -> torch.Tensor:
    """Rows for ``ids`` from a row-sharded table whose block this rank
    holds as ``table`` ``(rows / n, W)``: ``ids.shape + (W,)``.
    ``shard_batch`` and a training step on this rank's block of the batch
    over ``axis`` (``comm.batch_shard``): the training exchange; otherwise
    the replicated one. A trivial axis is a plain gather of the whole
    table."""
    ids = torch.as_tensor(ids, device=table.device).long()
    out_shape = tuple(ids.shape) + (table.shape[1],)
    flat = ids.reshape(-1)
    ax = comm.get_axis(axis, mesh)
    if ax.size <= 1 or ax.group is None:
        return F.embedding(flat, table).reshape(out_shape)
    lo = ax.index * table.shape[0]
    shard = comm.current_batch_shard()
    if shard_batch and shard is not None and axis in shard.axis:
        all_ids = comm.all_gather(flat, axis, dim=0, tiled=True, mesh=mesh)
        part = _owned_partial(table, all_ids, lo)
        out = comm.psum_scatter(part, axis, dim=0, tiled=True, mesh=mesh)
    else:
        out = comm.reduce_from(_owned_partial(table, flat, lo), axis,
                               mesh=mesh)
    return out.reshape(out_shape)


def sharded_table_layers(model) -> List[Any]:
    """The embedding layers of ``model`` (recursing through containers)
    whose 2-D ``embeddings`` table can shard."""
    from ..nn.layers.embedding import Embedding, FusedPairEmbedding

    out, stack, seen = [], [model], set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        for layer in getattr(node, "layers", []) or []:
            if isinstance(layer, (Embedding, FusedPairEmbedding)):
                out.append(layer)
            elif getattr(layer, "layers", None):
                stack.append(layer)
    return out


def table_rows(layer) -> int:
    """A table's global row count."""
    if hasattr(layer, "user_count"):
        return int(layer.user_count + layer.item_count)
    return int(layer.input_dim)


def shard_embedding_tables(model, mesh, *, axis: str = "dp",
                           min_rows: int = 0,
                           shard_batch: bool = True) -> Callable:
    """Mark every divisible embedding table of ``model`` for the sharded
    gather and return the ``(name, leaf) -> P`` rule that shards those
    ``embeddings`` leaves ``P(axis, None)`` (the Estimator's
    ``param_sharding``); everything else replicates. Tables whose rows do
    not divide the axis (pad the vocab with :func:`pad_rows`) or fall under
    ``min_rows`` stay replicated."""
    n = mesh.shape.get(axis, 1)

    def eligible(rows: int) -> bool:
        return n > 1 and rows % n == 0 and rows >= min_rows

    marked_shapes = set()
    for layer in sharded_table_layers(model):
        rows = table_rows(layer)
        if eligible(rows):
            layer.table_sharding = TableSharding(mesh, axis, shard_batch)
            marked_shapes.add(rows)

    def rule(path, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        keys = path_keys(path)
        if (len(shape) == 2 and keys and keys[-1] == "embeddings"
                and shape[0] in marked_shapes and eligible(shape[0])):
            return P(axis, None)
        return P(*([None] * len(shape)))

    return rule
