"""Parameter-sharding rules (port of ``parallel/sharding.py``): the tensor
parallel ``TP_RULES``, ``make_param_sharding``, ``replicated`` and the spec
sanitizer, as pure functions over specs.

A spec is a :class:`P`, the port's ``PartitionSpec``: a tuple with one
entry a dim, each ``None`` (replicated), an axis name or a tuple of axis
names. A rule is ``(path, leaf) -> P``; ``path`` is the parameter's dotted
name in the port (a JAX key path works too: its keys are joined with
``/``), and matching is by substring, as in JAX.

The Estimator places every leaf by its spec (``parallel/placement.py``):
each rank keeps its block, ``fsdp`` blocks are gathered at use and ``tp``
blocks are computed on Megatron-style by the modules that declare it.
:func:`qkv_tp_permutation` is the one column order of a fused QKV
projection under ``tp``: the placement, the checkpoint gather and restore
and the layers all go through it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


class P(tuple):
    """``P("dp", None)``: the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


TP_RULES: Tuple[Tuple[str, P], ...] = (
    ("qkv_kernel", P("fsdp", "tp")),
    ("mlp_up_kernel", P("fsdp", "tp")),
    ("out_kernel", P("tp", "fsdp")),
    ("mlp_down_kernel", P("tp", "fsdp")),
    ("token_embeddings", P("tp", None)),
    ("embeddings", P("tp", None)),
    ("logits_kernel", P("fsdp", "tp")),
)


def path_str(path) -> str:
    """A rule's path as one string: a dotted name as it is, a JAX key path
    joined with ``/``."""
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def path_keys(path) -> Tuple[str, ...]:
    if isinstance(path, str):
        return tuple(path.split("."))
    return tuple(str(getattr(p, "key", getattr(p, "name", p))) for p in path)


def _fits(size: int, axis, mesh) -> bool:
    if axis is None:
        return True
    ax_size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        ax_size *= mesh.shape[a]
    return size % ax_size == 0


def _sanitize(spec: P, shape, mesh, path: Optional[str] = None) -> P:
    """``spec`` adapted to ``shape``: a single axis that does not divide a
    dim replicates that dim; a tuple of axes that does not divide it
    raises, naming the parameter."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, axes[: len(shape)]):
        if isinstance(axis, tuple) and not _fits(dim, axis, mesh):
            sizes = {a: mesh.shape[a] for a in axis}
            raise ValueError(
                f"param {path or '<unknown>'}: dim of size {dim} cannot be "
                f"sharded over combined mesh axes {axis} (sizes {sizes}, "
                f"product {int(np.prod(list(sizes.values())))}) — the "
                f"combined axes must divide the dim; fix the sharding rule "
                f"or the mesh layout")
        out.append(axis if _fits(dim, axis, mesh) else None)
    return P(*out)


def make_param_sharding(mesh, rules: Sequence[Tuple[str, P]] = TP_RULES,
                        fsdp_default: bool = True) -> Callable:
    """``(path, leaf) -> P``: the first rule whose needle is in the path,
    sanitized; else (``fsdp_default``) the largest divisible dim over
    ``fsdp``; else replicated."""
    fsdp_size = mesh.shape.get("fsdp", 1)

    def rule(path, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return P()
        pstr = path_str(path)
        for needle, spec in rules:
            if needle in pstr:
                return _sanitize(spec, shape, mesh, path=pstr)
        if fsdp_default and fsdp_size > 1:
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
                    axes = [None] * len(shape)
                    axes[i] = "fsdp"
                    return P(*axes)
        return P()

    return rule


def qkv_tp_permutation(hidden_size: int, n_head: int, tp: int
                       ) -> np.ndarray:
    """The column order of a fused ``(d, 3 * hidden_size)`` QKV projection
    (columns read as ``(3, n_head, head_dim)``, the JAX layout) that puts
    each tp rank's heads' q, k and v side by side: the contiguous ``1/tp``
    block ``r`` of ``W[:, perm]`` holds q, then k, then v of heads
    ``r * n_head / tp`` up to ``(r + 1) * n_head / tp``. A contiguous block
    of the JAX layout holds no whole head (at tp=4 rank 0 would hold q of
    heads 0-11 and nothing of k or v)."""
    if n_head % tp:
        raise ValueError(f"n_head={n_head} does not split over tp={tp}: a "
                         f"tp rank attends over whole heads")
    cols = np.arange(3 * hidden_size).reshape(3, tp, hidden_size // tp)
    return np.ascontiguousarray(cols.transpose(1, 0, 2).reshape(-1))


def replicated(mesh) -> Callable:
    return lambda path, leaf: P()


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis name a spec mentions, in order."""
    out = []
    for e in spec or ():
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out.append(a)
    return tuple(out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes one spec entry names, the major one first."""
    if entry is None:
        return ()
    return tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                 if a is not None)


__all__ = ["P", "TP_RULES", "entry_axes", "make_param_sharding", "path_keys",
           "path_str", "qkv_tp_permutation", "replicated", "spec_axes"]
