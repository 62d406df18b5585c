"""A rank's blocks of the parameters, and how a module reads them.

In the JAX package a ``PartitionSpec`` is only a storage layout: GSPMD
gives every layout the same result. In the port a rank computes on its own
blocks, so each axis has a rule for how a module reads a leaf it holds
sharded. :func:`plan` gives every placed leaf its :class:`Placement`
(storage spec and compute layout), :func:`block_of` and :func:`whole_of`
cross between a whole leaf and a rank's block (placement, the checkpoint
gather and restore), and :func:`install` makes each module read its placed
leaves by these rules:

- **fsdp** (storage, gathered before use): the leaf keeps its ``1/fsdp``
  block. A module that reads it gets the block all-gathered
  (``comm.all_gather``), whose backward is a ``psum_scatter``: each rank
  gets back the sum over the fsdp ranks of its block's gradient. The
  gather happens at each read, in the module that reads, and what the
  backward saves of a gathered leaf is its block: inside :func:`gathering`
  a saved-tensor hook packs the whole leaf (or a view of it) as the stored
  block and gathers it again when the backward unpacks it. So the whole
  leaf lives from its read to the end of the op that reads it, and again
  in backward, and no rank holds every leaf whole at once, with or without
  remat (under remat the recomputed segments gather again in backward as
  well). Every rank's backward runs its nodes in the same order, so the
  regathers meet.
- **tp** (computed sharded): a module that computes Megatron-style over
  ``tp`` declares ``tp_compute_dims(tp) -> {leaf: (dim, perm)}``, the dim
  it splits each such leaf on. When any of those leaves is stored sharded
  over ``tp`` on that dim, the module computes in tp mode (its
  ``tp_mesh`` is set) and reads each of them as this rank's block along
  that dim: the stored block, or, for a leaf stored without tp there (a
  bias with no tp rule), the block taken at use through
  ``comm.shard_along``, whose backward all-gathers. ``perm`` reorders the
  dim first (the fused QKV columns, ``sharding.qkv_tp_permutation``); a
  leaf stored over tp on a permuted dim is stored permuted, and
  :func:`whole_of` puts the JAX layout back.
- Any other leaf stored over **tp**, read by a module that does not compute
  it over tp, is gathered at use through ``comm.gather_along``; its
  backward takes the rank's slice without summing, since tp ranks see the
  same batch. Correct, as GSPMD is, just not split.
- **dp**, **pp**, **sp** and **ep** blocks are read as they are: the
  module's own exchange handles them (row-sharded tables, pipeline
  stages).

A tuple entry's first axis is the major one, as in JAX: block ``i1 * n2 +
i2`` of ``(a1, a2)``. A module that reads a leaf differently from how it
is stored gets a subclass of its class whose ``__getattr__`` applies these
rules while :func:`gathering` is on (the Estimator's forward and backward,
``evaluate`` and ``predict``); elsewhere, and through ``named_parameters``
and ``state_dict`` always, a placed leaf is the rank's stored block.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import comm
from .sharding import P, entry_axes, spec_axes

_GATHERING = [0]
_LOCK = threading.Lock()
#: a leaf gathered whole by :meth:`Placement.view` -> (placement, block)
_WHOLE = WeakIdKeyDictionary()


class _Regather(NamedTuple):
    """What the backward saves of a gathered leaf, or of a view of it."""

    pl: "Placement"
    block: torch.Tensor
    size: torch.Size
    stride: tuple
    offset: int


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    src = _WHOLE.get(base)
    if src is None:
        # not ``t`` itself: a node that saves its own output would hold
        # the output that holds the node, a cycle that outlives the step
        # when the node never runs in backward
        return t.detach()
    return _Regather(src[0], src[1], t.size(), t.stride(), t.storage_offset())


def _unpack(x):
    if not isinstance(x, _Regather):
        return x
    with torch.no_grad():
        whole = x.pl.view(x.block)
    return whole.as_strided(x.size, x.stride, x.offset)


@contextlib.contextmanager
def gathering():
    """Placed modules read their leaves in the compute layout inside this
    context, and the backward of what runs in it saves a gathered leaf as
    its block (module docstring). The reads are process-wide, not per
    thread: autograd runs a card's backward (and the remat recompute in
    it) on a thread of its own."""
    with _LOCK:
        _GATHERING[0] += 1
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield
    finally:
        with _LOCK:
            _GATHERING[0] -= 1


def _entry(spec, d: int):
    return spec[d] if d < len(spec) else None


class Placement:
    """One leaf's layout on this rank: ``spec`` (the storage spec, axes of
    size 1 dropped), the ``mesh``, and, for a leaf its module computes over
    tp, ``tp_dim`` and the dim's column order ``perm``."""

    __slots__ = ("spec", "mesh", "tp_dim", "perm", "_perms")

    def __init__(self, spec: P, mesh, tp_dim: Optional[int] = None,
                 perm: Optional[np.ndarray] = None):
        self.spec = P(*spec)
        self.mesh = mesh
        self.tp_dim = tp_dim
        self.perm = None if perm is None else np.asarray(perm, np.int64)
        self._perms: Dict[Any, torch.Tensor] = {}

    def _gathered(self, d: int, axis: str) -> bool:
        return axis == "fsdp" or (axis == "tp" and d != self.tp_dim)

    @property
    def stored_permuted(self) -> bool:
        """Whether the stored blocks come from the permuted whole leaf."""
        return (self.perm is not None
                and "tp" in entry_axes(_entry(self.spec, self.tp_dim)))

    @property
    def reads_differ(self) -> bool:
        """Whether the module reads the leaf otherwise than it is stored."""
        if any(self._gathered(d, a) for d, e in enumerate(self.spec)
               for a in entry_axes(e)):
            return True
        return (self.tp_dim is not None
                and "tp" not in entry_axes(_entry(self.spec, self.tp_dim)))

    def check(self, name: str, shape) -> None:
        """Refuse a layout the reads cannot serve: a gathered axis major to
        a kept one on a dim, tp stored on a dim other than the computed
        one, a dim that does not split."""
        for d, e in enumerate(self.spec):
            flags = [self._gathered(d, a) for a in entry_axes(e)]
            if flags != sorted(flags):
                raise ValueError(f"param {name}: spec entry {e!r} gathers a "
                                 f"major axis and keeps a minor one")
            n = 1
            for a in entry_axes(e):
                n *= self.mesh.shape[a]
            if shape[d] % n:
                raise ValueError(f"param {name}: dim {d} of size {shape[d]} "
                                 f"does not split over {e!r}")
            if "tp" in entry_axes(e) and self.tp_dim not in (None, d):
                raise ValueError(f"param {name}: stored over tp on dim {d}, "
                                 f"computed over tp on dim {self.tp_dim}")
        if self.tp_dim is not None:
            tp = self.mesh.shape["tp"]
            if shape[self.tp_dim] % tp:
                raise ValueError(f"param {name}: dim {self.tp_dim} of size "
                                 f"{shape[self.tp_dim]} does not split over "
                                 f"tp={tp}")

    def _perm_on(self, device, inverse: bool = False) -> torch.Tensor:
        key = (str(device), inverse)
        t = self._perms.get(key)
        if t is None:
            p = np.argsort(self.perm) if inverse else self.perm
            t = self._perms[key] = torch.from_numpy(p).to(device)
        return t

    def view(self, stored: torch.Tensor) -> torch.Tensor:
        """The leaf as its module computes on it (module docstring)."""
        t = stored
        for d, e in enumerate(self.spec):
            for a in reversed(entry_axes(e)):
                if a == "fsdp":
                    t = comm.all_gather(t, a, dim=d, tiled=True,
                                        mesh=self.mesh)
                elif a == "tp" and d != self.tp_dim:
                    t = comm.gather_along(t, a, d, mesh=self.mesh)
        d = self.tp_dim
        if d is not None and "tp" not in entry_axes(_entry(self.spec, d)):
            if self.perm is not None:
                t = t.index_select(d, self._perm_on(t.device))
            t = comm.shard_along(t, "tp", d, mesh=self.mesh)
        elif t is not stored and torch.is_grad_enabled():
            _WHOLE[t] = (self, stored)
        return t


def block_of(whole: torch.Tensor, pl: Placement) -> torch.Tensor:
    """This rank's stored block of a whole leaf."""
    t = whole
    if pl.stored_permuted:
        t = t.index_select(pl.tp_dim, pl._perm_on(t.device))
    for d, e in enumerate(pl.spec):
        for a in entry_axes(e):
            ax = pl.mesh.axis(a)
            t = t.chunk(ax.size, d)[ax.index]
    return t.contiguous()


def whole_of(block: torch.Tensor, pl: Placement) -> torch.Tensor:
    """The whole leaf, in the JAX layout, from every rank's stored block
    (every rank calls it)."""
    t = block
    for d, e in enumerate(pl.spec):
        for a in reversed(entry_axes(e)):
            t = comm.all_gather(t, a, dim=d, tiled=True, mesh=pl.mesh)
    if pl.stored_permuted:
        t = t.index_select(pl.tp_dim, pl._perm_on(t.device, inverse=True))
    return t


def _local_params(model):
    """``(module, leaf, dotted name)`` of every parameter, by the module
    that holds it."""
    for prefix, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            yield module, leaf, (f"{prefix}.{leaf}" if prefix else leaf), p


def plan(model, specs: Dict[str, P], mesh) -> Dict[str, Placement]:
    """Every leaf's :class:`Placement` from its storage spec (``specs``:
    dotted name -> spec, axes of size 1 dropped; the leaves still whole),
    and each module that declares ``tp_compute_dims`` put in tp mode
    (``module.tp_mesh = mesh``) when one of those leaves is stored over tp
    on its compute dim. Leaves with neither a spec nor a tp compute dim are
    left out."""
    tp = mesh.shape.get("tp", 1)
    by_module: Dict[Any, list] = {}
    for module, leaf, name, p in _local_params(model):
        by_module.setdefault(module, []).append((leaf, name, p))
    out: Dict[str, Placement] = {}
    for module, leaves in by_module.items():
        dims = {}
        fn = getattr(module, "tp_compute_dims", None)
        if tp > 1 and fn is not None:
            dims = fn(tp)
            if any("tp" in entry_axes(_entry(specs.get(name, P()),
                                             dims[leaf][0]))
                   for leaf, name, _ in leaves if leaf in dims):
                module.tp_mesh = mesh
            else:
                dims = {}
        for leaf, name, p in leaves:
            spec = specs.get(name, P())
            d, perm = dims.get(leaf, (None, None))
            if not spec_axes(spec) and d is None:
                continue
            pl = Placement(spec, mesh, d, perm)
            pl.check(name, tuple(p.shape))
            out[name] = pl
    return out


class _Placed:
    """Reads the module's placed leaves through their placements while
    :func:`gathering` is on (mixed in ahead of the module's class)."""

    def __getattr__(self, name: str):
        placed = self.__dict__.get("_placed")
        if placed is not None and _GATHERING[0] and name in placed:
            return placed[name].view(self._parameters[name])
        return super().__getattr__(name)


_CLASSES: Dict[type, type] = {}


def _placed_class(cls: type) -> type:
    if issubclass(cls, _Placed):
        return cls
    sub = _CLASSES.get(cls)
    if sub is None:
        sub = _CLASSES[cls] = type(cls.__name__, (_Placed, cls), {
            "__module__": cls.__module__, "__qualname__": cls.__qualname__})
    return sub


def install(model, placements: Dict[str, Placement]) -> None:
    """Make every module that reads a placed leaf otherwise than it is
    stored read it through its placement (module docstring)."""
    for module, leaf, name, _ in _local_params(model):
        pl = placements.get(name)
        if pl is None or not pl.reads_differ:
            continue
        if "_placed" not in module.__dict__:
            module.__class__ = _placed_class(type(module))
            module._placed = {}
        module._placed[leaf] = pl


__all__ = ["Placement", "block_of", "gathering", "install", "plan",
           "whole_of"]
