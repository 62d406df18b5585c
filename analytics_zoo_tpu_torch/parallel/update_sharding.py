"""Weight-update sharding (ZeRO-1) over the ``dp`` axis, and master
weights for mixed precision (port of ``parallel/update_sharding.py``).

BigDL's ``AllReduceParameter`` slices the flat parameter vector across
nodes, reduces each gradient slice to its owner, runs the optimizer on
that slice only and broadcasts the updated slices back. Per step that is

    reduce-scatter(grads) → shard-local optimizer update → all-gather(params)

and the optimizer state (with the f32 masters of the mixed-precision path)
shrinks to ``1/dp`` a rank. Two layouts, chosen by the Estimator:

* **flat** (a pure-dp mesh, no ``param_sharding``): every gradient leaf is
  flattened into one zero-padded f32 vector in the JAX package's leaf order
  (:func:`flat_meta`), one tiled ``psum_scatter`` hands each rank its
  slice, the optimizer updates the slice against the rank's flat state,
  and one tiled ``all_gather`` in the model's dtype rebuilds the params
  (:func:`flat_exchange`). Gradient accumulation sums micro-steps locally
  first, so K micro-steps still cost one reduce-scatter and one
  all-gather (the global norm rides one scalar all-reduce).
* **per-leaf** (``"gspmd"`` in JAX, where the partitioner places the
  collectives): each leaf's spec is extended with ``dp`` on its largest
  divisible dim (:func:`shard_spec_over_axis`, rows first for 2-D leaves),
  and the Estimator reduce-scatters that leaf's gradient along that dim,
  updates the shard and all-gathers it; a leaf nothing divides is
  all-reduced and updated whole, and a leaf already sharded over ``dp``
  (a row-sharded table) keeps its rows local.

:func:`with_master_weights` wraps an optimizer so the f32 masters live only
in its state (the replicated layout's mixed precision).

The optimizers of the port run over dicts of tensors; the flat state is
the inner optimizer's state over ``{FLAT: shard}``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..nn.optimizers import GradientTransformation, Params, apply_updates
from .sharding import P

#: the one key of the flat optimizer's param dict
FLAT = "flat"

#: a comm probe's vector is capped at 16M f32 elements (64 MiB)
PROBE_MAX_ELEMS = 16 * 1024 * 1024


# --------------------------------------------------------- per-leaf specs
def shard_spec_over_axis(spec, shape: Sequence[int], mesh,
                         axis: str = "dp") -> P:
    """``spec`` extended with ``axis`` on the largest divisible dim: an
    unsharded dim first (for 2-D leaves the row dim wins ties, since row
    sharding is what the sharded gather and row deltas key on); else an
    already-sharded dim whose combined product still divides; else the
    spec unchanged (a replicated update)."""
    size = mesh.shape.get(axis, 1)
    shape = tuple(shape)
    spec = P(*(spec or ()))
    if size <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries = entries[: len(shape)]
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                used.add(a)
    if axis in used:
        return P(*entries)

    def axprod(e) -> int:
        p = 1
        for a in (e if isinstance(e, tuple) else ((e,) if e else ())):
            p *= mesh.shape[a]
        return p

    if len(shape) == 2:
        order = [0, 1]
    else:
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % size == 0:
            entries[i] = axis
            return P(*entries)
    for i in order:
        cur = axprod(entries[i])
        if entries[i] is not None and shape[i] % (cur * size) == 0:
            e = entries[i] if isinstance(entries[i], tuple) else (entries[i],)
            entries[i] = e + (axis,)
            return P(*entries)
    return P(*entries)


def make_update_sharding(mesh, base_rule: Optional[Callable] = None,
                         axis: str = "dp") -> Callable:
    """``(path, leaf) -> P`` for the optimizer state: the param's base spec
    (or replicated) plus ``axis`` on the largest divisible dim."""

    def rule(path, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        base = base_rule(path, leaf) if base_rule is not None else P()
        return shard_spec_over_axis(base, shape, mesh, axis)

    return rule


def dp_dim(spec, axis: str = "dp") -> Optional[int]:
    """The dim a spec shards over ``axis`` (None when it does not)."""
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


# --------------------------------------------------------------- flat layout
def leaf_order(names) -> list:
    """Dotted names in the JAX package's leaf order (a nested dict
    flattens in the lexicographic order of its key paths)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


class FlatParamMeta(NamedTuple):
    """The flat-vector layout of a param dict: leaf names in JAX's order,
    their shapes, sizes and dtypes, and the total length padded to a
    multiple of the shard count."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtypes: Tuple[torch.dtype, ...]
    n: int
    npad: int
    n_shards: int

    @property
    def shard_size(self) -> int:
        return self.npad // self.n_shards

    @property
    def gather_dtype(self) -> torch.dtype:
        """The all-gather's dtype: the params' one dtype, else f32."""
        return self.dtypes[0] if len(set(self.dtypes)) == 1 \
            else torch.float32


class FlatUpdateState(NamedTuple):
    """The flat exchange's optimizer state on one rank: the inner
    optimizer's state over ``{FLAT: shard}`` and the f32 master shard
    (``None`` for f32 params, whose shard is re-sliced each step)."""

    inner_state: Any
    master: Optional[torch.Tensor]


class MasterWeightsState(NamedTuple):
    inner_state: Any
    master: Params


def flat_meta(params: Dict[str, torch.Tensor], n_shards: int
              ) -> FlatParamMeta:
    names = tuple(leaf_order(params))
    shapes = tuple(tuple(params[n].shape) for n in names)
    sizes = tuple(math.prod(s) for s in shapes)
    dtypes = tuple(params[n].dtype for n in names)
    n = int(sum(sizes))
    npad = -(-n // n_shards) * n_shards
    return FlatParamMeta(names, shapes, sizes, dtypes, n, npad, n_shards)


def flatten_tree(tree: Dict[str, torch.Tensor], meta: FlatParamMeta,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A param dict as one (npad,) vector in ``dtype`` (zero tail)."""
    parts = [tree[n].reshape(-1).to(dtype) for n in meta.names]
    if meta.npad > meta.n:
        parts.append(torch.zeros(meta.npad - meta.n, dtype=dtype,
                                 device=parts[0].device))
    return torch.cat(parts)


def unflatten_tree(vec: torch.Tensor, meta: FlatParamMeta
                   ) -> Dict[str, torch.Tensor]:
    """An (npad,) vector as the param dict, each leaf in its shape and
    dtype."""
    out, off = {}, 0
    for name, shape, size, dt in zip(meta.names, meta.shapes, meta.sizes,
                                     meta.dtypes):
        out[name] = vec[off:off + size].reshape(shape).to(dt)
        off += size
    return out


def shard_of(vec: torch.Tensor, meta: FlatParamMeta, index: int
             ) -> torch.Tensor:
    s = meta.shard_size
    return vec[index * s:(index + 1) * s]


def flat_opt_init(tx: GradientTransformation, params, meta: FlatParamMeta,
                  keep_master: bool, index: int = 0) -> FlatUpdateState:
    """Shard ``index``'s state: the inner optimizer's over that slice of
    the flat f32 vector, and (``keep_master``) the slice as the master."""
    shard = shard_of(flatten_tree(params, meta), meta, index).clone()
    return FlatUpdateState(tx.init({FLAT: shard}),
                           shard if keep_master else None)


def flat_exchange(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], opt_state: FlatUpdateState,
                  meta: FlatParamMeta, tx: GradientTransformation, *,
                  axis: str = "dp", mesh=None,
                  clip_norm: Optional[float] = None,
                  clip_value: Optional[tuple] = None):
    """One weight-update exchange on this rank; ``grads`` are its local
    mean gradients. Returns ``(new_params, new_opt_state, grad_norm)``
    with the f32 global pre-clip norm. One ``psum_scatter`` in (the mean
    over ranks), the norm's scalar ``psum``, the update against the master
    shard, one tiled ``all_gather`` out in the model's dtype."""
    from . import comm

    n = comm.axis_size(axis, mesh)
    idx = comm.axis_index(axis, mesh)
    gflat = flatten_tree(grads, meta)
    gshard = comm.psum_scatter(gflat, axis, dim=0, tiled=True,
                               mesh=mesh) / n
    gnorm = torch.sqrt(comm.psum(torch.sum(gshard * gshard), axis,
                                 mesh=mesh))
    if clip_norm is not None:
        # f32 global-norm clipping across the shards (a clipping
        # transformation would see one shard's norm)
        gshard = gshard * torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
    if clip_value is not None:
        lo, hi = clip_value
        gshard = torch.clamp(gshard, lo, hi)
    if opt_state.master is not None:
        master = opt_state.master
    else:
        master = shard_of(flatten_tree(params, meta), meta, idx)
    updates, inner = tx.update({FLAT: gshard}, opt_state.inner_state,
                               {FLAT: master})
    master2 = apply_updates({FLAT: master}, updates)[FLAT]
    new_flat = comm.all_gather(master2.to(meta.gather_dtype), axis, dim=0,
                               tiled=True, mesh=mesh)
    new_opt = FlatUpdateState(inner, master2 if opt_state.master is not None
                              else None)
    return unflatten_tree(new_flat, meta), new_opt, gnorm


# ------------------------------------------------- master weights
def with_master_weights(tx: GradientTransformation) -> GradientTransformation:
    """Wrap ``tx`` so f32 masters live in (and only in) its state: the
    update takes f32 grads, runs ``tx`` against the masters and returns
    the NEW low-precision params as its "updates"."""

    def init(params: Params) -> MasterWeightsState:
        master = {n: p.detach().float().clone() if p.is_floating_point()
                  else p for n, p in params.items()}
        return MasterWeightsState(tx.init(master), master)

    def update(grads: Params, state: MasterWeightsState, params=None):
        g32 = {n: g.float() for n, g in grads.items()}
        updates, inner = tx.update(g32, state.inner_state, state.master)
        master = apply_updates(state.master, updates)
        if params is not None:
            new_params = {n: m.to(params[n].dtype) for n, m in master.items()}
        else:
            new_params = master
        return new_params, MasterWeightsState(inner, master)

    return GradientTransformation(init, update)


# ------------------------------------------------------------------ probe
def make_comm_probe(n_elems: int, axis: str = "dp", sharded: bool = False,
                    *, mesh=None, device="cpu"):
    """A one-round gradient-exchange probe over an ``n_elems`` f32 vector
    (capped at :data:`PROBE_MAX_ELEMS`): ``psum``, or ``psum_scatter`` and
    a tiled ``all_gather``. Returns ``(fn, vec)``; time ``fn(vec)`` (it
    waits for the device). Every rank of the axis must call it together;
    its collectives count like any other."""
    from . import comm

    n = comm.axis_size(axis, mesh)
    n_elems = min(max(1, int(n_elems)), PROBE_MAX_ELEMS)
    vec = torch.ones(-(-n_elems // n) * n, dtype=torch.float32,
                     device=device)

    def fn(v):
        if sharded:
            s = comm.psum_scatter(v, axis, dim=0, tiled=True, mesh=mesh)
            out = comm.all_gather(s, axis, dim=0, tiled=True, mesh=mesh)
        else:
            out = comm.psum(v, axis, mesh=mesh)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return out

    fn(vec)                                 # warm: the first round's setup
    return fn, vec


__all__ = ["FLAT", "FlatParamMeta", "FlatUpdateState", "MasterWeightsState",
           "PROBE_MAX_ELEMS", "dp_dim", "flat_exchange", "flat_meta",
           "flat_opt_init", "flatten_tree", "leaf_order", "make_comm_probe",
           "make_update_sharding", "shard_of", "shard_spec_over_axis",
           "unflatten_tree", "with_master_weights"]
