"""Collectives over the mesh's named axes: the port's counterparts of the
``jax.lax`` collectives that the JAX package calls inside ``shard_map``.

The port is multi-controller: every rank is a process running the same
program on its own block of the data, and each mesh axis is a
``torch.distributed`` process group of the ranks that differ only in that
axis's coordinate (``common/context.py::Mesh``). The collectives:

- :func:`axis_index`, :func:`axis_size`;
- :func:`ppermute` (``(src, dst)`` pairs over axis coordinates; a rank
  that no pair sends to receives zeros, as in JAX);
- :func:`all_gather` (``tiled``: concatenated along ``dim``, else stacked
  on a new ``dim``), :func:`psum`, :func:`pmax` (not differentiable: the
  shift of a vocab-parallel softmax), :func:`psum_scatter` (``tiled``: the
  ``dim`` split into equal blocks, else a dim of size n dropped) and
  :func:`all_to_all` (split ``split_dim`` into n blocks, block i to
  coordinate i, the received blocks concatenated on ``concat_dim``);
- :func:`batch_psum`: a :func:`psum` over the batch axes of the step
  running in this thread (:func:`batch_shard`), the global statistics of
  BatchNormalization in training.

Each is a ``torch.autograd.Function`` whose backward is its transpose:
``ppermute`` the inverse permutation, ``all_gather`` ``psum_scatter`` and
back, ``psum`` ``psum``, ``all_to_all`` the inverse ``all_to_all``.

JAX's ``shard_map`` takes a replicated global array apart into blocks and
puts the blocks back together; its transpose rule corrects the cotangent of
a replicated output for the devices that hold it. A rank of the port has
no global view, so the model code uses conjugate pairs that keep every
tensor outside a sharded region replicated and identical on the axis's
ranks, with gradients that are whole on every rank:

- :func:`shard_along`: this rank's block of a replicated tensor; backward
  all-gathers the blocks' gradients;
- :func:`gather_along`: the blocks all-gathered into the replicated
  tensor; backward takes this rank's block of the (replicated) gradient;
- :func:`reduce_from`: the sum of per-rank partials (the forward is
  :func:`psum`); backward hands the replicated gradient to each partial;
- :func:`copy_to`: the identity; backward sums the ranks' partial
  gradients (:func:`psum`).

Transports. On the CPU the groups are gloo's. Where ranks each hold their
own card they are NCCL's, and collectives take CUDA tensors directly.
NCCL refuses a communicator of ranks that share one card, so ranks on one
card use gloo, and a CUDA tensor crosses through a pinned host buffer: the
kernels still run on the card, only the bytes between ranks pass through
the host. gloo sums bf16 as f32 (it is cast up for the sum and back), and
its all-to-all is built from point-to-point sends and receives (torch
2.11's gloo has no alltoall).

Every collective issued through a group adds one to its kind's count in
:func:`collective_counts` (the HLO op names JAX's counter uses:
``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
``collective-permute``); an axis with no process group (no
``torch.distributed`` job) is trivial, issues nothing and counts nothing.
While a trace records in this thread (``analysis/trace.py``: the
graph checks' recorded step), a collective records a site (its kind, its
axis, its input, whether it sits in the accumulation loop) and returns a
tensor of its output's shape: nothing is issued or counted.

:class:`RankPool` spawns ``world`` rank processes (the ``spawn`` start
method, which CUDA needs), joins them in one process group over a
``localhost`` TCP store it holds itself and runs callables on all of them;
:func:`spawn_ranks` is a one-shot pool.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import traceback
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

from ..analysis import trace as _trace

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")

_COUNTS: "collections.Counter[str]" = collections.Counter()
_COUNTS_LOCK = threading.Lock()


def collective_counts() -> Dict[str, int]:
    """Collectives issued by this process since the last reset, by kind."""
    with _COUNTS_LOCK:
        return {k: _COUNTS.get(k, 0) for k in KINDS}


def reset_collective_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def _count(kind: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[kind] += 1


# ----------------------------------------------------------------- the axes
class Axis:
    """One mesh axis as this rank sees it: its process group (``None``
    when trivial), size, this rank's coordinate and the global ranks of
    the group in coordinate order."""

    __slots__ = ("name", "group", "size", "index", "ranks")

    def __init__(self, name: str, group, size: int, index: int,
                 ranks: Sequence[int]):
        self.name = name
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.ranks = tuple(ranks)


def _mesh(mesh=None):
    if mesh is not None:
        return mesh
    from ..common.context import get_zoo_context

    return get_zoo_context(auto_init=False).mesh


def get_axis(axis: str, mesh=None) -> Axis:
    """The :class:`Axis` of ``axis`` on ``mesh`` (the current context's
    when not given)."""
    return _mesh(mesh).axis(axis)


def axis_index(axis: str, mesh=None) -> int:
    return get_axis(axis, mesh).index


def axis_size(axis: str, mesh=None) -> int:
    return get_axis(axis, mesh).size


# --------------------------------------------------------------- transports
def _staged(group) -> bool:
    """Whether CUDA tensors cross this group through host buffers (gloo)."""
    return dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, group, reduce: bool) -> torch.Tensor:
    """``x`` as the group's transport takes it: contiguous; on a gloo
    group, on the host (pinned when it comes from a card), and a bf16 sum
    in f32."""
    x = x.contiguous()
    if reduce and x.dtype == torch.bfloat16 and _staged(group):
        x = x.float()
    if x.device.type == "cuda" and _staged(group):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    return x


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device:
        t = t.to(like.device)
    return t.to(like.dtype) if t.dtype != like.dtype else t


def _raw_all_gather(x, ax: Axis, dim: int, tiled: bool) -> torch.Tensor:
    if _trace.RECORDING and _trace.recording():
        parts = [x] * ax.size
        return _trace.collective_site(
            "all-gather", ax.name, x,
            lambda: torch.cat(parts, dim) if tiled else torch.stack(parts,
                                                                    dim))
    _count("all-gather")
    w = _to_wire(x, ax.group, reduce=False)
    parts = [torch.empty_like(w) for _ in range(ax.size)]
    dist.all_gather(parts, w, group=ax.group)
    parts = [_from_wire(p, x) for p in parts]
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _raw_psum(x, ax: Axis) -> torch.Tensor:
    if _trace.RECORDING and _trace.recording():
        return _trace.collective_site("all-reduce", ax.name, x, x.clone)
    _count("all-reduce")
    w = _to_wire(x, ax.group, reduce=True)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, group=ax.group)
    return _from_wire(w, x)


def _raw_pmax(x, ax: Axis) -> torch.Tensor:
    if _trace.RECORDING and _trace.recording():
        return _trace.collective_site("all-reduce", ax.name, x, x.clone)
    _count("all-reduce")
    w = _to_wire(x, ax.group, reduce=True)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=ax.group)
    return _from_wire(w, x)


def _raw_psum_scatter(x, ax: Axis, dim: int, tiled: bool) -> torch.Tensor:
    if _trace.RECORDING and _trace.recording():
        def block():
            out = x.chunk(ax.size, dim)[0].clone()
            return out if tiled else out.squeeze(dim)

        return _trace.collective_site("reduce-scatter", ax.name, x, block)
    _count("reduce-scatter")
    if not tiled and x.shape[dim] != ax.size:
        raise ValueError(f"psum_scatter: dim {dim} of size {x.shape[dim]} "
                         f"!= axis size {ax.size}")
    if x.shape[dim] % ax.size:
        raise ValueError(f"psum_scatter: dim {dim} of size {x.shape[dim]} "
                         f"does not split over {ax.size} ranks")
    w = _to_wire(x, ax.group, reduce=True)
    chunks = [c.contiguous() for c in w.chunk(ax.size, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=ax.group)
    out = _from_wire(out, x)
    return out if tiled else out.squeeze(dim)


def _raw_all_to_all(x, ax: Axis, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    if _trace.RECORDING and _trace.recording():
        return _trace.collective_site(
            "all-to-all", ax.name, x,
            lambda: torch.cat(x.chunk(ax.size, split_dim), concat_dim))
    _count("all-to-all")
    if x.shape[split_dim] % ax.size:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over "
                         f"{ax.size} ranks")
    w = _to_wire(x, ax.group, reduce=False)
    ins = [c.contiguous() for c in w.chunk(ax.size, split_dim)]
    outs = [torch.empty_like(c) for c in ins]
    if _staged(ax.group):
        # gloo has no alltoall in every torch (2.11's raises "Backend gloo
        # does not support alltoall"): one send and one receive a peer
        ops = []
        for j, peer in enumerate(ax.ranks):
            if j == ax.index:
                outs[j].copy_(ins[j])
                continue
            ops += [dist.P2POp(dist.isend, ins[j], peer, ax.group),
                    dist.P2POp(dist.irecv, outs[j], peer, ax.group)]
        _exchange(ops)
    else:
        dist.all_to_all(outs, ins, group=ax.group)
    return torch.cat([_from_wire(o, x) for o in outs], concat_dim)


def _exchange(ops) -> None:
    """Point-to-point sends and receives issued as one batch: NCCL runs a
    batch as one group, so a ring of sends cannot wait on each other."""
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()


def _raw_ppermute(x, ax: Axis, perm: Sequence[Tuple[int, int]]):
    if _trace.RECORDING and _trace.recording():
        return _trace.collective_site("collective-permute", ax.name, x,
                                      x.clone)
    _count("collective-permute")
    w = _to_wire(x, ax.group, reduce=False)
    out = None
    ops = []
    for src, dst in perm:
        if src == ax.index and dst == ax.index:
            out = w.clone()
        elif src == ax.index:
            ops.append(dist.P2POp(dist.isend, w, ax.ranks[dst], ax.group))
        elif dst == ax.index:
            out = torch.empty_like(w)
            ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src], ax.group))
    _exchange(ops)
    if out is None:
        return torch.zeros_like(x)
    return _from_wire(out, x)


# --------------------------------------------------- differentiable wrappers
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, tiled):
        ctx.ax, ctx.dim, ctx.tiled = ax, dim, tiled
        return _raw_all_gather(x, ax, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum_scatter(g, ctx.ax, ctx.dim, ctx.tiled), None, None, \
            None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, tiled):
        ctx.ax, ctx.dim, ctx.tiled = ax, dim, tiled
        return _raw_psum_scatter(x, ax, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.ax, ctx.dim, ctx.tiled), None, None, \
            None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _raw_psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum(g, ctx.ax), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.ax, ctx.split, ctx.concat = ax, split_dim, concat_dim
        return _raw_all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_to_all(g, ctx.ax, ctx.concat, ctx.split), None, \
            None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _raw_ppermute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _raw_ppermute(g, ctx.ax, inv), None, None


class _ShardAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return x.chunk(ax.size, dim)[ax.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.ax, ctx.dim, True), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _raw_all_gather(x, ax, dim, True)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.ax.size, ctx.dim)[ctx.ax.index].contiguous(), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _raw_psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum(g, ctx.ax), None


def _live(axis: str, mesh) -> Optional[Axis]:
    ax = get_axis(axis, mesh)
    return ax if ax.group is not None else None


def all_gather(x: torch.Tensor, axis: str, *, dim: int = 0,
               tiled: bool = False, mesh=None) -> torch.Tensor:
    ax = _live(axis, mesh)
    if ax is None:
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, ax, dim, tiled)


def psum(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    ax = _live(axis, mesh)
    return x if ax is None else _Psum.apply(x, ax)


def pmax(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The elementwise max over the axis's ranks (no gradient flows)."""
    ax = _live(axis, mesh)
    return x.detach() if ax is None else _raw_pmax(x.detach(), ax)


def psum_scatter(x: torch.Tensor, axis: str, *, dim: int = 0,
                 tiled: bool = False, mesh=None) -> torch.Tensor:
    ax = _live(axis, mesh)
    if ax is None:
        return x if tiled else x.squeeze(dim)
    return _PsumScatter.apply(x, ax, dim, tiled)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
               *, mesh=None) -> torch.Tensor:
    ax = _live(axis, mesh)
    return x if ax is None else _AllToAll.apply(x, ax, split_dim, concat_dim)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
             *, mesh=None) -> torch.Tensor:
    ax = _live(axis, mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if ax is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, ax, perm)


def shard_along(x: torch.Tensor, axis: str, dim: int = 0, *,
                mesh=None) -> torch.Tensor:
    """This rank's block of replicated ``x`` along ``dim`` (module
    docstring)."""
    ax = _live(axis, mesh)
    return x if ax is None else _ShardAlong.apply(x, ax, dim)


def gather_along(x: torch.Tensor, axis: str, dim: int = 0, *,
                 mesh=None) -> torch.Tensor:
    """The axis's blocks concatenated along ``dim``, replicated (module
    docstring)."""
    ax = _live(axis, mesh)
    return x if ax is None else _GatherAlong.apply(x, ax, dim)


def reduce_from(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The sum of the ranks' partials, replicated (module docstring)."""
    ax = _live(axis, mesh)
    return x if ax is None else _ReduceFrom.apply(x, ax)


def copy_to(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The identity, whose backward sums partial gradients (module
    docstring)."""
    ax = _live(axis, mesh)
    return x if ax is None else _CopyTo.apply(x, ax)


def ring_perm(n: int, shift: int = 1) -> Tuple[Tuple[int, int], ...]:
    """``(j, (j + shift) mod n)`` for every coordinate: one step round a
    ring."""
    return tuple((j, (j + shift) % n) for j in range(n))


# ----------------------------------------------------------- batch shards
class BatchShard(NamedTuple):
    """This rank's block of a global batch: block ``index`` of ``count``
    along dim 0, over the axes ``axis`` (the major one first: ``("dp",
    "fsdp")`` is the JAX ``P(("dp", "fsdp"))``, block ``dp_index * fsdp +
    fsdp_index``). ``global_draws``: a random mask drawn in
    a step is drawn for the global batch and sliced (the JAX step whose key
    carries no rank index draws it over the global array); otherwise the
    rank draws for its own block with a key that already differs by rank
    (the flat update's step). The same flag marks a step that computes
    over the global batch (:func:`batch_psum`); ``mesh``: the mesh of the
    axes (the context's when ``None``)."""

    index: int
    count: int
    axis: Tuple[str, ...] = ("dp",)
    global_draws: bool = True
    mesh: Any = None


_BATCH = threading.local()


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Mark the forward/backward inside as running on ``shard`` of the
    global batch (the Estimator's training step)."""
    prev = getattr(_BATCH, "shard", None)
    _BATCH.shard = shard
    try:
        yield
    finally:
        _BATCH.shard = prev


def current_batch_shard() -> Optional[BatchShard]:
    return getattr(_BATCH, "shard", None)


def global_batch_shard() -> Optional[BatchShard]:
    """The current shard when the step computes over a global batch of
    more than one block (the replicated and per-leaf updates: what
    :func:`batch_psum` sums over), else None (no step, the flat step, one
    block)."""
    shard = current_batch_shard()
    if shard is None or not shard.global_draws or shard.count == 1:
        return None
    return shard


def batch_psum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that hold blocks of the global batch
    (:func:`psum` over each batch axis: backward sums the gradient the
    same way), inside a step that computes over the global batch (the
    replicated and per-leaf updates, as under JAX's GSPMD); ``x`` as it is
    outside one and in the flat step, whose statistics are local."""
    shard = current_batch_shard()
    if shard is None or not shard.global_draws:
        return x
    for a in shard.axis:
        x = psum(x, a, mesh=shard.mesh)
    return x


# ---------------------------------------------------------------- rank pool
def _rank_main(rank: int, world: int, port: int, backend: str, device: str,
               threads: int, conn, env: Dict[str, str]) -> None:
    os.environ.update(env)
    if threads:
        torch.set_num_threads(threads)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                res = ("ok", fn(*args, **kwargs))
            except BaseException:       # reported to the caller, who raises
                res = ("err", traceback.format_exc())
            conn.send(res)
    finally:
        from ..common.context import reset_zoo_context

        reset_zoo_context()
        dist.destroy_process_group()
        conn.close()


class RankError(RuntimeError):
    """A rank raised; the message holds its traceback."""


def default_backend(device: str, world: int) -> str:
    """The transport of ``world`` ranks on ``device``: NCCL where each rank
    has a card of its own, gloo on the CPU and where ranks share a card
    (NCCL refuses that; CUDA tensors are staged through host buffers)."""
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


class RankPool:
    """``world`` rank processes joined in one process group, taking
    callables (module-level functions: the ``spawn`` start method pickles
    them by name) with :meth:`run`. ``device`` (default ``"cuda"``; pass
    ``"cpu"`` for CPU ranks): on ``"cuda"`` each rank's current card is
    ``cuda:<rank mod cards>``, and a host with no card raises.
    ``backend`` (default :func:`default_backend`). ``threads``: the CPU
    threads a rank's torch uses (0: torch's default). ``env``: set in each
    rank before it starts. Close it (or use it as a context manager) to
    stop every process it started."""

    def __init__(self, world: int, *, backend: Optional[str] = None,
                 device: str = "cuda", threads: int = 1,
                 env: Optional[Dict[str, str]] = None,
                 timeout_s: float = 600.0):
        import multiprocessing as mp

        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RankPool(device='cuda'): no CUDA device is "
                               "visible; pass device='cpu' for CPU ranks")
        self.world = int(world)
        backend = backend or default_backend(device, self.world)
        ctx = mp.get_context("spawn")
        self.timeout_s = float(timeout_s)
        # the job's store lives here, on a port the OS picked: no other
        # process can take it between choosing and binding
        self._store = dist.TCPStore("127.0.0.1", 0, self.world,
                                    is_master=True, wait_for_workers=False)
        port = self._store.port
        self._conns = []
        self._procs = []
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(r, self.world, port, backend, device,
                                  threads, child, dict(env or {})),
                            name=f"zoo-rank-{r}")
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank at once; the results in
        rank order. A rank that raises (or outlives ``timeout_s``) closes
        the pool and raises :class:`RankError`; a closed pool raises."""
        if not self._conns:
            raise RankError("the rank pool is closed")
        for c in self._conns:
            c.send((fn, args, kwargs))
        out, errors = [], []
        for r, c in enumerate(self._conns):
            if not c.poll(self.timeout_s):
                self.close(kill=True)
                raise RankError(f"rank {r} gave no result in "
                                f"{self.timeout_s:.0f} s")
            try:
                status, res = c.recv()
            except (EOFError, OSError) as e:
                self.close(kill=True)
                raise RankError(f"rank {r} exited: {e!r}") from e
            if status == "err":
                errors.append(f"rank {r}:\n{res}")
            out.append(res)
        if errors:
            self.close(kill=True)
            raise RankError("\n".join(errors))
        return out

    def close(self, kill: bool = False) -> None:
        for c in self._conns:
            if not kill:
                try:
                    c.send(None)
                except (OSError, EOFError, BrokenPipeError):
                    pass
        for p in self._procs:
            p.join(0 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join(5)
        for c in self._conns:
            c.close()
        self._conns, self._procs = [], []
        self._store = None

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def spawn_ranks(fn: Callable, world: int, backend: Optional[str] = None, *,
                device: str = "cuda", args: Sequence = (),
                **pool_kw) -> List[Any]:
    """``fn(*args)`` on ``world`` fresh rank processes (a one-shot
    :class:`RankPool`); results in rank order."""
    with RankPool(world, backend=backend, device=device, **pool_kw) as pool:
        return pool.run(fn, *args)


__all__ = ["Axis", "BatchShard", "KINDS", "batch_psum", "batch_shard",
           "current_batch_shard", "RankError", "RankPool", "all_gather",
           "all_to_all", "axis_index", "axis_size", "collective_counts",
           "copy_to", "default_backend", "gather_along", "get_axis",
           "global_batch_shard", "pmax",
           "ppermute", "psum", "psum_scatter", "reduce_from",
           "reset_collective_counts", "ring_perm", "shard_along",
           "spawn_ranks"]
