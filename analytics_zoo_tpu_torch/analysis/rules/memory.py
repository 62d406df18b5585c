"""Memory rules: in-place state, cache aliasing, device-memory budgets,
outsized temporaries (port of ``analytics_zoo_tpu/analysis/rules/memory.py``).

Over the live-range walk of :mod:`analysis.memory`:

* ``hbm-budget`` — the static peak must stay under the per-device budget
  declared in ``TrainConfig``/``ServingConfig`` (enforced at fit start and
  warm-up; the run-time witness re-checks the same id against measured
  bytes).
* ``peak-temporary`` — one temporary larger than the largest argument
  leaf (and at least 1 MiB): an unsharded gather, an f32 upcast of a bf16
  tree, an O(T^2) score buffer.
* ``cache-alias`` — the decode step writes its page pool in place: no
  pool-sized allocation outside a kernel site. A step that builds a new
  pool and copies it back has the JAX package's un-donated pool's cost (a
  second pool-sized buffer every step).
* ``donation-missed`` (trace half, :func:`lint_donation`) — state leaves
  that the caller replaces with the call's results (``ctx.dead_invars``)
  must be written in place: a leaf whose update is a new tensor of its
  shape keeps both alive. In the Estimator that is
  ``TrainConfig(donate_state=False)``. The JAX package's AST half (a
  ``jax.jit`` argument rebound without ``donate_argnums``) has no
  counterpart: torch has no donation to forget.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import Finding, Rule, RuleContext, finding, register, report
from ..memory import profile_trace
from ..trace import Trace

__all__ = [
    "CacheAliasRule", "HbmBudgetRule", "PEAK_TEMP_FLOOR_BYTES",
    "PeakTemporaryRule", "flatten_donation", "lint_donation", "lint_memory",
    "lint_sharded_gather",
]


def flatten_donation(n_leaves_per_arg: Sequence[int],
                     donate_argnums: Sequence[int]) -> List[bool]:
    """Per-flattened-leaf flags for a positional signature:
    ``n_leaves_per_arg`` is each positional arg's leaf count,
    ``donate_argnums`` the flagged positions (``dead_invars`` for the
    state arguments of a step)."""
    donated = set(donate_argnums)
    out: List[bool] = []
    for i, n in enumerate(n_leaves_per_arg):
        out.extend([i in donated] * n)
    return out


@register
class HbmBudgetRule(Rule):
    """Active when ``ctx.hbm_budget_bytes`` declares a per-device budget."""

    id = "hbm-budget"
    layer = "trace"
    severity = "error"
    doc = ("Static live-range peak of the traced call must stay under the "
           "per-device memory budget declared in TrainConfig/ServingConfig; "
           "the memory witness re-checks the same budget against measured "
           "bytes")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        if not ctx.hbm_budget_bytes:
            return []
        prof = profile_trace(trace)
        if prof.peak_live_bytes <= ctx.hbm_budget_bytes:
            return []
        top = [f"{t.primitive}:{t.dtype}{tuple(t.shape)}={t.nbytes}B"
               for t in prof.temporaries[:3]]
        return [self.emit(
            ctx, f"static peak-live estimate {prof.peak_live_bytes} bytes "
                 f"exceeds the declared per-device memory budget "
                 f"{ctx.hbm_budget_bytes} bytes (resident "
                 f"{prof.resident_bytes}B, top temporaries: "
                 f"{', '.join(top) or 'none'})",
            peak_live_bytes=prof.peak_live_bytes,
            budget_bytes=int(ctx.hbm_budget_bytes),
            resident_bytes=prof.resident_bytes,
            top_temporaries=tuple(top))]


#: peak-temporary ignores temporaries under this size whatever the leaf
#: bound — a kilobyte buffer "larger than" a toy model's largest leaf is
#: never actionable
PEAK_TEMP_FLOOR_BYTES = 1 << 20


@register
class PeakTemporaryRule(Rule):
    """A single temporary larger than the largest model leaf (warning)."""

    id = "peak-temporary"
    layer = "trace"
    severity = "warning"
    doc = ("A single device temporary (>= 1 MiB) larger than the largest "
           "model leaf — an unsharded gather, an f32 upcast of a bf16 tree, "
           "or an O(T^2) score buffer hiding in the step")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        prof = profile_trace(trace)
        limit = ctx.param_leaf_bytes or prof.largest_arg_leaf_bytes
        if not limit:
            return []
        limit = max(limit, PEAK_TEMP_FLOOR_BYTES)
        out: List[Finding] = []
        for t in prof.temporaries:
            if t.nbytes <= limit:
                break               # sorted descending
            out.append(self.emit(
                ctx, f"{t.primitive} materializes a "
                     f"{t.dtype}{tuple(t.shape)} temporary ({t.nbytes} "
                     f"bytes) larger than the largest model leaf ({limit} "
                     f"bytes)"
                     f"{' inside the accumulation loop' if t.in_loop else ''}",
                primitive=t.primitive, nbytes=t.nbytes,
                limit_bytes=int(limit), in_loop=t.in_loop))
            if len(out) >= 3:       # one call, a handful of findings
                break
        return out


def _allocations(trace: Trace):
    """``(op, tensor)`` for each output outside a site whose storage the
    call has not seen before: the call's device allocations."""
    known = {a.storage for a in trace.args}
    for op in trace.outside():
        for t in op.outputs:
            if t.storage not in known:
                known.add(t.storage)
                yield op, t


@register
class CacheAliasRule(Rule):
    """Active when ``ctx.decode_cache_avals`` names the cache leaves."""

    id = "cache-alias"
    layer = "trace"
    severity = "error"
    doc = ("The decode step must write its KV page pool in place — a "
           "pool-sized allocation in the step (a new pool copied back) "
           "costs a second pool every decode step")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        if not ctx.decode_cache_avals:
            return []
        leaf_counts: Dict[Tuple, int] = {}
        leaf_bytes: Dict[Tuple, int] = {}
        for a in trace.args:
            key = (tuple(a.shape), a.dtype)
            if key in {(tuple(s), d) for s, d in ctx.decode_cache_avals}:
                leaf_counts[key] = leaf_counts.get(key, 0) + 1
                leaf_bytes[key] = a.nbytes
        allocs = list(_allocations(trace))
        out: List[Finding] = []
        for key, n_leaves in leaf_counts.items():
            nbytes = leaf_bytes[key]
            hits = [(op, t) for op, t in allocs if t.storage_nbytes >= nbytes]
            if not hits:
                continue
            op, t = hits[0]
            shape, dtype = key
            leaves = (f"{n_leaves} cache leaves" if n_leaves > 1
                      else "cache leaf")
            out.append(self.emit(
                ctx, f"KV {leaves} {dtype}{shape} ({nbytes} bytes each): "
                     f"{len(hits)} pool-sized allocation(s) in the decode "
                     f"step, first {op.kind} -> {t.dtype}{t.shape} — the "
                     f"step copies the pool instead of writing it in place",
                shape=shape, dtype=dtype, nbytes=nbytes, leaves=n_leaves,
                allocations=len(hits)))
        return out


def lint_donation(trace: Trace, ctx: RuleContext) -> List[Finding]:
    """Trace half of ``donation-missed``: argument leaves the caller
    replaces with the call's results (``ctx.dead_invars``, one flag per
    ``trace.args`` leaf) that the call does not write in place while an
    output of their shape and dtype is a new tensor — both stay alive.

    Not a registered :class:`Rule`; findings carry the same id. Callers
    pass the result through :func:`analysis.core.report` (``lint_memory``
    does)."""
    if not ctx.dead_invars:
        return []
    dead = list(ctx.dead_invars) + [False] * (len(trace.args)
                                             - len(ctx.dead_invars))
    written = set()
    for op in trace.ops:
        written |= op.written
    arg_storages = {a.storage for a in trace.args}
    out_counts: Dict[Tuple, int] = {}
    for o in trace.outputs:
        if o.storage not in arg_storages:
            out_counts[o.key] = out_counts.get(o.key, 0) + 1
    missed_bytes = missed = 0
    example = None
    for a, d in zip(trace.args, dead):
        if not d or a.storage in written:
            continue
        if out_counts.get(a.key, 0) > 0:
            out_counts[a.key] -= 1
            missed_bytes += a.nbytes
            missed += 1
            if example is None or a.nbytes > example[1]:
                example = (a.key, a.nbytes)
    if not missed:
        return []
    (shape, dtype), ex_bytes = example
    return [finding(
        "donation-missed", "error", f"trace:{ctx.where or '<anon>'}",
        f"{missed} state leaf(s) totalling {missed_bytes} bytes are replaced "
        f"by the call's results but not written in place (largest: "
        f"{dtype}{tuple(shape)}, {ex_bytes} bytes) — old and new stay "
        f"alive together every step",
        leaves=missed, missed_bytes=missed_bytes,
        largest_shape=tuple(shape), largest_dtype=dtype)]


def lint_memory(trace: Trace, ctx: Optional[RuleContext] = None,
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the memory tier over one recorded call: the registered rules
    (``hbm-budget`` / ``peak-temporary`` / ``cache-alias``, each gated on
    its ctx knobs) plus the trace half of ``donation-missed``. Findings
    are counted into telemetry."""
    from ..graphlint import lint_trace

    ctx = ctx or RuleContext()
    findings = lint_trace(
        trace, ctx=ctx,
        rules=list(rules) if rules is not None
        else ["hbm-budget", "peak-temporary", "cache-alias"])
    findings += report(lint_donation(trace, ctx))
    return findings


def lint_sharded_gather(rows: int, width: int, batch: int, n_shards: int,
                        *, dtype="float32",
                        hbm_budget_bytes: Optional[int] = None,
                        where: str = "sharded_gather") -> List[Finding]:
    """``hbm-budget`` gate for one row-sharded embedding lookup
    (:func:`analytics_zoo_tpu_torch.parallel.embedding_sharding.
    sharded_gather`): records the SHARD-LOCAL block one device runs (the
    ``rows/n``-row table shard, the all-gathered ``(batch,)`` ids, the
    masked owner gather's ``(batch, width)`` partial and the reduce-scatter
    emulated as a reshape-sum to ``(batch/n, width)``) on the meta device,
    so nothing is allocated. Empty findings: the per-device budget holds."""
    import torch

    from ..graphlint import lint_trace
    from ..trace import trace_call

    if rows % n_shards or batch % n_shards:
        raise ValueError(f"rows={rows} and batch={batch} must divide "
                         f"n_shards={n_shards} (pad first)")
    local_rows = rows // n_shards
    dt = getattr(torch, str(dtype))

    def shard_block(local_table, all_ids):
        loc = all_ids - local_rows          # any fixed shard offset
        ok = (loc >= 0) & (loc < local_rows)
        part = local_table[torch.where(ok, loc, torch.zeros_like(loc))]
        part = torch.where(ok[:, None], part, torch.zeros((), dtype=dt,
                                                          device="meta"))
        return part.reshape(n_shards, batch // n_shards, width).sum(0)

    trace = trace_call(shard_block,
                       torch.empty((local_rows, width), dtype=dt,
                                   device="meta"),
                       torch.empty((batch,), dtype=torch.int32,
                                   device="meta"))
    return lint_trace(trace, ctx=RuleContext(
        where=where, hbm_budget_bytes=hbm_budget_bytes),
        rules=["hbm-budget", "peak-temporary"])
