"""The decode-shape-stability rule and the shared-prefix write-isolation
check (port of ``analytics_zoo_tpu/analysis/rules/decode.py``).

The continuous batcher's economics rest on the decode step being one fixed
dispatch whose cost is flat in generated length. Three structural facts
about the recorded ``decode_step`` make that true, each with a quiet
failure mode this rule catches at warm-up (``ServingConfig.graph_checks``):

* **The cache comes back in place.** Every cache leaf reappears among the
  step's outputs as the same tensor (same shape, dtype and storage). A
  cache grown by concatenation changes shape every step; one rebuilt as a
  new tensor is a second pool.
* **No per-step growth.** No op outside a kernel site produces a tensor
  larger than the largest cache leaf: an O(T^2) score tensor or an
  accidentally broadcast gather shows here.
* **No host reads.** ``.item()``/``.tolist()``/``.cpu()`` of a device value
  inside the step serializes the multi-slot loop on a round trip a token.

:func:`lint_prefix_write_isolation` is the host-side twin of ``cache-alias``
for shared-prefix admission (refcounted pages).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core import Finding, Rule, RuleContext, finding, register
from ..trace import Trace


@register
class DecodeShapeStabilityRule(Rule):
    """Active when ``ctx.decode_cache_avals`` names the cache leaves."""

    id = "decode-shape-stability"
    layer = "trace"
    severity = "error"
    doc = ("The traced decode step must return every KV-cache leaf in "
           "place (same shape, dtype and storage), produce no tensor larger "
           "than the cache, and read no device value on the host — the "
           "fixed-shape/no-O(T^2) contract of KV-cache decoding")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        if not ctx.decode_cache_avals:
            return []
        out: List[Finding] = []
        wanted = [(tuple(s), d) for s, d in ctx.decode_cache_avals]
        out_storages: Dict[Tuple, set] = {}
        for o in trace.outputs:
            out_storages.setdefault(o.key, set()).add(o.storage)
        leaf_bytes = []
        for key in wanted:
            args = [a for a in trace.args if a.key == key]
            leaf_bytes += [a.nbytes for a in args]
            shape, dtype = key
            if key not in out_storages:
                out.append(self.emit(
                    ctx, f"cache leaf {dtype}{shape} does not reappear "
                         f"among the decode step's outputs — the cache is "
                         f"grown or reshaped per step",
                    shape=shape, dtype=dtype))
            elif any(a.storage not in out_storages[key] for a in args):
                out.append(self.emit(
                    ctx, f"cache leaf {dtype}{shape} comes back as a new "
                         f"tensor, not written in place — a second pool "
                         f"every step",
                    shape=shape, dtype=dtype))
        limit = max(leaf_bytes) if leaf_bytes else 0
        for r in trace.host_reads:
            if not r.in_kernel:
                out.append(self.emit(
                    ctx, f"{r.what} of a device {r.tensor.dtype}"
                         f"{r.tensor.shape} inside the decode step — a host "
                         f"round trip per emitted token", primitive=r.what))
        if limit:
            for op in trace.outside():
                if op.site is not None:
                    continue
                for t in op.outputs:
                    if t.nbytes > limit:
                        out.append(self.emit(
                            ctx, f"{op.kind} produces a {t.dtype}{t.shape} "
                                 f"tensor ({t.nbytes} bytes) larger than "
                                 f"the whole KV cache leaf ({limit} bytes) "
                                 f"— per-step growth / O(T^2) shape",
                            primitive=op.kind, nbytes=int(t.nbytes)))
                        break
        return out


def _host_args(b: int, cfg, ids_shape):
    """The decode/verify step's host arguments at the batcher's dtypes:
    every row hot (temperature 1), so the sampler is traced too."""
    return (np.zeros(ids_shape, np.int32), np.zeros(b, np.int32),
            np.zeros((b, cfg.pages_per_slot), np.int32),
            np.zeros(b, np.int64), np.zeros(b, np.int64),
            np.ones(b, np.float32))


def trace_decode(model, cache_cfg, cache, *, top_k: int = 0,
                 spec_k: int = 0) -> Trace:
    """Record ``model.decode_step`` (or ``verify_step`` at ``spec_k >=
    2``) over every slot at the cache's fixed shapes."""
    from ..trace import trace_call

    b = cache_cfg.n_slots
    if spec_k >= 2:
        step, ids_shape = model.verify_step, (b, spec_k)
    else:
        step, ids_shape = model.decode_step, (b,)
    return trace_call(
        lambda c, *a: step(c, *a, page_size=cache_cfg.page_size,
                           top_k=top_k),
        cache, *_host_args(b, cache_cfg, ids_shape), modules=[model])


def trace_prefill_chunk(model, cache_cfg, cache, chunk_tokens: int) -> Trace:
    """Record ``model.prefill_chunk`` at B=1, chunk width
    ``chunk_tokens``, over the wide table a chunk dispatch uses
    (``pages_per_slot + chunk_tokens / page_size`` entries)."""
    from ..trace import trace_call

    wide = cache_cfg.pages_per_slot + chunk_tokens // cache_cfg.page_size
    return trace_call(
        lambda c, *a: model.prefill_chunk(c, *a,
                                          page_size=cache_cfg.page_size),
        cache, np.zeros((1, chunk_tokens), np.int32), np.zeros(1, np.int32),
        np.full(1, chunk_tokens, np.int32), np.zeros((1, wide), np.int32),
        modules=[model])


def lint_decode_stability(model, cache_cfg, cache, *, top_k: int = 0,
                          spec_k: int = 0, chunk_tokens: int = 0,
                          where: str = "serving.generation",
                          ctx: Optional[RuleContext] = None,
                          hbm_budget_bytes: Optional[int] = None,
                          note_static_site: Optional[str] = None
                          ) -> List[Finding]:
    """Record the decode-path step at the cache's fixed shapes (nothing
    runs) and run ``decode-shape-stability``, ``cache-alias`` and, with a
    budget, ``hbm-budget``. The warm-up entry point
    (``ContinuousBatcher.check_decode_stability``).

    ``spec_k >= 2`` lints the speculative ``verify_step`` at query length
    k instead of ``decode_step``. ``chunk_tokens > 0`` also lints
    ``prefill_chunk`` at that chunk width under the same rules, its
    findings appended. ``note_static_site`` records the decode trace's
    static peak into the memory witness under that site name."""
    from ..graphlint import lint_trace

    trace = trace_decode(model, cache_cfg, cache, top_k=top_k,
                         spec_k=spec_k)
    cache_avals = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for t in cache.values()]
    ctx = ctx or RuleContext(where=where)
    ctx = RuleContext(**{**ctx.__dict__,
                         "decode_cache_avals": cache_avals,
                         "hbm_budget_bytes": hbm_budget_bytes})
    rules = ["decode-shape-stability", "cache-alias"] + (
        ["hbm-budget"] if hbm_budget_bytes else [])
    findings = lint_trace(trace, ctx=ctx, rules=rules)
    if chunk_tokens > 0:
        findings = findings + lint_trace(
            trace_prefill_chunk(model, cache_cfg, cache, chunk_tokens),
            ctx=ctx, rules=rules)
    if note_static_site:
        from ...common import memwitness as _mw

        if _mw.enabled():
            from ..memory import profile_trace

            _mw.note_static(note_static_site,
                            profile_trace(trace).peak_live_bytes,
                            hbm_budget_bytes)
    return findings


def lint_prefix_write_isolation(pool, row, start: int, *,
                                page_size: int,
                                where: str = "serving.generation"
                                ) -> List[Finding]:
    """Refcounted-aliasing twin of the cache-alias rule, for the host side
    of shared-prefix admission: a suffix prefill from position ``start``
    writes K/V into the pages backing positions ``start ..``, so each of
    those must be exclusively the stream's (pool refcount 1), or the write
    would land in a page that sibling streams and the prefix cache read.

    ``pool``: the :class:`~analytics_zoo_tpu_torch.ops.kv_cache.PagePool`;
    ``row``: the stream's page ids in table order; ``start``: the first
    position the suffix dispatch writes. Pages strictly below
    ``start // page_size`` are the read-only shared prefix and are not
    flagged. Returns one error finding per written page with more than one
    reference (empty = isolated)."""
    out: List[Finding] = []
    first_written = int(start) // int(page_size)
    for idx in range(first_written, len(row)):
        page = int(row[idx])
        refs = pool.ref_count(page)
        if refs > 1:
            out.append(finding(
                "prefix-share-isolation", "error", f"pool:{where}",
                f"page {page} (table index {idx}) is written by the suffix "
                f"prefill from position {start} but carries {refs} "
                f"references — shared pages must be copy-on-write before "
                f"any paged_write touches them",
                page=page, table_index=idx, refcount=refs, start=int(start)))
    return out


__all__ = ["DecodeShapeStabilityRule", "lint_decode_stability",
           "lint_prefix_write_isolation", "trace_decode",
           "trace_prefill_chunk"]
