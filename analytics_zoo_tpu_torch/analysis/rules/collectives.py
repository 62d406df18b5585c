"""The collective-budget rule: the ZeRO-1 one-collective-per-global-step
gate (port of ``analytics_zoo_tpu/analysis/rules/collectives.py``).

The flat update-sharding path (``parallel/update_sharding.py``) is
structurally ONE grad-sized reduce-scatter + one params all-gather per
global step, with counts constant in ``grad_accum_steps``.
:func:`trace_collective_counts` is the trace-time census: every collective
of ``parallel/comm.py`` records a site under its HLO spelling
(``"reduce-scatter"``, ``"all-gather"``, ``"all-reduce"``,
``"all-to-all"``, ``"collective-permute"``), so one ``expect_collectives``
dict reads as in the JAX package. Collectives inside the accumulation loop
(:func:`analysis.trace.loop_region`) are tallied separately: there they run
once per micro-step — the cost accumulation exists to amortize away.

The JAX package's ``collective-budget-hlo`` (post-compile HLO text) has no
counterpart: the port compiles no HLO.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List

from ..core import Finding, Rule, RuleContext, register
from ..trace import Trace


def trace_collective_counts(trace: Trace) -> Dict[str, Dict[str, int]]:
    """``{"counts": {...}, "in_loop": {...}}`` of the collective sites of
    ``trace``, keyed by their HLO spelling."""
    counts: Counter = Counter()
    in_loop: Counter = Counter()
    for op in trace.sites("collective"):
        counts[op.name] += 1
        if op.in_loop:
            in_loop[op.name] += 1
    return {"counts": dict(counts), "in_loop": dict(in_loop)}


def _budget_findings(rule: Rule, ctx: RuleContext, counts: Dict[str, int],
                     in_loop: Dict[str, int]) -> List[Finding]:
    """Compare counts against ``ctx.expect_collectives`` (only listed keys
    are compared — an incidental all-reduce such as the loss mean does not
    trip a reduce-scatter budget)."""
    out: List[Finding] = []
    if ctx.expect_collectives:
        for key, want in ctx.expect_collectives.items():
            got = counts.get(key, 0)
            if got != want:
                out.append(rule.emit(
                    ctx, f"collective budget violated: expected {want} "
                         f"{key} per step, found {got}",
                    expected=want, found=got, collective=key))
    for key, n in in_loop.items():
        if ctx.expect_collectives is None or key not in ctx.expect_collectives:
            continue
        out.append(rule.emit(
            ctx, f"{n} {key} inside the accumulation loop — cost scales "
                 f"with the micro-step count (grad accumulation must keep "
                 f"the gradient exchange outside the loop)",
            collective=key, in_loop=n))
    return out


@register
class CollectiveBudgetRule(Rule):
    """Trace-time collective budget vs ``ctx.expect_collectives``."""

    id = "collective-budget"
    layer = "trace"
    severity = "error"
    doc = ("Collective census of the traced step vs an expected budget "
           "(e.g. ZeRO-1 flat: exactly 1 reduce-scatter + 1 all-gather per "
           "global step, none inside the accumulation loop)")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        if ctx.expect_collectives is None:
            return []
        census = trace_collective_counts(trace)
        return _budget_findings(self, ctx, census["counts"],
                                census["in_loop"])
