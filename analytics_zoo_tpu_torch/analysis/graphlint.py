"""Graph layer: trace a call, run the trace rules, track signatures (port
of ``analytics_zoo_tpu/analysis/graphlint.py``).

Entry points:

* :func:`lint_traced` — record ``fn(*args)`` (:func:`analysis.trace.
  trace_call`: fake tensors, nothing runs) and run the trace-layer rules.
  This is what ``TrainConfig.graph_checks`` runs at ``Estimator.fit`` start
  and what the int8 and decode warm-ups run.
* :func:`lint_trace` — the same, for an already recorded
  :class:`~analysis.trace.Trace` (the counterpart of ``lint_jaxpr``).
* :class:`SignatureTracker` — the run-time recompilation-hazard tracker
  (fed by the Estimator's step signatures, evaluated by the
  ``recompile-hazard`` rule).

Each recorded op says whether it sits inside a kernel or collective site
(the plain version's ops, which hold no device-memory structure:
structure rules skip them, :meth:`Trace.outside`) and inside the
accumulation loop (a collective there runs once per micro-step). The JAX
package's ``lint_hlo`` and ``walk_eqns`` have no counterpart: the port
compiles no HLO, and a trace is one flat list of ops.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable, List, Optional, Sequence

from .core import (Finding, Rule, RuleContext, all_rules, enforce, get_rule,
                   report)
from .trace import Trace, trace_call

logger = logging.getLogger("analytics_zoo_tpu_torch.analysis")


def _select(rules: Optional[Sequence[Any]], layer: str) -> List[Rule]:
    if rules is None:
        return all_rules(layer)
    out = []
    for r in rules:
        rule = get_rule(r) if isinstance(r, str) else r
        if rule.layer == layer:
            out.append(rule)
    return out


def lint_trace(trace: Trace, ctx: Optional[RuleContext] = None,
               rules: Optional[Sequence[Any]] = None) -> List[Finding]:
    """Run trace-layer rules over a recorded call; returns findings
    (already counted into telemetry)."""
    ctx = ctx or RuleContext()
    findings: List[Finding] = []
    for rule in _select(rules, "trace"):
        findings.extend(rule.check(trace, ctx))
    return report(findings)


def lint_traced(fn: Callable, *args, ctx: Optional[RuleContext] = None,
                rules: Optional[Sequence[Any]] = None,
                modules: Sequence[Any] = (), **kwargs) -> List[Finding]:
    """Record ``fn(*args, **kwargs)`` (no kernel launches, no state
    change; ``modules``: the modules whose weights it reads) and lint the
    trace."""
    return lint_trace(trace_call(fn, *args, modules=modules, **kwargs),
                      ctx=ctx, rules=rules)


def lint_signatures(signatures: Iterable[Any],
                    ctx: Optional[RuleContext] = None,
                    rules: Optional[Sequence[Any]] = None) -> List[Finding]:
    """Run signature-layer rules (recompilation hazards) over a recorded
    set of dispatch signatures."""
    ctx = ctx or RuleContext()
    sigs = list(signatures)
    findings: List[Finding] = []
    for rule in _select(rules, "signatures"):
        findings.extend(rule.check(sigs, ctx))
    return report(findings)


class SignatureTracker:
    """Recompilation-hazard tracker for one dispatch site.

    The JAX package compiles one executable per distinct (shape, dtype)
    signature; the port builds per signature what it caches (library
    handles, allocator blocks, the first step's timing), and a site whose
    signature count keeps growing is where the JAX package would compile
    mid-traffic. Callers :meth:`add` each dispatch key; once the distinct
    count exceeds ``max_distinct`` the tracker flags ONCE — the
    ``recompile-hazard`` finding is logged and counted at the crossing.

    ``max_distinct`` is ``log2(max_batch)+1`` when built via
    :meth:`for_bucket_ladder` — the executable count the ladder promises.
    """

    def __init__(self, name: str, max_distinct: int):
        self.name = name
        self.max_distinct = int(max_distinct)
        self._sigs: set = set()
        self._flagged = False

    @classmethod
    def for_bucket_ladder(cls, name: str, max_batch: int,
                          shapes_per_bucket: int = 1) -> "SignatureTracker":
        ladder = max_batch.bit_length() + (0 if max_batch &
                                           (max_batch - 1) == 0 else 1)
        return cls(name, max(1, ladder) * max(1, shapes_per_bucket))

    def add(self, signature: Any) -> bool:
        """Record one dispatch signature; returns True the single time the
        distinct count first exceeds the bound."""
        self._sigs.add(signature)
        if len(self._sigs) > self.max_distinct and not self._flagged:
            self._flagged = True
            ctx = RuleContext(where=self.name,
                              max_signatures=self.max_distinct)
            for f in lint_signatures(self._sigs, ctx=ctx):
                logger.warning("graph-lint: %s", f)
            return True
        return False

    @property
    def distinct(self) -> int:
        return len(self._sigs)


__all__ = ["SignatureTracker", "enforce", "lint_signatures", "lint_trace",
           "lint_traced"]
