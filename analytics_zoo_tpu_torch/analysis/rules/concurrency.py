"""Concurrency rules: guarded-by, lock order, hold hazards (AST layer; port
of ``analytics_zoo_tpu/analysis/rules/concurrency.py``).

The facts these rules consume — per-class lock models, guarded-by inference,
the static lock-order graph, blocking-op detection — are extracted by
:mod:`analysis.concurrency`; this module turns them into findings. The rule
ids:

* ``lock-guarded-by`` (error) — a field predominantly (or declaredly, via
  ``# zoo-lock: guards(...)``) mutated under a lock is mutated outside it.
  The generalized successor of the one-off ``telemetry-lock`` rule, which
  remains a suppression/``get_rule`` alias.
* ``lock-order-cycle`` (error) — the module's static lock-order graph
  (nested ``with`` + held-method call edges + ``# zoo-lock: order(a<b)``
  declarations) contains a cycle: a potential ABBA deadlock.
* ``lock-hold-hazard`` (error) — a blocking operation (wire round-trip,
  socket op, ``queue.get/put(timeout=...)``, ``subprocess``, ``time.sleep``,
  event wait, user-callback invocation) runs inside a critical section.
* ``lock-leaf-violation`` (error) — a ``# zoo-lock: leaf`` lock statically
  acquires another lock while held.
* ``lock-unused`` (warning) — a lock is constructed but never acquired in
  its module: either dead weight or, worse, state the author believed was
  guarded.
* ``lock-reachin`` (warning) — ``with other._lock:`` acquires another
  object's private lock; the owning class should expose the operation.

The runtime counterpart (:func:`analysis.concurrency.check_witness`, fed by
:class:`~analytics_zoo_tpu_torch.common.locks.TracedLock`) reuses the same rule
ids, so inline suppressions and the docs cover both halves.
"""

from __future__ import annotations

from typing import Iterable, List

from ..concurrency import build_module_model, find_cycles
from ..core import Finding, Rule, RuleContext, finding, register


def _model(art):
    m = getattr(art, "_concurrency_model", None)
    if m is None:
        m = build_module_model(art.tree, art.path, art.lines)
        art._concurrency_model = m
    return m


@register
class GuardedByRule(Rule):
    id = "lock-guarded-by"
    layer = "ast"
    severity = "error"
    doc = ("mutation of a lock-guarded field outside its lock — guarded-by "
           "sets are inferred from predominant `with self._lock` usage or "
           "declared via `# zoo-lock: guards(...)`; __init__ is exempt "
           "(alias: telemetry-lock)")

    def check(self, art, ctx: RuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for cm in _model(art).classes.values():
            for mut in cm.outliers:
                lock = cm.guarded.get(mut.field, "?")
                under, plain = cm.mutation_stats.get(mut.field, (0, 0))
                out.append(finding(
                    self.id, self.severity, f"{art.path}:{mut.line}",
                    f"mutation of {cm.name}.{mut.field} without holding "
                    f"{lock} ({under} mutation site(s) hold it, {plain} do "
                    f"not) — races every reader/writer that trusts the "
                    f"lock", field=mut.field, lock=lock))
        return out


@register
class LockOrderCycleRule(Rule):
    id = "lock-order-cycle"
    layer = "ast"
    severity = "error"
    doc = ("cycle in the static lock-order graph (nested `with` blocks, "
           "held-method call edges, `# zoo-lock: order(a<b)` declarations) "
           "— a lock-order inversion two threads can deadlock on")

    def check(self, art, ctx: RuleContext) -> Iterable[Finding]:
        model = _model(art)
        edges = [(e.src, e.dst) for e in model.edges]
        edges += [(a, b) for a, b, _line in model.declared_edges]
        out: List[Finding] = []
        for cycle in find_cycles(edges):
            cset = set(cycle)
            line = min((e.line for e in model.edges
                        if e.src in cset and e.dst in cset),
                       default=min((ln for a, b, ln in model.declared_edges
                                    if a in cset and b in cset), default=1))
            path = " -> ".join(cycle + cycle[:1])
            out.append(finding(
                self.id, self.severity, f"{art.path}:{line}",
                f"lock-order inversion: {path} — these locks are acquired "
                f"in opposite orders on different paths; two threads "
                f"interleaving them deadlock", cycle=tuple(cycle)))
        return out


@register
class HoldHazardRule(Rule):
    id = "lock-hold-hazard"
    layer = "ast"
    severity = "error"
    doc = ("blocking operation under a lock (wire/broker round-trip, socket "
           "send/recv, queue get/put with timeout, subprocess, time.sleep, "
           "event wait, user-callback invocation) — stalls every contender "
           "and can self-deadlock (the final-frame-callback class)")

    def check(self, art, ctx: RuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for hz in _model(art).hazards:
            held = ", ".join(hz.held)
            out.append(finding(
                self.id, self.severity, f"{art.path}:{hz.line}",
                f"{hz.label} while holding {held} — blocking inside the "
                f"critical section stalls every contender (and any callback "
                f"that re-enters the lock deadlocks); move it outside the "
                f"lock", held=hz.held))
        return out


@register
class LeafViolationRule(Rule):
    id = "lock-leaf-violation"
    layer = "ast"
    severity = "error"
    doc = ("a `# zoo-lock: leaf` lock acquires another lock while held — "
           "the leaf declaration (what makes nesting it under other locks "
           "deadlock-free) no longer holds")

    def check(self, art, ctx: RuleContext) -> Iterable[Finding]:
        model = _model(art)
        out: List[Finding] = []
        for e in model.edges:
            if e.src in model.leaf_locks:
                out.append(finding(
                    self.id, self.severity, f"{art.path}:{e.line}",
                    f"{e.src} is declared `zoo-lock: leaf` but acquires "
                    f"{e.dst} while held — drop the leaf declaration or "
                    f"move the acquisition out", src=e.src, dst=e.dst))
        return out


@register
class UnusedLockRule(Rule):
    id = "lock-unused"
    layer = "ast"
    severity = "warning"
    doc = ("a lock constructed but never acquired in its module — dead "
           "weight, or state the author believed was guarded and is not")

    def check(self, art, ctx: RuleContext) -> Iterable[Finding]:
        model = _model(art)
        out: List[Finding] = []
        seen = set()
        for info in model.all_locks().values():
            if info.name in seen:
                continue
            seen.add(info.name)
            if info.alias_of:       # the Condition rides its inner lock
                continue
            if not model.acquisitions.get(info.name):
                out.append(finding(
                    self.id, self.severity, f"{art.path}:{info.line}",
                    f"lock {info.name} is created but never acquired in "
                    f"this module — remove it, or guard the state it was "
                    f"meant to protect", lock=info.name))
        return out


@register
class ReachInRule(Rule):
    id = "lock-reachin"
    layer = "ast"
    severity = "warning"
    doc = ("`with other._lock:` acquires another object's private lock — "
           "the owning class should expose the locked operation (reach-ins "
           "hide lock-order edges from both owners)")

    def check(self, art, ctx: RuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for r in _model(art).reachins:
            out.append(finding(
                self.id, self.severity, f"{art.path}:{r.line}",
                f"acquiring {r.expr} reaches into another object's private "
                f"lock — add a method on the owning class (its lock-order "
                f"and guarded-by facts are invisible from here)",
                expr=r.expr))
        return out
