"""Rule engine core: findings, rules, registry, enforcement (port of
``analytics_zoo_tpu/analysis/core.py``).

A :class:`Rule` walks an artifact (a recorded op trace of one call, a
recorded signature history, or Python source) and emits structured
:class:`Finding`\\ s; callers decide whether findings warn, raise, or fail
a CI gate.

Layers (``Rule.layer``):

* ``"trace"`` — the rule's ``check`` receives a :class:`~analytics_zoo_tpu_
  torch.analysis.trace.Trace`, the port's counterpart of a traced jaxpr
  (:mod:`analysis.graphlint` runs it; :mod:`analysis.trace` records it).
* ``"signatures"`` — ``check`` receives an iterable of dispatch signatures
  recorded at run time (:class:`analysis.graphlint.SignatureTracker`).
* ``"ast"`` — ``check`` receives a parsed Python module
  (:mod:`analysis.astlint` owns traversal and inline suppressions).
* ``"docs"`` — ``check`` receives ``(package paths, doc path)``.

The JAX package's ``"hlo"`` layer has no counterpart: the port compiles no
HLO. :data:`CATALOG_EXTRAS` names the rule ids that are implemented outside
the registry (or not at all) so ``--list-rules`` lists every JAX rule id.

Every emitted finding lands in ``zoo_analysis_findings_total{rule,severity}``
on the port's registry.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Type

from ..common import telemetry as _tm

logger = logging.getLogger("analytics_zoo_tpu_torch.analysis")

_FINDINGS = _tm.counter("zoo_analysis_findings_total",
                        "Static-analysis findings emitted (graph + AST "
                        "layers; suppressed findings are not counted)",
                        labels=("rule", "severity"))

#: Severity ladder (ordered weakest → strongest).
SEVERITIES = ("info", "warning", "error")


class GraphLintError(RuntimeError):
    """Raised by :func:`enforce` in ``"raise"`` mode: a graph invariant the
    caller declared load-bearing does not hold. Carries the findings."""

    def __init__(self, findings: Sequence["Finding"]):
        self.findings = list(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"{len(self.findings)} graph-lint finding(s):\n{lines}")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured analyzer result."""

    rule: str                     # rule id, e.g. "fused-int8-dispatch"
    severity: str                 # "info" | "warning" | "error"
    location: str                 # "path:line", "trace:<where>", ...
    message: str
    data: Tuple[Tuple[str, Any], ...] = ()   # structured extras (sorted kv)

    def __str__(self) -> str:
        return f"{self.location}: [{self.severity}] {self.rule}: {self.message}"

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "location": self.location, "message": self.message,
                "data": dict(self.data)}


def finding(rule: str, severity: str, location: str, message: str,
            **data) -> Finding:
    """Build a :class:`Finding` (validates severity, normalizes data)."""
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}")
    return Finding(rule, severity, location, message,
                   tuple(sorted(data.items())))


@dataclasses.dataclass
class RuleContext:
    """Per-run configuration shared by every rule.

    ``where`` prefixes finding locations so a fit-time check reads
    ``trace:estimator.fit`` while a warmup check reads
    ``trace:inference.load``. The remaining knobs parameterize individual
    rules; a rule whose knob is unset (``None``) stays silent rather than
    guessing an expectation.
    """

    where: str = ""
    # collective-budget: {"reduce-scatter": 1, ...} — ONLY listed keys are
    # compared, so incidental all-reduces (loss pmean) don't false-positive
    expect_collectives: Optional[Dict[str, int]] = None
    # fused-int8-dispatch: the caller asserts the fused kernel tier should be
    # active for this computation (quantized model + fused_mode() != "off")
    fused_expected: bool = False
    # dtype-discipline: declared compute dtype ("bfloat16") for the region
    compute_dtype: Optional[str] = None
    # large-constant: host arrays at/above this many bytes uploaded inside
    # the traced call are flagged
    const_bytes_limit: int = 1 << 20
    # recompile-hazard: distinct dispatch signatures allowed before flagging
    max_signatures: Optional[int] = None
    # decode-shape-stability: the (shape, dtype-name) of every KV-cache leaf
    # the traced decode step carries — the rule asserts each one comes back
    # among the outputs as the same tensor (written in place, no per-step
    # growth) and bounds intermediate sizes by the largest cache leaf
    decode_cache_avals: Optional[Sequence[Tuple[Tuple[int, ...], str]]] = None
    # memory tier (analysis/memory.py + rules/memory.py):
    # hbm-budget: declared per-device HBM budget; the static live-range peak
    # (and, via the witness, the measured peak) must stay under it
    hbm_budget_bytes: Optional[int] = None
    # donation-missed: which flattened arg leaves are DEAD after the call
    # (the caller replaces them with the call's results) and so should be
    # written in place — the port's counterpart of donation
    dead_invars: Optional[Sequence[bool]] = None
    # peak-temporary: byte bound a single HBM temporary may not exceed
    # (None = the largest argument leaf, i.e. "the largest model leaf")
    param_leaf_bytes: Optional[int] = None


class Rule:
    """Base class: subclasses set ``id``/``layer``/``severity`` and implement
    ``check(artifact, ctx) -> Iterable[Finding]``."""

    id: str = ""
    layer: str = ""               # "trace" | "signatures" | "ast" | "docs"
    severity: str = "error"       # default severity for this rule's findings
    doc: str = ""                 # one-line catalog entry (docs + --list-rules)

    def check(self, artifact: Any, ctx: RuleContext) -> Iterable[Finding]:
        raise NotImplementedError

    def emit(self, ctx: RuleContext, message: str, line: Optional[int] = None,
             severity: Optional[str] = None, **data) -> Finding:
        loc = f"{self.layer}:{ctx.where or '<anon>'}"
        if line is not None:
            loc += f":{line}"
        return finding(self.id, severity or self.severity, loc, message,
                       **data)


_REGISTRY: Dict[str, Rule] = {}

#: historical rule names that generalized into a successor: resolved by
#: :func:`get_rule` and honored by inline ``zoo-lint: disable=`` comments
#: (``telemetry-lock`` became the inferred guarded-by rule).
RULE_ALIASES: Dict[str, str] = {"telemetry-lock": "lock-guarded-by"}

#: rule ids the JAX package catalogs that are not registered :class:`Rule`\\ s
#: here: ``id -> (layer, severity, what implements it or why nothing does)``
CATALOG_EXTRAS: Dict[str, Tuple[str, str, str]] = {
    "donation-missed": (
        "trace", "error",
        "Trace half (analysis.rules.memory.lint_donation): a state leaf the "
        "caller replaces with the call's result is not written in place "
        "(TrainConfig(donate_state=False) keeps the pre-step tensors "
        "alive). AST half: no counterpart — torch has no donate_argnums, "
        "so there is no rebind-without-donation pattern to find"),
    "mem-witness-divergence": (
        "witness", "warning",
        "analysis.memory.check_memory_witness: a site's measured peak is "
        "more than 2x its static estimate and more than 64 MiB above it"),
    "collective-budget-hlo": (
        "none", "error",
        "No counterpart: the port compiles no HLO, so there is no "
        "post-partitioner collective to count; collective-budget counts "
        "the traced step's collective sites"),
}


def register(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator: instantiate + register a rule by id."""
    rule = cls()
    if not rule.id or not rule.layer:
        raise ValueError(f"rule {cls.__name__} needs id and layer")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules(layer: Optional[str] = None) -> List[Rule]:
    """Registered rules, optionally filtered by layer. Importing
    :mod:`analysis.rules` populates the registry."""
    from . import rules as _rules  # noqa: F401 (registration side effect)

    out = [r for r in _REGISTRY.values() if layer is None or r.layer == layer]
    return sorted(out, key=lambda r: r.id)


def get_rule(rule_id: str) -> Rule:
    from . import rules as _rules  # noqa: F401

    rule_id = RULE_ALIASES.get(rule_id, rule_id)
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise KeyError(f"unknown rule {rule_id!r}; known: "
                       f"{sorted(_REGISTRY)}") from None


def report(findings: Sequence[Finding]) -> List[Finding]:
    """Count findings into ``zoo_analysis_findings_total`` and return them
    (every lint entry point funnels through here exactly once)."""
    for f in findings:
        _FINDINGS.labels(rule=f.rule, severity=f.severity).inc()
    return list(findings)


def enforce(findings: Sequence[Finding], mode: Optional[str],
            log: Optional[logging.Logger] = None) -> List[Finding]:
    """Apply a ``graph_checks``-style policy to findings.

    ``mode``: ``None``/``"off"`` = no-op; ``"warn"`` = log each finding;
    ``"raise"`` = log warnings/infos, raise :class:`GraphLintError` when any
    error-severity finding is present. Returns the findings either way.
    """
    if not mode or mode == "off":
        return list(findings)
    if mode not in ("warn", "raise"):
        raise ValueError(f"graph_checks must be 'off'/'warn'/'raise', "
                         f"got {mode!r}")
    log = log or logger
    errors = [f for f in findings if f.severity == "error"]
    for f in findings:
        if mode == "warn" or f.severity != "error":
            log.warning("graph-lint: %s", f)
    if mode == "raise" and errors:
        raise GraphLintError(errors)
    return list(findings)
