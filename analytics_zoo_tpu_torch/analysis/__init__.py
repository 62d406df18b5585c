"""Graph-lint: rule-driven static analysis of the port's traced calls and
host code (port of ``analytics_zoo_tpu/analysis``).

Layers over one rule engine (:mod:`analysis.core`):

* **Graph layer** (:mod:`analysis.trace`, :mod:`analysis.graphlint`,
  :mod:`analysis.rules`) — a call is recorded without running
  (:func:`trace_call`: fake tensors under a dispatch recorder; each kernel
  wrapper and collective records one site), and rules walk the trace:
  collective budgets (the ZeRO-1 one-reduce-scatter/one-all-gather
  invariant), the fused-int8 dispatch structure, the decode step's
  shape stability, host reads of device values inside a step, host arrays
  uploaded inside it, dtype discipline, and recompilation hazards.
* **Host layer** (:mod:`analysis.astlint`) — an AST lint for the hazards
  around the traced and captured regions: host reads and wall-clock reads
  inside functions under ``torch.compile``/``torch.jit``/``torch.func``/
  CUDA-graph capture, unregistered ``chaos_point`` sites. Inline
  suppressions: ``# zoo-lint: disable=<rule> — reason``.
* **Concurrency tier** (:mod:`analysis.concurrency` +
  :mod:`analysis.rules.concurrency`) — per-class lock models, guarded-by
  inference, the static lock-order graph and its cycles, hold hazards, and
  the run-time witness of :mod:`analytics_zoo_tpu_torch.common.locks`
  checked by :func:`check_witness`.
* **Memory tier** (:mod:`analysis.memory` + :mod:`analysis.rules.memory`)
  — a live-range walk of the trace (in-place writes and views allocate
  nothing; kernel sites add their outputs and scratch) feeding
  ``hbm-budget``, ``peak-temporary``, ``cache-alias`` and the trace half of
  ``donation-missed``; the run-time allocation witness
  (:mod:`analytics_zoo_tpu_torch.common.memwitness`,
  ``ZOO_TPU_MEM_WITNESS``) and :func:`check_memory_witness`.

Wired three ways: the CLI (``python -m analytics_zoo_tpu_torch.analysis``)
lints the package; ``TrainConfig.graph_checks`` runs the trace rules on the
recorded train step at ``Estimator.fit`` start; the decode and int8
warm-ups run them at model load. Findings are counted into
``zoo_analysis_findings_total{rule,severity}``.
"""

from .core import (CATALOG_EXTRAS, Finding, GraphLintError, Rule,
                   RuleContext, RULE_ALIASES, all_rules, enforce, finding,
                   get_rule, register, report)
from .trace import Trace, trace_call
from .graphlint import (SignatureTracker, lint_signatures, lint_trace,
                        lint_traced)
from .astlint import lint_file, lint_package, lint_source
from .concurrency import (build_module_model, check_witness,
                          collect_lock_graph, find_cycles)
from .memory import (MemoryProfile, check_memory_witness, memory_fields,
                     profile_trace)

__all__ = [
    "CATALOG_EXTRAS", "Finding", "GraphLintError", "MemoryProfile", "Rule",
    "RuleContext", "RULE_ALIASES", "SignatureTracker", "Trace", "all_rules",
    "build_module_model", "check_memory_witness", "check_witness",
    "collect_lock_graph", "enforce", "find_cycles", "finding", "get_rule",
    "lint_file", "lint_package", "lint_signatures", "lint_source",
    "lint_trace", "lint_traced", "memory_fields", "profile_trace",
    "register", "report", "trace_call",
]
