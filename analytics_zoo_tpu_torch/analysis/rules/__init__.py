"""Rule catalog: importing this package registers every shipped rule (port
of ``analytics_zoo_tpu/analysis/rules``).

Graph layer (recorded traces): :mod:`collectives` (ZeRO-1 collective
budgets), :mod:`fused_int8` (the K5/K6 dispatch structure), :mod:`decode`
(the decode step's shape stability), :mod:`graph_hygiene` (host reads,
uploaded constants, dtype discipline, recompilation hazards),
:mod:`memory` (budgets, outsized temporaries, cache aliasing, the trace
half of donation-missed). Host layer (AST): the tracer/wall-clock/chaos
rules live in :mod:`analysis.astlint`; the concurrency tier in
:mod:`concurrency`. Docs layer: :mod:`docs` (``metric-doc-drift``).
"""

from . import (collectives, concurrency, decode, docs,  # noqa: F401
               fused_int8, graph_hygiene, memory)
from .. import astlint  # noqa: F401  (registers the AST rules)

from .collectives import trace_collective_counts
from .decode import lint_decode_stability, lint_prefix_write_isolation
from .docs import NOT_YET_PORTED, check_metric_doc_drift, render_metric_table
from .fused_int8 import fused_dispatch_report, fused_structure_counts
from .memory import (flatten_donation, lint_donation, lint_memory,
                     lint_sharded_gather)

__all__ = [
    "NOT_YET_PORTED", "check_metric_doc_drift", "collectives", "concurrency",
    "decode", "docs", "flatten_donation", "fused_dispatch_report",
    "fused_int8", "fused_structure_counts", "graph_hygiene",
    "lint_decode_stability", "lint_donation", "lint_memory",
    "lint_prefix_write_isolation", "lint_sharded_gather", "memory",
    "render_metric_table", "trace_collective_counts",
]
