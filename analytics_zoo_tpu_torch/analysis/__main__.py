"""CLI: lint the port's host code (port of ``analytics_zoo_tpu/analysis/
__main__.py``).

    python -m analytics_zoo_tpu_torch.analysis              # lint the package
    python -m analytics_zoo_tpu_torch.analysis path1 path2  # lint files/dirs
    python -m analytics_zoo_tpu_torch.analysis --json       # machine-readable
    python -m analytics_zoo_tpu_torch.analysis --list-rules # rule catalog
    python -m analytics_zoo_tpu_torch.analysis --rules 'lock-*'
                                                    # only matching rules
    python -m analytics_zoo_tpu_torch.analysis --witness w.jsonl
                                                    # check a recorded
                                                    # lock-order witness
    python -m analytics_zoo_tpu_torch.analysis --mem-witness m.jsonl \\
        --budget-mb 64                              # check a recorded
                                                    # allocation witness

Exit status: 1 when any unsuppressed error-severity finding remains, else 0.
Trace-layer rules need a recorded call and therefore run at fit and
model-load time, not here — ``--list-rules`` still catalogs them, with the
JAX rule ids that are implemented outside the registry or have no
counterpart (``core.CATALOG_EXTRAS``).

``--witness`` is the lock witness's offline half: it loads the JSONL a
:class:`~analytics_zoo_tpu_torch.common.locks.TracedLock` run dumped
(``ZOO_TPU_TRACE_LOCKS=1 ZOO_TPU_LOCK_WITNESS=<path>``), unions the
witnessed acquisition edges with the static lock-order graph of the linted
paths, and fails on any cycle or leaf-lock violation (plus over-budget holds
when ``--max-hold-s``/``ZOO_TPU_LOCK_MAX_HOLD_S`` is set) — so CI and local
debugging drive the same checker. Both packages write and read one
format.

``--mem-witness`` is the memory tier's analog: it loads the JSONL a
``ZOO_TPU_MEM_WITNESS=<path>`` run dumped (device bytes sampled at step and
dispatch boundaries, plus the static peak estimates noted alongside them)
and fails when a site's measured peak exceeds its declared HBM budget
(``--budget-mb``/``ZOO_TPU_HBM_BUDGET_MB`` as the global fallback), warning
when it diverges far above the static estimate — allocation the traced
computation cannot see.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys

from . import all_rules
from .astlint import lint_file, lint_package


def _env_max_hold_s():
    """ZOO_TPU_LOCK_MAX_HOLD_S as a float, or None — a malformed value must
    not crash plain lint runs that never touch witness mode."""
    raw = os.environ.get("ZOO_TPU_LOCK_MAX_HOLD_S")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        print(f"[zoo-lint] ignoring malformed ZOO_TPU_LOCK_MAX_HOLD_S="
              f"{raw!r} (want a float)", file=sys.stderr)
        return None


def _selected_rules(pattern):
    """AST-layer rules whose id matches the ``--rules`` glob (None = all)."""
    if pattern is None:
        return None
    sel = [r for r in all_rules("ast") if fnmatch.fnmatch(r.id, pattern)]
    if not sel:
        raise SystemExit(f"--rules {pattern!r} matches no AST rule; known: "
                         f"{[r.id for r in all_rules('ast')]}")
    return sel


def _env_budget_mb():
    raw = os.environ.get("ZOO_TPU_HBM_BUDGET_MB")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        print(f"[zoo-lint] ignoring malformed ZOO_TPU_HBM_BUDGET_MB="
              f"{raw!r} (want a float)", file=sys.stderr)
        return None


def _check_mem_witness(witness_path, budget_mb):
    from ..common.memwitness import load_witness
    from .core import report
    from .memory import check_memory_witness

    samples, statics = load_witness(witness_path)
    findings = report(check_memory_witness(
        samples, statics,
        budget_bytes=int(budget_mb * 2 ** 20) if budget_mb else None,
        where=os.path.basename(witness_path)))
    return findings, samples, statics


def _check_witness(witness_path, paths, max_hold_s):
    from ..common.locks import load_witness
    from .concurrency import check_witness, collect_lock_graph
    from .core import report

    static_edges, leaves, declared = [], set(), []
    for path in paths:
        e, lv, de = collect_lock_graph(path)
        static_edges.extend((x.src, x.dst) for x in e)
        leaves |= lv
        declared.extend(de)
    static_edges.extend((a, b) for a, b, _line in declared)
    w_edges, w_holds = load_witness(witness_path)
    findings = report(check_witness(
        static_edges, w_edges, leaf_locks=leaves,
        max_holds=w_holds, max_hold_s=max_hold_s,
        where=os.path.basename(witness_path)))
    return findings, len(w_edges), len(set(static_edges))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.analysis",
        description="Graph-lint host-layer CLI of the PyTorch package "
                    "(AST and docs rules; witness checks)")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to lint (default: the "
                             "analytics_zoo_tpu_torch package)")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as one JSON object")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog (all layers) and exit")
    parser.add_argument("--rules", metavar="GLOB", default=None,
                        help="run only AST rules whose id matches this glob "
                             "(e.g. 'lock-*' for the concurrency tier)")
    parser.add_argument("--witness", metavar="JSONL", default=None,
                        help="check a recorded lock-order witness "
                             "(TracedLock dump) against the static lock "
                             "graph of PATHS instead of linting source")
    parser.add_argument("--max-hold-s", type=float, default=None,
                        help="with --witness: fail locks observed held "
                             "longer than this many seconds (default: env "
                             "ZOO_TPU_LOCK_MAX_HOLD_S, else off)")
    parser.add_argument("--mem-witness", metavar="JSONL", default=None,
                        help="check a recorded memory witness "
                             "(ZOO_TPU_MEM_WITNESS dump) against the "
                             "device-memory budget and the static peak "
                             "estimates noted in it")
    parser.add_argument("--budget-mb", type=float, default=None,
                        help="with --mem-witness: global per-device "
                             "memory budget in MiB for sites without a recorded "
                             "budget (default: env ZOO_TPU_HBM_BUDGET_MB, "
                             "else off)")
    parser.add_argument("--metrics-doc", action="store_true",
                        help="print regenerated docs/observability.md "
                             "metric-table rows for every registered zoo_* "
                             "family and exit (the metric-doc-drift repair "
                             "helper)")
    args = parser.parse_args(argv)
    if args.max_hold_s is None:
        args.max_hold_s = _env_max_hold_s()
    if args.budget_mb is None:
        args.budget_mb = _env_budget_mb()
    if (args.witness is not None or args.mem_witness is not None) \
            and args.rules is not None:
        parser.error("--rules filters source lint rules and does not apply "
                     "to witness checks; pass one or the other")

    if args.list_rules:
        from .core import CATALOG_EXTRAS

        for rule in all_rules():
            print(f"{rule.id:24s} [{rule.layer}/{rule.severity}] {rule.doc}")
        for rid, (layer, severity, doc) in sorted(CATALOG_EXTRAS.items()):
            print(f"{rid:24s} [{layer}/{severity}] {doc}")
        return 0

    # default target: the analytics_zoo_tpu_torch package this module is in
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = args.paths or [pkg_root]

    if args.metrics_doc:
        from .rules.docs import render_metric_table

        print(render_metric_table(paths))
        return 0

    if args.witness is not None or args.mem_witness is not None:
        findings, extra, detail = [], {}, []
        if args.witness is not None:
            fs, n_witnessed, n_static = _check_witness(
                args.witness, paths, args.max_hold_s)
            findings += fs
            extra.update(witnessed_edges=n_witnessed, static_edges=n_static)
            detail.append(f"{n_witnessed} witnessed edge(s) ∪ "
                          f"{n_static} static edge(s)")
        if args.mem_witness is not None:
            fs, samples, statics = _check_mem_witness(
                args.mem_witness, args.budget_mb)
            findings += fs
            extra.update(mem_sites=samples, mem_statics=statics)
            detail.append(f"{len(samples)} memory site(s), "
                          f"{len(statics)} static peak record(s)")
        errors = [f for f in findings if f.severity == "error"]
        if args.json:
            print(json.dumps({
                "findings": [f.as_dict() for f in findings],
                "errors": len(errors), **extra}, indent=1))
        else:
            for f in findings:
                print(f)
            print(f"[zoo-lint] witness: {'; '.join(detail)}; "
                  f"{len(findings)} finding(s) ({len(errors)} error(s))",
                  file=sys.stderr)
        return 1 if errors else 0

    rules = _selected_rules(args.rules)
    findings, suppressed = [], 0
    for path in paths:
        if os.path.isdir(path):
            fs, ns = lint_package(path, rules=rules)
        else:
            fs, ns = lint_file(path, rules=rules)
        findings.extend(fs)
        suppressed += ns

    # metric-doc-drift runs on whole-package lints only (explicit PATHS lint
    # a slice, where "registered but undocumented" would false-positive the
    # other direction); the doc lives beside the package checkout
    if not args.paths and args.rules is None:
        doc_path = os.path.join(os.path.dirname(pkg_root), "docs",
                                "observability.md")
        if os.path.exists(doc_path):
            from .core import report
            from .rules.docs import check_metric_doc_drift

            findings.extend(report(
                check_metric_doc_drift(paths, doc_path)))

    errors = [f for f in findings if f.severity == "error"]
    if args.json:
        print(json.dumps({
            "findings": [f.as_dict() for f in findings],
            "suppressed": suppressed, "errors": len(errors)}, indent=1))
    else:
        for f in findings:
            print(f)
        print(f"[zoo-lint] {len(findings)} finding(s) "
              f"({len(errors)} error(s)), {suppressed} suppressed",
              file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
