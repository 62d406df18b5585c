"""Docs rules: ``metric-doc-drift`` — code vs. docs/observability.md (port of
``analytics_zoo_tpu/analysis/rules/docs.py``).

The metric reference in ``docs/observability.md`` is the operator's contract:
alert rules, dashboards and the SLO objectives are written against it, and
the port registers the JAX package's families under the same names. This
rule makes drift between the port's registrations and the doc a failure:

* every ``zoo_*`` metric family registered in code (a literal first argument
  to ``counter``/``gauge``/``histogram``/``collector``, module-level or
  registry-method) must appear as a table row in the doc;
* every ``zoo_*`` name in a doc TABLE row must be registered somewhere in
  the package (prose mentions are free — only tables are contract).

The doc is the JAX package's, shared by both packages. The names it lists
that the port does not register yet are :data:`NOT_YET_PORTED`, each tied
to the ROADMAP item that ports it: they are not findings (a test holds the
list to exactly what is missing).

``python -m analytics_zoo_tpu_torch.analysis`` runs it on whole-package
lints; ``--metrics-doc`` prints regenerated table rows.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Tuple

from ..core import Finding, Rule, RuleContext, finding, register

_REG_FUNCS = frozenset(("counter", "gauge", "histogram", "collector"))
# `zoo_...` inside backticks on a markdown table row; label-set suffixes
# (`{rule,severity}`) and exposition suffixes are stripped
_DOC_NAME_RE = re.compile(r"`(zoo_[a-zA-Z0-9_]+)")

DOC_RELPATH = os.path.join("docs", "observability.md")

#: documented families the port does not register yet -> the ROADMAP item
#: that brings them (none since the tile table registered the last three)
NOT_YET_PORTED: Dict[str, str] = {}


def _call_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def registered_metrics(paths: Iterable[str]
                       ) -> Dict[str, Tuple[str, str, str]]:
    """``{name: (location, kind, help)}`` for every literal ``zoo_*`` metric
    registration under ``paths`` (files or directories)."""
    out: Dict[str, Tuple[str, str, str]] = {}

    def scan_file(path: str) -> None:
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _call_name(node.func)
            if kind not in _REG_FUNCS or not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.startswith("zoo_")):
                continue
            help_txt = ""
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                help_txt = node.args[1].value
            name = first.value
            if name not in out:       # first registrant's help wins
                out[name] = (f"{path}:{node.lineno}", kind, help_txt)

    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        scan_file(os.path.join(dirpath, fname))
        elif path.endswith(".py"):
            scan_file(path)
    return out


def documented_metrics(doc_path: str) -> Dict[str, int]:
    """``{name: first_table_lineno}`` for every ``zoo_*`` name appearing in
    a markdown TABLE row (lines starting with ``|``) of the doc."""
    out: Dict[str, int] = {}
    with open(doc_path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            if not line.lstrip().startswith("|"):
                continue
            for m in _DOC_NAME_RE.finditer(line):
                out.setdefault(m.group(1), lineno)
    return out


def check_metric_doc_drift(package_paths: Iterable[str],
                           doc_path: str) -> List[Finding]:
    """Cross-check registrations vs. the doc's tables (both directions)."""
    code = registered_metrics(package_paths)
    doc = documented_metrics(doc_path)
    out: List[Finding] = []
    for name in sorted(set(code) - set(doc)):
        loc, kind, _help = code[name]
        out.append(finding(
            "metric-doc-drift", "error", loc,
            f"metric {name!r} ({kind}) is registered here but has no table "
            f"row in {DOC_RELPATH} — run `python -m analytics_zoo_tpu_torch"
            f".analysis --metrics-doc` for a regenerated row"))
    for name in sorted(set(doc) - set(code) - set(NOT_YET_PORTED)):
        out.append(finding(
            "metric-doc-drift", "error", f"{doc_path}:{doc[name]}",
            f"documented metric {name!r} is not registered anywhere in the "
            f"package and not in NOT_YET_PORTED — renamed, removed, or a "
            f"port that lost it"))
    return out


def render_metric_table(package_paths: Iterable[str]) -> str:
    """Markdown table rows for every registered metric — the regeneration
    helper behind ``--metrics-doc``."""
    code = registered_metrics(package_paths)
    lines = ["| metric | kind | meaning |", "|---|---|---|"]
    for name in sorted(code):
        _loc, kind, help_txt = code[name]
        help_txt = " ".join(help_txt.split()) or "(no help string)"
        lines.append(f"| `{name}` | {kind} | {help_txt} |")
    return "\n".join(lines)


@register
class MetricDocDriftRule(Rule):
    """Catalog entry; the check itself needs the whole package + the doc,
    so ``__main__`` drives :func:`check_metric_doc_drift` on package-wide
    lints rather than the per-file AST traversal."""

    id = "metric-doc-drift"
    layer = "docs"
    severity = "error"
    doc = ("a zoo_* metric family registered in code is missing from the "
           "docs/observability.md metric tables, or a documented name is no "
           "longer registered — the operator contract rotted")

    def check(self, artifact, ctx: RuleContext) -> Iterable[Finding]:
        package_paths, doc_path = artifact
        return check_metric_doc_drift(package_paths, doc_path)
