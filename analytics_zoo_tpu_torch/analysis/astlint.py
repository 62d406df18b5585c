"""Host layer: AST lint for the Python-side hazards around the port's
traced and captured regions (port of ``analytics_zoo_tpu/analysis/
astlint.py``).

Trace rules see what a recorded call does; these rules see host code:

* ``tracer-leak`` — ``float()``/``int()``/``bool()``/``np.asarray``/
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` applied to a local value
  inside a function the port freezes at trace or capture time: one under
  ``torch.compile`` (a graph break and a host sync), ``torch.jit.script``/
  ``torch.jit.trace`` (the value freezes into the program),
  ``torch.cuda.make_graphed_callables`` or a ``with torch.cuda.graph(...)``
  capture (a host read there fails the capture), or a ``torch.func``
  transform (``grad``, ``vmap``, ``jacrev``, ... : a host read of a
  transformed value raises).
* ``wallclock-in-jit`` — ``time.*``/``random.*``/``np.random.*``/
  ``datetime.now`` inside such a function: frozen at trace or capture
  time, the "current" or "random" value is replayed every call.
  ``torch``'s own RNG is traced as an op and stays allowed.
* ``chaos-site`` — ``chaos_point("name")`` call sites whose name is not in
  :data:`analytics_zoo_tpu_torch.common.chaos.KNOWN_SITES`: a typo'd site
  never fires, so the drill that targets it tests nothing.

Traced-function detection is heuristic by construction: a function is
traced when it is (a) decorated with one of the wrappers (or a
``functools.partial`` of one), (b) passed by name or inline (lambda /
``functools.partial(name, ...)``) to one, (c) defined inside such a
function, or (d) the body of a ``with torch.cuda.graph(...)`` block. The
ambiguous names (``compile``, ``trace``, ``script``, ``graph``, ``grad``,
``vmap``...) count only when called through ``torch``/``jit``/``func``/
``cuda`` (``torch.compile``, ``jit.trace``), so ``re.compile`` stays out.
False positives are silenced inline with a justified
``# zoo-lint: disable=<rule> — reason``.

The concurrency tier (``lock-*``) shares this module's traversal and
suppression machinery but lives in :mod:`analysis.rules.concurrency` over
the per-class lock models of :mod:`analysis.concurrency`.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import (Finding, Rule, RuleContext, RULE_ALIASES, all_rules,
                   finding, get_rule, register, report)

_SUPPRESS_RE = re.compile(r"zoo-lint:\s*disable=([\w,-]+)")

#: callables whose function-valued arguments get traced or captured,
#: mapped to the positional slots that hold functions
TRACE_WRAPPERS: Dict[str, Tuple[int, ...]] = {
    "compile": (0,), "script": (0,), "trace": (0,),
    "make_graphed_callables": (0,), "grad": (0,), "grad_and_value": (0,),
    "vmap": (0,), "jacrev": (0,), "jacfwd": (0,), "hessian": (0,),
    "jvp": (0,), "vjp": (0,), "linearize": (0,),
}
#: wrapper names that count only through these chain roots/links
_QUALIFIED = frozenset(("compile", "script", "trace", "grad", "vmap",
                        "jvp", "vjp", "hessian", "linearize"))
_TORCH_LINKS = frozenset(("torch", "jit", "func", "cuda"))
#: keyword names that hold functions in the wrappers above
_FN_KEYWORDS = frozenset(("f", "fn", "func", "model", "callables"))

_CAST_BUILTINS = frozenset(("float", "int", "bool", "complex"))
_NP_BASES = frozenset(("np", "numpy", "onp"))
_NP_MATERIALIZERS = frozenset(("asarray", "array", "ascontiguousarray"))
_HOST_METHODS = frozenset(("item", "tolist", "cpu", "numpy"))
_WALLCLOCK: Tuple[Tuple[str, Optional[frozenset]], ...] = (
    # (base name — the chain ROOT, so torch's RNG stays allowed — and the
    # attr set; None = any attribute)
    ("time", frozenset(("time", "time_ns", "perf_counter",
                        "perf_counter_ns", "monotonic", "monotonic_ns"))),
    ("datetime", frozenset(("now", "utcnow", "today"))),
    ("random", None),
    ("uuid", frozenset(("uuid1", "uuid4"))),
    ("os", frozenset(("urandom",))),
)


def _attr_chain(node: ast.AST) -> List[str]:
    """``a.b.c`` -> ["a", "b", "c"] (empty when the base isn't a Name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _call_target_name(func: ast.AST) -> Optional[str]:
    """Terminal callable name of ``torch.compile`` / ``vmap``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _wrapper_name(func: ast.AST) -> Optional[str]:
    """The trace wrapper ``func`` names, or None: an ambiguous name counts
    only through a ``torch``/``jit``/``func``/``cuda`` link."""
    name = _call_target_name(func)
    if name not in TRACE_WRAPPERS:
        return None
    if name in _QUALIFIED:
        chain = _attr_chain(func)
        if not _TORCH_LINKS & set(chain[:-1]):
            return None
    return name


def _is_graph_capture(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` (or ``cuda.graph(g)``)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call) and _call_target_name(e.func) == "graph" \
                and "cuda" in _attr_chain(e.func)[:-1]:
            return True
    return False


@dataclasses.dataclass
class SourceArtifact:
    """One parsed module plus the derived facts the AST rules share."""

    path: str
    src: str
    tree: ast.Module
    lines: List[str]
    parents: Dict[int, ast.AST]                 # id(node) -> parent
    traced_fns: List[ast.AST]                   # FunctionDef/Lambda nodes
    chaos_sites: frozenset

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)


def _build_artifact(src: str, path: str,
                    chaos_sites: Optional[Iterable[str]]) -> SourceArtifact:
    tree = ast.parse(src, filename=path)
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node

    # --- pass 1: which function names / inline defs get traced ------------
    traced_names: Set[str] = set()
    traced_nodes: List[ast.AST] = []

    def note_fn_arg(arg: ast.AST) -> None:
        if isinstance(arg, ast.Name):
            traced_names.add(arg.id)
        elif isinstance(arg, ast.Lambda):
            traced_nodes.append(arg)
        elif isinstance(arg, (ast.List, ast.Tuple)):
            for elt in arg.elts:        # switch's branches list
                note_fn_arg(elt)
        elif isinstance(arg, ast.Call):
            # functools.partial(kernel, ...) passed inline to a wrapper
            if _call_target_name(arg.func) == "partial" and arg.args:
                note_fn_arg(arg.args[0])

    for node in ast.walk(tree):
        if _is_graph_capture(node):
            traced_nodes.append(node)
        if isinstance(node, ast.Call):
            fn_slots = TRACE_WRAPPERS.get(_wrapper_name(node.func))
            if fn_slots is not None:
                for i in fn_slots:
                    if i < len(node.args):
                        note_fn_arg(node.args[i])
                for kw in node.keywords:
                    if kw.arg in _FN_KEYWORDS:
                        note_fn_arg(kw.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                name = (_wrapper_name(dec.func) if isinstance(dec, ast.Call)
                        else _wrapper_name(dec))
                if name is not None:
                    traced_nodes.append(node)
                elif (isinstance(dec, ast.Call)
                        and _call_target_name(dec.func) == "partial"
                        and dec.args
                        and _wrapper_name(dec.args[0]) is not None):
                    traced_nodes.append(node)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in traced_names:
            traced_nodes.append(node)
    # a def nested inside a traced function (or capture block) is traced too
    expanded: List[ast.AST] = []
    seen: Set[int] = set()
    for fn in traced_nodes:
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.With, ast.AsyncWith)) \
                    and id(node) not in seen and (
                        node is fn or not isinstance(node, (ast.With,
                                                            ast.AsyncWith))):
                seen.add(id(node))
                expanded.append(node)
    return SourceArtifact(path=path, src=src, tree=tree,
                          lines=src.splitlines(), parents=parents,
                          traced_fns=expanded,
                          chaos_sites=frozenset(chaos_sites or ()))


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters + names assigned inside ``fn`` (the values that are traced
    at runtime; module globals/constants are not)."""
    out: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.args + args.posonlyargs + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            out.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
            tgt = getattr(node, "target", None)
            if tgt is not None:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    out.discard("self")
    return out


def _refs_local(node: ast.AST, local: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in local
               for n in ast.walk(node))


# ------------------------------------------------------------------ AST rules

@register
class TracerLeakRule(Rule):
    id = "tracer-leak"
    layer = "ast"
    severity = "error"
    doc = ("float()/int()/bool()/np.asarray/.item()/.tolist()/.cpu()/"
           ".numpy() applied to a local value inside a traced or captured "
           "function — a graph break, a frozen value or a failed capture")

    def check(self, art: SourceArtifact, ctx: RuleContext
              ) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in art.traced_fns:
            local = _local_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                # the call must consume a LOCAL of the traced function — a
                # float()/np.asarray() of a module constant is trace-time
                # static and perfectly fine
                label = None
                if isinstance(node.func, ast.Name) \
                        and node.func.id in _CAST_BUILTINS:
                    if node.args and _refs_local(node.args[0], local):
                        label = f"{node.func.id}()"
                elif isinstance(node.func, ast.Attribute):
                    chain = _attr_chain(node.func)
                    arg_is_local = bool(node.args
                                        and _refs_local(node.args[0], local))
                    if (len(chain) >= 2 and chain[0] in _NP_BASES
                            and chain[-1] in _NP_MATERIALIZERS
                            and arg_is_local):
                        label = ".".join(chain)
                    elif node.func.attr in _HOST_METHODS and not node.args \
                            and _refs_local(node.func.value, local):
                        label = f".{node.func.attr}()"
                if label is None:
                    continue
                out.append(finding(
                    self.id, self.severity,
                    f"{art.path}:{node.lineno}",
                    f"{label} on a traced value inside a traced or "
                    f"captured function — a host sync per call (a graph "
                    f"break under torch.compile, a frozen constant under "
                    f"torch.jit.trace, a failed CUDA-graph capture)"))
        return out


@register
class WallclockRule(Rule):
    id = "wallclock-in-jit"
    layer = "ast"
    severity = "error"
    doc = ("time/random/datetime/uuid reads inside a traced or captured "
           "function — the value freezes at trace or capture time and "
           "replays every call")

    def check(self, art: SourceArtifact, ctx: RuleContext
              ) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in art.traced_fns:
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                chain = _attr_chain(node.func)
                if len(chain) < 2:
                    continue
                # stdlib module reads (chain ROOT match — torch's RNG is
                # traced as an op and must not match) plus np.random.*
                hit = any(chain[0] == base and (attrs is None
                                                or chain[-1] in attrs)
                          for base, attrs in _WALLCLOCK)
                hit = hit or (chain[0] in _NP_BASES and len(chain) >= 3
                              and chain[1] == "random")
                if hit:
                    out.append(finding(
                        self.id, self.severity,
                        f"{art.path}:{node.lineno}",
                        f"{'.'.join(chain)} inside a traced or captured "
                        f"function — evaluated once at trace or capture "
                        f"time, constant thereafter"))
        return out


@register
class ChaosSiteRule(Rule):
    id = "chaos-site"
    layer = "ast"
    severity = "error"
    doc = ("chaos_point() call with a site name not registered in "
           "common.chaos.KNOWN_SITES — a typo'd site never fires and the "
           "drill that targets it tests nothing")

    def check(self, art: SourceArtifact, ctx: RuleContext
              ) -> Iterable[Finding]:
        if not art.chaos_sites:
            return []
        out: List[Finding] = []
        for node in ast.walk(art.tree):
            if not (isinstance(node, ast.Call)
                    and _call_target_name(node.func) == "chaos_point"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            site = node.args[0].value
            if site not in art.chaos_sites:
                out.append(finding(
                    self.id, self.severity,
                    f"{art.path}:{node.lineno}",
                    f"chaos_point site {site!r} is not registered in "
                    f"common.chaos.KNOWN_SITES — register it (or fix the "
                    f"typo) so schedules can target it"))
        return out


# -------------------------------------------------------------- entry points

def _suppressed(f: Finding, lines: List[str]) -> bool:
    """``# zoo-lint: disable=<rule>[,rule2]`` on the finding's line or on a
    pure-comment line immediately above silences it (``disable=all`` too)."""
    try:
        lineno = int(f.location.rsplit(":", 1)[1])
    except (IndexError, ValueError):
        return False
    candidates = []
    if 1 <= lineno <= len(lines):
        candidates.append(lines[lineno - 1])
    if lineno >= 2 and lines[lineno - 2].lstrip().startswith("#"):
        candidates.append(lines[lineno - 2])
    for line in candidates:
        m = _SUPPRESS_RE.search(line)
        if m:
            # historical names resolve through RULE_ALIASES, so a
            # `disable=telemetry-lock` written before the guarded-by
            # generalization still silences its successor's findings
            rules = {RULE_ALIASES.get(r.strip(), r.strip())
                     for r in m.group(1).split(",")}
            if "all" in rules or f.rule in rules:
                return True
    return False


def default_chaos_sites() -> frozenset:
    """The registered chaos sites (import kept lazy: astlint must be usable
    on a source tree without importing it)."""
    try:
        from ..common.chaos import KNOWN_SITES

        return frozenset(KNOWN_SITES)
    except Exception:  # pragma: no cover - partial checkouts
        return frozenset()


def lint_source(src: str, path: str = "<string>",
                chaos_sites: Optional[Iterable[str]] = None,
                rules: Optional[Sequence[Any]] = None,
                ) -> Tuple[List[Finding], int]:
    """Lint one module's source. Returns ``(findings, n_suppressed)`` —
    findings already have inline suppressions applied and are counted into
    telemetry."""
    sites = (frozenset(chaos_sites) if chaos_sites is not None
             else default_chaos_sites())
    art = _build_artifact(src, path, sites)
    selected = (all_rules("ast") if rules is None else
                [get_rule(r) if isinstance(r, str) else r for r in rules])
    raw: List[Finding] = []
    ctx = RuleContext(where=path)
    for rule in selected:
        if rule.layer == "ast":
            raw.extend(rule.check(art, ctx))
    # a node inside a nested def is reachable from BOTH its own traced_fns
    # entry and every enclosing one (the enclosing walk is what catches
    # closure-variable leaks) — identical findings collapse to one
    raw = list(dict.fromkeys(raw))
    kept = [f for f in raw if not _suppressed(f, art.lines)]
    return report(kept), len(raw) - len(kept)


def lint_file(path: str, **kw) -> Tuple[List[Finding], int]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, path=path, **kw)


def lint_package(root: str, **kw) -> Tuple[List[Finding], int]:
    """Lint every ``.py`` file under ``root`` (skips ``__pycache__``).
    Returns ``(findings, n_suppressed)`` sorted by location."""
    findings: List[Finding] = []
    suppressed = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            fs, ns = lint_file(os.path.join(dirpath, fname), **kw)
            findings.extend(fs)
            suppressed += ns
    findings.sort(key=lambda f: f.location)
    return findings, suppressed
