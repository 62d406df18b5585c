"""Concurrency lint: per-class lock models, lock-order graphs, hold hazards
(port of ``analytics_zoo_tpu/analysis/concurrency.py``, which needs no JAX:
the same source gives the same facts in both packages).

The thread-safety bugs a serving stack breeds — final-frame callbacks
invoked under the batcher lock, a router's probe-lifecycle race, an error
nonce scoped to the wrong lock — are encoded here as machine-checkable
facts extracted from the AST, consumed by the rules in
:mod:`analysis.rules.concurrency`:

* **Lock model** — lock attributes created in ``__init__`` (or class body):
  ``self._lock = threading.Lock()`` / ``RLock`` / ``Condition`` /
  :func:`~analytics_zoo_tpu_torch.common.locks.traced_lock`. A ``traced_lock``'s
  string literal IS the lock's canonical graph-node name; bare stdlib locks
  get ``ClassName.attr``. ``Condition(self.lock)`` aliases the underlying
  lock.
* **Guarded-by inference** — fields predominantly mutated under ``with
  self._lock`` are inferred guarded by it; mutations outside are outliers
  (the generalized ``telemetry-lock`` rule). ``__init__``-only contexts are
  exempt — the object is not yet shared. A helper method whose every
  intra-class call site holds the lock (``_retire_locked`` et al.) inherits
  that context; one reachable only from ``__init__`` inherits the exemption.
* **Lock-order graph** — directed edges from nested ``with`` blocks and
  held-method call edges, plus ``# zoo-lock: order(a<b)`` declarations;
  cycles are potential deadlocks (lock-order inversion).
* **Hold hazards** — blocking operations inside a critical section: wire
  round-trips (``send_msg``/``recv_msg``/``conn.call``), socket ops, queue
  ``get``/``put`` with a timeout, ``subprocess``, ``time.sleep``, event
  waits, and user-callback invocation (``on_*`` / ``*_cb`` / ``cb``) —
  exactly the callback-under-lock bug class. ``Condition.wait`` on the HELD lock is the
  correct CV pattern and exempt.

Annotation vocabulary (on the lock-creation line or the line above; ``order``
anywhere in the module)::

    self._lock = traced_lock("C._lock")   # zoo-lock: guards(_slots, _table)
    self._lock = threading.Lock()         # zoo-lock: leaf — acquires nothing
    # zoo-lock: order(ReplicaRouter._lock < CircuitBreaker._lock)

plus the usual ``# zoo-lint: disable=<rule> — reason`` escape hatch.

The run-time half lives in :mod:`analytics_zoo_tpu_torch.common.locks`:
:func:`check_witness` unions witnessed edges with the static graph and fails
on any cycle (``python -m analytics_zoo_tpu_torch.analysis --witness``).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .core import Finding, finding

#: constructors whose result is a lock (stdlib + common.locks factories)
LOCK_CTORS = frozenset(("Lock", "RLock", "traced_lock", "traced_rlock"))
CONDITION_CTORS = frozenset(("Condition",))

_ANNOT_RE = re.compile(r"zoo-lock:\s*(.+)")
_GUARDS_RE = re.compile(r"guards\(([^)]*)\)")
_ORDER_RE = re.compile(r"order\(\s*([\w.]+)\s*<\s*([\w.]+)\s*\)")
_LEAF_RE = re.compile(r"\bleaf\b")

_MUTATING_METHODS = frozenset((
    "append", "appendleft", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "remove", "extend", "add", "discard", "insert", "sort",
    "move_to_end"))

#: callback-shaped callable names — invoking user code under a lock is the
#: final-frame bug class even when the callback is currently cheap
_CALLBACK_NAME = re.compile(r"^(cb|callback|on_[a-z0-9_]+)$|_cb$|_callback$"
                            r"|_hook$|^listener(s)?$")
#: socket-level blocking primitives (any receiver: a socket rarely travels
#: under another object's name without being one)
_SOCKET_METHODS = frozenset(("sendall", "recv", "recv_into", "recvfrom",
                             "sendto", "accept", "makefile",
                             "create_connection"))
_WIRE_FNS = frozenset(("send_msg", "recv_msg"))
_EXEMPT = "exempt"          # method context: only reachable from __init__


def _attr_chain(node: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _call_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _expr_key(node: ast.AST) -> str:
    """Stable identity for 'same object' checks (``self.cond`` vs the held
    ``with self.cond:`` context)."""
    chain = _attr_chain(node)
    return ".".join(chain) if chain else ast.dump(node)


# ---------------------------------------------------------------------------
# model dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LockInfo:
    attr: str                     # attribute / global / local variable name
    name: str                     # canonical graph-node name
    line: int
    cls: Optional[str] = None
    leaf: bool = False
    declared_guards: Optional[FrozenSet[str]] = None
    alias_of: Optional[str] = None      # Condition(self.X) -> "X"


@dataclasses.dataclass
class Mutation:
    field: str
    line: int
    held: FrozenSet[str]          # canonical lock names held (effective)
    exempt: bool                  # __init__ / init-only-reachable context


@dataclasses.dataclass
class Hazard:
    line: int
    label: str                    # what blocks, e.g. "time.sleep"
    held: Tuple[str, ...]         # canonical lock names held


@dataclasses.dataclass
class Edge:
    src: str
    dst: str
    line: int                     # acquisition site of dst


@dataclasses.dataclass
class ReachIn:
    line: int
    expr: str                     # e.g. "self.router._lock"


@dataclasses.dataclass
class ClassModel:
    name: str
    locks: Dict[str, LockInfo] = dataclasses.field(default_factory=dict)
    #: field -> (lock name, under_count, plain_sites) after inference
    guarded: Dict[str, str] = dataclasses.field(default_factory=dict)
    outliers: List[Mutation] = dataclasses.field(default_factory=list)
    mutation_stats: Dict[str, Tuple[int, int]] = \
        dataclasses.field(default_factory=dict)   # field -> (under, plain)


@dataclasses.dataclass
class ModuleModel:
    path: str
    classes: Dict[str, ClassModel] = dataclasses.field(default_factory=dict)
    module_locks: Dict[str, LockInfo] = dataclasses.field(default_factory=dict)
    edges: List[Edge] = dataclasses.field(default_factory=list)
    declared_edges: List[Tuple[str, str, int]] = \
        dataclasses.field(default_factory=list)
    hazards: List[Hazard] = dataclasses.field(default_factory=list)
    reachins: List[ReachIn] = dataclasses.field(default_factory=list)
    acquisitions: Dict[str, List[int]] = \
        dataclasses.field(default_factory=dict)   # lock name -> with lines
    leaf_locks: Set[str] = dataclasses.field(default_factory=set)

    def all_locks(self) -> Dict[str, LockInfo]:
        out = dict(self.module_locks)
        for cm in self.classes.values():
            for info in cm.locks.values():
                out[info.name] = info
        return out


# ---------------------------------------------------------------------------
# annotation parsing
# ---------------------------------------------------------------------------

def _annotations_for_line(lines: List[str], lineno: int) -> str:
    """zoo-lock annotation text attached to ``lineno``: the line itself plus
    the contiguous block of comment-only lines directly above it (so a
    ``guards(...)`` declaration can carry a justification paragraph)."""
    out = []
    if 1 <= lineno <= len(lines):
        m = _ANNOT_RE.search(lines[lineno - 1])
        if m:
            out.append(m.group(1))
    i = lineno - 1
    while i >= 1 and lines[i - 1].lstrip().startswith("#"):
        m = _ANNOT_RE.search(lines[i - 1])
        if m:
            out.append(m.group(1))
        i -= 1
    return " ".join(out)


def _declared_orders(lines: List[str]) -> List[Tuple[str, str, int]]:
    out = []
    for i, line in enumerate(lines, start=1):
        m = _ANNOT_RE.search(line)
        if not m:
            continue
        for om in _ORDER_RE.finditer(m.group(1)):
            out.append((om.group(1), om.group(2), i))
    return out


# ---------------------------------------------------------------------------
# lock-creation discovery
# ---------------------------------------------------------------------------

def _lock_ctor(value: ast.AST) -> Optional[Tuple[str, Optional[str],
                                                 Optional[ast.AST]]]:
    """``("lock"|"condition", traced_name, cond_lock_arg)`` when ``value``
    constructs a lock, else None."""
    if not isinstance(value, ast.Call):
        return None
    name = _call_name(value.func)
    if name in LOCK_CTORS:
        traced = None
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            traced = value.args[0].value
        return ("lock", traced, None)
    if name in CONDITION_CTORS:
        arg = value.args[0] if value.args else None
        return ("condition", None, arg)
    return None


def _self_attr_target(target: ast.AST) -> Optional[str]:
    if isinstance(target, ast.Attribute) \
            and isinstance(target.value, ast.Name) \
            and target.value.id == "self":
        return target.attr
    return None


def _discover_class_locks(cls: ast.ClassDef, lines: List[str],
                          ) -> Dict[str, LockInfo]:
    locks: Dict[str, LockInfo] = {}

    def note(attr: str, value: ast.AST, line: int) -> None:
        ctor = _lock_ctor(value)
        if ctor is None:
            return
        kind, traced, cond_arg = ctor
        alias = None
        if kind == "condition" and cond_arg is not None:
            alias = _self_attr_target(cond_arg) or None
            if alias is None:
                chain = _attr_chain(cond_arg)
                alias = chain[-1] if chain else None
        annot = _annotations_for_line(lines, line)
        guards = None
        fields = [f.strip() for gm in _GUARDS_RE.finditer(annot)
                  for f in gm.group(1).split(",") if f.strip()]
        if fields:
            guards = frozenset(fields)
        locks[attr] = LockInfo(
            attr=attr, name=traced or f"{cls.name}.{attr}", line=line,
            cls=cls.name, leaf=bool(_LEAF_RE.search(annot)),
            declared_guards=guards, alias_of=alias)

    for node in cls.body:                       # class-level: _seq_lock = ...
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            note(node.targets[0].id, node.value, node.lineno)
    for node in ast.walk(cls):                  # instance attrs in methods
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _self_attr_target(t)
                if attr is not None:
                    note(attr, node.value, node.lineno)
    # resolve condition aliases to their underlying lock's canonical name
    for info in locks.values():
        if info.alias_of and info.alias_of in locks \
                and info.alias_of != info.attr:
            info.name = locks[info.alias_of].name
    return locks


def _discover_module_locks(tree: ast.Module, lines: List[str],
                           modname: str) -> Dict[str, LockInfo]:
    locks: Dict[str, LockInfo] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            ctor = _lock_ctor(node.value)
            if ctor is None:
                continue
            kind, traced, _arg = ctor
            name = node.targets[0].id
            annot = _annotations_for_line(lines, node.lineno)
            locks[name] = LockInfo(
                attr=name, name=traced or f"{modname}.{name}",
                line=node.lineno, leaf=bool(_LEAF_RE.search(annot)))
    return locks


# ---------------------------------------------------------------------------
# per-method fact extraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RawMutation:
    field: str
    line: int
    local_held: FrozenSet[str]


@dataclasses.dataclass
class _RawHazard:
    line: int
    label: str
    local_held: Tuple[str, ...]


@dataclasses.dataclass
class _RawAcq:
    lock: str
    line: int
    local_held: Tuple[str, ...]


@dataclasses.dataclass
class _MethodFacts:
    name: str
    is_init: bool
    mutations: List[_RawMutation] = dataclasses.field(default_factory=list)
    hazards: List[_RawHazard] = dataclasses.field(default_factory=list)
    acqs: List[_RawAcq] = dataclasses.field(default_factory=list)
    #: callee method name -> list of local held sets at the call site
    callsites: List[Tuple[str, FrozenSet[str]]] = \
        dataclasses.field(default_factory=list)


class _MethodWalker:
    """Walks one function body tracking the stack of held locks. Nested
    function definitions restart with an empty stack (their bodies run
    later, not under the enclosing ``with``)."""

    def __init__(self, cls_locks: Dict[str, LockInfo], cls_name: Optional[str],
                 facts: _MethodFacts, model: ModuleModel):
        self.cls_locks = cls_locks
        self.cls_name = cls_name
        self.facts = facts
        self.model = model
        self.held: List[Tuple[str, str]] = []    # (canonical name, expr key)
        self.local_locks: Dict[str, LockInfo] = {}

    # -- lock expression resolution -----------------------------------------

    def _resolve_lock(self, expr: ast.AST) -> Optional[Tuple[str, bool]]:
        """``(canonical_name, is_reachin)`` when ``expr`` names a lock."""
        if isinstance(expr, ast.Call):
            expr = expr.func
        chain = _attr_chain(expr)
        if not chain:
            return None
        term = chain[-1]
        if len(chain) == 1:                          # local or module global
            if term in self.local_locks:
                return self.local_locks[term].name, False
            if term in self.model.module_locks:
                return self.model.module_locks[term].name, False
            if term.endswith("lock"):
                # undiscovered local/param: scope the node to THIS function —
                # a repo-wide graph must not unify every `lock` parameter
                # into one shared node (phantom cycles across modules)
                mod = os.path.splitext(os.path.basename(self.model.path))[0]
                scope = f"{mod}.{self.cls_name}" if self.cls_name else mod
                return f"<local>.{scope}.{self.facts.name}.{term}", False
            return None
        base = chain[0]
        if base in ("self", "cls", self.cls_name):
            if len(chain) == 2:
                info = self.cls_locks.get(term)
                if info is not None:
                    return info.name, False
                if term.endswith("lock") or term == "cond":
                    return f"{self.cls_name}.{term}", False
                return None
            # self.other._lock — reaching through an attribute
            if term.endswith("lock") or term == "cond":
                return ".".join(chain[1:]), True
            return None
        if term.endswith("lock") or term == "cond":
            return ".".join(chain), True
        return None

    # -- traversal -----------------------------------------------------------

    def walk_body(self, body: Iterable[ast.AST]) -> None:
        for node in body:
            self.visit(node)

    def visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            saved, self.held = self.held, []
            if isinstance(node, ast.Lambda):
                self.visit(node.body)
            else:
                self.walk_body(node.body)
            self.held = saved
            return
        if isinstance(node, ast.With):
            self._visit_with(node)
            return
        if isinstance(node, ast.Assign):
            # local lock creations: cond = threading.Condition()
            if len(node.targets) == 1 and isinstance(node.targets[0],
                                                     ast.Name):
                ctor = _lock_ctor(node.value)
                if ctor is not None:
                    kind, traced, _arg = ctor
                    var = node.targets[0].id
                    self.local_locks[var] = LockInfo(
                        attr=var,
                        name=traced or (f"{self.cls_name or '<mod>'}."
                                        f"{self.facts.name}.{var}"),
                        line=node.lineno, cls=self.cls_name)
            self._note_mutation_targets(node.targets, node.lineno)
            self.visit(node.value)
            return
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            tgt = node.target
            self._note_mutation_targets([tgt], node.lineno)
            if getattr(node, "value", None) is not None:
                self.visit(node.value)
            return
        if isinstance(node, ast.Delete):
            self._note_mutation_targets(node.targets, node.lineno)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node)
            for child in ast.iter_child_nodes(node):
                self.visit(child)
            return
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _visit_with(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            resolved = self._resolve_lock(item.context_expr)
            if resolved is None:
                self.visit(item.context_expr)
                continue
            name, reachin = resolved
            if reachin:
                self.model.reachins.append(
                    ReachIn(node.lineno, _expr_key(item.context_expr)))
            self.facts.acqs.append(_RawAcq(
                name, node.lineno, tuple(n for n, _k in self.held)))
            self.held.append((name, _expr_key(item.context_expr)))
            pushed += 1
        self.walk_body(node.body)
        for _ in range(pushed):
            self.held.pop()

    def _note_mutation_targets(self, targets, lineno: int) -> None:
        for t in targets:
            field = self._mutated_field(t)
            if field is not None and self.cls_name is not None:
                self.facts.mutations.append(_RawMutation(
                    field, lineno, frozenset(n for n, _k in self.held)))
            # subscript index expressions may contain calls
            for child in ast.walk(t):
                if isinstance(child, ast.Call):
                    self._visit_call(child)

    @staticmethod
    def _mutated_field(target: ast.AST) -> Optional[str]:
        """The ``self.F`` field a store/del target mutates (outermost attr
        after ``self``; subscripts and nested attributes resolve to F)."""
        node = target
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                return node.attr
            node = node.value
        return None

    def _receiver_field(self, func: ast.Attribute) -> Optional[str]:
        node = func.value
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        return None

    def _visit_call(self, node: ast.Call) -> None:
        func = node.func
        # intra-class call sites: self.m(...)
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self":
            self.facts.callsites.append(
                (func.attr, frozenset(n for n, _k in self.held)))
        # explicit X.acquire(): counts as an acquisition (unused-lock
        # accuracy + order edges) without held-stack tracking — the paired
        # release is not statically scoped
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            resolved = self._resolve_lock(func.value)
            if resolved is not None:
                self.facts.acqs.append(_RawAcq(
                    resolved[0], node.lineno,
                    tuple(n for n, _k in self.held)))
        # mutating method on self.F (incl. self.F[k].pop(...))
        if isinstance(func, ast.Attribute) \
                and func.attr in _MUTATING_METHODS:
            field = self._receiver_field(func)
            if field is not None and self.cls_name is not None:
                self.facts.mutations.append(_RawMutation(
                    field, node.lineno,
                    frozenset(n for n, _k in self.held)))
        label = self._blocking_label(node)
        if label is not None:
            self.facts.hazards.append(_RawHazard(
                node.lineno, label, tuple(n for n, _k in self.held)))

    def _blocking_label(self, node: ast.Call) -> Optional[str]:
        """A human-readable label when ``node`` is a blocking operation."""
        func = node.func
        kwnames = {kw.arg for kw in node.keywords}
        if isinstance(func, ast.Name):
            if func.id in _WIRE_FNS:
                return f"{func.id}() wire round-trip"
            if _CALLBACK_NAME.match(func.id):
                return f"user callback {func.id}()"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        chain = _attr_chain(func)
        term = func.attr
        root = chain[0] if chain else ""
        if root == "time" and term == "sleep":
            return "time.sleep()"
        if root == "subprocess" or term == "Popen":
            return f"subprocess ({'.'.join(chain) if chain else term})"
        if term in _WIRE_FNS:
            return f"{term}() wire round-trip"
        if term == "call" and chain and any(
                p in ("conn", "_conn") or p.endswith("conn")
                for p in chain[:-1]):
            return "broker round-trip (conn.call)"
        if term in _SOCKET_METHODS:
            return f"socket .{term}()"
        if term in ("get", "put") and "timeout" in kwnames:
            return f"queue .{term}(timeout=...)"
        if term in ("wait", "wait_for"):
            # Condition.wait on the HELD lock is the CV pattern and fine;
            # waiting on anything else (an Event, another condition) blocks
            # every contender of the held lock
            recv_key = _expr_key(func.value)
            if any(recv_key == key for _n, key in self.held):
                return None
            return f".{term}() on {recv_key}"
        if _CALLBACK_NAME.match(term):
            return f"user callback .{term}()"
        return None


# ---------------------------------------------------------------------------
# module model assembly
# ---------------------------------------------------------------------------

def _method_contexts(methods: Dict[str, _MethodFacts],
                     rounds: int = 4) -> Dict[str, Any]:
    """Effective inherited-lock context per method.

    Returns ``name -> frozenset(locks)`` (guaranteed held at every call
    site), ``_EXEMPT`` (only reachable from ``__init__`` with no locks), or
    ``frozenset()`` for public/plain methods."""
    ctx: Dict[str, Any] = {}
    # collect call sites per callee: (caller, local_held)
    sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for m in methods.values():
        for callee, held in m.callsites:
            if callee in methods:
                sites.setdefault(callee, []).append((m.name, held))
    for name in methods:
        ctx[name] = frozenset()
    for _ in range(rounds):
        changed = False
        for name, facts in methods.items():
            cs = sites.get(name)
            if not cs:
                continue            # public/plain: no inherited context
            parts: List[FrozenSet[str]] = []
            exempt_only = True
            for caller, held in cs:
                caller_facts = methods.get(caller)
                caller_ctx = ctx.get(caller, frozenset())
                caller_exempt = (caller_facts is not None
                                 and caller_facts.is_init) \
                    or caller_ctx == _EXEMPT
                if caller_exempt and not held:
                    continue
                exempt_only = False
                base = caller_ctx if isinstance(caller_ctx, frozenset) \
                    else frozenset()
                parts.append(base | held)
            if exempt_only:
                new = _EXEMPT
            elif parts:
                inter = parts[0]
                for p in parts[1:]:
                    inter = inter & p
                new = inter
            else:
                new = frozenset()
            if new != ctx[name]:
                ctx[name] = new
                changed = True
        if not changed:
            break
    return ctx


def build_module_model(tree: ast.Module, path: str,
                       lines: List[str]) -> ModuleModel:
    modname = os.path.splitext(os.path.basename(path))[0]
    model = ModuleModel(path=path)
    model.module_locks = _discover_module_locks(tree, lines, modname)
    model.declared_edges = _declared_orders(lines)

    def process_scope(cls: Optional[ast.ClassDef],
                      fns: List[ast.AST]) -> None:
        cls_name = cls.name if cls is not None else None
        cls_locks = _discover_class_locks(cls, lines) if cls is not None \
            else {}
        methods: Dict[str, _MethodFacts] = {}
        for fn in fns:
            facts = _MethodFacts(fn.name, fn.name == "__init__")
            walker = _MethodWalker(cls_locks, cls_name, facts, model)
            walker.walk_body(fn.body)
            methods[fn.name] = facts
        ctx = _method_contexts(methods)
        cm = ClassModel(cls_name or f"<module:{modname}>", locks=cls_locks)

        raw_mutations: Dict[str, List[Mutation]] = {}
        for name, facts in methods.items():
            mctx = ctx.get(name, frozenset())
            exempt = facts.is_init or mctx == _EXEMPT
            inherited = mctx if isinstance(mctx, frozenset) else frozenset()
            for acq in facts.acqs:
                model.acquisitions.setdefault(acq.lock, []).append(acq.line)
                for held in frozenset(acq.local_held) | inherited:
                    if held != acq.lock:
                        model.edges.append(Edge(held, acq.lock, acq.line))
            for hz in facts.hazards:
                held = frozenset(hz.local_held) | inherited
                if held:
                    model.hazards.append(Hazard(hz.line, hz.label,
                                                tuple(sorted(held))))
            for mut in facts.mutations:
                eff = Mutation(mut.field, mut.line,
                               frozenset(mut.local_held) | inherited,
                               exempt and not mut.local_held)
                raw_mutations.setdefault(mut.field, []).append(eff)

        if cls is not None:
            _infer_guards(cm, raw_mutations)
            model.classes[cls_name] = cm

    top_fns = [n for n in tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    if top_fns:
        process_scope(None, top_fns)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            fns = [n for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            process_scope(node, fns)

    for info in model.all_locks().values():
        if info.leaf:
            model.leaf_locks.add(info.name)
    return model


def _infer_guards(cm: ClassModel,
                  mutations: Dict[str, List[Mutation]]) -> None:
    """Fill ``cm.guarded``/``cm.outliers`` from declared ``guards(...)``
    annotations and predominance inference."""
    own_lock_names = {info.name for info in cm.locks.values()}
    declared: Dict[str, str] = {}
    for info in cm.locks.values():
        for field in (info.declared_guards or ()):
            declared[field] = info.name

    for field, muts in mutations.items():
        live = [m for m in muts if not m.exempt]
        lock = declared.get(field)
        if lock is None:
            # predominance inference over this class's OWN locks
            counts: Dict[str, int] = {}
            for m in live:
                for name in m.held & own_lock_names:
                    counts[name] = counts.get(name, 0) + 1
            if not counts:
                continue
            best = max(counts, key=lambda k: counts[k])
            under = counts[best]
            plain = sum(1 for m in live if best not in m.held)
            if under <= plain:
                continue            # not predominantly guarded: stay silent
            lock = best
        cm.guarded[field] = lock
        under = sum(1 for m in live if lock in m.held)
        plain_muts = [m for m in live if lock not in m.held]
        cm.mutation_stats[field] = (under, len(plain_muts))
        cm.outliers.extend(dataclasses.replace(m) for m in plain_muts)
    # outliers carry no lock name themselves: the rule resolves it through
    # cm.guarded (a declared guards() is authoritative even when inference
    # sees zero locked mutation sites)


# ---------------------------------------------------------------------------
# graph algorithms
# ---------------------------------------------------------------------------

def find_cycles(edges: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Elementary cycles (as node lists) in the directed graph — one
    representative per strongly connected component with a cycle."""
    adj: Dict[str, Set[str]] = {}
    for src, dst in edges:
        adj.setdefault(src, set()).add(dst)
        adj.setdefault(dst, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or node in adj.get(node, ()):
                    sccs.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return sccs


# ---------------------------------------------------------------------------
# repo-wide graph + witness checking (the chaos-suite gate)
# ---------------------------------------------------------------------------

def collect_lock_graph(root: str) -> Tuple[List[Edge], Set[str],
                                           List[Tuple[str, str, int]]]:
    """Union of every module's static lock-order edges under ``root`` (a
    package dir or single file): ``(edges, leaf_locks, declared_edges)``."""
    edges: List[Edge] = []
    leaves: Set[str] = set()
    declared: List[Tuple[str, str, int]] = []
    paths: List[str] = []
    if os.path.isdir(root):
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            paths.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                         if f.endswith(".py"))
    else:
        paths.append(root)
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=p)
        except (OSError, SyntaxError):
            continue
        model = build_module_model(tree, p, src.splitlines())
        edges.extend(model.edges)
        leaves |= model.leaf_locks
        declared.extend(model.declared_edges)
    return edges, leaves, declared


def check_witness(static_edges: Iterable[Tuple[str, str]],
                  witness_edges: Dict[Tuple[str, str], int],
                  leaf_locks: Iterable[str] = (),
                  max_holds: Optional[Dict[str, float]] = None,
                  max_hold_s: Optional[float] = None,
                  where: str = "witness") -> List[Finding]:
    """Union witnessed acquisition-order edges with the static graph and
    fail on any cycle; also flag witnessed edges OUT of a declared-leaf lock
    and (when ``max_hold_s`` is set) locks observed held longer than the
    budget. Findings use the same rule ids as the static pass, so one
    suppression/document story covers both halves."""
    out: List[Finding] = []
    union: Set[Tuple[str, str]] = set(static_edges)
    union |= set(witness_edges)
    for cycle in find_cycles(union):
        path = " -> ".join(cycle + cycle[:1])
        witnessed = sorted(
            f"{s}->{d}" for (s, d) in witness_edges
            if s in cycle and d in cycle)
        out.append(finding(
            "lock-order-cycle", "error", f"witness:{where}",
            f"lock-order inversion across the witnessed∪static acquisition "
            f"graph: {path} — two threads taking these locks in opposite "
            f"orders can deadlock",
            cycle=tuple(cycle), witnessed=tuple(witnessed)))
    leaves = set(leaf_locks)
    for (src, dst), n in sorted(witness_edges.items()):
        if src in leaves:
            out.append(finding(
                "lock-leaf-violation", "error", f"witness:{where}",
                f"declared-leaf lock {src} was witnessed holding while "
                f"acquiring {dst} ({n}x) — the leaf declaration (what makes "
                f"nesting it deadlock-free) no longer holds",
                src=src, dst=dst, count=n))
    if max_hold_s is not None and max_holds:
        for lock, held_s in sorted(max_holds.items()):
            if held_s > max_hold_s:
                out.append(finding(
                    "lock-hold-witness", "error", f"witness:{where}",
                    f"{lock} observed held for {held_s:.3f}s (budget "
                    f"{max_hold_s:.3f}s) — blocking work is running inside "
                    f"the critical section", lock=lock,
                    max_hold_s=round(held_s, 6)))
    return out
