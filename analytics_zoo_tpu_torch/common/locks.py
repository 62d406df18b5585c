"""Named locks + an opt-in runtime lock witness (port of
``analytics_zoo_tpu/common/locks.py``, which needs no JAX).

* :func:`traced_lock` / :func:`traced_rlock` are the constructors the
  lock-bearing modules use instead of bare ``threading.Lock()``. They take a
  canonical name (``"ClassName._lock"``) and return a plain stdlib lock
  unless ``ZOO_TPU_TRACE_LOCKS`` is set, so the hot path pays nothing by
  default.
* With tracing on, every acquisition records the set of locks the acquiring
  thread already holds as directed edges into a process-wide witness
  (``zoo_lock_order_edges_total{src,dst}``), and every release observes the
  hold time (``zoo_lock_hold_seconds{lock}``) plus a per-lock max-hold
  watermark. ``ZOO_TPU_LOCK_WITNESS=<path.jsonl>`` appends the witness at
  process exit, in the JAX package's format, so the JAX package's
  lock-order analysis reads a witness of the port's locks too.

``TracedLock`` is ``threading.Condition``-compatible, so traced code keeps
its exact semantics.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Tuple

from . import telemetry as _tm

__all__ = [
    "TracedLock", "traced_lock", "traced_rlock", "tracing_enabled",
    "witness_edges", "witness_max_holds", "reset_witness", "dump_witness",
    "load_witness",
]

_HOLD = _tm.histogram(
    "zoo_lock_hold_seconds",
    "Traced-lock hold time per acquisition (ZOO_TPU_TRACE_LOCKS=1); a lock "
    "whose tail grows under load is serializing blocking work",
    labels=("lock",),
    buckets=(1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
_EDGES_TOTAL = _tm.counter(
    "zoo_lock_order_edges_total",
    "Witnessed lock-order edges (src held while dst acquired) recorded by "
    "TracedLock", labels=("src", "dst"))


def tracing_enabled() -> bool:
    """True when ``ZOO_TPU_TRACE_LOCKS`` asks for the runtime witness."""
    return os.environ.get("ZOO_TPU_TRACE_LOCKS", "").lower() \
        not in ("", "0", "false", "off")


# ---------------------------------------------------------------------------
# the process-wide witness
# ---------------------------------------------------------------------------

class _Witness:
    """Edge counts + per-lock hold watermarks, merged across all traced
    locks of the process. Its own lock is plain and terminal — it is taken
    UNDER traced locks by construction and never acquires anything.

    Stack entries are mutable ``[name, t0, alive]`` records: a lock released
    by a thread OTHER than its acquirer (legal for ``threading.Lock`` —
    handoff patterns) is marked dead and lazily pruned from the acquiring
    thread's stack, so it never fabricates src edges after its release."""

    def __init__(self):
        self._lock = threading.Lock()
        self._edges: Dict[Tuple[str, str], int] = {}
        self._max_hold: Dict[str, float] = {}
        self._local = threading.local()

    def held_stack(self) -> List[list]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def note_acquired(self, name: str) -> list:
        stack = self.held_stack()
        if any(not rec[2] for rec in stack):    # cross-thread releases
            stack[:] = [rec for rec in stack if rec[2]]
        new_edges = [(rec[0], name) for rec in stack if rec[0] != name]
        rec = [name, time.perf_counter(), True]
        stack.append(rec)
        if new_edges:
            with self._lock:
                for e in new_edges:
                    self._edges[e] = self._edges.get(e, 0) + 1
            for src, dst in new_edges:
                _EDGES_TOTAL.labels(src=src, dst=dst).inc()
        return rec

    def note_released(self, rec: list) -> None:
        name, t0, _alive = rec
        held_s = time.perf_counter() - t0
        _HOLD.labels(lock=name).observe(held_s)
        with self._lock:
            if held_s > self._max_hold.get(name, 0.0):
                self._max_hold[name] = held_s
        rec[2] = False
        stack = self.held_stack()
        try:
            stack.remove(rec)       # fast path: released by its acquirer
        except ValueError:
            pass                    # cross-thread release: acquirer prunes

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._edges)

    def max_holds(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._max_hold)

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._max_hold.clear()


_WITNESS = _Witness()


def witness_edges() -> Dict[Tuple[str, str], int]:
    """Witnessed ``(src, dst) -> count`` acquisition-order edges so far."""
    return _WITNESS.edges()


def witness_max_holds() -> Dict[str, float]:
    """Per-lock max observed hold time (seconds) so far."""
    return _WITNESS.max_holds()


def reset_witness() -> None:
    _WITNESS.reset()


def dump_witness(path: str) -> None:
    """Append the witness as JSONL (one edge or hold record per line) via a
    single ``os.write`` on an ``O_APPEND`` fd — buffered text I/O would
    split payloads over the buffer size into several syscalls, and two
    fleet-replica processes exiting together would tear each other's
    lines."""
    edges = _WITNESS.edges()
    holds = _WITNESS.max_holds()
    if not edges and not holds:
        return
    lines = [json.dumps({"src": s, "dst": d, "n": n})
             for (s, d), n in sorted(edges.items())]
    lines += [json.dumps({"lock": k, "max_hold_s": round(v, 6)})
              for k, v in sorted(holds.items())]
    payload = ("\n".join(lines) + "\n").encode("utf-8")
    fd = os.open(path, os.O_APPEND | os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)


def load_witness(path: str) -> Tuple[Dict[Tuple[str, str], int],
                                     Dict[str, float]]:
    """Parse a witness JSONL back into ``(edges, max_holds)`` (edge counts
    summed, hold watermarks maxed — the file may hold several processes'
    dumps)."""
    edges: Dict[Tuple[str, str], int] = {}
    holds: Dict[str, float] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue        # torn concurrent append
            if "src" in rec:
                key = (str(rec["src"]), str(rec["dst"]))
                edges[key] = edges.get(key, 0) + int(rec.get("n", 1))
            elif "lock" in rec:
                k = str(rec["lock"])
                holds[k] = max(holds.get(k, 0.0),
                               float(rec.get("max_hold_s", 0.0)))
    return edges, holds


_atexit_armed = False


def _arm_atexit_dump() -> None:
    global _atexit_armed
    if _atexit_armed:
        return
    _atexit_armed = True

    def _dump():
        path = os.environ.get("ZOO_TPU_LOCK_WITNESS")
        if path:
            try:
                dump_witness(path)
            except OSError:
                pass

    atexit.register(_dump)


# ---------------------------------------------------------------------------
# the traced lock itself
# ---------------------------------------------------------------------------

class TracedLock:
    """A named lock wrapper that feeds the witness.

    Exposes the full ``threading.Lock`` protocol plus context-manager use,
    and works as the lock behind a ``threading.Condition`` (the Condition
    falls back to plain ``acquire``/``release`` for its save/restore hooks,
    so a ``wait()`` correctly shows up as release-then-reacquire: the wait
    itself is never counted as hold time)."""

    __slots__ = ("name", "_inner", "_recs")

    def __init__(self, name: str, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()
        # witness records of in-flight acquisitions. Only ever touched while
        # the inner lock is held (append after acquire, pop before release),
        # so access is serialized for a Lock and same-thread for an RLock
        self._recs: List[list] = []

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._recs.append(_WITNESS.note_acquired(self.name))
        return got

    def release(self) -> None:
        rec = self._recs.pop() if self._recs else None
        if rec is not None:
            _WITNESS.note_released(rec)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedLock {self.name!r} over {self._inner!r}>"


def traced_lock(name: str):
    """A ``threading.Lock`` named ``name`` (= the static lock-order graph's
    node name, conventionally ``"ClassName._attr"``). Plain stdlib lock
    unless ``ZOO_TPU_TRACE_LOCKS`` is set — zero overhead by default."""
    if not tracing_enabled():
        return threading.Lock()
    _arm_atexit_dump()
    return TracedLock(name, threading.Lock())


def traced_rlock(name: str):
    """:func:`traced_lock` over an RLock (reentrant re-acquisitions record
    no self-edges)."""
    if not tracing_enabled():
        return threading.RLock()
    _arm_atexit_dump()
    return TracedLock(name, threading.RLock())
