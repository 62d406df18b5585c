"""Deterministic fault injection (port of ``common/chaos.py``).

Every resilience behaviour (retry-from-checkpoint, the SIGTERM final
save, a kill between a checkpoint's serialization and its publication)
is testable without real flakiness: a :class:`ChaosSchedule` is a seeded,
deterministic list of faults keyed to *named sites* in the code and to
*occurrence counts* at each site. Code marks its fault points with
:func:`chaos_point`, a no-op (one module-global load) unless a schedule
is installed:

    sched = ChaosSchedule(seed=7)
    sched.fail("estimator.step", at=3, exc=RuntimeError)  # raise
    sched.delay("estimator.step", at=None, seconds=0.05)  # slow every step
    sched.kill("ckpt.write", at=1)                        # WorkerKilled
    with sched:                                           # install/uninstall
        ... train ...

A copy of the JAX package's schedule and sites: every injected fault is a
``chaos.injected`` decision event (``observability/events.py``), and
:meth:`ChaosSchedule.counts` is what the flight recorder folds into its
dump. :data:`KNOWN_SITES` lists the sites the port marks (a test holds
every ``chaos_point`` of the package to it, as the JAX lint does);
:func:`register_chaos_site` adds one at run time. Schedules pickle
(counters reset on unpickle), so a process pool can forward one to
its workers.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from .locks import traced_lock


class WorkerKilled(BaseException):
    """Cooperative simulated worker death.

    Deliberately a ``BaseException``: production code's broad
    ``except Exception`` error handlers must NOT absorb a simulated kill —
    only the supervisor/respawn machinery handles it.
    """


@dataclasses.dataclass
class _Rule:
    site: str
    action: str                      # "fail" | "delay" | "kill"
    at: Optional[frozenset]          # occurrence indices (1-based); None=every
    tag: Any = None                  # None matches any tag
    exc_type: type = ConnectionError
    message: str = "chaos: injected fault"
    delay_s: float = 0.0
    exit_code: Optional[int] = None  # kill: None => raise WorkerKilled

    def matches(self, site: str, tag: Any, n: int) -> bool:
        if site != self.site:
            return False
        if self.tag is not None and tag != self.tag:
            return False
        return self.at is None or n in self.at


def _as_occurrences(at) -> Optional[frozenset]:
    if at is None:
        return None
    if isinstance(at, int):
        return frozenset((at,))
    return frozenset(int(i) for i in at)


class ChaosSchedule:
    """A seeded, deterministic fault plan over named chaos sites."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: List[_Rule] = []
        # zoo-lock: leaf — fire() counts under it, actions run outside
        self._lock = traced_lock("ChaosSchedule._lock")
        self._counts: Dict[Tuple[str, Any], int] = {}

    # -- authoring -----------------------------------------------------------
    def fail(self, site: str, at: Union[int, Iterable[int], None] = None,
             exc: type = ConnectionError,
             message: str = "chaos: injected fault",
             tag: Any = None) -> "ChaosSchedule":
        """Raise ``exc(message)`` at the given occurrence(s) of ``site``."""
        self._rules.append(_Rule(site, "fail", _as_occurrences(at), tag,
                                 exc_type=exc, message=message))
        return self

    def delay(self, site: str, at: Union[int, Iterable[int], None] = None,
              seconds: float = 0.05, tag: Any = None) -> "ChaosSchedule":
        """Sleep ``seconds`` at the given occurrence(s) (a slow reply)."""
        self._rules.append(_Rule(site, "delay", _as_occurrences(at), tag,
                                 delay_s=seconds))
        return self

    def kill(self, site: str, at: Union[int, Iterable[int], None] = None,
             tag: Any = None,
             exit_code: Optional[int] = None) -> "ChaosSchedule":
        """Kill the worker at the given occurrence(s): raises
        :class:`WorkerKilled` (cooperative, for threads), or hard-exits the
        process with ``exit_code`` when given (SIGKILL-style, for process
        workers)."""
        self._rules.append(_Rule(site, "kill", _as_occurrences(at), tag,
                                 exit_code=exit_code))
        return self

    # -- execution -----------------------------------------------------------
    def fire(self, site: str, tag: Any = None) -> None:
        with self._lock:
            key = (site, tag)
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            hits = [r for r in self._rules if r.matches(site, tag, n)]
        for r in hits:
            # every injected fault is a decision event: a drill's faults are
            # auditable next to what they provoked (lazy import: chaos must
            # stay importable before observability)
            from ..observability import events as _ev

            _ev.emit("chaos.injected", severity="warning", site=site,
                     tag=repr(tag) if tag is not None else None,
                     action=r.action, occurrence=n)
            if r.action == "delay":
                time.sleep(r.delay_s)
            elif r.action == "fail":
                raise r.exc_type(f"{r.message} (site={site} tag={tag} n={n})")
            elif r.action == "kill":
                if r.exit_code is not None:
                    os._exit(r.exit_code)
                raise WorkerKilled(f"chaos kill (site={site} tag={tag} n={n})")

    def occurrences(self, site: str, tag: Any = None) -> int:
        with self._lock:
            return self._counts.get((site, tag), 0)

    def counts(self) -> List[Dict[str, Any]]:
        """Every site this schedule has fired, with occurrence counts: the
        flight recorder folds this into its dump."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (kv[0][0], str(kv[0][1])))
        return [{"site": site, "tag": tag, "fired": n}
                for (site, tag), n in items]

    # -- pickling: counters/lock are process-local ---------------------------
    def __getstate__(self):
        return {"seed": self.seed, "_rules": self._rules}

    def __setstate__(self, state):
        self.seed = state["seed"]
        self._rules = state["_rules"]
        # zoo-lock: leaf — see __init__
        self._lock = traced_lock("ChaosSchedule._lock")
        self._counts = {}

    # -- install -------------------------------------------------------------
    def __enter__(self) -> "ChaosSchedule":
        install_chaos(self)
        return self

    def __exit__(self, *exc):
        uninstall_chaos()


#: the chaos sites the port's code marks: a typo'd site never fires, so a
#: drill aimed at it would test nothing
KNOWN_SITES = {
    "autoscale.scale",    # serving/fleet.py, each autoscaler scale event
    "broker.handle",      # serving/broker.py, each command dispatch
    "ckpt.write",         # engine/checkpoint.py writer (serialize->publish)
    "conn.call",          # serving/client.py, each broker round trip
    "data.prefetch",      # data/pipeline.py, once a produced batch
    "estimator.step",     # engine/estimator.py, every step (or block)
    "fleet.host_respawn",  # serving/fleet.py, whole-host failover respawns
    "fleet.respawn",      # serving/fleet.py, each dead-replica respawn
    "fleet.route",        # serving/fleet.py, each routing decision
    "host.heartbeat",     # serving/hostagent.py, each agent round
    "overload.shed",      # each deadline or admission shed (the frontend,
                          # the router, the micro-batcher, the engines)
    "prefill.chunk",      # serving/generation.py, before each chunk dispatch
    "prefix.publish",     # serving/generation.py, between a stream's prefill
                          # and its prefix-cache publish
    "rollout.phase",      # serving/hotswap.py, each rollout phase entry
    "serving.generate",   # serving/generation.py, each decode-loop pass
    "serving.infer",      # serving/engine.py, each infer-worker batch
    "swap.stage",         # serving/hotswap.py, between a swap's checks and
                          # its load
    "task_pool.worker",   # orca/task_pool.py, before each task or actor call
}


def register_chaos_site(site: str) -> str:
    """Register a chaos-point site name at run time (generated sites,
    tests). Returns ``site`` so it can be used inline."""
    KNOWN_SITES.add(site)
    return site

_active: Optional[ChaosSchedule] = None


def install_chaos(schedule: ChaosSchedule) -> None:
    """Install ``schedule`` globally; chaos points start firing."""
    global _active
    _active = schedule


def uninstall_chaos() -> None:
    global _active
    _active = None


def get_chaos() -> Optional[ChaosSchedule]:
    return _active


def chaos_point(site: str, tag: Any = None) -> None:
    """Production-code fault point. Free when no schedule is installed."""
    sched = _active
    if sched is not None:
        sched.fire(site, tag)


__all__ = ["ChaosSchedule", "KNOWN_SITES", "WorkerKilled", "chaos_point",
           "get_chaos", "install_chaos", "register_chaos_site",
           "uninstall_chaos"]
