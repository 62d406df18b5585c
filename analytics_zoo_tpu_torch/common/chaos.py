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

A copy of the JAX package's schedule and sites. The JAX one takes its
lock from ``common/locks.py`` (a traced lock feeding
``common/telemetry.py``) and emits a ``chaos.injected`` decision event per
fault; here the lock is a plain ``threading.Lock`` and no event is
emitted. :data:`KNOWN_SITES` lists the sites the port marks (a test holds
every ``chaos_point`` of the package to it, as the JAX lint does); the
runtime ``register_chaos_site``, ``counts()`` (read by the flight
recorder) and the pickling (for the TaskPool's workers) wait with those
modules for ROADMAP Queue 1, items 8 and 11.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union


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
        # fire() counts under it, actions run outside
        self._lock = threading.Lock()
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

    # -- install -------------------------------------------------------------
    def __enter__(self) -> "ChaosSchedule":
        install_chaos(self)
        return self

    def __exit__(self, *exc):
        uninstall_chaos()


#: the chaos sites the port's code marks: a typo'd site never fires, so a
#: drill aimed at it would test nothing
KNOWN_SITES = frozenset({
    "ckpt.write",         # engine/checkpoint.py writer (serialize->publish)
    "data.prefetch",      # data/pipeline.py, once a produced batch
    "estimator.step",     # engine/estimator.py, every step (or block)
})

_active: Optional[ChaosSchedule] = None


def install_chaos(schedule: ChaosSchedule) -> None:
    """Install ``schedule`` globally; chaos points start firing."""
    global _active
    _active = schedule


def uninstall_chaos() -> None:
    global _active
    _active = None


def chaos_point(site: str, tag: Any = None) -> None:
    """Production-code fault point. Free when no schedule is installed."""
    sched = _active
    if sched is not None:
        sched.fire(site, tag)


__all__ = ["ChaosSchedule", "KNOWN_SITES", "WorkerKilled", "chaos_point",
           "install_chaos", "uninstall_chaos"]
