"""Declarative SLO engine with multi-window burn-rate alerting.
(port of ``analytics_zoo_tpu/observability/slo.py``, which needs no JAX:
a copy over the port's own telemetry registry).

Objectives are declared in the ``slo:`` section of the ServingConfig YAML
(parsed into plain dicts by ``serving/config.py`` — this module never
imports serving) and evaluated against the :class:`~.history.MetricsHistory`
store on every sampler tick. Alerting is SRE-workbook multi-window burn
rate: with error budget ``1 - target``,

    burn(window) = bad_fraction(window) / (1 - target)

and an objective FIRES when burn exceeds ``burn_factor`` over BOTH the slow
(long) and fast (short) window — the long window proves sustained budget
spend, the short one proves it is still happening — and RESOLVES when the
fast window drops back under the factor. Transitions drive a
firing/resolved alert state machine, land on the decision-event stream
(``slo.firing`` / ``slo.resolved``), and are exported as scrape-time
collectors:

    zoo_slo_burn_rate{objective,window}        current burn per window
    zoo_slo_error_budget_remaining{objective}  1 - burn(slow)*budget spend
    zoo_slo_alerts_firing                      number of firing objectives

Objective types (all window math from the history store):

* ``latency`` — fraction of ``zoo_request_latency_seconds{priority}``
  observations over ``threshold_ms`` (bucket-aligned STRICTLY: the
  effective threshold rounds DOWN to the largest histogram bound <= the
  declared one, so an observation above the declared threshold can never
  count as good).
* ``availability`` — sheds over served+shed from
  ``zoo_request_outcomes_total{priority,outcome}``.
* ``error_ratio`` — 5xx over all of ``zoo_http_requests_total{code}``.
* ``queue_depth`` — fraction of history samples where the summed
  ``zoo_fleet_queue_depth`` exceeded ``max_depth``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..common import telemetry as _tm
from . import events as _ev
from .history import MetricsHistory

__all__ = ["Objective", "SLOEngine", "parse_objectives",
           "DEFAULT_FAST_WINDOW_S", "DEFAULT_SLOW_WINDOW_S",
           "DEFAULT_BURN_FACTOR"]

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
#: one burn factor for both windows (the workbook's per-pair constant);
#: 9 ≈ "spending a 30d budget in ~3.3d"
DEFAULT_BURN_FACTOR = 9.0

OBJECTIVE_TYPES = ("latency", "availability", "error_ratio", "queue_depth")

# scrape-time collectors walk the live engines (the resilience.py weakset
# pattern) so zoo_slo_* appears on the shared registry without a push loop
_LIVE_ENGINES: "weakref.WeakSet[SLOEngine]" = weakref.WeakSet()


def _collect_burn():
    out = {}
    for eng in list(_LIVE_ENGINES):
        for st in eng.objective_states():
            out[(st["name"], "fast")] = st["burn_fast"]
            out[(st["name"], "slow")] = st["burn_slow"]
    return out.items()


def _collect_budget():
    out = {}
    for eng in list(_LIVE_ENGINES):
        for st in eng.objective_states():
            out[(st["name"],)] = st["budget_remaining"]
    return out.items()


def _collect_firing():
    n = 0.0
    for eng in list(_LIVE_ENGINES):
        n += sum(1 for st in eng.objective_states()
                 if st["state"] == "firing")
    return [((), n)]


_tm.collector("zoo_slo_burn_rate",
              "Current SLO burn rate per objective and window (1.0 = "
              "spending exactly the error budget)", _collect_burn,
              labels=("objective", "window"))
_tm.collector("zoo_slo_error_budget_remaining",
              "Fraction of the error budget left over the slow window "
              "(clamped at 0)", _collect_budget, labels=("objective",))
_tm.collector("zoo_slo_alerts_firing",
              "Number of SLO objectives currently in the firing state",
              _collect_firing)


class Objective:
    """One parsed SLO objective (see module docstring for types)."""

    def __init__(self, spec: Dict[str, Any]):
        self.name = str(spec.get("name") or "")
        self.type = str(spec.get("type") or "")
        if not self.name:
            raise ValueError(f"slo objective needs a name: {spec!r}")
        if self.type not in OBJECTIVE_TYPES:
            raise ValueError(f"slo objective {self.name!r}: type must be one "
                             f"of {OBJECTIVE_TYPES}, got {self.type!r}")
        self.priority = str(spec.get("priority", "normal"))
        self.target = float(spec.get("target", 0.99))
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"slo objective {self.name!r}: target must be "
                             f"in (0, 1), got {self.target!r}")
        self.threshold_ms = float(spec.get("threshold_ms", 1000.0))
        self.max_depth = float(spec.get("max_depth", 16.0))
        self.burn_factor = (float(spec["burn_factor"])
                            if spec.get("burn_factor") is not None else None)

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def bad_total(self, hist: MetricsHistory, window_s: float,
                  now: Optional[float] = None) -> Tuple[float, float]:
        """(bad, total) event counts over the window."""
        if self.type == "latency":
            good, total = hist.fraction_le(
                "zoo_request_latency_seconds", self.priority,
                self.threshold_ms / 1e3, window_s, now=now)
            return total - good, total
        if self.type == "availability":
            served = hist.delta("zoo_request_outcomes_total",
                                f"{self.priority},served", window_s,
                                now=now) or 0.0
            shed = hist.delta("zoo_request_outcomes_total",
                              f"{self.priority},shed", window_s,
                              now=now) or 0.0
            return shed, served + shed
        if self.type == "error_ratio":
            total = hist.sum_delta("zoo_http_requests_total", window_s,
                                   now=now)
            bad = hist.sum_delta("zoo_http_requests_total", window_s,
                                 key_pred=lambda k: k.startswith("5"),
                                 now=now)
            return bad, total
        # queue_depth: gauge samples, summed across replicas per sample
        pts = hist._window(window_s, now=now)
        bad = total = 0.0
        for _ts, snap in pts:
            fam = snap.get("zoo_fleet_queue_depth")
            if fam is None:
                continue
            depth = sum(float(v) for v in fam["samples"].values())
            total += 1
            if depth > self.max_depth:
                bad += 1
        return bad, total

    def as_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "type": self.type, "target": self.target}
        if self.type == "latency":
            out.update(priority=self.priority,
                       threshold_ms=self.threshold_ms)
        elif self.type == "availability":
            out.update(priority=self.priority)
        elif self.type == "queue_depth":
            out.update(max_depth=self.max_depth)
        return out


def parse_objectives(specs: Sequence[Dict[str, Any]]) -> List[Objective]:
    objs = [Objective(dict(s)) for s in specs]
    names = [o.name for o in objs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate slo objective names: {names}")
    return objs


class _AlertState:
    __slots__ = ("state", "since", "fired_count", "burn_fast", "burn_slow",
                 "bad_slow", "total_slow")

    def __init__(self):
        self.state = "ok"
        self.since = time.time()
        self.fired_count = 0
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.bad_slow = 0.0
        self.total_slow = 0.0


class SLOEngine:
    """Evaluates objectives against a history store; owns alert state."""

    def __init__(self, history: MetricsHistory,
                 objectives: Sequence[Any],
                 fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 burn_factor: float = DEFAULT_BURN_FACTOR,
                 clock: Optional[Callable[[], float]] = None):
        if fast_window_s >= slow_window_s:
            raise ValueError(f"fast window ({fast_window_s}s) must be "
                             f"shorter than slow ({slow_window_s}s)")
        self.history = history
        self.objectives = [o if isinstance(o, Objective) else Objective(o)
                           for o in objectives]
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_factor = float(burn_factor)
        self._clock = clock or time.time
        import collections

        self._lock = threading.Lock()
        self._states: Dict[str, _AlertState] = \
            {o.name: _AlertState() for o in self.objectives}
        # (ts, objective, to) — bounded: a flapping objective on a
        # weeks-long stack must not grow memory one tuple per flip
        self.transitions: "collections.deque" = \
            collections.deque(maxlen=256)
        self._attached = False
        _LIVE_ENGINES.add(self)

    def attach(self) -> "SLOEngine":
        """Evaluate on every history sampler tick."""
        if not self._attached:
            self._attached = True
            self.history.add_listener(self.evaluate)
        return self

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Tuple[str, str]]:
        """One evaluation pass; returns the ``(objective, new_state)``
        transitions it caused."""
        now = self._clock() if now is None else now
        flips: List[Tuple[str, str, float, float]] = []
        for obj in self.objectives:
            factor = obj.burn_factor if obj.burn_factor is not None \
                else self.burn_factor
            bad_f, total_f = obj.bad_total(self.history, self.fast_window_s,
                                           now=now)
            bad_s, total_s = obj.bad_total(self.history, self.slow_window_s,
                                           now=now)
            burn_f = (bad_f / total_f / obj.budget) if total_f > 0 else 0.0
            burn_s = (bad_s / total_s / obj.budget) if total_s > 0 else 0.0
            with self._lock:
                st = self._states[obj.name]
                st.burn_fast, st.burn_slow = burn_f, burn_s
                st.bad_slow, st.total_slow = bad_s, total_s
                if st.state == "ok" and burn_f > factor and burn_s > factor:
                    st.state, st.since = "firing", now
                    st.fired_count += 1
                    self.transitions.append((now, obj.name, "firing"))
                    flips.append((obj.name, "firing", burn_f, burn_s))
                elif st.state == "firing" and burn_f <= factor:
                    st.state, st.since = "ok", now
                    self.transitions.append((now, obj.name, "resolved"))
                    flips.append((obj.name, "resolved", burn_f, burn_s))
        for name, to, bf, bs in flips:       # events OUTSIDE the state lock
            _ev.emit(f"slo.{to}",
                     severity="warning" if to == "firing" else "info",
                     objective=name, burn_fast=round(bf, 3),
                     burn_slow=round(bs, 3))
        return [(n, t) for n, t, _bf, _bs in flips]

    # -- introspection ---------------------------------------------------------

    def objective_states(self) -> List[Dict[str, Any]]:
        out = []
        with self._lock:
            for obj in self.objectives:
                st = self._states[obj.name]
                consumed = st.burn_slow     # budget-multiples spent in-window
                out.append({
                    "name": obj.name, **obj.as_dict(),
                    "state": st.state, "since": st.since,
                    "fired_count": st.fired_count,
                    "burn_fast": round(st.burn_fast, 4),
                    "burn_slow": round(st.burn_slow, 4),
                    "bad_slow": st.bad_slow, "total_slow": st.total_slow,
                    "budget_remaining": round(max(0.0, 1.0 - consumed), 4),
                })
        return out

    def ever_fired(self, name: str) -> bool:
        with self._lock:
            st = self._states.get(name)
            return bool(st and st.fired_count)

    def state_of(self, name: str) -> str:
        with self._lock:
            st = self._states.get(name)
            return st.state if st else "unknown"

    def status(self) -> Dict[str, Any]:
        """The ``/debug/slo`` / ``cli slo-status`` payload."""
        objs = self.objective_states()
        with self._lock:
            transitions = [{"ts": ts, "objective": o, "to": to}
                           for ts, o, to in list(self.transitions)[-32:]]
        return {"fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "burn_factor": self.burn_factor,
                "firing": sum(1 for o in objs if o["state"] == "firing"),
                "objectives": objs,
                "transitions": transitions}
