"""Always-on flight recorder: bounded black-box capture + one-file dumps
(port of ``analytics_zoo_tpu/observability/recorder.py``, which needs no
JAX).

A bounded, synchronized ring of **control-input records** — for every
consequential decision, the exact observation dict the decision function
consumed plus the decision it returned (admission, autoscale, prefill
budget, failover, rollout) — assembled on demand
with the event ring, recent traces, chaos-site firings and the metric
snapshot into ONE versioned self-contained JSON artifact (``schema:
zoo-flight-v1``, the JAX package's format).

Dump triggers:

* **process fault** — ``atexit`` plus chained signal handlers installed by
  :func:`install`; the previous handler still runs after the dump.
* **auto** — an event sink watches the decision stream from the events
  drain thread and cuts a dump on a fast-burn SLO page (``slo.firing``), a
  chaos kill (``chaos.injected`` with ``action=kill``) or a fleet death
  (``fleet.failover`` / ``fleet.host_failed``), throttled by
  ``min_auto_dump_interval_s``.
* **operator** — ``cli dump`` (through the ``/debug/flight`` endpoint) or
  :meth:`FlightRecorder.dump` directly.

Lock discipline mirrors ``events.py``: the ring sits behind one plain
terminal lock touched only for O(1) appends and list copies; serialization
and file I/O happen outside it, and the auto trigger runs on the events
drain thread, so ``record()``/``emit()`` during a dump never block. Dumps
are written tmp-then-rename, so a reader never sees a torn artifact.

Metric-history windows and SLO verdicts ride a dump when an
:class:`~.ObservabilityPlane` is attached as ``plane`` (the serving stack
attaches its own); without one a dump carries ``"slo": null`` and an empty
``"history"``.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal as _signal
import socket
import tempfile
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..common import telemetry as _tm
from . import events as _ev
from . import traces as _traces

FLIGHT_SCHEMA = "zoo-flight-v1"

# metric families whose history windows ride along in the dump (when the
# recorder has a plane attached): queue pressure, shed rate and burn rate
# are the inputs an operator reads first in a postmortem
DEFAULT_HISTORY_METRICS: Tuple[str, ...] = (
    "zoo_fleet_queue_depth", "zoo_router_shed_total", "zoo_slo_burn_rate",
    "zoo_fleet_dispatch_total")

_DUMPS = _tm.counter(
    "zoo_flight_dumps_total",
    "Flight-recorder dumps cut, by trigger (signal/atexit/slo_fast_burn/"
    "chaos_kill/failover/debug/manual)",
    labels=("trigger",))

_LIVE_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def _collect_ring_records() -> Iterable[Tuple[Tuple, float]]:
    return [((), float(sum(r.occupancy()[0]
                           for r in list(_LIVE_RECORDERS))))]


_tm.collector(
    "zoo_flight_ring_records",
    "Control-input records currently held across live flight-recorder "
    "rings (bounded; oldest records overwrite)",
    _collect_ring_records)

# event kinds that auto-cut a dump, mapped to the dump's trigger label
_AUTO_TRIGGERS = {"slo.firing": "slo_fast_burn",
                  "fleet.failover": "failover",
                  "fleet.host_failed": "failover"}


class FlightRecorder:
    """Bounded ring of (site, inputs, decision) control records + dump
    assembly. One per process in practice (module-level :func:`install`),
    but plain instances work for tests and offline tooling."""

    def __init__(self, capacity: int = 4096,
                 dump_dir: Optional[str] = None,
                 plane: Any = None,
                 min_auto_dump_interval_s: float = 30.0,
                 history_window_s: float = 300.0,
                 history_metrics: Iterable[str] = DEFAULT_HISTORY_METRICS):
        self.capacity = int(capacity)
        self.dump_dir = (dump_dir or os.environ.get("ZOO_FLIGHT_DIR")
                         or tempfile.gettempdir())
        self.plane = plane
        self.min_auto_dump_interval_s = float(min_auto_dump_interval_s)
        self.history_window_s = float(history_window_s)
        self.history_metrics = tuple(history_metrics)
        self.enabled = True
        self.last_dump_path: Optional[str] = None
        self.dumps = 0
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self._last_auto_dump = 0.0
        # terminal lock: O(1) appends + list copies only — never held
        # across serialization, file I/O, or another component's lock
        self._lock = threading.Lock()
        _LIVE_RECORDERS.add(self)

    # -- capture -------------------------------------------------------------

    def record(self, site: str, inputs: Dict[str, Any],
               decision: Optional[Dict[str, Any]] = None) -> None:
        """Append one control record. Hot-path safe: one dict build + one
        deque append under the terminal lock; the inputs/decision dicts are
        shallow-copied so later caller mutation cannot tear the record."""
        if not self.enabled:
            return
        rec = {"site": site, "ts": time.time(), "mono": time.monotonic(),
               "inputs": dict(inputs),
               "decision": dict(decision) if decision is not None else None}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)

    def records(self, site: Optional[str] = None) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring, optionally filtered by site (a
        prefix before the dot matches the whole family)."""
        with self._lock:
            out = list(self._ring)
        if site is not None:
            out = [r for r in out if r["site"] == site
                   or r["site"].startswith(site + ".")]
        return out

    def occupancy(self) -> Tuple[int, int]:
        """(records currently held, total ever recorded)."""
        with self._lock:
            return len(self._ring), self._seq

    # -- dump assembly -------------------------------------------------------

    def snapshot(self, trigger: str = "manual") -> Dict[str, Any]:
        """Assemble the self-contained dump dict. Every source is copied
        under ITS OWN short lock (ring, event ring, telemetry registry);
        nothing here holds two locks at once and nothing blocks emitters."""
        held, seq = self.occupancy()
        recs = self.records()
        events = [e.to_dict() for e in _ev.events()]
        slo_status = None
        history: Dict[str, Any] = {}
        plane = self.plane
        if plane is not None:
            slo = getattr(plane, "slo", None)
            if slo is not None:
                try:
                    slo_status = slo.status()
                except Exception:
                    slo_status = {"error": "slo status unavailable"}
            hist = getattr(plane, "history", None)
            if hist is not None:
                now = time.time()
                for name in self.history_metrics:
                    try:
                        keys = hist.keys(name) or [""]
                        history[name] = {
                            key: hist.series(
                                name, key=key,
                                window_s=self.history_window_s, now=now)
                            for key in keys[:8]}
                    except Exception:
                        continue
        # the traces each decision pins: event-carried trace ids, newest
        # first, exported complete (bounded — a dump is a postmortem aid,
        # not a trace archive)
        trace_ids: List[str] = []
        for e in reversed(events):
            tid = e.get("trace_id")
            if tid and tid not in trace_ids:
                trace_ids.append(tid)
            if len(trace_ids) >= 8:
                break
        exported = {}
        for tid in trace_ids:
            try:
                trace = _traces.export_trace(tid)
            except Exception:
                trace = None
            if trace is not None:
                exported[tid] = trace
        try:
            from ..common.chaos import get_chaos
            chaos_counts = get_chaos().counts()
        except Exception:
            chaos_counts = []
        snap = {"schema": FLIGHT_SCHEMA,
                "created": time.time(),
                "trigger": trigger,
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "records_held": held,
                "records_total": seq,
                "records_dropped": seq - held,
                "records": recs,
                "events": events,
                "slo": slo_status,
                "metrics": _tm.snapshot(),
                "history": history,
                "traces": exported,
                "chaos": chaos_counts}
        _DUMPS.labels(trigger=trigger).inc()
        return snap

    def dump(self, path: Optional[str] = None,
             trigger: str = "manual") -> str:
        """Write one dump artifact atomically (tmp + rename — a concurrent
        reader, or the chaos suite's post-run check, never sees a torn
        file). Returns the path."""
        snap = self.snapshot(trigger)
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight-{os.getpid()}-{int(snap['created'] * 1000)}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(snap, fh, default=str)
        os.replace(tmp, path)
        self.last_dump_path = path
        self.dumps += 1
        _ev.emit("flight.dump", trigger=trigger, path=path,
                 records=snap["records_held"], events=len(snap["events"]))
        return path

    # -- auto trigger (runs on the events drain thread) ----------------------

    def _event_sink(self, event: Any) -> None:
        kind = getattr(event, "kind", None)
        trigger = _AUTO_TRIGGERS.get(kind)
        if trigger is None and kind == "chaos.injected":
            if getattr(event, "fields", {}).get("action") == "kill":
                trigger = "chaos_kill"
        if trigger is None:
            return
        now = time.monotonic()
        if now - self._last_auto_dump < self.min_auto_dump_interval_s:
            return
        self._last_auto_dump = now
        try:
            self.dump(trigger=trigger)
        except Exception:
            # the black box must never take down the event drain thread
            pass


# -- module-level singleton (what the serving stack and the taps use) --------

_RECORDER: Optional[FlightRecorder] = None
_ATEXIT_REGISTERED = False
_PREV_SIGNAL_HANDLERS: Dict[int, Any] = {}


def install(dump_dir: Optional[str] = None,
            capacity: int = 4096,
            plane: Any = None,
            signals: Iterable[int] = (),
            min_auto_dump_interval_s: float = 30.0) -> FlightRecorder:
    """Install the process flight recorder: ring + auto event trigger +
    atexit hook + chained signal handlers. Idempotent-ish: a second install
    replaces the first (uninstalling its trigger sink)."""
    global _RECORDER, _ATEXIT_REGISTERED
    uninstall()
    rec = FlightRecorder(
        capacity=capacity, dump_dir=dump_dir, plane=plane,
        min_auto_dump_interval_s=min_auto_dump_interval_s)
    _RECORDER = rec
    _ev.default_log().add_sink(rec._event_sink)
    if not _ATEXIT_REGISTERED:
        atexit.register(_atexit_dump)
        _ATEXIT_REGISTERED = True
    for signum in signals:
        try:
            prev = _signal.getsignal(signum)
            _signal.signal(signum, _make_signal_handler(signum))
            _PREV_SIGNAL_HANDLERS[signum] = prev
        except (ValueError, OSError):
            # not the main thread / exotic signal: fault coverage falls
            # back to atexit + the auto event trigger
            continue
    return rec


def uninstall() -> None:
    """Remove the process recorder (tests): trigger sink detached, chained
    signal handlers restored. The atexit hook stays registered but no-ops
    with no recorder installed."""
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    if rec is not None:
        _ev.default_log().remove_sink(rec._event_sink)
    while _PREV_SIGNAL_HANDLERS:
        signum, prev = _PREV_SIGNAL_HANDLERS.popitem()
        try:
            _signal.signal(signum, prev)
        except (ValueError, OSError, TypeError):
            continue


def get() -> Optional[FlightRecorder]:
    return _RECORDER


def record(site: str, inputs: Dict[str, Any],
           decision: Optional[Dict[str, Any]] = None) -> None:
    """Tap entry point for the serving tiers: no-op (one global read) when
    no recorder is installed, so the hot path costs nothing by default."""
    rec = _RECORDER
    if rec is not None:
        rec.record(site, inputs, decision)


def _atexit_dump() -> None:
    rec = _RECORDER
    if rec is None:
        return
    try:
        rec.dump(trigger="atexit")
    except Exception:
        pass


def _make_signal_handler(signum: int):
    def handler(sig, frame):
        rec = _RECORDER
        if rec is not None:
            try:
                rec.dump(trigger="signal")
            except Exception:
                pass
        prev = _PREV_SIGNAL_HANDLERS.get(signum)
        if callable(prev):
            prev(sig, frame)
        elif prev == _signal.SIG_DFL:
            # re-raise under the default disposition so the process still
            # dies with the right signal semantics
            _signal.signal(signum, _signal.SIG_DFL)
            _signal.raise_signal(signum)
    return handler


__all__ = ["DEFAULT_HISTORY_METRICS", "FLIGHT_SCHEMA", "FlightRecorder",
           "get", "install", "record", "uninstall"]
