"""Structured decision events — the system's audit stream (port of
``analytics_zoo_tpu/observability/events.py``, which needs no JAX).

Every consequential runtime decision — a deadline shed, a prefix-cache
invalidation on a hot swap, a chaos injection, a breaker opening — goes
through the ONE emission API:

    from ..observability import events
    events.emit("gen.prefix.invalidated", severity="info",
                reason="hot_swap", pages=dropped)

An event is ``{ts, kind, severity, trace_id, fields}``. ``trace_id`` defaults
to the ambient telemetry span's trace, so the decision links to a concrete
trace. Events land in:

* a bounded in-process ring (``events()``);
* ``zoo_events_total{kind,severity}`` on the port's metric registry;
* optional sinks: a JSONL file (:func:`attach_jsonl`) and a broker stream
  (:func:`attach_broker`), drained by a background thread so ``emit`` never
  blocks on a disk or the network; the JAX package's ``cli events`` reads
  the stream from another process.

High-rate sites pass ``throttle_s``: repeats of the same ``(kind, reason)``
within the window are counted, not stored, and the next stored event
carries the ``suppressed`` count.

Lock discipline: the ring lock is a plain terminal ``threading.Lock``
(nothing is acquired under it). Sink fan-out runs on ONE background drain
thread behind a bounded drop-oldest queue: ``emit`` itself never touches a
file or socket, so emitters that hold other locks are never stalled by a
slow disk or broker.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..common import telemetry as _tm

__all__ = ["Event", "EventLog", "EVENT_STREAM", "SEVERITIES", "emit",
           "events", "attach_jsonl", "attach_broker", "detach_sinks",
           "reset_events", "default_log"]

EVENT_STREAM = "events"

SEVERITIES = ("info", "warning", "error")

_EVENTS = _tm.counter("zoo_events_total",
                      "Structured decision events emitted, by kind and "
                      "severity (autoscale, failover, rollout, breaker, "
                      "shed, chaos, slo)", labels=("kind", "severity"))


class Event:
    """One structured decision event (immutable once emitted)."""

    __slots__ = ("ts", "kind", "severity", "trace_id", "fields")

    def __init__(self, ts: float, kind: str, severity: str,
                 trace_id: Optional[str], fields: Dict[str, Any]):
        self.ts = ts
        self.kind = kind
        self.severity = severity
        self.trace_id = trace_id
        self.fields = fields

    def to_dict(self) -> Dict[str, Any]:
        return {"ts": self.ts, "kind": self.kind, "severity": self.severity,
                "trace_id": self.trace_id, "fields": self.fields}

    def __repr__(self):
        return (f"Event({self.kind!r}, {self.severity}, "
                f"{sorted(self.fields)!r})")


class EventLog:
    """Bounded ring of :class:`Event` + background fan-out to sinks."""

    def __init__(self, maxlen: int = 2048, sink_queue: int = 512):
        self._lock = threading.Lock()
        self._ring: "collections.deque[Event]" = \
            collections.deque(maxlen=maxlen)
        self._sinks: List[Callable[[Event], None]] = []
        self._seq = 0
        # throttle bookkeeping: (kind, reason) -> [last_emit_t, suppressed_n]
        self._throttle: Dict[Any, List[float]] = {}
        # sink fan-out stays OFF the emitter's thread: bounded drop-oldest
        # queue drained by one daemon thread (started on first add_sink)
        self._sink_q: "queue.Queue[Optional[Event]]" = \
            queue.Queue(maxsize=sink_queue)
        self._drain: Optional[threading.Thread] = None

    # -- emission ------------------------------------------------------------

    def emit(self, kind: str, severity: str = "info",
             trace_id: Optional[str] = None,
             throttle_s: Optional[float] = None,
             **fields: Any) -> Optional[Event]:
        """Emit one event. Returns it, or ``None`` when throttled away."""
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}")
        if trace_id is None:
            sp = _tm.current_span()
            trace_id = sp.trace_id if sp is not None else None
        now = time.time()
        suppressed = 0
        with self._lock:
            if throttle_s:
                key = (kind, fields.get("reason"))
                ent = self._throttle.get(key)
                if ent is not None and now - ent[0] < throttle_s:
                    ent[1] += 1
                    return None
                if ent is not None:
                    suppressed = int(ent[1])
                self._throttle[key] = [now, 0]
            if suppressed:
                fields = {**fields, "suppressed": suppressed}
            ev = Event(now, kind, severity, trace_id, dict(fields))
            self._ring.append(ev)
            self._seq += 1
            have_sinks = bool(self._sinks)
        if trace_id:
            # a STORED audit entry's trace must outlive span churn: pin it
            # so /debug/events links keep resolving. After the throttle
            # check on purpose — a flood of suppressed repeats must not
            # flush the bounded pin FIFO of the rare important events
            _tm.pin_trace(trace_id)
        _EVENTS.labels(kind=kind, severity=severity).inc()
        if have_sinks:
            # non-blocking hand-off to the drain thread; under a wedged
            # sink the OLDEST queued event is dropped (the ring keeps it)
            try:
                self._sink_q.put_nowait(ev)
            except queue.Full:
                try:
                    self._sink_q.get_nowait()
                    self._sink_q.put_nowait(ev)
                except (queue.Empty, queue.Full):
                    pass
        return ev

    def _drain_loop(self) -> None:
        while True:
            ev = self._sink_q.get()
            if ev is None:
                break
            with self._lock:
                sinks = list(self._sinks)
            for sink in sinks:
                try:
                    sink(ev)
                except Exception:
                    pass

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Best-effort wait until queued events reached the sinks."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self._sink_q.empty():
                return True
            time.sleep(0.02)
        return self._sink_q.empty()

    # -- reads ---------------------------------------------------------------

    def events(self, kind: Optional[str] = None,
               min_severity: Optional[str] = None,
               limit: Optional[int] = None) -> List[Event]:
        """Newest-last slice of the ring, optionally filtered."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e.kind == kind
                   or e.kind.startswith(kind + ".")]
        if min_severity is not None:
            floor = SEVERITIES.index(min_severity)
            out = [e for e in out if SEVERITIES.index(e.severity) >= floor]
        if limit is not None:
            out = out[-limit:]
        return out

    def count(self) -> int:
        with self._lock:
            return self._seq

    # -- sinks ---------------------------------------------------------------

    def add_sink(self, fn: Callable[[Event], None]) -> None:
        start = None
        with self._lock:
            self._sinks.append(fn)
            if self._drain is None:
                self._drain = start = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name="zoo-events-sink-drain")
        if start is not None:
            start.start()

    def remove_sink(self, fn: Callable[[Event], None]) -> None:
        """Detach ONE sink (the flight recorder uninstalls its dump trigger
        this way without disturbing jsonl/broker sinks). Unknown fns are
        ignored; the drain thread stays up — it is harmless idle."""
        with self._lock:
            try:
                self._sinks.remove(fn)
            except ValueError:
                pass

    def detach_sinks(self) -> None:
        with self._lock:
            sinks, self._sinks = self._sinks, []
        for s in sinks:
            close = getattr(s, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._throttle.clear()
            self._seq = 0


class _JsonlSink:
    """Append events as JSON lines (its own lock: file writes serialize
    here, never under the ring lock)."""

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def __call__(self, ev: Event) -> None:
        line = json.dumps(ev.to_dict()) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except Exception:
                pass


class _BrokerSink:
    """XADD events onto the broker's ``events`` stream from a drain thread.

    ``emit`` only does a non-blocking put on a bounded queue — when the
    broker is slow or down, the OLDEST queued event is dropped (the ring
    still holds it in-process); the audit stream is best-effort by design.
    """

    def __init__(self, host: str, port: int, stream: str = EVENT_STREAM,
                 maxq: int = 512):
        from ..serving.client import _Conn

        self._q: "queue.Queue[Optional[Event]]" = queue.Queue(maxsize=maxq)
        self._stop = threading.Event()
        self._conn_cls = _Conn
        self._host, self._port, self._stream = host, port, stream
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="zoo-events-broker-sink")
        self._thread.start()

    def __call__(self, ev: Event) -> None:
        try:
            self._q.put_nowait(ev)
        except queue.Full:
            try:
                self._q.get_nowait()      # drop oldest, keep newest
                self._q.put_nowait(ev)
            except (queue.Empty, queue.Full):
                pass

    def _drain(self) -> None:
        from ..common.resilience import RetryPolicy

        policy = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                             max_delay_s=0.5, attempt_timeout_s=5.0,
                             retryable=(ConnectionError, OSError))
        conn = self._conn_cls(self._host, self._port, policy=policy,
                              abort=self._stop.is_set, tag="events.sink")
        try:
            while True:
                ev = self._q.get()
                if ev is None or self._stop.is_set():
                    break
                try:
                    conn.call("XADD", self._stream, ev.to_dict())
                except Exception:
                    if self._stop.is_set():
                        break
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=2.0)


_LOG = EventLog()


def default_log() -> EventLog:
    return _LOG


def emit(kind: str, severity: str = "info", trace_id: Optional[str] = None,
         throttle_s: Optional[float] = None, **fields: Any) -> Optional[Event]:
    """Emit a decision event on the default log (see :class:`EventLog`)."""
    return _LOG.emit(kind, severity=severity, trace_id=trace_id,
                     throttle_s=throttle_s, **fields)


def events(kind: Optional[str] = None, min_severity: Optional[str] = None,
           limit: Optional[int] = None) -> List[Event]:
    return _LOG.events(kind=kind, min_severity=min_severity, limit=limit)


def attach_jsonl(path: str) -> None:
    """Append every subsequent event to ``path`` as one JSON line."""
    _LOG.add_sink(_JsonlSink(path))


def attach_broker(host: str, port: int, stream: str = EVENT_STREAM) -> None:
    """Mirror every subsequent event onto a broker stream (best-effort,
    background-drained) so ``cli events`` works from another process."""
    _LOG.add_sink(_BrokerSink(host, port, stream=stream))


def detach_sinks() -> None:
    _LOG.detach_sinks()


def reset_events() -> None:
    """Test helper: drop ring contents and detach sinks."""
    _LOG.detach_sinks()
    _LOG.clear()
