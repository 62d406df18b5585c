"""Trace export: telemetry spans → Chrome/Perfetto trace-event JSON (port
of ``analytics_zoo_tpu/observability/traces.py``, which needs no JAX).

The span recorder (``common/telemetry.py``) keeps whole traces with
tail-based retention (errored + slowest-k traces survive eviction longest —
see ``_SpanRecorder``). This module renders one trace as the Chrome
trace-event format that ``ui.perfetto.dev`` / ``chrome://tracing`` load
directly: complete (``"ph": "X"``) events with microsecond ``ts``/``dur``,
one row (tid) per span, span tags in ``args``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..common import telemetry as _tm

__all__ = ["export_trace", "trace_summaries", "interesting_traces"]


def render_chrome_trace(records: Sequence[_tm.SpanRecord],
                        trace_id: str) -> Dict[str, Any]:
    """Chrome trace-event JSON for one trace's span records."""
    events: List[Dict[str, Any]] = []
    # stable row assignment: spans sorted by start time, one tid each —
    # Perfetto then renders overlap/nesting on the shared wall-clock axis
    ordered = sorted(records, key=lambda s: (s.start_wall, s.name))
    for tid, s in enumerate(ordered, start=1):
        events.append({
            "name": s.name,
            "cat": "zoo" if s.status == "ok" else "zoo,error",
            "ph": "X",
            "ts": s.start_wall * 1e6,
            "dur": max(0.0, s.duration_s) * 1e6,
            "pid": 1,
            "tid": tid,
            "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                     "status": s.status, **s.tags},
        })
    # cross-host traces (whole-host failover) tag spans with the machine
    # they ran on / acted about — surface the distinct set so an operator
    # sees at a glance that one timeline stitches several hosts
    hosts = sorted({str(v) for s in ordered for k, v in s.tags.items()
                    if k in ("host", "failed_host") and v})
    other: Dict[str, Any] = {"trace_id": trace_id,
                             "spans": len(events),
                             "exporter": "analytics_zoo_tpu_torch.observability"}
    if hosts:
        other["hosts"] = hosts
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def export_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """Export one trace from the in-process recorder (``None`` when the
    recorder holds no spans for it — evicted or never local)."""
    records = _tm.spans(trace_id=trace_id)
    if not records:
        return None
    return render_chrome_trace(records, trace_id)


def _summary(trace_id: str, records: Sequence[_tm.SpanRecord],
             retained: Dict[str, str]) -> Dict[str, Any]:
    roots = [s for s in records if s.parent_id is None]
    dur = max((s.duration_s for s in records), default=0.0)
    return {"trace_id": trace_id,
            "spans": len(records),
            "root": roots[0].name if roots else records[0].name,
            "complete": bool(roots),
            "duration_ms": round(dur * 1e3, 3),
            "errored": any(s.status != "ok" for s in records),
            "retention": retained.get(trace_id, "sampled"),
            "start_wall": min(s.start_wall for s in records)}


def trace_summaries(limit: int = 50) -> List[Dict[str, Any]]:
    """Newest-first summaries of the recorder's traces (the
    ``/debug/traces`` index)."""
    retained = _tm.protected_trace_ids()
    out = []
    for tid in reversed(_tm.trace_ids()[-limit * 2:]):
        records = _tm.spans(trace_id=tid)
        if records:
            out.append(_summary(tid, records, retained))
        if len(out) >= limit:
            break
    return out


def interesting_traces(limit: int = 20) -> List[Dict[str, Any]]:
    """Tail-sampled view: every errored trace, then the slowest, then a
    sample of the rest — the order an operator wants after an incident."""
    summaries = trace_summaries(limit=max(limit * 4, 50))
    errored = [s for s in summaries if s["errored"]]
    slow = sorted((s for s in summaries if not s["errored"]),
                  key=lambda s: -s["duration_ms"])
    out, seen = [], set()
    for s in errored + slow:
        if s["trace_id"] not in seen:
            seen.add(s["trace_id"])
            out.append(s)
        if len(out) >= limit:
            break
    return out
