"""Observability plane (port of ``analytics_zoo_tpu/observability``, the
parts the serving path reports through):

* :mod:`.events` — ``emit(kind, severity, **fields)`` structured decision
  events (shed, prefix invalidation, prefill budget, chaos, breaker) with a
  bounded ring, a JSONL sink and a broker-stream sink.
* :mod:`.traces` — telemetry spans rendered as Chrome/Perfetto trace-event
  JSON.
* :mod:`.recorder` — the flight recorder: a bounded ring of control-input
  records behind every consequential serving decision, dumped with the
  events, traces and metrics as one versioned artifact.
* :mod:`.debug` — the ``/debug`` ops surface the HTTP frontend serves
  (HTML dashboard, events, traces, the flight-recorder dump).

``events.attach_broker`` mirrors events onto the broker's ``events``
stream. The JAX package's metric history, SLO engine and decision replay
are not ported yet (ROADMAP Queue 1, item 8's next slice); ``/debug`` shows
no SLO table or sparklines until then.
"""

from __future__ import annotations

from . import events, recorder, traces
from .events import attach_jsonl, emit, reset_events
from .recorder import FlightRecorder
from .traces import export_trace, trace_summaries

__all__ = ["FlightRecorder", "attach_jsonl", "emit", "events",
           "export_trace", "recorder", "reset_events", "trace_summaries",
           "traces"]
