"""Observability plane (port of ``analytics_zoo_tpu/observability``, which
needs no JAX: the same modules over the port's own telemetry registry).

* :mod:`.history` — background sampler into multi-resolution ring buffers
  with ``rate()`` / ``delta()`` / ``quantile_over_time()`` window queries.
* :mod:`.slo` — declarative objectives (``slo:`` YAML section) evaluated
  with multi-window burn rates into a firing/resolved alert state machine,
  exported as ``zoo_slo_*``.
* :mod:`.events` — structured decision events (autoscale, failover,
  rollout, breaker, shed, chaos, slo) with a ring, a JSONL sink and a
  broker-stream sink.
* :mod:`.traces` — telemetry spans rendered as Chrome/Perfetto trace-event
  JSON.
* :mod:`.recorder` — the flight recorder: a bounded ring of control-input
  records behind every consequential serving decision, dumped with events,
  traces, SLO verdicts and metric windows as one versioned artifact.
* :mod:`.replay` — deterministic decision replay of a flight recording
  under a virtual clock against the incumbent or a candidate policy; the
  JAX package's recordings replay here and the port's there.

:class:`ObservabilityPlane` bundles history + SLO engine for the serving
stack; :class:`~.debug.DebugSurface` serves it all at ``/debug``.
"""

from __future__ import annotations

from typing import Any, Optional

from . import events, history, recorder, replay, slo, traces
from .debug import DebugSurface
from .events import attach_broker, attach_jsonl, emit, reset_events
from .history import DEFAULT_RESOLUTIONS, MetricsHistory
from .recorder import FlightRecorder
from .replay import (IncumbentPolicy, VirtualClock,
                     WatermarkAdmissionPolicy, verify_incumbent)
from .slo import Objective, SLOEngine, parse_objectives
from .traces import export_trace, trace_summaries

__all__ = [
    "DebugSurface", "FlightRecorder", "IncumbentPolicy", "MetricsHistory",
    "Objective", "ObservabilityPlane", "SLOEngine", "VirtualClock",
    "WatermarkAdmissionPolicy", "DEFAULT_RESOLUTIONS", "attach_broker",
    "attach_jsonl", "emit", "events", "export_trace", "history",
    "parse_objectives", "recorder", "replay", "reset_events", "slo",
    "trace_summaries", "traces", "verify_incumbent",
]


class ObservabilityPlane:
    """History sampler + (optional) SLO engine, one start/stop lifecycle.

    ``from_config`` reads the ServingConfig observability knobs: the SLO
    engine exists only when ``slo_objectives`` were declared; the history
    store always runs (one snapshot per second is what makes ``/debug``
    and burn rates self-contained).
    """

    def __init__(self, history_store: Optional[MetricsHistory] = None,
                 slo_engine: Optional[SLOEngine] = None):
        self.history = history_store or MetricsHistory()
        self.slo = slo_engine
        if self.slo is not None:
            self.slo.attach()

    @classmethod
    def from_config(cls, config: Any) -> "ObservabilityPlane":
        fast = float(getattr(config, "slo_fast_window_s", 60.0))
        # a burn-rate window needs several samples in it to difference —
        # scale the finest ring to at least ~5 samples per fast window
        # (sub-second steps only when the config asks for drill-scale
        # windows; production 60s windows keep the 1s default)
        step = max(0.1, min(1.0, fast / 5.0))
        span_s = DEFAULT_RESOLUTIONS[0][0] * DEFAULT_RESOLUTIONS[0][1]
        resolutions = ((step, int(span_s / step)),) + DEFAULT_RESOLUTIONS[1:]
        hist = MetricsHistory(resolutions=resolutions)
        engine = None
        objectives = tuple(getattr(config, "slo_objectives", ()) or ())
        if objectives:
            engine = SLOEngine(
                hist, parse_objectives(objectives),
                fast_window_s=fast,
                slow_window_s=getattr(config, "slo_slow_window_s", 600.0),
                burn_factor=getattr(config, "slo_burn_factor", 9.0))
        return cls(history_store=hist, slo_engine=engine)

    def start(self, interval_s: Optional[float] = None
              ) -> "ObservabilityPlane":
        self.history.start(interval_s=interval_s)
        return self

    def stop(self) -> None:
        self.history.stop()

    def debug_surface(self, extra_status: Any = None) -> DebugSurface:
        return DebugSurface(self, extra_status=extra_status)
