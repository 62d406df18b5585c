"""The per-priority SLO-evidence metric families, registered ONCE (port of
``analytics_zoo_tpu/serving/slo_metrics.py``, which needs no JAX; the SLO
engine that reads them is ``observability/slo.py``).

Three tiers feed these (the engine, the router, the HTTP frontend) and the
observability SLO engine reads them; registering the family in each consumer
meant three hand-maintained copies of the semantics note whose winner
depended on import order. This module is the single registrant — consumers
import the handles.

Accounting contract (enforced by the call sites, asserted by the overload
bench): predict records are counted ``served`` at the serving engine (or the
direct-mode frontend) and ``shed`` at whichever tier DECIDED the shed
(frontend admission, router deadline proof, engine in-flight expiry);
generation streams have both outcomes attributed at the frontend. No
request is ever double-counted.
"""

from __future__ import annotations

from ..common import telemetry as _tm

REQUEST_LATENCY = _tm.histogram(
    "zoo_request_latency_seconds",
    "Receipt-to-computed latency per served record, by priority class — "
    "the SLO latency-objective source", labels=("priority",))

REQUEST_OUTCOMES = _tm.counter(
    "zoo_request_outcomes_total",
    "Per-priority request outcomes (predict: served at the engine / "
    "direct-mode frontend, shed at the deciding tier; generation streams: "
    "attributed at the frontend; never double-counted) — the SLO "
    "availability-objective source", labels=("priority", "outcome"))

__all__ = ["REQUEST_LATENCY", "REQUEST_OUTCOMES"]
