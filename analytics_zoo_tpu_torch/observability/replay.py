"""Deterministic decision replay: re-run a flight recording offline.
(port of ``analytics_zoo_tpu/observability/replay.py``, which needs no JAX:
a copy over the port's own telemetry registry).

The flight recorder (``recorder.py``) captures, for every consequential
serving decision, the exact observation dict the pure decision function in
``serving/qos.py`` consumed — arrival stamps, queue depths, service-time
EMAs, autoscaler debounce state — plus the decision it returned. This
module re-runs that input stream under a **virtual clock** against a
pluggable policy and emits the same decision-event kinds the live tiers
emit, so a recorded run and a candidate run are directly diffable:

* :class:`IncumbentPolicy` routes each record back through the SAME pure
  functions the live tiers used. Replaying a recording under it must
  reproduce the recorded decision sequence **exactly** (kinds, order,
  fields — decisions carry no timestamps), which :func:`verify_incumbent`
  asserts; ``bench.py --replay`` gates on it.
* Candidate policies (e.g. :class:`WatermarkAdmissionPolicy`) see the same
  inputs and may decide differently; :func:`diff_runs` lists the
  divergences and feeds ``zoo_flight_replay_divergence_total``, and
  :func:`score_admission` summarizes served/shed per policy — offline
  policy benching on a real overload trace, before anything ships.

Nothing here imports the serving package at module scope (the observability
package must stay import-light and cycle-free); the incumbent policy pulls
``serving.qos`` lazily at first decision.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from ..common import telemetry as _tm

_DIVERGENCE = _tm.counter(
    "zoo_flight_replay_divergence_total",
    "Decisions that differed between two replay runs of the same "
    "recording (incumbent-vs-recorded exactness checks and "
    "candidate-policy diffs both count here)")


class VirtualClock:
    """Replay time: advances only via the recorded monotonic stamps, and
    only forward — a recording whose stamps run backwards is corrupt and
    must fail loudly, not silently reorder decisions."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self.steps = 0

    @property
    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> float:
        t = float(t)
        if t < self._t:
            raise ValueError(
                f"virtual clock moved backwards: {t:.6f} < {self._t:.6f}")
        self._t = t
        self.steps += 1
        return self._t


class Policy:
    """A replayable decision policy. ``decide`` returns the decision dict
    for a record, or ``None`` to pass the recorded decision through
    unchanged (sites the policy does not model stay as context)."""

    name = "policy"

    def decide(self, site: str,
               inputs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class IncumbentPolicy(Policy):
    """The shipped policies, replayed: admission records go back through
    :func:`~..serving.qos.admission_decision`; autoscale ticks go back
    through :func:`~..serving.qos.autoscale_decision` seeded from the
    debounce-state snapshot embedded in each record — every tick is a pure
    function of its own recorded inputs, so exactness survives ring
    truncation mid-stream; prefill-budget records go back through
    :func:`~..serving.qos.prefill_budget_decision` (the chunked-prefill
    token budget the decode loop spends each iteration)."""

    name = "incumbent"

    def decide(self, site: str,
               inputs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        from ..serving import qos as _qos
        if site.startswith("admission."):
            return _qos.admission_decision(inputs)
        if site == "autoscale.tick":
            state = dict(inputs.get("state")
                         or {"pressure_since": None, "idle_since": None,
                             "last_event_t": 0.0})
            return _qos.autoscale_decision(inputs, state)
        if site == "gen.prefill.budget":
            return _qos.prefill_budget_decision(inputs)
        return None


class WatermarkAdmissionPolicy(Policy):
    """Candidate admission policy: shed any non-protected request once the
    estimated wait crosses a fixed watermark, deadline or not — the classic
    queue-length guard, benchable against the incumbent's deadline-proof
    shedding on the same recorded trace."""

    name = "watermark"

    def __init__(self, watermark_s: float = 0.25,
                 protect: Iterable[str] = ("critical",)):
        self.watermark_s = float(watermark_s)
        self.protect = frozenset(protect)

    def decide(self, site: str,
               inputs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if not site.startswith("admission."):
            return None
        from ..serving import qos as _qos
        est = (max(0.0, float(inputs.get("est_wait_s", 0.0)))
               + max(0.0, float(inputs.get("service_ema_s", 0.0))))
        if (est > self.watermark_s
                and inputs.get("priority") not in self.protect):
            svc = max(0.0, float(inputs.get("service_ema_s", 0.0)))
            return {"action": "shed", "reason": "watermark",
                    "retry_after_s": round(_qos.retry_after_s(
                        int(inputs.get("depth", 0)), svc,
                        max(1, int(inputs.get("concurrency", 1)))), 4),
                    "est_wait_s": round(est, 4)}
        return {"action": "admit", "reason": None, "retry_after_s": None,
                "est_wait_s": round(est, 4)}


class ReplayRun:
    """One policy's pass over a recording: the per-record decisions plus
    the decision events the live tiers would have emitted (kept local to
    the run — replay must never pollute the process event log)."""

    def __init__(self, policy_name: str):
        self.policy_name = policy_name
        self.decisions: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []

    def add(self, record: Dict[str, Any],
            decision: Optional[Dict[str, Any]], vts: float) -> None:
        self.decisions.append({"seq": record.get("seq"),
                               "site": record["site"], "vts": vts,
                               "decision": decision})
        event = _decision_event(record["site"], decision,
                                record.get("inputs") or {}, vts)
        if event is not None:
            self.events.append(event)

    def signature(self) -> List[Any]:
        """Timestamp-free shape of the run — two deterministic policies
        replaying the same recording must produce identical signatures."""
        return [(d["seq"], d["site"], d["decision"])
                for d in self.decisions]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out


def _decision_event(site: str, decision: Optional[Dict[str, Any]],
                    inputs: Dict[str, Any],
                    vts: float) -> Optional[Dict[str, Any]]:
    """The decision-event kind the live tier emits for this decision —
    same kinds, same salient fields, virtual timestamps."""
    if not decision:
        return None
    action = decision.get("action")
    if site.startswith("admission.") and action == "shed":
        tier = site.split(".", 1)[1]
        return {"kind": f"shed.{tier}", "vts": vts,
                "fields": {"reason": decision.get("reason"),
                           "priority": inputs.get("priority"),
                           "est_wait_s": decision.get("est_wait_s"),
                           "retry_after_s": decision.get("retry_after_s")}}
    if site == "autoscale.tick" and action in ("up", "down"):
        return {"kind": f"autoscale.{action}", "vts": vts,
                "fields": {"reason": decision.get("reason"),
                           "load": decision.get("load"),
                           "replicas": inputs.get("n")}}
    if site == "host.reconcile" and action == "reconcile":
        return {"kind": "host.reconcile", "vts": vts,
                "fields": {"spawn": decision.get("spawn"),
                           "remove": decision.get("remove")}}
    if site == "fleet.host_check" and action == "failover":
        return {"kind": "fleet.host_failed", "vts": vts,
                "fields": {"host": inputs.get("host"),
                           "hb_age_s": inputs.get("hb_age_s")}}
    return None


def replay(records: Iterable[Dict[str, Any]], policy: Policy,
           clock: Optional[VirtualClock] = None) -> ReplayRun:
    """Re-run a recorded input stream under ``policy``. Records replay in
    recorded order (monotonic stamp, then capture seq); the virtual clock
    enforces that order is actually monotonic."""
    recs = sorted(records,
                  key=lambda r: (float(r.get("mono", r.get("ts", 0.0))),
                                 int(r.get("seq", 0))))
    policy.reset()
    if clock is None:
        start = (float(recs[0].get("mono", recs[0].get("ts", 0.0)))
                 if recs else 0.0)
        clock = VirtualClock(start=start)
    run = ReplayRun(policy.name)
    for rec in recs:
        clock.advance_to(float(rec.get("mono", rec.get("ts", 0.0))))
        decision = policy.decide(rec["site"], rec.get("inputs") or {})
        if decision is None:
            decision = rec.get("decision")
        run.add(rec, decision, clock.now)
    return run


def diff_runs(a: ReplayRun, b: ReplayRun) -> List[Dict[str, Any]]:
    """Per-record decision divergences between two runs of the SAME
    recording. Counted on ``zoo_flight_replay_divergence_total``."""
    out: List[Dict[str, Any]] = []
    for da, db in zip(a.decisions, b.decisions):
        if da["decision"] != db["decision"]:
            out.append({"seq": da["seq"], "site": da["site"],
                        a.policy_name: da["decision"],
                        b.policy_name: db["decision"]})
    if out:
        _DIVERGENCE.inc(len(out))
    return out


def verify_incumbent(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """THE determinism gate: replaying under the incumbent policy must
    reproduce every recorded decision exactly (kinds, order, fields —
    decisions are timestamp-free by construction)."""
    recs = sorted(records,
                  key=lambda r: (float(r.get("mono", r.get("ts", 0.0))),
                                 int(r.get("seq", 0))))
    run = replay(recs, IncumbentPolicy())
    divergences: List[Dict[str, Any]] = []
    for rec, replayed in zip(recs, run.decisions):
        if rec.get("decision") != replayed["decision"]:
            divergences.append({"seq": rec.get("seq"), "site": rec["site"],
                                "recorded": rec.get("decision"),
                                "replayed": replayed["decision"]})
    if divergences:
        _DIVERGENCE.inc(len(divergences))
    return {"exact": not divergences, "decisions": len(run.decisions),
            "divergences": divergences[:20]}


def score_admission(run: ReplayRun) -> Dict[str, Any]:
    """Outcome summary for one policy's admission decisions — the numbers
    ``bench.py --replay`` compares across policies."""
    considered = admitted = shed = 0
    shed_by_priority: Dict[str, int] = {}
    retry: List[float] = []
    for d in run.decisions:
        if not d["site"].startswith("admission."):
            continue
        considered += 1
        decision = d["decision"] or {}
        if decision.get("action") == "shed":
            shed += 1
            if decision.get("retry_after_s") is not None:
                retry.append(float(decision["retry_after_s"]))
        else:
            admitted += 1
    # priorities live on the inputs, not the decisions — recount from events
    for e in run.events:
        if e["kind"].startswith("shed."):
            pri = str(e["fields"].get("priority"))
            shed_by_priority[pri] = shed_by_priority.get(pri, 0) + 1
    return {"policy": run.policy_name, "considered": considered,
            "admitted": admitted, "shed": shed,
            "shed_by_priority": shed_by_priority,
            "mean_retry_after_s": (round(sum(retry) / len(retry), 4)
                                   if retry else None)}


def load_records(source: Any) -> List[Dict[str, Any]]:
    """Control records from a flight dump: accepts a dump dict, a path to
    one, or a bare record list. Refuses unknown schema versions — replay
    semantics are tied to what the recorder captured."""
    if isinstance(source, str):
        with open(source) as fh:
            source = json.load(fh)
    if isinstance(source, list):
        return list(source)
    if not isinstance(source, dict):
        raise ValueError(f"not a flight dump: {type(source).__name__}")
    schema = source.get("schema")
    if schema != "zoo-flight-v1":
        raise ValueError(f"unsupported flight dump schema: {schema!r}")
    return list(source.get("records") or [])


__all__ = ["IncumbentPolicy", "Policy", "ReplayRun", "VirtualClock",
           "WatermarkAdmissionPolicy", "diff_runs", "load_records",
           "replay", "score_admission", "verify_incumbent"]
