"""Serving quality-of-service primitives: priorities, deadlines, shedding
(port of ``analytics_zoo_tpu/serving/qos.py``, which needs no JAX).

Under overload a FIFO queue is the worst policy: every request, latency-
critical and bulk alike, waits behind the whole backlog until it times
out. This module is the shared vocabulary the decode loop
(:class:`~.generation.ContinuousBatcher`) uses to do better, the same
functions the JAX package's serving tiers call:

* **Priorities** — ``critical`` / ``normal`` / ``bulk``, ordered. Eligible
  work is served in ``(priority, deadline)`` order; latency-critical traffic
  may preempt bulk generation slots.
* **Deadlines** — absolute wall-clock (``time.time()`` epoch seconds, so
  they survive process boundaries). A request that *provably cannot meet
  its deadline* is shed BEFORE any work is spent on it — estimated wait
  (measured service time × queue depth) is the proof — and answered with
  an honest computed ``Retry-After``.
* **Shedding** — :class:`ShedError` carries ``retry_after_s`` end to end and
  is honored as the backoff floor by
  :class:`~..common.resilience.RetryPolicy`.

Everything here is dependency-free host code: the decisions run per
request on the hot path and must cost microseconds.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

# ordered: lower rank = served first. Unknown strings normalize to "normal"
# (an old or foreign client must never be rejected over a QoS label).
PRIORITIES: Tuple[str, ...] = ("critical", "normal", "bulk")
PRIORITY_RANK: Dict[str, int] = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "normal"

# a shed answer must never tell the client "retry immediately": even an
# empty queue costs one service time to drain the request that triggered
# the shed decision
MIN_RETRY_AFTER_S = 0.05


def normalize_priority(priority: Any) -> str:
    """Tolerant read of a priority label: unknown/absent → ``normal``."""
    if isinstance(priority, str):
        p = priority.strip().lower()
        if p in PRIORITY_RANK:
            return p
    return DEFAULT_PRIORITY


def priority_rank(priority: Any) -> int:
    return PRIORITY_RANK[normalize_priority(priority)]


def normalize_deadline(deadline: Any) -> Optional[float]:
    """Tolerant read of an absolute wall-clock deadline (epoch seconds).
    Anything non-numeric or non-positive → ``None`` (no deadline)."""
    if isinstance(deadline, bool):
        return None
    if isinstance(deadline, (int, float)) and deadline > 0:
        return float(deadline)
    return None


def deadline_from_ms(deadline_ms: Optional[float],
                     now: Optional[float] = None) -> Optional[float]:
    """Relative budget (ms from now — the client/HTTP-header shape) →
    absolute epoch-seconds deadline (the wire/payload shape)."""
    if deadline_ms is None:
        return None
    return (time.time() if now is None else now) + float(deadline_ms) / 1e3


def order_key(priority: Any, deadline: Any, seq: Any = 0) -> Tuple:
    """Sort key for eligible work: ``(priority rank, deadline, FIFO seq)``.
    Deadline-less requests sort after dated ones within a priority class
    (they declared no urgency); ``seq`` keeps the order total and FIFO-fair
    within a class."""
    dl = normalize_deadline(deadline)
    return (priority_rank(priority),
            dl if dl is not None else float("inf"), seq)


class ShedError(RuntimeError):
    """A request was shed by an overloaded tier instead of being served.

    ``retry_after_s`` is the server's honest drain estimate (queue depth ×
    measured service time) — the client should back off at least this long.
    Subclasses :class:`RuntimeError` so pre-QoS handlers that catch generic
    serving errors keep working.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 reason: str = "admission"):
        super().__init__(message)
        self.retry_after_s = max(MIN_RETRY_AFTER_S, float(retry_after_s))
        self.reason = reason


def shed_payload(message: str, retry_after_s: float,
                 reason: str = "admission") -> Dict[str, Any]:
    """The result-hash payload a shedding tier writes for a queued request:
    the client's :meth:`OutputQueue.query` turns it back into a
    :class:`ShedError` carrying the same ``retry_after_s``."""
    return {"error": message, "shed": True,
            "retry_after_s": round(max(MIN_RETRY_AFTER_S,
                                       float(retry_after_s)), 4),
            "shed_reason": reason}


def shed_error_from_payload(payload: Dict[str, Any],
                            uri: str) -> Optional[ShedError]:
    """Rebuild the :class:`ShedError` a shed result payload encodes (or
    ``None`` for ordinary results/errors)."""
    if isinstance(payload, dict) and payload.get("shed"):
        return ShedError(
            f"request {uri!r} shed: {payload.get('error', 'overloaded')}",
            retry_after_s=float(payload.get("retry_after_s", 1.0)),
            reason=str(payload.get("shed_reason", "admission")))
    return None


class ServiceTimeEMA:
    """Thread-safe EMA of observed service seconds — the measured half of
    every tier's ``estimated wait = service time × queue depth`` shed proof.
    ``value()`` is 0.0 until the first observation (no evidence → no
    evidence-based shedding; expired deadlines still shed)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._value = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._n += 1
            self._value = (seconds if self._n == 1
                           else (1 - self.alpha) * self._value
                           + self.alpha * seconds)

    def value(self) -> float:
        with self._lock:
            return self._value

    def observations(self) -> int:
        with self._lock:
            return self._n


def estimated_wait_s(queue_depth: int, service_ema_s: float,
                     concurrency: int = 1) -> float:
    """Expected time for ``queue_depth`` queued records to drain through
    ``concurrency`` parallel servers of measured ``service_ema_s`` each —
    the wait a newly admitted request would sit through before service."""
    if service_ema_s <= 0.0:
        return 0.0
    return (max(0, int(queue_depth)) * float(service_ema_s)
            / max(1, int(concurrency)))


def cannot_meet(deadline: Any, est_wait_s: float, service_ema_s: float = 0.0,
                now: Optional[float] = None,
                skew_tolerance_s: float = 0.0) -> bool:
    """True when a request with ``deadline`` provably cannot be served in
    time: already expired, or the estimated queue wait plus one service time
    overruns it. Deadline-less requests always pass.

    ``skew_tolerance_s`` loosens the verdict by the fleet's measured cross-
    host clock uncertainty: deadlines are wall-clock epoch seconds stamped on
    the CLIENT's host, so a router whose clock runs ahead of the client's
    would otherwise shed requests that are in fact meetable. Shedding is
    irreversible while a late answer is merely late — so skew widens the
    admit side, never the shed side."""
    dl = normalize_deadline(deadline)
    if dl is None:
        return False
    t = time.time() if now is None else now
    return (t + max(0.0, est_wait_s) + max(0.0, service_ema_s)
            > dl + max(0.0, skew_tolerance_s))


def retry_after_s(queue_depth: int, service_ema_s: float,
                  concurrency: int = 1) -> float:
    """Honest ``Retry-After``: the current backlog's drain estimate, floored
    so a client never hammers an overloaded server at 0s intervals."""
    return max(MIN_RETRY_AFTER_S,
               estimated_wait_s(queue_depth, service_ema_s, concurrency))


# -- pure decision functions (shared by live sites and offline replay) -------
#
# Every consequential serving decision routes through ONE of these pure
# functions: the live tier builds an observation dict, calls the function,
# records (inputs, decision) on the flight recorder
# (observability/recorder.py), then ACTS on the decision. The JAX package's
# offline replay re-runs the same function over the recorded inputs —
# determinism is by construction, not by careful reimplementation.
# Neither function may read clocks, randomness, or globals: everything the
# verdict depends on must arrive in the inputs.

def admission_decision(inputs: Dict[str, Any]) -> Dict[str, Any]:
    """One admission verdict (router hold-queue or decode-loop backlog).

    ``inputs``: ``now`` (epoch s), ``deadline`` (epoch s or None),
    ``est_wait_s`` (queue wait ahead of this request), ``service_ema_s``,
    ``skew_tolerance_s``, ``depth`` (backlog the Retry-After is computed
    over), ``concurrency`` (parallel servers draining it). Extra keys
    (priority, eligible, site context) are ignored — recorded inputs may
    carry more than the verdict needs.

    Returns ``{"action": "admit"|"shed", "reason", "retry_after_s",
    "est_wait_s"}`` — deterministic, timestamp-free, directly comparable
    across replay runs.
    """
    est = max(0.0, float(inputs.get("est_wait_s", 0.0)))
    svc = max(0.0, float(inputs.get("service_ema_s", 0.0)))
    if cannot_meet(inputs.get("deadline"), est, svc,
                   now=float(inputs["now"]),
                   skew_tolerance_s=float(
                       inputs.get("skew_tolerance_s", 0.0))):
        return {"action": "shed", "reason": "deadline",
                "retry_after_s": round(
                    retry_after_s(int(inputs.get("depth", 0)), svc,
                                  max(1, int(inputs.get("concurrency", 1)))),
                    4),
                "est_wait_s": round(est + svc, 4)}
    return {"action": "admit", "reason": None, "retry_after_s": None,
            "est_wait_s": round(est + svc, 4)}


def autoscale_decision(obs: Dict[str, Any],
                       state: Dict[str, Any]) -> Dict[str, Any]:
    """One autoscaler evaluation: owed work per eligible replica (shed
    traffic counting double — demand the fleet failed to serve), debounced
    both directions and cooldown rate-limited.

    ``obs``: ``now`` (monotonic s), ``n`` (replicas), ``eligible``, ``owed``
    (broker-measured backlog; ``None`` = broker unreachable this poll),
    ``shed_delta``/``routed_delta`` (router counter deltas since the last
    tick), plus the config knobs ``up_depth``, ``sustain_s``, ``idle_s``,
    ``cooldown_s``, ``min_replicas``, ``max_replicas``.

    ``state`` is the debounce memory ``{"pressure_since", "idle_since",
    "last_event_t"}`` — mutated IN PLACE, and only here, so the live
    autoscaler and an offline replay evolve it identically. The flight
    recorder snapshots the pre-call state into each record, which makes
    every tick independently replayable even after ring truncation.

    Returns ``{"action": "up"|"down"|"hold", "reason", "load"}``.
    """
    now = float(obs["now"])
    owed = obs.get("owed")
    if owed is None:
        state["idle_since"] = None
        return {"action": "hold", "reason": "broker_unreachable",
                "load": None}
    owed = int(owed)
    shed_delta = int(obs.get("shed_delta", 0))
    load = ((owed + 2.0 * shed_delta)
            / max(1, int(obs.get("eligible", 0))))
    load = round(load, 4)
    if load > float(obs["up_depth"]):
        if state.get("pressure_since") is None:
            state["pressure_since"] = now
    else:
        state["pressure_since"] = None
    if owed == 0 and int(obs.get("routed_delta", 0)) == 0 \
            and shed_delta == 0:
        if state.get("idle_since") is None:
            state["idle_since"] = now
    else:
        state["idle_since"] = None
    if now - float(state.get("last_event_t", 0.0)) < float(obs["cooldown_s"]):
        return {"action": "hold", "reason": "cooldown", "load": load}
    n = int(obs["n"])
    if (state.get("pressure_since") is not None
            and now - state["pressure_since"] >= float(obs["sustain_s"])
            and n < int(obs["max_replicas"])):
        state["last_event_t"] = now
        state["pressure_since"] = None
        return {"action": "up", "reason": "pressure", "load": load}
    if (state.get("idle_since") is not None
            and now - state["idle_since"] >= float(obs["idle_s"])
            and n > int(obs["min_replicas"])):
        state["last_event_t"] = now
        state["idle_since"] = None
        return {"action": "down", "reason": "idle", "load": load}
    return {"action": "hold", "reason": "steady", "load": load}


def prefill_budget_from_slo(itl_target_s: float, decode_ema_s: float,
                            chunk_ema_s: float, chunk_tokens: int) -> int:
    """Per-loop-iteration prefill token budget derived from an ITL
    objective: the headroom an interleaved decode step leaves under the
    target, divided into whole chunks.

    ``itl_target_s``: the ITL SLO target (seconds between tokens of a
    running stream — each loop iteration emits one decode step, so the
    prefill work squeezed in front of it is exactly the ITL inflation);
    ``decode_ema_s``: measured decode-step EMA; ``chunk_ema_s``: measured
    per-chunk prefill EMA; ``chunk_tokens``: tokens per chunk. No evidence
    yet (either EMA unobserved) or no headroom → ONE chunk (the progress
    floor: a prefilling stream must always advance, else a saturated decode
    loop starves prefill forever). Pure: no clocks, no globals.
    """
    chunk_tokens = max(1, int(chunk_tokens))
    if chunk_ema_s <= 0.0 or decode_ema_s <= 0.0:
        return chunk_tokens                       # cold: floor of one chunk
    headroom = float(itl_target_s) - float(decode_ema_s)
    if headroom <= 0.0:
        return chunk_tokens                       # saturated: floor
    return max(1, int(headroom / float(chunk_ema_s))) * chunk_tokens


def prefill_budget_decision(inputs: Dict[str, Any]) -> Dict[str, Any]:
    """One prefill-budget verdict for the decode loop (the ``gen.prefill.
    budget`` recorder site).

    ``inputs``: ``chunk_tokens``, ``static_budget`` (YAML
    ``prefill_token_budget``; 0 = unset), ``itl_target_s`` (SLO target or
    None), ``decode_ema_s``, ``chunk_ema_s``. Extra keys are ignored.

    Returns ``{"budget_tokens", "chunks", "source"}`` where ``source`` is
    ``"slo"`` (headroom-derived), ``"static"`` (YAML budget), or
    ``"floor"`` (no signal → one chunk). Deterministic and timestamp-free,
    so live records replay exactly (:class:`~..observability.replay.
    IncumbentPolicy`).
    """
    chunk_tokens = max(1, int(inputs.get("chunk_tokens", 1)))
    itl = inputs.get("itl_target_s")
    if itl is not None and float(itl) > 0.0:
        budget = prefill_budget_from_slo(
            float(itl), float(inputs.get("decode_ema_s", 0.0)),
            float(inputs.get("chunk_ema_s", 0.0)), chunk_tokens)
        source = "slo"
    elif int(inputs.get("static_budget", 0)) > 0:
        budget = max(chunk_tokens, int(inputs["static_budget"]))
        source = "static"
    else:
        budget = chunk_tokens
        source = "floor"
    return {"budget_tokens": int(budget),
            "chunks": int(budget) // chunk_tokens, "source": source}


__all__ = ["DEFAULT_PRIORITY", "MIN_RETRY_AFTER_S", "PRIORITIES",
           "PRIORITY_RANK", "ServiceTimeEMA", "ShedError",
           "admission_decision", "autoscale_decision", "cannot_meet",
           "deadline_from_ms", "estimated_wait_s", "normalize_deadline",
           "normalize_priority", "order_key", "prefill_budget_decision",
           "prefill_budget_from_slo", "priority_rank", "retry_after_s",
           "shed_error_from_payload", "shed_payload"]
