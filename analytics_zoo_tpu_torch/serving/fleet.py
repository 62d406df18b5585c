"""Serving replica fleet — health-routed multi-replica dispatch with
zero-loss failover (port of ``analytics_zoo_tpu/serving/fleet.py``, which
needs no JAX: the same router, supervisor, broker keys and decisions).

Replicas serve on ``device`` (CUDA unless the caller names another):
thread-mode replicas are :class:`~.engine.ClusterServing` engines in this
process on that device, process-mode replicas and host agents get
``--device`` on their command line, and every spawned command names this
package (``python -m analytics_zoo_tpu_torch.serving.fleet`` /
``...hostagent``). A replica that cannot reach the card dies loudly; it
never serves on the CPU unless ``device="cpu"`` was asked for. Several
process replicas on one card each make their own CUDA context and load
their own kernels (``ops/_build.py`` builds into a per-process temporary
file and renames it into place, so concurrent builds are safe).

The reference's Cluster Serving inherited horizontal scale and task restarts
from Flink's runtime (PAPERS.md "BigDL 2.0"); this module builds the same
supervision loop natively over the queue broker, in the at-least-once
redelivery spirit of PAPERS.md "TensorFlow: A system for large-scale machine
learning":

* :class:`ReplicaRouter` sits at the broker: it consumes the client-facing
  request stream under its own consumer group and forwards each entry onto a
  per-replica dispatch stream (``fleet:req:<rid>``), choosing the replica by a
  pluggable policy — ``round_robin`` or ``least_pending`` (fed by the same
  per-replica queue-depth numbers it publishes as ``zoo_fleet_queue_depth``
  gauges). A per-replica :class:`~..common.resilience.CircuitBreaker` gates
  eligibility: an evicted replica takes no traffic until its half-open probe
  request is observed SERVED.

* :class:`FleetSupervisor` owns the replica lifecycle: it spawns N
  :class:`~.engine.ClusterServing` replicas (``thread`` mode — N engines in
  this process — or ``process`` mode — one subprocess each, see ``main``),
  folds their broker-side heartbeats (``fleet:hb:<rid>``, written by the
  engine's fleet-heartbeat loop) into a
  :class:`~..common.resilience.HealthRegistry`, and reacts to liveness
  TRANSITIONS via the registry's listener hook: a replica that goes silent is
  evicted from routing, its claimed-but-unacked requests are moved back onto
  the dispatch stream in one atomic broker ``XTRANSFER`` (delivery counts
  ride along), and the replica is respawned. Requests are therefore
  at-least-once: a slow-not-dead replica may still answer work that was
  requeued — replica sinks write results with ``HSETNX`` (first-write-wins,
  dedup-on-uri), so the client sees exactly one response per submitted uri.

* Graceful drain (``drain()`` / the ``cli drain`` command) flips a replica to
  stop-accepting via its control hash; it finishes + acks in-flight work,
  reaches state ``drained``, and is deregistered from routing — the
  zero-downtime half of :meth:`FleetSupervisor.rolling_restart`, which drains,
  restarts and readmits replicas one at a time (the model hot-swap
  precondition).

* Cross-host fleets (``fleet_spawn: host`` / ``fleet_hosts > 0``) add a HOST
  failure domain above the replica tier: per-machine :class:`~.hostagent.
  HostAgent` daemons register under ``fleet:host:<hid>``, spawn replicas on
  supervisor command (the declarative ``fleet:hostctl:<hid>`` hash), and
  heartbeat host-level liveness distinct from replica liveness. Placement is
  spread-by-default (the emptiest registered host first — the autoscaler
  "borrows an idle machine" before packing a busy one) under a per-host
  capacity; host-heartbeat expiry triggers WHOLE-HOST failover: every
  replica on the host is evicted, claim-transferred, and respawned on
  surviving hosts in one decision (one ``fleet.host_failed`` event whose
  trace carries spans tagged with both host ids and the measured clock
  offset). A per-host :class:`~..common.resilience.CircuitBreaker` makes
  dials to a dead host fail fast with a computed Retry-After.

Wire layout on the broker::

    serving_stream                   client XADDs (unchanged client API)
    fleet:req:<rid>                  router -> replica dispatch stream
    fleet:hb:<rid>                   replica heartbeat hash {ts, state, served}
    fleet:ctl:<rid>                  supervisor/cli -> replica control hash
    fleet:host:<hid>                 host-agent heartbeat hash (hostagent.py)
    fleet:hostctl:<hid>              supervisor -> host-agent desired state
    fleet:members                    supervisor-published replica roster
    result:<uri>                     replica HSETNX (first answer wins)
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.locks import traced_lock
from ..common.resilience import (CircuitBreaker, HealthRegistry,
                                 RetryAbortedError, RetryPolicy)
from ..observability import events as _ev
from ..observability import recorder as _flight
from . import qos as _qos
from . import slo_metrics as _slo_metrics
from .client import INPUT_STREAM, RESULT_PREFIX, _Conn
from .config import ServingConfig
from .engine import FLEET_CTL_PREFIX, FLEET_HB_PREFIX, ClusterServing
from .hostagent import HOST_CTL_PREFIX, HOST_HB_PREFIX, HostAgent
from .schema import payload_deadline, payload_priority
from .shm import host_identity

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.fleet")

REPLICA_STREAM_PREFIX = "fleet:req:"
ROUTER_GROUP = "fleet-router"

# the router resolves half-open probes and trips/queries breakers while
# holding its own lock; the breaker lock is a declared leaf (resilience.py),
# so this nesting is the one legal order — the witness + static graph fail
# on any inversion
# zoo-lock: order(ReplicaRouter._lock < CircuitBreaker._lock)
MEMBERS_KEY = "fleet:members"
ROLLING_KEY = "fleet:ctl:__rolling__"

_DISPATCH = _tm.counter("zoo_fleet_dispatch_total",
                        "Requests dispatched to a replica by the router",
                        labels=("replica",))
_REQUEUED = _tm.counter(
    "zoo_fleet_requeued_requests_total",
    "Requests claim-transferred back to the dispatch stream from a dead "
    "replica (XTRANSFER moves; each implies a redelivery)")
_FLEET_RESPAWNS = _tm.counter("zoo_fleet_respawns_total",
                              "Dead replicas respawned by the supervisor")
_FAILOVER = _tm.histogram(
    "zoo_fleet_failover_seconds",
    "Death detection -> claimed work requeued + respawn initiated",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
_NO_REPLICA = _tm.counter(
    "zoo_fleet_route_stalls_total",
    "Router iterations that held traffic because no replica was eligible")
_ROUTER_SHED = _tm.counter(
    "zoo_fleet_shed_total",
    "Requests the router shed (answered + acked, never dispatched) because "
    "their deadline provably cannot be met, by overload class",
    labels=("reason",))
# per-class SLO evidence, registered once in serving/slo_metrics.py
_REQ_OUTCOMES = _slo_metrics.REQUEST_OUTCOMES
_AUTOSCALE = _tm.counter(
    "zoo_autoscale_events_total",
    "Autoscaler scale events, by direction (up = capacity spawned on "
    "sustained queue pressure, down = capacity drained away when idle) and "
    "scope (replica = single-machine fleet, host = cross-host placement — "
    "up borrows an idle host, down retires a whole host to idle)",
    labels=("direction", "scope"))
_HOST_SKEW = _tm.gauge(
    "zoo_fleet_host_clock_skew_seconds",
    "Per-host wall-clock offset vs the supervisor, estimated NTP-style from "
    "heartbeat round trips (positive = host clock ahead); feeds the QoS "
    "deadline skew tolerance", labels=("host",))
_HOST_FAILOVERS = _tm.counter(
    "zoo_fleet_host_failovers_total",
    "Whole-host failovers: a host heartbeat expired and every replica on it "
    "was evicted, requeued, and respawned on surviving hosts in one decision")
_HOSTS = _tm.gauge(
    "zoo_fleet_hosts",
    "Registered fleet hosts, by liveness state", labels=("state",))

# scrape-time gauges walk the live routers (weakset, the resilience.py
# pattern): eligible-replica count + per-replica queue depth — the numbers
# the least_pending policy itself routes on
_LIVE_ROUTERS: "weakref.WeakSet[ReplicaRouter]" = weakref.WeakSet()


def _collect_eligible():
    out = {}
    for r in list(_LIVE_ROUTERS):
        out[(r.name,)] = float(len(r.eligible_ids()))
    return out.items()


def _collect_depths():
    out = {}
    for r in list(_LIVE_ROUTERS):
        for rid, depth in r.depths().items():
            out[(rid,)] = float(depth)
    return out.items()


_tm.collector("zoo_fleet_eligible_replicas",
              "Replicas currently eligible for dispatch (heartbeat fresh, "
              "state up, breaker not open)", _collect_eligible,
              labels=("router",))
_tm.collector("zoo_fleet_queue_depth",
              "Per-replica pending work (dispatch-stream depth + reported "
              "in-flight) — the least_pending routing signal",
              _collect_depths, labels=("replica",))


class _ReplicaSlot:
    """Router-side view of one replica: breaker, liveness fed by the
    supervisor's heartbeat polls, dispatch/depth accounting, and the
    outstanding half-open probe (if any)."""

    def __init__(self, rid: str, config: ServingConfig):
        self.rid = rid
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_failure_threshold,
            reset_timeout_s=config.breaker_reset_timeout_s,
            name=f"fleet-replica-{rid}")
        self.alive = True           # hb freshness (supervisor-fed)
        self.state = "up"           # replica lifecycle state from the hb
        self.served = 0             # replica's cumulative served counter
        self.dispatched = 0
        self.depth = 0              # stream LEN + reported in-flight
        self.reported_inflight = 0  # engine-internal queue depth from the hb
        # (served_at_dispatch, t_dispatch) while a half-open probe request
        # is outstanding; progress on `served` closes the breaker
        self.probe: Optional[Tuple[int, float]] = None
        # hot-swap telemetry folded from the heartbeat (serving/hotswap.py):
        # the rollout controller validates the canary on these
        self.last_seen = time.monotonic()   # last alive=True liveness feed
        self.model_version: Optional[str] = None
        self.swap_state: Optional[str] = None
        self.swap_error: Optional[str] = None
        self.swap_nonce: Any = None   # nonce of the replica's LAST swap
                                      # command — scopes swap_error to it
        self.errors = 0             # cumulative error-result counter
        self.lat_ms = 0.0           # receipt->computed latency EMA
        self.svc_ms = 0.0           # per-record COMPUTE time EMA (no queue
                                    # wait) — the deadline-shed evidence
        # canary traffic weight: 1.0 = full member of the rotation; a
        # fraction f < 1 admits this replica on ~every (1/f)th pick only
        self.weight = 1.0
        self.host: Optional[str] = None   # placement (cross-host fleets)


class ReplicaRouter:
    """Broker-level dispatch tier over N engine replicas.

    Consumes ``stream`` under consumer group ``group`` and forwards each
    entry to ``prefix + <chosen replica>``; the origin entry is XACKed only
    after the forward landed, so a router crash redelivers (at-least-once,
    deduped on uri by the replica sinks). Standalone use (e.g. routing the
    generation stream over :class:`~.generation.GenerationEngine` replicas)
    needs only ``replica_ids``; under a :class:`FleetSupervisor` the
    supervisor feeds liveness into :meth:`set_liveness`/:meth:`evict`.
    """

    def __init__(self, config: Optional[ServingConfig] = None,
                 replica_ids: Tuple[str, ...] = (), *,
                 stream: str = INPUT_STREAM,
                 prefix: str = REPLICA_STREAM_PREFIX,
                 group: str = ROUTER_GROUP,
                 policy: Optional[str] = None,
                 registry: Optional[HealthRegistry] = None,
                 name: str = "fleet", group_fmt: str = "fleet-{rid}"):
        self.config = config or ServingConfig()
        self.stream, self.prefix, self.group = stream, prefix, group
        # each replica's consumer-group name (the depth probe counts work
        # OWED to that group: undelivered + claimed-but-unacked)
        self.group_fmt = group_fmt
        self.policy = policy or self.config.fleet_policy
        if self.policy not in ("least_pending", "round_robin"):
            raise ValueError(f"unknown routing policy {self.policy!r}")
        self.registry = registry
        self.name = name
        # zoo-lock: guards(_slots, _rr_next, _pick_seq, _host_breakers)
        self._lock = traced_lock("ReplicaRouter._lock")
        self._slots: "collections.OrderedDict[str, _ReplicaSlot]" = \
            collections.OrderedDict()
        # per-host circuit breakers (supervisor-fed, shared objects): an
        # OPEN host breaker removes every replica placed there from
        # eligibility in one stroke — dials to a dead host fail fast
        self._host_breakers: Dict[str, CircuitBreaker] = {}
        # fleet-wide deadline slack for cross-host clock skew (supervisor-
        # fed: configured floor + worst measured per-host offset). Plain
        # float, single writer — a stale read for one poll interval only
        # shifts the shed boundary by that poll's skew delta
        self.skew_s = 0.0
        for rid in replica_ids:
            self.add_replica(rid)
        self._rr_next = 0
        self._pick_seq = 0          # canary-weight admission counter
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._depths_refreshed = 0.0
        self.routed = 0
        self.shed = 0           # monotonic: deadline sheds at this tier —
                                # with queue depth, the autoscaler's
                                # pressure signal
        _LIVE_ROUTERS.add(self)

    # -- membership / liveness (supervisor-fed) ------------------------------

    def add_replica(self, rid: str) -> None:
        with self._lock:
            if rid not in self._slots:
                self._slots[rid] = _ReplicaSlot(rid, self.config)

    def remove_replica(self, rid: str) -> None:
        with self._lock:
            self._slots.pop(rid, None)

    def set_replica_host(self, rid: str, hid: Optional[str]) -> None:
        """Record a replica's host placement (cross-host fleets): host-spread
        tie-breaking in ``least_pending`` and host-breaker gating key on it."""
        with self._lock:
            slot = self._slots.get(rid)
            if slot is not None:
                slot.host = hid

    def set_host_breaker(self, hid: str,
                         breaker: Optional[CircuitBreaker]) -> None:
        """Share a host's breaker with the router (``None`` removes it). The
        SUPERVISOR owns host liveness and trips it; the router only reads
        state — a dial toward a dead host is refused at pick time instead of
        hanging a dispatch."""
        with self._lock:
            if breaker is None:
                self._host_breakers.pop(hid, None)
            else:
                self._host_breakers[hid] = breaker

    def _host_open_locked(self, slot: _ReplicaSlot) -> bool:
        """Caller holds the router lock. Reading the breaker takes its leaf
        lock — the declared ReplicaRouter._lock < CircuitBreaker._lock
        order."""
        if slot.host is None:
            return False
        b = self._host_breakers.get(slot.host)
        return b is not None and b.state == CircuitBreaker.OPEN

    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._slots)

    def slot(self, rid: str) -> Optional[_ReplicaSlot]:
        """Live slot handle (or None), looked up under the router lock —
        the accessor the rollout controller reads canary/cohort telemetry
        through (reaching into ``_slots`` unlocked would race membership
        churn from add/remove/failover)."""
        with self._lock:
            return self._slots.get(rid)

    def model_versions(self) -> Dict[str, Optional[str]]:
        """Per-replica active model version from the heartbeat-fed slots,
        snapshotted under the router lock."""
        with self._lock:
            return {rid: s.model_version
                    for rid, s in self._slots.items()}

    def evict(self, rid: str) -> None:
        """Force a replica out of the rotation NOW (death, operator action).
        The breaker trips open; readmission follows the normal half-open
        probe path once the replica heartbeats again."""
        with self._lock:
            slot = self._slots.get(rid)
            if slot is None:
                return
            slot.breaker.trip()
            slot.probe = None
        _ev.emit("fleet.evict", severity="warning", replica=rid,
                 router=self.name)
        logger.warning("fleet: evicted replica %s (breaker open)", rid)

    def set_liveness(self, rid: str, alive: bool, state: str = "up",
                     served: Optional[int] = None,
                     inflight: Optional[int] = None,
                     model_version: Optional[str] = None,
                     errors: Optional[int] = None,
                     lat_ms: Optional[float] = None,
                     svc_ms: Optional[float] = None,
                     swap_state: Optional[str] = None,
                     swap_error: Optional[str] = None,
                     swap_nonce: Any = None) -> None:
        """Heartbeat-poll feed from the supervisor. Also resolves half-open
        probes: a probe request counts as SUCCEEDED when the replica's
        cumulative ``served`` advanced past its at-dispatch value, and as
        FAILED when the replica went stale (or the probe aged out) — so a
        respawned replica re-earns traffic by actually serving, not merely
        by heartbeating."""
        readmitted = False
        with self._lock:
            slot = self._slots.get(rid)
            if slot is None:
                return
            slot.alive = alive
            slot.state = state
            if alive:
                slot.last_seen = time.monotonic()
            if served is not None:
                slot.served = served
            if inflight is not None:
                slot.reported_inflight = inflight
            if model_version is not None:
                slot.model_version = model_version
            if errors is not None:
                slot.errors = errors
            if lat_ms is not None:
                slot.lat_ms = lat_ms
            if svc_ms is not None:
                slot.svc_ms = svc_ms
            if swap_state is not None:
                slot.swap_state = swap_state
            slot.swap_error = swap_error
            if swap_nonce is not None:
                slot.swap_nonce = swap_nonce
            # probe resolution stays under the lock: _pick() reserves
            # slot.probe while holding it, and clearing the reservation here
            # without it could admit a second in-flight probe (the breaker's
            # own lock is leaf-level, so nesting it is deadlock-free)
            probe = slot.probe
            if probe is not None:
                served_at, t_probe = probe
                if alive and served is not None and served > served_at:
                    slot.breaker.record_success()
                    slot.probe = None
                    readmitted = True
                elif not alive or (time.monotonic() - t_probe
                                   > 2 * self.config.fleet_failover_timeout_s):
                    slot.breaker.record_failure()
                    slot.probe = None
        if readmitted:
            logger.info("fleet: replica %s probe served; readmitted", rid)

    def eligible_ids(self) -> List[str]:
        """Replicas a dispatch could go to right now (hb fresh, lifecycle
        ``up``, neither the replica's nor its host's breaker open; half-open
        counts — the probe admission happens per-dispatch via ``allow()``)."""
        with self._lock:
            slots = list(self._slots.values())
            host_open = {s.rid: self._host_open_locked(s) for s in slots}
        return [s.rid for s in slots
                if s.alive and s.state == "up"
                and s.breaker.state != CircuitBreaker.OPEN
                and s.probe is None and not host_open[s.rid]]

    def set_traffic_fraction(self, rid: str, fraction: float) -> None:
        """Canary traffic weighting (the rollout-policy hook): route roughly
        ``fraction`` of dispatch decisions to ``rid``, the rest to the full-
        weight members. Deterministic (every k-th pick admits the canary, k
        = round(1/fraction)) — no RNG in the dispatch path. ``1.0`` restores
        full membership."""
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction!r}")
        with self._lock:
            slot = self._slots.get(rid)
            if slot is not None:
                slot.weight = float(fraction)

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {rid: s.depth for rid, s in self._slots.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            slots = list(self._slots.values())
        return {"routed": self.routed, "shed": self.shed,
                "policy": self.policy, "skew_s": self.skew_s,
                "replicas": {
                    s.rid: {"dispatched": s.dispatched, "depth": s.depth,
                            "alive": s.alive, "state": s.state,
                            "served": s.served, "errors": s.errors,
                            "model_version": s.model_version,
                            "swap_state": s.swap_state,
                            "weight": s.weight, "lat_ms": s.lat_ms,
                            "svc_ms": s.svc_ms, "host": s.host,
                            "breaker": s.breaker.state} for s in slots}}

    # -- routing -------------------------------------------------------------

    def _connect(self, tag: str) -> _Conn:
        policy = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                             max_delay_s=0.5, attempt_timeout_s=5.0,
                             retryable=(ConnectionError, OSError))
        return _Conn(self.config.queue_host, self.config.queue_port,
                     policy=policy, abort=self._stop.is_set, tag=tag)

    def _refresh_depths(self, conn: _Conn) -> None:
        """Per-replica queue depth = everything the replica still owes on
        its dispatch stream: undelivered entries PLUS claimed-but-unacked
        ones (group-aware broker LEN — an engine buffers claimed batches
        internally, so the live stream length alone understates load).
        Refreshed at most every 50ms; incremented locally per dispatch in
        between."""
        now = time.monotonic()
        if now - self._depths_refreshed < 0.05:
            return
        self._depths_refreshed = now
        for rid in self.replica_ids():
            try:
                depth = int(conn.call("LEN", self.prefix + rid,
                                      self.group_fmt.format(rid=rid)))
            except RetryAbortedError:
                raise
            except Exception:
                continue
            with self._lock:
                slot = self._slots.get(rid)
                if slot is not None:
                    slot.depth = depth

    def _pick(self) -> Optional[str]:
        """Choose an eligible replica per the policy; reserves a half-open
        probe slot via ``breaker.allow()`` (so at most one in-flight probe
        per recovering replica). Weighted (canary) replicas are admitted as
        candidates only on every ``round(1/weight)``-th pick."""
        with self._lock:
            slots = [s for s in self._slots.values()
                     if s.alive and s.state == "up"
                     and not self._host_open_locked(s)]
            if not slots:
                return None
            self._pick_seq += 1
            if any(s.weight < 1.0 for s in slots):
                admitted = [
                    s for s in slots
                    if s.weight >= 1.0
                    or self._pick_seq % max(1, round(1.0 / s.weight)) == 0]
                # a rotation of only weighted members must not stall traffic
                slots = admitted or slots
            if self.policy == "least_pending":
                # host-spread tie-break: equal-depth replicas go to the host
                # with the least TOTAL pending work first, so cross-host
                # placement stays balanced even when every replica is idle
                hload: Dict[str, int] = {}
                for s in slots:
                    key = s.host or s.rid
                    hload[key] = hload.get(key, 0) + s.depth
                order = sorted(slots,
                               key=lambda s: (s.depth,
                                              hload[s.host or s.rid]))
            else:                       # round_robin over the stable roster
                n = len(slots)
                start = self._rr_next % n
                order = slots[start:] + slots[:start]
                self._rr_next += 1
            for slot in order:
                if slot.breaker.allow():
                    # the half-open check must come AFTER the admission:
                    # allow() itself transitions OPEN -> HALF_OPEN once the
                    # reset timeout elapses, and a consumed probe slot that
                    # never lands on slot.probe would wedge the breaker
                    # half-open forever (set_liveness only resolves recorded
                    # probes). Post-admission HALF_OPEN implies exactly that
                    # a probe was reserved; CLOSED admissions need none.
                    if slot.breaker.state == CircuitBreaker.HALF_OPEN:
                        slot.probe = (slot.served, time.monotonic())
                    return slot.rid
        return None

    def _wait_estimate(self) -> Tuple[float, float, int, int]:
        """(best-replica est wait s, per-record service estimate s,
        total owed, eligible count) from the heartbeat-fed slots. The
        service estimate is the per-RECORD compute-time EMA the engines
        publish (``svc_ms``) — deliberately NOT the receipt→computed
        latency, which includes replica-side queue wait and would double-
        count it against the depth (over-shedding healthy traffic)."""
        with self._lock:
            live = [s for s in self._slots.values()
                    if s.alive and s.state == "up"
                    and s.breaker.state != CircuitBreaker.OPEN
                    and not self._host_open_locked(s)]
            depths = [s.depth for s in live]
            svcs = [s.svc_ms for s in live if s.svc_ms > 0]
        if not live:
            return 0.0, 0.0, 0, 0
        svc = (min(svcs) / 1e3) if svcs else 0.0
        return min(depths) * svc, svc, sum(depths), len(live)

    @staticmethod
    def _hold_key(item) -> Tuple:
        """(priority, deadline, arrival) ordering for held entries — the
        entry id's monotonic sequence keeps FIFO fairness inside a class."""
        entry_id, payload = item
        try:
            seq = int(str(entry_id).split("-")[0])
        except (TypeError, ValueError):
            seq = 0
        return _qos.order_key(payload_priority(payload),
                              payload_deadline(payload), seq)

    def _maybe_shed(self, conn: _Conn, payload: Any) -> bool:
        """Shed one held entry whose deadline provably cannot be met —
        BEFORE spending a dispatch on it. The shed answer (first-write-wins,
        like any replica result) carries the computed Retry-After so the
        waiting client backs off proportionally to real drain time."""
        dl = payload_deadline(payload)
        if dl is None:
            return False
        est, svc, total, eligible = self._wait_estimate()
        rec = _flight.get()
        # skew_s loosens the verdict by the fleet's measured cross-host
        # clock uncertainty: the deadline was stamped on the CLIENT's clock.
        # With no recorder installed the admit case (the per-wave hot path —
        # each held entry is re-judged every claim wave) answers on the bare
        # predicate; the shed path and any recorded decision go through the
        # full pure function, so live and replay semantics stay identical
        # (cannot_meet is monotone in `now`: an admit here is an admit there)
        if rec is None and not _qos.cannot_meet(
                dl, est, svc, skew_tolerance_s=self.skew_s):
            return False
        pri = payload_priority(payload)
        inputs = {"now": time.time(), "deadline": dl, "est_wait_s": est,
                  "service_ema_s": svc, "skew_tolerance_s": self.skew_s,
                  "depth": total, "concurrency": max(1, eligible),
                  "eligible": eligible, "priority": pri}
        decision = _qos.admission_decision(inputs)
        if rec is not None:
            # admits are recorded too: a candidate policy replayed offline
            # may shed what the incumbent admitted — the diff needs both
            rec.record("admission.router", inputs, decision)
        if decision["action"] != "shed":
            return False
        chaos_point("overload.shed", tag="router")
        uri = payload.get("uri") if isinstance(payload, dict) else None
        if uri:
            conn.call("HSETNX", RESULT_PREFIX + uri, _qos.shed_payload(
                "deadline cannot be met at the routing tier "
                f"(est wait {est + svc:.3f}s)",
                decision["retry_after_s"], reason="deadline"))
        self.shed += 1
        _ROUTER_SHED.labels(reason="deadline").inc()
        _REQ_OUTCOMES.labels(priority=pri, outcome="shed").inc()
        # audit-rate, not request-rate: under sustained overload this fires
        # per request, so repeats within the window fold into `suppressed`
        _ev.emit("shed.router", severity="warning", throttle_s=1.0,
                 reason="deadline", priority=pri,
                 est_wait_s=decision["est_wait_s"], eligible=eligible)
        return True

    def _note_dispatched(self, rid: str) -> None:
        with self._lock:
            slot = self._slots.get(rid)
            if slot is not None:
                slot.dispatched += 1
                slot.depth += 1
        self.routed += 1
        _DISPATCH.labels(replica=rid).inc()

    def _route_loop(self):
        conn = self._connect("fleet.router")
        hb = (self.registry.register("fleet.router")
              if self.registry is not None else None)
        hold: "collections.deque" = collections.deque()
        try:
            while not self._stop.is_set():
                if hb is not None:
                    hb.beat()
                if not hold:
                    if self._draining.is_set():
                        break           # drained: nothing held, stop claiming
                    try:
                        entries = conn.call("XREADGROUP", self.stream,
                                            self.group, 64, 100)
                    except RetryAbortedError:
                        break
                    if entries:
                        hold.extend(entries)
                        # (priority, deadline) ordering: eligible work is
                        # dispatched critical-first, earliest-deadline-first
                        # within a class, FIFO within ties — stable across
                        # re-sorts because the entry id is the tiebreak
                        hold = collections.deque(
                            sorted(hold, key=self._hold_key))
                    if not hold:
                        continue
                try:
                    self._refresh_depths(conn)
                    done: List[str] = []
                    stalled = False
                    while hold:
                        entry_id, payload = hold[0]
                        if self._maybe_shed(conn, payload):
                            # answered with a shed record: ack the origin
                            # entry, never dispatch it
                            hold.popleft()
                            done.append(entry_id)
                            continue
                        rid = self._pick()
                        if rid is None:
                            stalled = True
                            break
                        # deterministic fault site: a "fail" rule drops this
                        # routing decision (entry retried next iteration —
                        # at-least-once), a "delay" rule models a slow router
                        chaos_point("fleet.route", tag=rid)
                        conn.call("XADD", self.prefix + rid, payload)
                        self._note_dispatched(rid)
                        hold.popleft()
                        done.append(entry_id)
                    if done:
                        conn.call("XACK", self.stream, self.group, done)
                    if stalled:
                        _NO_REPLICA.inc()
                        self._stop.wait(0.02)
                except RetryAbortedError:
                    break
                except Exception:
                    # injected routing fault / transient broker hiccup: the
                    # un-forwarded entries stay in `hold` (and pending
                    # broker-side under the router group) — retry, never drop
                    logger.exception("fleet: routing iteration failed; "
                                     "holding %d entries", len(hold))
                    self._stop.wait(0.02)
        finally:
            if hb is not None:
                hb.stop()
            conn.close()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaRouter":
        self._stop.clear()
        self._draining.clear()
        conn = self._connect("fleet.router-init")
        try:
            conn.call("XGROUPCREATE", self.stream, self.group, "$")
        except RetryAbortedError:
            pass
        finally:
            conn.close()
        self._thread = threading.Thread(target=self._route_loop, daemon=True,
                                        name="zoo-fleet-router")
        self._thread.start()
        return self

    def stop(self, drain_s: float = 2.0):
        """Drain-then-stop: forward everything already claimed, then exit.
        Unclaimed stream entries stay on the broker (redelivered to the next
        router incarnation)."""
        self._draining.set()
        if self._thread is not None:
            self._thread.join(timeout=drain_s)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class _ReplicaHandle:
    """Supervisor-side handle on one replica incarnation."""

    def __init__(self, rid: str, mode: str):
        self.rid = rid
        self.mode = mode                    # "thread" | "process" | "host"
        self.engine: Optional[ClusterServing] = None
        self.proc: Optional[subprocess.Popen] = None
        self.host: Optional[str] = None     # placement (host mode)
        self.spawned_at = time.monotonic()
        self.drain_requested = False
        self.restarting = False             # deliberate restart in progress:
                                            # the monitor must not failover
        self.generation = 0                 # incarnation count (respawns)

    def kill(self):
        """Hard-stop this incarnation (no drain, no acks)."""
        if self.engine is not None:
            self.engine.kill()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def stop(self, drain_s: float = 2.0):
        if self.engine is not None:
            self.engine.stop(drain_s)
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=max(drain_s, 5.0))
            except subprocess.TimeoutExpired:
                self.proc.kill()


class _HostSlot:
    """Supervisor-side view of one host failure domain: the desired replica
    placement, the host breaker (dials fail fast while it is open), the
    measured clock offset, and the locally-managed stand-in agent (if any).
    Single-writer: mutated only by the monitor thread + lifecycle calls,
    like ``_handles``."""

    def __init__(self, hid: str, config: ServingConfig):
        self.hid = hid
        self.capacity = max(1, getattr(config, "fleet_host_capacity", 4))
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_failure_threshold,
            reset_timeout_s=config.breaker_reset_timeout_s,
            name=f"fleet-host-{hid}")
        self.replicas: set = set()      # desired placement (rids)
        self.reported: set = set()      # rids the agent reports running
        self.alive = False
        self.hb_seen = False            # first fresh heartbeat observed?
        self.state = "up"
        self.identity: Optional[str] = None
        self.last_hb_wall = 0.0         # supervisor clock at last fresh hb
        # NTP-style offset estimate (host clock - supervisor clock) from the
        # ping/pong riding the ctl/hb hashes; EMA over round trips
        self.clock_offset_s = 0.0
        self.skew_samples = 0
        self.last_pong_t0: Any = None   # dedupe: one sample per echo
        self.ctl_nonce = 0
        self.retiring = False           # scale-down drain owns this host
        self.proc: Optional[subprocess.Popen] = None   # stand-in subprocess
        self.agent: Optional[HostAgent] = None         # in-process stand-in


class FleetSupervisor:
    """Heartbeat-monitors N replicas, requeues a dead replica's claimed
    work, respawns it, and supports graceful drain / rolling restart.

    ``spawn="thread"`` builds each replica as a :class:`ClusterServing` in
    this process (``model_factory()`` per replica, or ``None`` to load from
    ``config.model_path``); ``spawn="process"`` launches
    ``python -m analytics_zoo_tpu_torch.serving.fleet --replica <rid>
    --device <device> ...`` — real process isolation, requires
    ``config.model_path`` (or ``demo=True``). ``device``: where replicas
    serve (CUDA when ``None``; a thread replica then raises without it).

    ``spawn="host"`` (implied by ``config.fleet_hosts > 0``) places replicas
    on :class:`~.hostagent.HostAgent` failure domains instead of spawning
    them directly: the supervisor writes desired state into each host's
    ``fleet:hostctl:<hid>`` hash and the agents reconcile. With
    ``manage_agents=True`` the supervisor also launches the agents — as
    local stand-in subprocesses (each under a synthetic host identity, so
    their connections negotiate shm like genuinely remote peers and settle
    on TCP), or in-process when a live ``model_factory`` is supplied (tests:
    ``agent.kill()`` is the whole-host death). Real deployments run
    ``python -m analytics_zoo_tpu_torch.serving.hostagent`` per machine and
    pass
    ``manage_agents=False``.
    """

    def __init__(self, config: ServingConfig, *,
                 model_factory: Optional[Callable[[], Any]] = None,
                 replica_ids: Optional[List[str]] = None,
                 spawn: Optional[str] = None,
                 router: Optional[ReplicaRouter] = None,
                 registry: Optional[HealthRegistry] = None,
                 demo: bool = False, config_path: Optional[str] = None,
                 device: Optional[str] = None,
                 host_ids: Optional[List[str]] = None,
                 manage_agents: bool = True):
        self.config = config
        self.spawn = spawn or (
            "host" if getattr(config, "fleet_hosts", 0) > 0
            else config.fleet_spawn)
        if self.spawn not in ("thread", "process", "host"):
            raise ValueError(f"unknown spawn mode {self.spawn!r}")
        self.model_factory = model_factory
        self.demo = demo
        # process-mode replicas re-read the operator's YAML themselves: a
        # live ServingConfig object can't cross the fork, and spawning with
        # defaults would silently drop batch/int8/heartbeat tuning
        self.config_path = config_path
        self.device = device
        n0 = max(1, config.replicas)
        if getattr(config, "autoscale", False):
            # start inside the autoscaler's band: at least min_replicas, at
            # most max_replicas — the loop adjusts from there
            n0 = min(max(n0, max(1, config.min_replicas)),
                     max(1, config.max_replicas))
        ids = list(replica_ids) if replica_ids else \
            [f"r{i}" for i in range(n0)]
        self.router = router or ReplicaRouter(config, tuple(ids))
        # the fleet registry holds one component per replica; death/revival
        # TRANSITIONS drive eviction + requeue + respawn via the listener
        # hook (common/resilience.py) — /readyz and tests read it too
        self.registry = registry or HealthRegistry(
            default_timeout_s=config.fleet_failover_timeout_s, name="fleet")
        self.registry.add_transition_listener(self._on_transition)
        # single-writer state: _handles/_hb_seen are mutated only by the
        # monitor thread + lifecycle calls; the shared telemetry the router
        # needs lives on ITS slots (under ITS lock), so no supervisor lock
        self._handles: Dict[str, _ReplicaHandle] = {}
        self._hb_seen: Dict[str, bool] = {}      # first fresh hb observed?
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._conn: Optional[_Conn] = None
        self._rolling_seen: Any = None
        self._rolling_busy = False
        self.requeued = 0
        self.respawns = 0
        self.failovers: List[float] = []
        # host failure domains (spawn="host"): desired placement + liveness
        # per host; single-writer on the monitor thread like _handles
        self._host_mode = self.spawn == "host"
        self._hosts: Dict[str, _HostSlot] = {}
        self.manage_agents = manage_agents
        self.host_failovers = 0
        if self._host_mode:
            n_hosts = max(1, getattr(config, "fleet_hosts", 0) or 2)
            hids = list(host_ids) if host_ids else \
                [f"h{i}" for i in range(n_hosts)]
            for hid in hids:
                self._hosts[hid] = _HostSlot(hid, config)
        # queue-driven autoscaling (ROADMAP "adaptive serving under
        # overload"): the monitor loop watches owed work per eligible
        # replica (the zoo_fleet_queue_depth signal) plus the router's
        # deadline-shed rate, spawns replicas on sustained pressure up to
        # max_replicas, and drains them away (graceful drain + straggler
        # XTRANSFER — zero-loss by construction) when idle down to
        # min_replicas
        self.autoscale_enabled = bool(getattr(config, "autoscale", False))
        # debounce memory owned by the PURE decision function
        # (qos.autoscale_decision) — the flight recorder snapshots it into
        # every autoscale.tick record, which is what makes the recorded
        # decision stream exactly replayable offline
        self._as_state: Dict[str, Any] = {"pressure_since": None,
                                          "idle_since": None,
                                          "last_event_t": 0.0}
        self._as_last_routed = 0
        self._as_last_shed = 0
        self._as_busy = False          # a scale-down drain is in flight
        self.scale_events: List[Tuple[str, int]] = []
        # canary rollout controller (serving/hotswap.py): consumes the
        # trainer's publish stream and drives per-replica swap commands
        self.rollout = None
        if getattr(config, "hot_swap", True):
            from .hotswap import RolloutController

            self.rollout = RolloutController(self, config)

    # -- lifecycle -----------------------------------------------------------

    def _connect(self, tag: str) -> _Conn:
        policy = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                             max_delay_s=0.5, attempt_timeout_s=5.0,
                             retryable=(ConnectionError, OSError))
        return _Conn(self.config.queue_host, self.config.queue_port,
                     policy=policy, abort=self._stop.is_set, tag=tag)

    def start(self) -> "FleetSupervisor":
        self._stop.clear()
        self._conn = self._connect("fleet.supervisor")
        try:
            # roster published for operators (`cli fleet-status`/frontends)
            self._conn.call("HSET", MEMBERS_KEY,
                            {"replicas": self.router.replica_ids(),
                             "spawn": self.spawn,
                             "hosts": sorted(self._hosts)})
            # a rolling-restart nonce left by a PREVIOUS stack incarnation
            # (the hash is never deleted and survives AOF replay) is an
            # already-executed command, not an order for this one: snapshot
            # it so only nonces written from now on trigger
            prior = self._conn.call("HGET", ROLLING_KEY, 0)
            if isinstance(prior, dict):
                self._rolling_seen = prior.get("nonce")
        except RetryAbortedError:
            pass
        self.router.start()
        for hid, slot in self._hosts.items():
            self.router.set_host_breaker(hid, slot.breaker)
            # host liveness budget: spawn grace until the first heartbeat
            # (the agent may still be importing/compiling), failover timeout
            # after
            self.registry.register(f"host.{hid}",
                                   timeout_s=self.config.fleet_spawn_grace_s)
            if self.manage_agents:
                self._start_agent(hid)
        for rid in self.router.replica_ids():
            self._spawn_replica(rid)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="zoo-fleet-supervisor")
        self._monitor.start()
        if self.rollout is not None:
            self.rollout.start()
        return self

    def _replica_config(self) -> ServingConfig:
        import dataclasses

        return dataclasses.replace(self.config)

    def _start_agent(self, hid: str) -> None:
        """Launch the stand-in agent for one host: in-process (a live
        ``model_factory`` can't cross a fork) or as a subprocess under a
        synthetic host identity — its engines then negotiate shm like
        genuinely remote peers (denied → TCP with retry-backed reconnect)."""
        slot = self._hosts[hid]
        if self.model_factory is not None and not self.demo:
            slot.agent = HostAgent(hid, self._replica_config(),
                                   model_factory=self.model_factory,
                                   capacity=slot.capacity,
                                   device=self.device)
            slot.agent.start()
            return
        cmd = [sys.executable, "-m",
               "analytics_zoo_tpu_torch.serving.hostagent",
               "--hid", hid,
               "--broker-host", self.config.queue_host,
               "--broker-port", str(self.config.queue_port),
               "--capacity", str(slot.capacity),
               "--device", str(self.device or "cuda")]
        if self.config_path:
            cmd += ["--config", self.config_path]
        if self.demo:
            cmd.append("--demo")
        elif self.config.model_path:
            cmd += ["--model", self.config.model_path]
        elif not self.config_path:
            raise ValueError("host-mode agents need model_path, config_path, "
                             "demo=True, or an in-process model_factory")
        env = dict(os.environ)
        env["ZOO_HOST_IDENTITY"] = f"{host_identity()}/{hid}"
        slot.proc = subprocess.Popen(cmd, env=env)

    def _place_host(self, exclude: Tuple[str, ...] = ()) -> Optional[str]:
        """Spread placement: the emptiest host with free capacity wins, live
        hosts before not-yet-heartbeating ones, never one whose breaker is
        open. "Emptiest first" IS the borrow-a-machine policy — an idle
        registered host attracts the next replica before any occupied host
        gets packed further."""
        cands = [s for s in self._hosts.values()
                 if s.hid not in exclude and not s.retiring
                 and s.breaker.state != CircuitBreaker.OPEN
                 and len(s.replicas) < s.capacity]
        if not cands:
            return None
        cands.sort(key=lambda s: (not s.alive, len(s.replicas), s.hid))
        return cands[0].hid

    def _push_host_ctl(self, hid: str, shutdown: bool = False) -> None:
        """Publish one host's desired state (declarative: the agent
        reconciles; re-sends converge idempotently). The piggybacked
        ``ping_t0`` is the skew-estimation round trip's first leg."""
        slot = self._hosts.get(hid)
        if slot is None:
            return
        slot.ctl_nonce += 1
        mapping: Dict[str, Any] = {
            "replicas": {rid: self._handles[rid].generation
                         for rid in sorted(slot.replicas)
                         if rid in self._handles},
            "nonce": slot.ctl_nonce, "ping_t0": time.time()}
        if shutdown:
            mapping["shutdown"] = True
        try:
            self._conn.call("HSET", HOST_CTL_PREFIX + hid, mapping)
        except RetryAbortedError:
            raise
        except Exception:
            logger.exception("fleet: host ctl push for %s failed", hid)

    def _assign_replica(self, rid: str, hid: str) -> None:
        """Place one replica on a host: desired-state bookkeeping here, the
        actual engine spawn happens agent-side on the next reconcile."""
        handle = self._handles.get(rid)
        generation = handle.generation + 1 if handle is not None else 1
        handle = _ReplicaHandle(rid, "host")
        handle.generation = generation
        handle.host = hid
        try:
            self._conn.call("HDEL", FLEET_HB_PREFIX + rid)
            self._conn.call("HDEL", FLEET_CTL_PREFIX + rid)
        except RetryAbortedError:
            pass
        for s in self._hosts.values():
            s.replicas.discard(rid)
        self._hosts[hid].replicas.add(rid)
        self._handles[rid] = handle
        self._hb_seen[rid] = False
        self.registry.register(f"replica.{rid}",
                               timeout_s=self.config.fleet_spawn_grace_s)
        self.router.add_replica(rid)
        self.router.set_replica_host(rid, hid)
        self._push_host_ctl(hid)

    def _spawn_replica(self, rid: str) -> None:
        if self._host_mode:
            target = self._place_host()
            if target is None:
                raise RuntimeError(f"fleet: no host with free capacity for "
                                   f"replica {rid}")
            self._assign_replica(rid, target)
            return
        handle = self._handles.get(rid)
        generation = handle.generation + 1 if handle is not None else 1
        handle = _ReplicaHandle(rid, self.spawn)
        handle.generation = generation
        # stale state from the previous incarnation must not leak in: a dead
        # replica's old hb would otherwise look "fresh enough" right after
        # respawn, and an old drain command would insta-drain the new one
        try:
            self._conn.call("HDEL", FLEET_HB_PREFIX + rid)
            self._conn.call("HDEL", FLEET_CTL_PREFIX + rid)
        except RetryAbortedError:
            pass
        if self.spawn == "thread":
            model = self.model_factory() if self.model_factory else None
            handle.engine = ClusterServing(
                model, config=self._replica_config(), group=f"fleet-{rid}",
                stream=self.router.prefix + rid, replica_id=rid,
                device=self.device)
            handle.engine.start()
        else:
            cmd = [sys.executable, "-m",
                   "analytics_zoo_tpu_torch.serving.fleet",
                   "--replica", rid,
                   "--broker-host", self.config.queue_host,
                   "--broker-port", str(self.config.queue_port),
                   "--device", str(self.device or "cuda")]
            if self.config_path:
                cmd += ["--config", self.config_path]
            if self.demo:
                cmd.append("--demo")
            elif self.config.model_path:
                cmd += ["--model", self.config.model_path]
            elif not self.config_path:
                raise ValueError("process-mode replicas need model_path, "
                                 "config_path, or demo=True")
            handle.proc = subprocess.Popen(cmd)
        self._handles[rid] = handle
        self._hb_seen[rid] = False
        # liveness budget: normal failover timeout once beating; until the
        # first heartbeat the replica may still be loading/compiling, so it
        # gets the spawn grace instead
        self.registry.register(f"replica.{rid}",
                               timeout_s=self.config.fleet_spawn_grace_s)
        self.router.add_replica(rid)

    # -- monitoring ----------------------------------------------------------

    def _monitor_loop(self):
        interval = max(0.05, min(self.config.fleet_heartbeat_s, 0.2))
        while not self._stop.is_set():
            try:
                self._poll_once()
            except RetryAbortedError:
                break
            except Exception:
                logger.exception("fleet: supervisor poll failed")
            self._stop.wait(interval)

    def _poll_hosts(self, now: float) -> None:
        """Host-tier liveness + clock-skew pass. Runs BEFORE the replica
        pass so a whole-host death is recognized as ONE decision (the
        replica pass then skips that host's replicas instead of issuing N
        independent failovers)."""
        for hid, slot in self._hosts.items():
            # re-publishing desired state is idempotent agent-side and
            # refreshes ping_t0 — each round trip is one skew sample
            self._push_host_ctl(hid)
            hb = self._conn.call("HGET", HOST_HB_PREFIX + hid, 0)
            proc_dead = (slot.proc is not None
                         and slot.proc.poll() is not None)
            fresh = False
            if isinstance(hb, dict):
                slot.identity = hb.get("identity") or slot.identity
                slot.reported = set(hb.get("replicas") or ())
                slot.state = str(hb.get("state", "up"))
                pong_t0 = hb.get("pong_t0")
                pong_host_t = hb.get("pong_host_t")
                if (pong_t0 is not None and pong_host_t is not None
                        and pong_t0 != slot.last_pong_t0):
                    # one sample per DISTINCT echo: re-reading a frozen
                    # heartbeat (dead host) must not keep feeding the EMA
                    # with an ever-staler round trip
                    slot.last_pong_t0 = pong_t0
                    # NTP-style offset from the hb round trip: the agent saw
                    # our ping_t0 and stamped its own clock at the echo;
                    # midpoint of [t0, now] is our best guess at when.
                    t2 = time.time()
                    rtt = t2 - float(pong_t0)
                    if 0.0 <= rtt < 5.0:
                        off = float(pong_host_t) - (float(pong_t0) + t2) / 2.0
                        if slot.skew_samples == 0:
                            slot.clock_offset_s = off
                        else:
                            slot.clock_offset_s = (0.7 * slot.clock_offset_s
                                                   + 0.3 * off)
                        slot.skew_samples += 1
                        _HOST_SKEW.labels(host=hid).set(slot.clock_offset_s)
                # translate the host's clock into ours before judging
                # freshness — a skewed-but-healthy host must not look stale
                ts = float(hb.get("ts", 0.0)) - slot.clock_offset_s
                fresh = (now - ts < self.config.fleet_failover_timeout_s
                         and slot.state != "stopped")
            if fresh and not proc_dead:
                if not slot.hb_seen:
                    slot.hb_seen = True
                    self.registry.register(
                        f"host.{hid}",
                        timeout_s=self.config.fleet_failover_timeout_s)
                self.registry.beat(f"host.{hid}")
                if not slot.alive:
                    # dead -> alive edge: a fresh heartbeat is live proof of
                    # recovery — close the per-host breaker rather than
                    # waiting out its probe cycle
                    slot.alive = True
                    if slot.breaker.state != CircuitBreaker.CLOSED:
                        logger.info("fleet: host %s is back", hid)
                        slot.breaker.reset()
                slot.last_hb_wall = now
            elif proc_dead:
                self.registry.register(f"host.{hid}", timeout_s=0.0)
        alive = sum(1 for s in self._hosts.values() if s.alive)
        _HOSTS.labels(state="alive").set(alive)
        _HOSTS.labels(state="dead").set(len(self._hosts) - alive)
        # worst observed |offset| across live hosts widens the QoS deadline
        # tolerance: a request is only refused when it cannot be met even
        # after allowing for how far fleet clocks disagree
        worst = max((abs(s.clock_offset_s) for s in self._hosts.values()
                     if s.alive and s.skew_samples), default=0.0)
        self.router.skew_s = (self.config.fleet_host_skew_tolerance_s
                              + worst)

    def _poll_once(self):
        now = time.time()
        if self._host_mode:
            self._poll_hosts(now)
        for rid in list(self._handles):
            hb = self._conn.call("HGET", FLEET_HB_PREFIX + rid, 0)
            handle = self._handles.get(rid)
            if handle is None:
                continue
            # a process-mode replica that exited is dead regardless of the
            # staleness window — don't wait out the timeout
            proc_dead = (handle.proc is not None
                         and handle.proc.poll() is not None)
            fresh = (isinstance(hb, dict)
                     and now - float(hb.get("ts", 0))
                     < self.config.fleet_failover_timeout_s
                     and hb.get("state") != "stopped")
            if fresh and not proc_dead:
                if not self._hb_seen.get(rid):
                    # first beat: tighten the liveness budget from spawn
                    # grace down to the failover timeout. Host-placed
                    # replicas get 1.5x — if the whole host died, the host
                    # component (1.0x) must expire FIRST so the failover is
                    # one host-level decision, not N per-replica races; a
                    # lone engine crash inside a live host still trips this.
                    self._hb_seen[rid] = True
                    budget = self.config.fleet_failover_timeout_s
                    if self._host_mode:
                        budget *= 1.5
                    self.registry.register(f"replica.{rid}",
                                           timeout_s=budget)
                self.registry.beat(f"replica.{rid}")
                state = str(hb.get("state", "up"))
                if state in ("draining", "drained") and not handle.restarting:
                    # the drain may have been commanded out-of-band (`cli
                    # drain` writes the control hash directly): a replica
                    # that dies mid-drain must not be respawned regardless
                    # of which path asked for the drain
                    handle.drain_requested = True
                self.router.set_liveness(
                    rid, True, state=state,
                    served=int(hb.get("served", 0)),
                    inflight=int(hb.get("inflight", 0)),
                    model_version=hb.get("model_version"),
                    errors=int(hb.get("errors", 0)),
                    lat_ms=float(hb.get("lat_ms", 0.0)),
                    svc_ms=float(hb.get("svc_ms", 0.0)),
                    swap_state=hb.get("swap_state"),
                    swap_error=hb.get("swap_error"),
                    swap_nonce=hb.get("swap_nonce"))
            elif proc_dead:
                # hard process exit: expire the component immediately by
                # re-registering with a zero budget — check_transitions
                # below turns that into the death callback
                self.registry.register(f"replica.{rid}", timeout_s=0.0)
        self.registry.check_transitions()
        self._check_rolling()
        self._autoscale_check()

    def _on_transition(self, component: str, alive: bool) -> None:
        if component.startswith("host."):
            hid = component[len("host."):]
            slot = self._hosts.get(hid)
            if slot is None:
                return
            if alive:
                # re-registering a failed-over host resurrects its registry
                # component and fires this edge too — only a FRESH heartbeat
                # (slot.alive, set by the host poll) is proof of recovery
                if slot.alive:
                    logger.info("fleet: host %s is back", hid)
                    slot.breaker.reset()
                return
            if self._stop.is_set() or slot.retiring:
                return
            if slot.state == "stopped":
                # graceful agent shutdown, not a failure
                slot.alive = False
                return
            if not slot.alive:
                return  # already failed over; edge only fires once per death
            self._host_failover(hid)
            return
        if not component.startswith("replica."):
            return
        rid = component[len("replica."):]
        if alive:
            logger.info("fleet: replica %s is back", rid)
            return
        if self._stop.is_set():
            return
        handle = self._handles.get(rid)
        if handle is not None and handle.restarting:
            return      # deliberate rolling restart owns this lifecycle
        if handle is not None and handle.host is not None:
            hslot = self._hosts.get(handle.host)
            if hslot is not None and (
                    not hslot.alive
                    or time.time() - hslot.last_hb_wall
                    > self.config.fleet_failover_timeout_s):
                # its whole host is dead/dying: the host failover owns
                # every replica there in ONE decision — no per-replica
                # failovers racing it
                return
        self._failover(rid)

    def _failover(self, rid: str) -> None:
        """A replica went silent: evict it from routing, claim-transfer its
        owed requests back to the dispatch stream, respawn it (unless it was
        deliberately draining). Zero-loss: nothing it claimed was acked, so
        everything it owed is still on the broker.

        The whole action runs inside a ``fleet.failover`` span and emits one
        decision event carrying that trace — an operator reading
        ``/debug/events`` can pull the complete failover timeline as a
        Perfetto trace."""
        t0 = time.perf_counter()
        handle = self._handles.get(rid)
        with _tm.span("fleet.failover", replica=rid) as sp:
            self.router.evict(rid)
            self.router.set_liveness(rid, False, state="dead")
            try:
                res = self._conn.call("XTRANSFER", self.router.prefix + rid,
                                      f"fleet-{rid}", self.router.stream)
                moved = (int(res.get("moved", 0))
                         if isinstance(res, dict) else 0)
            except RetryAbortedError:
                return
            except Exception:
                logger.exception("fleet: requeue for dead replica %s failed",
                                 rid)
                moved = 0
            if moved:
                _REQUEUED.inc(moved)
                self.requeued += moved
            logger.warning("fleet: replica %s dead; requeued %d claimed "
                           "request(s)", rid, moved)
            respawned = False
            if handle is not None:
                handle.kill()   # reap whatever half-dead incarnation remains
                if not handle.drain_requested:
                    chaos_point("fleet.respawn", tag=rid)
                    self._spawn_replica(rid)
                    self.respawns += 1
                    _FLEET_RESPAWNS.inc()
                    respawned = True
                else:
                    # died while draining: work requeued above; the drain
                    # decided this replica should not take traffic
                    self._handles.pop(rid, None)
                    self._hb_seen.pop(rid, None)
                    self.router.remove_replica(rid)
                    self.registry.deregister(f"replica.{rid}")
                    if handle.host is not None:
                        hslot = self._hosts.get(handle.host)
                        if hslot is not None:
                            hslot.replicas.discard(rid)
                            self._push_host_ctl(handle.host)
            dt = time.perf_counter() - t0
            self.failovers.append(dt)
            _FAILOVER.observe(dt)
            _ev.emit("fleet.failover", severity="warning",
                     trace_id=sp.trace_id, replica=rid, requeued=moved,
                     respawned=respawned, failover_s=round(dt, 4))

    def _host_failover(self, hid: str) -> None:
        """An entire host went silent: evict EVERY replica it carried,
        claim-transfer all their owed work back, and respawn each on a
        surviving host — one decision, one span, one ``fleet.host_failed``
        event. Zero-loss for the same reason single-replica failover is:
        dead engines acked nothing, so everything they owed is still on the
        broker (dedup tombstones absorb the did-the-ack-race cases).

        The parent span is tagged with THIS process's host identity; each
        per-replica child span carries the failed host's id and its last
        estimated clock offset — the exported trace therefore stitches
        spans from both machines with explicit clock-offset annotations."""
        slot = self._hosts[hid]
        t0 = time.perf_counter()
        rids = sorted(slot.replicas)
        # black-box the control inputs behind the verdict: how stale the
        # heartbeat was (on OUR clock, after skew translation) vs the budget
        now_w = time.time()
        _flight.record(
            "fleet.host_check",
            {"now": now_w, "host": hid,
             "hb_age_s": round(now_w - slot.last_hb_wall, 4),
             "timeout_s": self.config.fleet_failover_timeout_s,
             "clock_offset_s": round(slot.clock_offset_s, 6),
             "replicas": rids},
            {"action": "failover", "replicas": rids})
        with _tm.span("fleet.host_failover", host=host_identity(),
                      failed_host=hid, replicas=len(rids)) as sp:
            # fail fast from now on: dials/routes to this host short-circuit
            # through the breaker until fresh heartbeats prove recovery
            slot.breaker.trip()
            slot.alive = False
            slot.hb_seen = False
            # drop the dead agent's last heartbeat: a death seen through its
            # process exit comes within the failover timeout of that beat,
            # which would still read as fresh and resurrect the host (one
            # more failover of nothing once it expires, as the JAX
            # supervisor does); a recovered agent writes a new one
            try:
                self._conn.call("HDEL", HOST_HB_PREFIX + hid)
            except RetryAbortedError:
                return
            except Exception:
                logger.exception("fleet: clearing host %s's heartbeat "
                                 "failed", hid)
            self.registry.register(f"host.{hid}",
                                   timeout_s=self.config.fleet_spawn_grace_s)
            if slot.agent is not None:
                try:
                    slot.agent.kill()
                except Exception:
                    pass
                slot.agent = None
            if slot.proc is not None:
                try:
                    slot.proc.kill()
                    slot.proc.wait(timeout=2.0)
                except Exception:
                    pass
                slot.proc = None
            total_moved = 0
            for rid in rids:
                with _tm.span("fleet.host_failover.evict", replica=rid,
                              host=hid,
                              clock_offset_s=round(slot.clock_offset_s, 6)):
                    self.router.evict(rid)
                    self.router.set_liveness(rid, False, state="dead")
                    try:
                        res = self._conn.call(
                            "XTRANSFER", self.router.prefix + rid,
                            f"fleet-{rid}", self.router.stream)
                        moved = (int(res.get("moved", 0))
                                 if isinstance(res, dict) else 0)
                    except RetryAbortedError:
                        return
                    except Exception:
                        logger.exception("fleet: requeue for %s on dead "
                                         "host %s failed", rid, hid)
                        moved = 0
                    total_moved += moved
            if total_moved:
                _REQUEUED.inc(total_moved)
                self.requeued += total_moved
            slot.replicas.clear()
            logger.warning("fleet: host %s dead; evicted %s, requeued %d "
                           "claimed request(s)", hid, rids, total_moved)
            respawned: Dict[str, Optional[str]] = {}
            for rid in rids:
                handle = self._handles.get(rid)
                if handle is not None and handle.drain_requested:
                    self._handles.pop(rid, None)
                    self._hb_seen.pop(rid, None)
                    self.router.remove_replica(rid)
                    self.registry.deregister(f"replica.{rid}")
                    continue
                chaos_point("fleet.host_respawn", tag=rid)
                target = self._place_host(exclude=(hid,))
                if target is None:
                    # honest stall: no surviving capacity — leave the handle
                    # so a later recovery/scale-up can re-place it
                    logger.error("fleet: no surviving host can take %s "
                                 "(all at capacity or open)", rid)
                    respawned[rid] = None
                    continue
                self._assign_replica(rid, target)
                self.respawns += 1
                _FLEET_RESPAWNS.inc()
                respawned[rid] = target
            dt = time.perf_counter() - t0
            self.failovers.append(dt)
            _FAILOVER.observe(dt)
            _HOST_FAILOVERS.inc()
            self.host_failovers += 1
            _ev.emit("fleet.host_failed", severity="error",
                     trace_id=sp.trace_id, host=hid, replicas=rids,
                     requeued=total_moved, respawned=respawned,
                     failover_s=round(dt, 4),
                     clock_offset_s=round(slot.clock_offset_s, 6))

    def dial_host(self, hid: str) -> Any:
        """Probe one host through its circuit breaker. While the host is
        marked dead the breaker is OPEN and this fails fast —
        :class:`CircuitOpenError` with a computed ``retry_after_s`` —
        without touching the network path. Half-open probes judge the
        host's HEARTBEAT freshness (broker reachability proves nothing
        about the host), so a still-dead host re-opens the breaker."""
        slot = self._hosts[hid]

        def probe():
            hb = self._conn.call("HGET", HOST_HB_PREFIX + hid, 0)
            fresh = (isinstance(hb, dict)
                     and time.time() - (float(hb.get("ts", 0.0))
                                        - slot.clock_offset_s)
                     < self.config.fleet_failover_timeout_s
                     and hb.get("state") != "stopped")
            if not fresh:
                raise ConnectionError(f"host {hid}: heartbeat stale or "
                                      "missing")
            return hb

        return slot.breaker.call(probe)

    def kill_host(self, hid: str) -> None:
        """Chaos hook: SIGKILL the whole host agent (subprocess) or
        hard-kill the in-process one — every replica it carried dies at
        once, nothing acks, no goodbye heartbeat."""
        slot = self._hosts[hid]
        if slot.agent is not None:
            slot.agent.kill()
        if slot.proc is not None:
            slot.proc.kill()

    # -- autoscaling ---------------------------------------------------------

    def _fresh_rid(self) -> str:
        i = 0
        while f"r{i}" in self._handles:
            i += 1
        return f"r{i}"

    def _owed_work(self) -> Optional[int]:
        """Total work the fleet still owes, measured at the BROKER (the
        router's cached per-replica depths only refresh while it is
        actively routing, so they can hold a stale nonzero value across an
        idle gap): un-routed entries on the shared stream plus everything
        owed on every replica dispatch stream. ``None`` = broker
        unreachable this poll (treated as not-idle)."""
        try:
            total = int(self._conn.call("LEN", self.router.stream,
                                        self.router.group))
            for rid in self.router.replica_ids():
                total += int(self._conn.call(
                    "LEN", self.router.prefix + rid,
                    self.router.group_fmt.format(rid=rid)))
        except RetryAbortedError:
            raise
        except Exception:
            return None
        return total

    def _autoscale_check(self) -> None:
        """One autoscaler evaluation (runs on the monitor thread, every
        poll). The pressure signal is owed work per ELIGIBLE replica —
        exactly what ``zoo_fleet_queue_depth`` publishes — plus the router's
        deadline-shed rate (shed traffic is demand the current fleet failed
        to serve, so it counts double). Both directions are debounced
        (sustain/idle windows) and rate-limited (cooldown) so one slow
        batch never spawns a replica and a gap between bursts never drains
        one."""
        if not self.autoscale_enabled or self._as_busy \
                or self._stop.is_set():
            return
        cfg = self.config
        shed_delta = self.router.shed - self._as_last_shed
        self._as_last_shed = self.router.shed
        routed_delta = self.router.routed - self._as_last_routed
        self._as_last_routed = self.router.routed
        obs = {"now": time.monotonic(),
               "n": len(self._handles),
               "eligible": len(self.router.eligible_ids()),
               "owed": self._owed_work(),
               "shed_delta": shed_delta,
               "routed_delta": routed_delta,
               "up_depth": cfg.autoscale_up_depth,
               "sustain_s": cfg.autoscale_sustain_s,
               "idle_s": cfg.autoscale_idle_s,
               "cooldown_s": cfg.autoscale_cooldown_s,
               "min_replicas": cfg.min_replicas,
               "max_replicas": cfg.max_replicas}
        # the pre-decision debounce snapshot rides in the record, so every
        # recorded tick replays as a pure function of its own inputs
        state_before = dict(self._as_state)
        decision = _qos.autoscale_decision(obs, self._as_state)
        _flight.record("autoscale.tick", {**obs, "state": state_before},
                       decision)
        if decision["action"] == "up":
            self._scale_up()
        elif decision["action"] == "down":
            self._scale_down()

    def _scale_up(self) -> None:
        rid = self._fresh_rid()
        # deterministic fault site: a "fail" rule aborts THIS spawn attempt
        # (the monitor retries next poll while pressure persists) — the
        # kill-during-scale-up drill targets the spawned replica instead
        chaos_point("autoscale.scale", tag="up")
        scope = "host" if self._host_mode else "replica"
        with _tm.span("fleet.autoscale", direction="up", replica=rid) as sp:
            self._spawn_replica(rid)
            self.scale_events.append(("up", len(self._handles)))
            _AUTOSCALE.labels(direction="up", scope=scope).inc()
            extra = {}
            if self._host_mode:
                handle = self._handles.get(rid)
                # placement is borrow-a-machine: _place_host already chose
                # the emptiest (idlest) registered host for the new replica
                extra["host"] = handle.host if handle is not None else None
            _ev.emit("autoscale.up", trace_id=sp.trace_id, replica=rid,
                     replicas=len(self._handles), **extra)
        logger.info("autoscale: spawned replica %s (%d total) on sustained "
                    "queue pressure", rid, len(self._handles))

    def _scale_down(self) -> None:
        """Drain one replica away, zero-loss: stop routing to it (drain),
        let it finish + ack everything it claimed, then claim-transfer any
        stragglers back to the dispatch pool before deregistering. Runs on
        a side thread — the monitor must keep polling heartbeats during the
        drain."""
        if self._host_mode:
            self._scale_down_host()
            return
        victims = [rid for rid, h in self._handles.items()
                   if not h.drain_requested and not h.restarting]
        if len(victims) <= max(1, self.config.min_replicas):
            return
        rid = victims[-1]        # newest first: r0 stays the stable core
        handle = self._handles[rid]
        handle.restarting = True     # monitor hands off this lifecycle
        self._as_busy = True
        chaos_point("autoscale.scale", tag="down")

        def run():
            try:
                with _tm.span("fleet.autoscale", direction="down",
                              replica=rid) as sp:
                    self.drain(rid)
                    self.wait_state(rid, "drained",
                                    timeout_s=max(
                                        5.0, self.config
                                        .fleet_failover_timeout_s * 4))
                    handle.stop(drain_s=2.0)
                    try:
                        res = self._conn.call("XTRANSFER",
                                              self.router.prefix + rid,
                                              f"fleet-{rid}",
                                              self.router.stream)
                        moved = (int(res.get("moved", 0))
                                 if isinstance(res, dict) else 0)
                        if moved:
                            _REQUEUED.inc(moved)
                            self.requeued += moved
                    except Exception:
                        logger.exception("autoscale: straggler requeue for "
                                         "%s failed", rid)
                    self._handles.pop(rid, None)
                    self._hb_seen.pop(rid, None)
                    self.router.remove_replica(rid)
                    self.registry.deregister(f"replica.{rid}")
                    self.scale_events.append(("down", len(self._handles)))
                    _AUTOSCALE.labels(direction="down",
                                      scope="replica").inc()
                    _ev.emit("autoscale.down", trace_id=sp.trace_id,
                             replica=rid, replicas=len(self._handles))
                logger.info("autoscale: drained replica %s away (%d left)",
                            rid, len(self._handles))
            finally:
                self._as_busy = False

        threading.Thread(target=run, daemon=True,
                         name=f"zoo-autoscale-drain-{rid}").start()

    def _scale_down_host(self) -> None:
        """Host-scoped scale-down: retire a WHOLE host to idle, zero-loss.
        The least-loaded occupied host's replicas are drained (finish +
        ack everything claimed), stragglers claim-transferred back, and
        the host is left registered-but-empty — exactly the idle machine a
        later scale-up borrows first."""
        occupied = [s for s in self._hosts.values()
                    if s.replicas and s.alive and not s.retiring]
        if len(occupied) < 2:
            return      # never drain the last working host
        victim = min(occupied, key=lambda s: (len(s.replicas), s.hid))
        rids = sorted(victim.replicas)
        handles = [self._handles[r] for r in rids if r in self._handles]
        if len(self._handles) - len(rids) < max(1, self.config.min_replicas):
            return      # the fleet floor survives the retirement
        if any(h.drain_requested or h.restarting for h in handles):
            return
        for h in handles:
            h.restarting = True      # monitor hands off these lifecycles
        victim.retiring = True
        self._as_busy = True
        chaos_point("autoscale.scale", tag="down")

        def run():
            try:
                with _tm.span("fleet.autoscale", direction="down",
                              host=victim.hid, replicas=len(rids)) as sp:
                    for rid in rids:
                        self.drain(rid)
                    for rid in rids:
                        self.wait_state(rid, "drained",
                                        timeout_s=max(
                                            5.0, self.config
                                            .fleet_failover_timeout_s * 4))
                    # emptying the desired set makes the agent stop its
                    # engines on the monitor's next ctl push
                    victim.replicas.clear()
                    for rid in rids:
                        try:
                            res = self._conn.call("XTRANSFER",
                                                  self.router.prefix + rid,
                                                  f"fleet-{rid}",
                                                  self.router.stream)
                            moved = (int(res.get("moved", 0))
                                     if isinstance(res, dict) else 0)
                            if moved:
                                _REQUEUED.inc(moved)
                                self.requeued += moved
                        except Exception:
                            logger.exception("autoscale: straggler requeue "
                                             "for %s failed", rid)
                        self._handles.pop(rid, None)
                        self._hb_seen.pop(rid, None)
                        self.router.remove_replica(rid)
                        self.registry.deregister(f"replica.{rid}")
                    self.scale_events.append(("down", len(self._handles)))
                    _AUTOSCALE.labels(direction="down", scope="host").inc()
                    _ev.emit("autoscale.down", trace_id=sp.trace_id,
                             host=victim.hid, replicas_drained=rids,
                             replicas=len(self._handles))
                logger.info("autoscale: retired host %s to idle (drained "
                            "%s; %d replicas left)", victim.hid, rids,
                            len(self._handles))
            finally:
                victim.retiring = False
                self._as_busy = False

        threading.Thread(target=run, daemon=True,
                         name=f"zoo-autoscale-drain-{victim.hid}").start()

    # -- drain / rolling restart --------------------------------------------

    def drain(self, rid: str) -> None:
        """Ask one replica to stop accepting and finish in-flight work (the
        command rides the broker control hash, so `cli drain` from another
        process takes the same path)."""
        handle = self._handles.get(rid)
        if handle is not None:
            handle.drain_requested = True
        self._conn.call("HSET", FLEET_CTL_PREFIX + rid, {"state": "drain"})

    def wait_state(self, rid: str, state: str, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            hb = self._conn.call("HGET", FLEET_HB_PREFIX + rid, 0)
            if isinstance(hb, dict) and hb.get("state") == state:
                return True
            time.sleep(0.05)
        return False

    def wait_eligible(self, n: int, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.router.eligible_ids()) >= n:
                return True
            time.sleep(0.05)
        return False

    def restart_replica(self, rid: str, timeout_s: float = 30.0) -> bool:
        """One rolling-restart step: drain → stop → respawn → wait until the
        fresh incarnation is eligible again. Zero-downtime as long as the
        other replicas stay up (the router keeps dispatching to them)."""
        handle = self._handles.get(rid)
        if handle is None:
            return False
        handle.restarting = True    # monitor: hands off this lifecycle
        self.drain(rid)
        self.wait_state(rid, "drained", timeout_s=timeout_s)
        handle.stop(drain_s=2.0)
        try:
            # stragglers dispatched in the eviction race go back to the pool
            res = self._conn.call("XTRANSFER", self.router.prefix + rid,
                                  f"fleet-{rid}", self.router.stream)
            moved = int(res.get("moved", 0)) if isinstance(res, dict) else 0
            if moved:
                _REQUEUED.inc(moved)
                self.requeued += moved
        except Exception:
            logger.exception("fleet: straggler requeue for %s failed", rid)
        self._spawn_replica(rid)    # fresh handle: restarting/drain cleared
        # wait for the fresh incarnation's first heartbeat, not only for an
        # eligible count: when the drain finished between two monitor polls
        # the router slot still holds the old incarnation's "up" state and
        # the count is met at once (the JAX supervisor returns there)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._hb_seen.get(rid):
            time.sleep(0.05)
        ok = bool(self._hb_seen.get(rid)) and self.wait_eligible(
            len(self.router.replica_ids()),
            timeout_s=max(0.0, deadline - time.monotonic()))
        logger.info("fleet: rolling-restarted replica %s (eligible=%s)",
                    rid, ok)
        return ok

    def rolling_restart(self, timeout_s: float = 60.0) -> bool:
        """Drain + restart every replica one at a time (model hot-swap /
        config rollout): at every instant N-1 replicas serve traffic."""
        ok = True
        for rid in list(self.router.replica_ids()):
            ok = self.restart_replica(rid, timeout_s=timeout_s) and ok
        return ok

    def _check_rolling(self):
        """`cli rolling-restart` writes a nonce to the rolling control hash;
        execute it once per nonce (on a side thread — the monitor loop must
        keep polling heartbeats while replicas restart)."""
        val = self._conn.call("HGET", ROLLING_KEY, 0)
        if not isinstance(val, dict) or val.get("nonce") == self._rolling_seen:
            return
        if self._rolling_busy:
            # a restart is still executing: leave the new nonce unconsumed
            # so the next poll after this run finishes picks it up (the
            # operator's command queues instead of silently vanishing)
            return
        self._rolling_seen = val.get("nonce")
        self._rolling_busy = True

        def run():
            try:
                self.rolling_restart()
            finally:
                self._rolling_busy = False

        threading.Thread(target=run, daemon=True,
                         name="zoo-fleet-rolling").start()

    # -- introspection -------------------------------------------------------

    def readiness(self) -> Tuple[bool, Dict[str, Any]]:
        """/readyz payload: ready iff >= 1 replica is eligible for dispatch
        (distinct from liveness — a fleet mid-drain is alive but not ready).
        Carries each replica's active model version and the rollout phase so
        an operator probing readiness sees a stuck rollout at a glance."""
        eligible = self.router.eligible_ids()
        detail: Dict[str, Any] = {
            "eligible": eligible,
            "replicas": self.router.replica_ids(),
            "requeued": self.requeued, "respawns": self.respawns,
            "model_versions": self.model_versions()}
        if self.autoscale_enabled:
            detail["autoscale"] = {
                "replicas": len(self._handles),
                "min": self.config.min_replicas,
                "max": self.config.max_replicas,
                "events": len(self.scale_events)}
        if self.rollout is not None:
            detail["rollout"] = self.rollout.state()
        if self._host_mode:
            detail["hosts"] = {
                hid: {"alive": s.alive, "replicas": sorted(s.replicas),
                      "clock_offset_s": round(s.clock_offset_s, 6),
                      "breaker": s.breaker.state}
                for hid, s in self._hosts.items()}
            detail["host_failovers"] = self.host_failovers
        return len(eligible) >= 1, detail

    def model_versions(self) -> Dict[str, Optional[str]]:
        """Per-replica active model version, from the heartbeat-fed slots."""
        return self.router.model_versions()

    def stats(self) -> Dict[str, Any]:
        """Aggregated engine stats + router view (feeds /metrics.json)."""
        router_stats = self.router.stats()
        out: Dict[str, Any] = {"router": router_stats,
                               "requeued": self.requeued,
                               "respawns": self.respawns,
                               "served": 0}
        if self.autoscale_enabled:
            out["autoscale"] = {"replicas": len(self._handles),
                                "events": list(self.scale_events)}
        if self.rollout is not None:
            out["rollout"] = self.rollout.state()
        if self._host_mode:
            out["hosts"] = {
                hid: {"alive": s.alive, "replicas": sorted(s.replicas),
                      "capacity": s.capacity,
                      "clock_offset_s": round(s.clock_offset_s, 6),
                      "breaker": s.breaker.state}
                for hid, s in self._hosts.items()}
            out["host_failovers"] = self.host_failovers
        slots = router_stats.get("replicas", {})
        for rid, handle in list(self._handles.items()):
            if handle.engine is not None:
                out["served"] += handle.engine.served
            else:
                # process-mode replica: no in-process engine — its served
                # counter rides the fleet:hb:<rid> heartbeat hash, polled by
                # the supervisor and cached on the router slot
                out["served"] += int(slots.get(rid, {}).get("served", 0))
        return out

    def kill_replica(self, rid: str) -> None:
        """Chaos hook: hard-kill one replica (threads stop un-acked /
        process SIGKILL). The monitor detects the silence and fails over."""
        handle = self._handles.get(rid)
        if handle is not None:
            handle.kill()

    def stop(self, drain_s: float = 5.0):
        """Ordered fleet shutdown: router first (stop claiming client
        traffic), then replicas drain + stop (in-flight work finishes and
        acks), then the monitor. Undispatched client entries stay on the
        broker for the next incarnation (AOF redelivery)."""
        if self.rollout is not None:
            self.rollout.stop()
        self.router.stop(drain_s=min(2.0, drain_s))
        if self._host_mode:
            # agents own the engines: command shutdown (they drain their
            # engines themselves), then reap whatever we manage locally
            for hid, slot in self._hosts.items():
                try:
                    self._push_host_ctl(hid, shutdown=True)
                except Exception:
                    pass
            self._stop.set()
            for slot in self._hosts.values():
                if slot.agent is not None:
                    try:
                        slot.agent.stop(drain_s=min(2.0, drain_s))
                    except Exception:
                        pass
                    slot.agent = None
                if slot.proc is not None:
                    try:
                        slot.proc.terminate()
                        slot.proc.wait(timeout=max(5.0, drain_s + 2.0))
                    except Exception:
                        try:
                            slot.proc.kill()
                        except Exception:
                            pass
                    slot.proc = None
            if self._monitor is not None:
                self._monitor.join(timeout=2.0)
                self._monitor = None
            if self._conn is not None:
                self._conn.close()
                self._conn = None
            return
        for rid, handle in list(self._handles.items()):
            if handle.engine is not None:
                handle.engine.drain()
        deadline = time.monotonic() + drain_s
        for rid, handle in list(self._handles.items()):
            if handle.engine is not None:
                while (time.monotonic() < deadline
                       and not handle.engine.drained()):
                    time.sleep(0.02)
        self._stop.set()
        for handle in list(self._handles.values()):
            handle.stop(drain_s=1.0)
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        if self._conn is not None:
            self._conn.close()
            self._conn = None


# ---------------------------------------------------------------------------
# subprocess replica entrypoint (fleet_spawn: process)
# ---------------------------------------------------------------------------

def main(argv=None) -> int:  # pragma: no cover - exercised as a subprocess
    ap = argparse.ArgumentParser(
        description="one fleet replica: ClusterServing consuming its own "
                    "dispatch stream, heartbeating over the broker")
    ap.add_argument("--replica", required=True, help="replica id (rN)")
    ap.add_argument("--broker-host", default="127.0.0.1")
    ap.add_argument("--broker-port", type=int, required=True)
    ap.add_argument("--config", default=None, help="ServingConfig yaml")
    ap.add_argument("--model", default=None, help="zoo model bundle path")
    ap.add_argument("--demo", action="store_true",
                    help="serve the built-in demo model")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the replica serves (default: the card; it "
                         "exits with an error when there is none)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = (ServingConfig.from_yaml(args.config) if args.config
           else ServingConfig())
    cfg.queue_host, cfg.queue_port = args.broker_host, args.broker_port
    if args.model:
        cfg.model_path = args.model
    model = None
    if args.demo and not cfg.model_path:
        from .stack import _demo_model

        model = _demo_model(args.device)
    rid = args.replica
    engine = ClusterServing(model, config=cfg, group=f"fleet-{rid}",
                            stream=REPLICA_STREAM_PREFIX + rid,
                            replica_id=rid,
                            device=args.device)
    engine.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    logger.info("fleet replica %s up (stream=%s)", rid,
                REPLICA_STREAM_PREFIX + rid)
    stop.wait()
    engine.drain()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not engine.drained():
        time.sleep(0.05)
    engine.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
