"""Host agent — one supervising daemon per machine in a cross-host fleet
(port of ``analytics_zoo_tpu/serving/hostagent.py``, which needs no JAX: the
same hashes and reconcile decisions; its engines serve on ``device``, the
card unless the caller names another).

The single-machine fleet (serving/fleet.py) treats the PROCESS as the failure
unit; the reference's cluster-serving/hyperzoo story — and the TensorFlow
design it cites (PAPERS.md) — treats the worker HOST as the normal failure
unit. This module is that host abstraction:

* A :class:`HostAgent` runs on each machine (or as a local subprocess
  standing in for one — the chaos drills SIGKILL an agent to kill "a whole
  host" at once). It registers with the broker by heartbeating the
  ``fleet:host:<hid>`` hash — host-level liveness, distinct from the
  per-replica ``fleet:hb:<rid>`` heartbeats its engines write.

* The supervisor never spawns cross-host replicas itself: it writes the
  DESIRED replica set into the declarative ``fleet:hostctl:<hid>`` hash and
  the agent reconciles — spawning missing engines, draining removed ones —
  idempotently, so a broker restart or a re-sent command converges to the
  same state instead of double-spawning.

* Clock-skew estimation rides the same hashes, NTP-style: the supervisor
  stamps ``ping_t0`` (its wall clock) into the control hash; the agent
  echoes it back in its next heartbeat together with ``pong_host_t`` (the
  AGENT's wall clock at the echo). The supervisor derives
  ``offset ≈ pong_host_t - (t0 + t2) / 2`` per round trip — the evidence
  behind ``zoo_fleet_host_clock_skew_seconds`` and the deadline skew
  tolerance (qos.cannot_meet). ``clock_offset_s`` lets tests simulate a
  skewed machine deterministically.

Wire layout on the broker::

    fleet:host:<hid>      agent heartbeat {ts, identity, capacity, replicas,
                          pong_t0, pong_host_t, state}
    fleet:hostctl:<hid>   supervisor desired state {replicas, nonce, ping_t0,
                          shutdown}

Run one per machine::

    python -m analytics_zoo_tpu_torch.serving.hostagent --hid h0 \\
        --broker-host <broker> --broker-port 6380 --config serving.yaml \\
        --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..common.chaos import chaos_point
from ..common.resilience import RetryAbortedError, RetryPolicy
from ..observability import recorder as _flight
from .client import _Conn
from .config import ServingConfig
from .engine import ClusterServing
from .shm import host_identity

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.hostagent")

HOST_HB_PREFIX = "fleet:host:"       # agent -> broker host heartbeat hash
HOST_CTL_PREFIX = "fleet:hostctl:"   # supervisor -> agent desired-state hash


class HostAgent:
    """Per-machine replica supervisor: heartbeats host liveness, reconciles
    the broker-declared desired replica set into running
    :class:`ClusterServing` engines.

    ``model_factory`` supplies the model object per spawned replica (tests /
    in-process agents); without one, engines load ``config.model_path``
    themselves. ``clock_offset_s`` shifts every wall-clock value this agent
    writes — a deterministic stand-in for a machine whose clock drifted.
    ``device``: where the engines serve (CUDA when ``None``).
    """

    def __init__(self, hid: str, config: ServingConfig, *,
                 model_factory: Optional[Callable[[], Any]] = None,
                 capacity: Optional[int] = None,
                 clock_offset_s: float = 0.0,
                 identity: Optional[str] = None,
                 stream_prefix: str = "fleet:req:",
                 device: Optional[str] = None):
        self.hid = hid
        self.device = device
        self.config = config
        self.model_factory = model_factory
        self.capacity = int(capacity if capacity is not None
                            else config.fleet_host_capacity)
        self.clock_offset_s = float(clock_offset_s)
        self.identity = identity or host_identity()
        self.stream_prefix = stream_prefix
        # engines are touched only by the agent loop thread (single-writer,
        # the supervisor pattern) — kill()/stop() join the loop first
        self._engines: Dict[str, ClusterServing] = {}
        self._gens: Dict[str, Any] = {}   # running generation per replica
        self._last_nonce: Any = None
        self._pong: Optional[Dict[str, float]] = None  # last echoed ping
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn: Optional[_Conn] = None
        self.started_at = time.time()

    # -- clock ----------------------------------------------------------------

    def _now(self) -> float:
        """This host's wall clock (offset-shifted for skew simulation)."""
        return time.time() + self.clock_offset_s

    # -- lifecycle -------------------------------------------------------------

    def _connect(self) -> _Conn:
        policy = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                             max_delay_s=0.5, attempt_timeout_s=5.0,
                             retryable=(ConnectionError, OSError))
        return _Conn(self.config.queue_host, self.config.queue_port,
                     policy=policy, abort=self._stop.is_set,
                     tag=f"hostagent.{self.hid}")

    def start(self) -> "HostAgent":
        self._stop.clear()
        self._conn = self._connect()
        self._heartbeat()           # register before the first reconcile
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"zoo-hostagent-{self.hid}")
        self._thread.start()
        logger.info("hostagent %s up (identity=%s, capacity=%d, "
                    "clock_offset=%+.3fs)", self.hid, self.identity,
                    self.capacity, self.clock_offset_s)
        return self

    def _loop(self):
        interval = max(0.05, min(self.config.fleet_heartbeat_s, 0.5))
        while not self._stop.is_set():
            try:
                # deterministic fault site: a "fail" rule makes this host
                # miss a heartbeat/reconcile round (network-partition model)
                chaos_point("host.heartbeat", tag=self.hid)
                self._poll_ctl()
                self._heartbeat()
            except RetryAbortedError:
                break
            except Exception:
                logger.exception("hostagent %s: poll failed", self.hid)
            self._stop.wait(interval)

    def _poll_ctl(self):
        ctl = self._conn.call("HGET", HOST_CTL_PREFIX + self.hid, 0)
        if not isinstance(ctl, dict):
            return
        ping = ctl.get("ping_t0")
        if ping is not None:
            # echo the supervisor's ping together with OUR clock at the echo
            # (the skew-estimation round trip)
            self._pong = {"pong_t0": float(ping), "pong_host_t": self._now()}
        if ctl.get("shutdown"):
            logger.info("hostagent %s: shutdown commanded", self.hid)
            self._stop.set()
            return
        if "replicas" in ctl:
            self._reconcile(ctl.get("replicas") or {})
            self._last_nonce = ctl.get("nonce")

    def _reconcile(self, desired):
        """Converge running engines onto the desired replica set. Idempotent:
        a replayed/duplicated command (broker AOF restart, supervisor resend)
        finds nothing to do.

        ``desired`` is ``{rid: generation}`` — a bumped generation means the
        supervisor decided that replica must be a FRESH incarnation (single-
        replica failover onto the same host), so the running engine is torn
        down and respawned. A bare list (no generations) is also accepted.
        """
        if isinstance(desired, dict):
            want = {str(r): g for r, g in desired.items()}
        else:
            want = {str(r): None for r in desired}
        running_before = sorted(self._engines)
        removed: list = []
        spawned: list = []
        refused: list = []
        for rid in list(self._engines):
            gen = want.get(rid)
            if rid in want and (gen is None or gen == self._gens.get(rid)):
                continue
            eng = self._engines.pop(rid)
            self._gens.pop(rid, None)
            # removal is always preceded by a supervisor-side drain (the
            # replica's ctl hash), so in-flight work is already acked;
            # the short engine drain here covers stragglers. A generation
            # bump skips straight to respawn below.
            try:
                eng.stop(drain_s=0.0 if rid in want else 1.0)
            except Exception:
                logger.exception("hostagent %s: stop of %s failed",
                                 self.hid, rid)
            removed.append(rid)
            logger.info("hostagent %s: removed replica %s%s", self.hid, rid,
                        " (generation bump)" if rid in want else "")
        for rid, gen in want.items():
            if rid in self._engines:
                continue
            if len(self._engines) >= self.capacity:
                logger.warning("hostagent %s: at capacity (%d), refusing "
                               "replica %s", self.hid, self.capacity, rid)
                refused.append(rid)
                continue
            self._spawn(rid)
            self._gens[rid] = gen
            spawned.append(rid)
        if removed or spawned or refused:
            # reconcile runs every heartbeat round — only CHANGES are flight
            # records (a converged no-op would flood the ring with noise)
            _flight.record(
                "host.reconcile",
                {"now": time.time(), "host": self.hid,
                 "desired": sorted(want), "running": running_before,
                 "capacity": self.capacity},
                {"action": "reconcile", "spawn": spawned,
                 "remove": removed, "refused": refused})

    def _spawn(self, rid: str):
        model = self.model_factory() if self.model_factory else None
        eng = ClusterServing(model, config=dataclasses.replace(self.config),
                             group=f"fleet-{rid}",
                             stream=self.stream_prefix + rid,
                             replica_id=rid,
                             device=self.device)
        eng.start()
        self._engines[rid] = eng
        logger.info("hostagent %s: spawned replica %s", self.hid, rid)

    def _heartbeat(self, state: str = "up"):
        mapping: Dict[str, Any] = {
            "ts": self._now(), "hid": self.hid, "pid": os.getpid(),
            "identity": self.identity, "capacity": self.capacity,
            "replicas": sorted(self._engines), "nonce": self._last_nonce,
            "state": state, "started_at": self.started_at}
        if self._pong is not None:
            mapping.update(self._pong)
        self._conn.call("HSET", HOST_HB_PREFIX + self.hid, mapping)

    # -- teardown --------------------------------------------------------------

    def replica_ids(self):
        return sorted(self._engines)

    def kill(self):
        """Whole-host hard death: every engine dies at once, nothing acks,
        no "stopped" heartbeat is written — exactly what SIGKILLing the agent
        process does. The chaos drills' in-process stand-in."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for eng in self._engines.values():
            try:
                eng.kill()
            except Exception:
                pass
        self._engines.clear()
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def stop(self, drain_s: float = 2.0):
        """Graceful host retirement: drain every engine, write a final
        ``stopped`` heartbeat (the supervisor deregisters instead of
        failing over), then disconnect."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for eng in self._engines.values():
            try:
                eng.drain()
            except Exception:
                pass
        deadline = time.monotonic() + drain_s
        for eng in self._engines.values():
            while time.monotonic() < deadline and not eng.drained():
                time.sleep(0.02)
        for eng in self._engines.values():
            try:
                eng.stop(drain_s=0.5)
            except Exception:
                pass
        self._engines.clear()
        if self._conn is not None:
            try:
                self._heartbeat(state="stopped")
            except Exception:
                pass
            self._conn.close()
            self._conn = None


# ---------------------------------------------------------------------------
# subprocess / per-machine entrypoint
# ---------------------------------------------------------------------------

def _stub_factory(service_s: float, device):  # pragma: no cover
    """Device-bound stand-in model for the bench host-kill drills:
    ``predict`` blocks (GIL released) for a fixed service time per
    micro-batch, like a kernel launch on this host's own card."""
    import numpy as np

    from ..inference.inference_model import InferenceModel

    class _Stub(InferenceModel):
        def predict(self, inputs, batch_first=True):
            time.sleep(service_s)
            x = np.asarray(inputs)
            return x.sum(axis=tuple(range(1, x.ndim)), keepdims=True)

    return lambda: _Stub(device=device)


def main(argv=None) -> int:  # pragma: no cover - exercised as a subprocess
    ap = argparse.ArgumentParser(
        description="one fleet host agent: registers fleet:host:<hid>, "
                    "spawns/supervises replicas on supervisor command")
    ap.add_argument("--hid", required=True, help="host id (hN)")
    ap.add_argument("--broker-host", default="127.0.0.1")
    ap.add_argument("--broker-port", type=int, required=True)
    ap.add_argument("--config", default=None, help="ServingConfig yaml")
    ap.add_argument("--model", default=None, help="zoo model bundle path")
    ap.add_argument("--demo", action="store_true",
                    help="serve the built-in demo model")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where this host's engines serve (default: the "
                         "card; they fail when there is none)")
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--clock-offset", type=float, default=0.0,
                    help="simulated wall-clock skew (s) for this host")
    ap.add_argument("--identity", default=None,
                    help="override host_identity() (containerized tests)")
    ap.add_argument("--stub-service-ms", type=float, default=None,
                    help="serve a sleep-per-microbatch stub model with this "
                         "service time (bench host-kill drills)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = (ServingConfig.from_yaml(args.config) if args.config
           else ServingConfig())
    cfg.queue_host, cfg.queue_port = args.broker_host, args.broker_port
    if args.model:
        cfg.model_path = args.model
    factory = None
    if args.stub_service_ms is not None:
        factory = _stub_factory(args.stub_service_ms / 1000.0, args.device)
    elif args.demo and not cfg.model_path:
        from .stack import _demo_model

        model = _demo_model(args.device)  # built once, shared by engines
        factory = lambda: model  # noqa: E731
    agent = HostAgent(args.hid, cfg, model_factory=factory,
                      capacity=args.capacity,
                      clock_offset_s=args.clock_offset,
                      identity=args.identity, device=args.device)
    agent.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    agent.stop(drain_s=5.0)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
