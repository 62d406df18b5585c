"""ClusterServing engine — source → batched inference → sink, pipelined
(port of ``analytics_zoo_tpu/serving/engine.py``).

Parity: the reference's ``ClusterServing.scala`` assembles
``FlinkRedisSource → FlinkInference → FlinkRedisSink``; FlinkInference
batches up to ``coreNum`` records and runs the InferenceModel replica pool;
PostProcessing applies topN.

Here the three stages are daemon threads joined by bounded queues, so
decode, the card's work and result writing overlap like Flink operator
chaining. Inference is the port's :class:`InferenceModel` on ``device``
(CUDA unless the caller names another; it raises without CUDA): int8 K5/K6
on the card for a quantized model. Each infer worker calls
``InferenceModel.predict`` from its own thread; ``predict`` hands back host
numpy arrays made by an explicit, blocking device-to-host copy (``.cpu()``
in the model's gather), so everything the card computed for a batch is on
the host before the batch reaches the sink queue. A failed batch is answered
with an error record per uri (the canary signal); nothing catches a kernel
build or launch failure to answer with another result.

Hot swap (``config.hot_swap``): a listener thread consumes the publisher
stream (``serving/hotswap.py``), stages each published checkpoint off the
hot path and flips it between dispatch waves; every result carries the
version that computed it.

Replica mode (``stream``/``replica_id``, driven by ``serving/fleet.py``): the
engine consumes its own routed dispatch stream under a group that starts at
``"0"``, heartbeats into the ``fleet:hb:<replica_id>`` hash, polls
``fleet:ctl:<replica_id>`` for drain and nonce-deduped swap commands from
the ``RolloutController``, and writes results first-write-wins
(``HSETNX``), so a requeued request answered twice reaches
the client once. With ``graph_checks`` ("warn" default / "raise") and a
``warmup_shape``, the warm-up runs the int8 dispatch checks
(``InferenceModel.check_fused_dispatch`` and ``check_memory`` under
``hbm_budget_mb``) before the engine takes traffic; ``stats()`` reports
the mode and the warm-up's finding count.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..common import telemetry as _tm
from ..common.chaos import WorkerKilled, chaos_point
from ..common.locks import traced_lock
from ..common.resilience import (HealthRegistry, RetryAbortedError,
                                 RetryPolicy)
from ..inference.inference_model import InferenceModel
from ..inference.summary import InferenceSummary
from . import qos as _qos
from . import slo_metrics as _slo_metrics
from .client import INPUT_STREAM, RESULT_PREFIX, _Conn
from .config import ServingConfig
from .hotswap import MODEL_STREAM, ModelSwapper, SwapRejected
from .schema import (MODEL_VERSION_KEY, decode_payload, payload_deadline,
                     payload_priority, payload_trace)
from .wire import set_wire_model_version

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

_RECORDS = _tm.counter("zoo_serving_records_total",
                       "Records served by the streaming engine",
                       labels=("outcome",))
_RESPAWNS = _tm.counter("zoo_serving_worker_respawns_total",
                        "Dead model-worker slots respawned by the supervisor")
_DUP_RESULTS = _tm.counter(
    "zoo_fleet_duplicate_results_dropped_total",
    "Result writes a dedup-mode sink dropped because another replica "
    "already answered the uri (HSETNX returned 0)")
_ENGINE_SHED = _tm.counter(
    "zoo_serving_shed_total",
    "Requests the engine shed instead of served, by overload class "
    "(deadline = expired in flight — incl. AOF-replayed / failover-"
    "requeued records)", labels=("reason",))
# the SLO engine's per-class evidence (observability/slo.py), registered
# once in serving/slo_metrics.py
_REQ_LAT = _slo_metrics.REQUEST_LATENCY
_REQ_OUTCOMES = _slo_metrics.REQUEST_OUTCOMES

# fleet coordination keys on the broker (written by replica engines, read by
# the ReplicaRouter/FleetSupervisor in serving/fleet.py)
FLEET_HB_PREFIX = "fleet:hb:"     # per-replica heartbeat hash
FLEET_CTL_PREFIX = "fleet:ctl:"   # per-replica control hash (drain commands)


class ClusterServing:
    """Streaming inference job.

    ``model`` may be an :class:`InferenceModel` (served on its own device),
    a ``torch.nn.Module`` (served through an :class:`InferenceModel` on
    ``device``), or ``None`` with ``config.model_path`` pointing at a zoo
    bundle.
    """

    def __init__(self, model=None, config: Optional[ServingConfig] = None,
                 group: str = "serving",
                 registry: Optional[HealthRegistry] = None,
                 stream: Optional[str] = None,
                 replica_id: Optional[str] = None, *,
                 device=None):
        self.config = config or ServingConfig()
        self.group = group
        # fleet wiring: a replica consumes its OWN stream (the router's
        # per-replica dispatch stream) under its own consumer group, announces
        # itself via a broker-side heartbeat hash, and writes results
        # first-write-wins (HSETNX) so a requeued request answered twice
        # reaches the client exactly once
        self.stream = stream or INPUT_STREAM
        self.replica_id = replica_id
        # liveness registry: every stage thread registers + beats; the
        # supervisor respawns dead model workers; /healthz reads status()
        self.registry = registry if registry is not None else HealthRegistry(
            default_timeout_s=self.config.heartbeat_timeout_s)
        self.summary = (InferenceSummary(self.config.log_dir, "serving")
                        if self.config.log_dir else None)
        if isinstance(model, InferenceModel):
            self.model = model
        elif model is not None:
            self.model = InferenceModel(
                supported_concurrent_num=self.config.concurrent_num,
                max_batch_size=max(self.config.batch_size, 1),
                summary=self.summary, device=device).load(model)
        else:
            if not self.config.model_path:
                raise ValueError("pass a model or set config.model_path")
            self.model = InferenceModel(
                supported_concurrent_num=self.config.concurrent_num,
                max_batch_size=max(self.config.batch_size, 1),
                summary=self.summary,
                device=device).load_zoo(self.config.model_path)
        self._stop = threading.Event()
        # drain mode: stop CLAIMING new stream entries, finish + ack what is
        # already in flight (the zero-downtime rolling-restart precondition)
        self._draining = threading.Event()
        # hard kill: every loop exits at its next check WITHOUT acking or
        # sinking — simulates replica death for failover drills (claimed
        # entries stay pending broker-side and get requeued by the fleet)
        self._killed = threading.Event()
        self._threads: List[threading.Thread] = []
        # model-worker threads are tracked by slot so the supervisor can
        # respawn a dead one in place (reference: Flink task restarts)
        self._infer_threads: Dict[int, threading.Thread] = {}
        self.workers_respawned = 0
        # the findings of the warm-up's graph checks (graph_checks)
        self.graph_findings: list = []
        # bounded hand-off queues = operator-chain backpressure
        self._infer_q: "queue.Queue" = queue.Queue(maxsize=8)
        self._sink_q: "queue.Queue" = queue.Queue(maxsize=32)
        self._inflight = 0              # batches popped but not yet sunk
        # zoo-lock: guards(_inflight)
        self._inflight_lock = traced_lock("ClusterServing._inflight_lock")
        self.served = 0
        self.errors = 0                 # records answered with an error —
                                        # the canary-validation signal
        self._lat_ema_s = 0.0           # EMA of receipt->computed latency
        # per-RECORD compute time (pickup->computed / batch size) — the
        # router's shed-proof evidence; unlike lat it excludes queue wait,
        # so depth x svc doesn't double-count
        self._svc_ema = _qos.ServiceTimeEMA()
        # model hot-swap (serving/hotswap.py): staging + the atomic flip.
        # Commands arrive via the fleet control hash (replica mode) or the
        # publisher stream directly (single-engine mode, config.hot_swap)
        self.swapper = ModelSwapper(
            self.model, warmup=getattr(self.config, "swap_warmup", True),
            probe_shape=getattr(self.config, "warmup_shape", None))
        self._swap_state = "idle"       # idle | staging | ok | error
        self._swap_error: Optional[str] = None
        self._swap_thread: Optional[threading.Thread] = None
        self._swap_nonce_seen: Any = None

    # ------------------------------------------------------------------ stages

    def _connect(self, tag: str = "engine") -> _Conn:
        """A broker connection that reconnects-with-backoff on every failure
        and retries until the job stops (then raises RetryAbortedError out of
        the in-flight ``call``). Connection is lazy: the loops come up even
        while the broker is still starting. The bulk-transfer roles (source
        reads request batches, sink writes result batches) negotiate the
        same-host shared-memory ring eagerly so large batches never cross
        the loopback socket."""
        policy = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                             max_delay_s=0.5, attempt_timeout_s=5.0,
                             retryable=(ConnectionError, OSError))
        bulk = tag in ("engine.source", "engine.sink")
        return _Conn(self.config.queue_host, self.config.queue_port,
                     policy=policy, abort=self._stop.is_set, tag=tag,
                     shm_mode="eager" if bulk else "lazy")

    def _source_loop(self):
        conn = self._connect("engine.source")
        hb = self.registry.register("serving.source")
        cfg = self.config
        try:
            while not self._stop.is_set():
                hb.beat()
                if self._draining.is_set():
                    # shed: a draining engine claims nothing new; in-flight
                    # work keeps moving through infer/sink until acked
                    time.sleep(0.01)
                    continue
                try:
                    entries = conn.call("XREADGROUP", self.stream, self.group,
                                        cfg.batch_size, cfg.batch_timeout_ms)
                except RetryAbortedError:
                    break          # job stopping
                if not entries:
                    if cfg.batch_timeout_ms <= 0:
                        time.sleep(0.005)  # non-blocking poll: avoid busy spin
                    continue
                batch, bad = [], []
                t_recv = time.perf_counter()
                for _id, payload in entries:
                    # trace context enqueued by the client rides the payload
                    # through the stream (and AOF replay); absent from old
                    # clients — every consumer below tolerates ctx=None
                    ctx = payload_trace(payload)
                    # deadline gate BEFORE the model sees the record: a
                    # request whose deadline expired in flight (deep queue,
                    # AOF-replayed after a broker restart, requeued off a
                    # dead replica) is answered with a shed record — serving
                    # it would burn device time on a result the client
                    # already gave up on. The deadline is the ORIGINAL one:
                    # it rides the payload through every requeue.
                    dl = payload_deadline(payload)
                    pri = payload_priority(payload)
                    if dl is not None and time.time() > dl:
                        chaos_point("overload.shed", tag="engine")
                        _ENGINE_SHED.labels(reason="deadline").inc()
                        _REQ_OUTCOMES.labels(priority=pri,
                                             outcome="shed").inc()
                        bad.append((_id, payload.get("uri"),
                                    _qos.shed_payload(
                                        "deadline expired before service",
                                        _qos.retry_after_s(
                                            self._infer_q.qsize() + 1,
                                            self._svc_ema.value()),
                                        reason="deadline"), ctx))
                        continue
                    try:
                        batch.append((_id, payload["uri"],
                                      decode_payload(payload["data"]),
                                      ctx, t_recv, pri))
                    except Exception as e:  # malformed record: report, keep running
                        logger.exception("malformed record %s", _id)
                        uri = payload.get("uri") if isinstance(payload, dict) else None
                        bad.append((_id, uri,
                                    {"error": f"malformed payload: {e}"}, ctx))
                if bad:
                    self._sink_q.put(bad)
                if batch:
                    with self._inflight_lock:
                        self._inflight += 1
                    self._infer_q.put(batch)
        finally:
            hb.stop()
            conn.close()

    def _collate(self, batch):
        """Stack per-record tensors into batched arrays (FlinkInference batches
        records before predict). Records must share input names/shapes."""
        names = list(batch[0][2].keys())
        arrays = []
        for name in names:
            arrays.append(np.stack([rec[2][name] for rec in batch], axis=0))
        return arrays[0] if len(arrays) == 1 else arrays

    def _infer_loop(self, widx: int = 0):
        """One model worker. Registers a heartbeat; a (simulated or real)
        death mid-batch re-queues the batch it held — nothing is acked until
        the sink writes results, so no request can be lost — and the
        supervisor respawns the worker slot."""
        hb = self.registry.register(f"serving.infer.{widx}")
        try:
            while not self._stop.is_set():
                hb.beat()
                try:
                    batch = self._infer_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                ids = [rec[0] for rec in batch]
                uris = [rec[1] for rec in batch]
                ctxs = [rec[3] for rec in batch]
                # micro-batch wait: source receipt -> this worker picking the
                # batch up (stream dwell + XREADGROUP window + queue depth)
                t_pick = time.perf_counter()
                for rec in batch:
                    if rec[3] is not None:
                        _tm.record_span("serving.batch.wait", rec[4], t_pick,
                                        remote=rec[3], worker=widx)
                try:
                    chaos_point("serving.infer", tag=widx)
                    x = self._collate(batch)
                    # host numpy out: predict's gather copies the outputs
                    # off the card explicitly (a blocking .cpu()), so the
                    # sink never reads a result the card is still writing
                    y = self.model.predict(x)
                    outs = self._postprocess(y)
                    # version attribution at COMPUTE time, not sink time: a
                    # swap landing while this batch sits in the sink queue
                    # must not relabel results the OLD weights produced.
                    # last_served_version is snapshotted inside the model's
                    # concurrency slot, so it is race-free vs the flip.
                    getver = getattr(self.model, "last_served_version", None)
                    ver = ((getver() if getver is not None else None)
                           or self.model_version)
                    t_done = time.perf_counter()
                    # receipt -> computed latency EMA, published in the fleet
                    # heartbeat — the canary-validation latency signal
                    lat = t_done - min(rec[4] for rec in batch)
                    self._lat_ema_s = (lat if self._lat_ema_s == 0.0
                                       else 0.8 * self._lat_ema_s + 0.2 * lat)
                    self._svc_ema.observe((t_done - t_pick)
                                          / max(1, len(batch)))
                    for rec in batch:
                        # per-class SLO evidence; a pre-QoS record tuple
                        # (5-long, e.g. handed back by an older requeue)
                        # counts as the default class
                        pri = rec[5] if len(rec) > 5 else "normal"
                        _REQ_LAT.labels(priority=pri).observe(
                            t_done - rec[4])
                        _REQ_OUTCOMES.labels(priority=pri,
                                             outcome="served").inc()
                    for ctx in ctxs:
                        if ctx is not None:
                            _tm.record_span("serving.engine.dispatch", t_pick,
                                            t_done, remote=ctx, worker=widx,
                                            batch=len(batch))
                    self._sink_q.put([
                        (i, u, {"value": o, MODEL_VERSION_KEY: ver}, c)
                        for i, u, o, c in zip(ids, uris, outs, ctxs)])
                except WorkerKilled:
                    # simulated hard death: hand the un-sunk batch back (it is
                    # still unacked broker-side) and die; the supervisor
                    # respawns this slot and the batch is re-processed. The
                    # re-queue rides a side thread: a blocking put on the
                    # bounded queue would keep THIS thread alive, and the
                    # supervisor's is_alive() check would never fire
                    threading.Thread(target=self._infer_q.put, args=(batch,),
                                     daemon=True,
                                     name=f"serving-requeue-{widx}").start()
                    logger.warning("infer worker %d killed mid-batch; "
                                   "re-queued %d records", widx, len(batch))
                    return
                except Exception as e:  # one bad record must not kill the job
                    logger.exception("inference batch failed")
                    self._sink_q.put([(i, u, {"error": str(e)}, c)
                                      for i, u, c in zip(ids, uris, ctxs)])
                # a re-queued batch stays in flight, so the decrement lives
                # here (after sinking) rather than in a finally
                with self._inflight_lock:
                    self._inflight -= 1
        finally:
            hb.stop()

    def _postprocess(self, y) -> List[Any]:
        """Split batch back into per-record results; apply topN
        (serving/PostProcessing.scala parity)."""
        if isinstance(y, (list, tuple)):
            per_rec = [[np.asarray(o[i]) for o in y] for i in range(len(y[0]))]
        else:
            y = np.asarray(y)
            per_rec = [y[i] for i in range(y.shape[0])]
        if self.config.top_n is None:
            return per_rec
        n = self.config.top_n
        out = []
        for r in per_rec:
            flat = np.asarray(r).ravel()
            idx = np.argsort(-flat)[:n]
            out.append(np.stack([idx.astype(np.float32), flat[idx]], axis=1))
        return out

    def _sink_loop(self):
        conn = self._connect("engine.sink")
        hb = self.registry.register("serving.sink")
        try:
            # keep draining after _stop so results already computed still land
            while not self._killed.is_set():
                hb.beat()
                try:
                    results = self._sink_q.get(timeout=0.1)
                except queue.Empty:
                    if self._stop.is_set():
                        break
                    continue
                try:
                    done_ids = []
                    for entry_id, uri, value, ctx in results:
                        # version tagging: results stamped at compute time
                        # keep their tag; error/malformed records (never ran
                        # the model) get the current version. The payload
                        # field is the durable copy; the ambient wire-header
                        # "v" tags this result's binary frame to match.
                        if isinstance(value, dict) \
                                and MODEL_VERSION_KEY not in value:
                            value[MODEL_VERSION_KEY] = self.model_version
                        set_wire_model_version(
                            value.get(MODEL_VERSION_KEY)
                            if isinstance(value, dict) else None)
                        # the connection's policy retries across reconnects; a
                        # RetryAbortedError means stopping AND broker gone.
                        # Result tensors ride raw binary frames (no npy/base64)
                        if uri is not None:
                            span_cm = (_tm.span("serving.fanout", remote=ctx,
                                                uri=uri) if ctx is not None
                                       else None)
                            if span_cm is not None:
                                with span_cm:
                                    self._write_result(conn, uri, value)
                            else:
                                self._write_result(conn, uri, value)
                        is_shed = isinstance(value, dict) and value.get("shed")
                        is_err = (not is_shed and isinstance(value, dict)
                                  and "error" in value)
                        _RECORDS.labels(
                            outcome="shed" if is_shed
                            else "error" if is_err else "ok").inc()
                        if is_err:
                            # sheds are deliberate load management, not model
                            # failures — they must not poison the canary-
                            # validation error-rate signal
                            self.errors += 1
                        self.served += 1
                        done_ids.append(entry_id)
                    # results are durably written: release the broker's pending
                    # entries (Redis XACK after the sink commits —
                    # at-least-once). Retried across reconnects like HSET: a
                    # dropped ack would leave the entries pending forever and
                    # redeliver them on every restart
                    if done_ids:
                        conn.call("XACK", self.stream, self.group, done_ids)
                except RetryAbortedError:
                    break          # stopping and broker gone: give up
        finally:
            hb.stop()
            conn.close()

    def _write_result(self, conn: _Conn, uri: str, value: Any) -> None:
        """One result write. A replica lets only the FIRST answer per uri
        land — the broker's HSETNX tombstones make a slow-not-dead
        replica's duplicate answer for a requeued request a counted no-op."""
        if self.replica_id is not None:
            if conn.call("HSETNX", RESULT_PREFIX + uri, value) == 0:
                _DUP_RESULTS.inc()
        else:
            conn.call("HSET", RESULT_PREFIX + uri, value)

    # ----------------------------------------------------------------- control

    def _warm_model(self) -> None:
        """Startup warmup: int8 packing and, when the config names an input
        shape, one predict per bucket of the ladder happen HERE, not on the
        first request; the costs land in ``compile_stats``
        (``quantize_seconds``, ``compiles``).

        With ``config.graph_checks`` ("warn" default / "raise"), the
        warm-up also runs the ``fused-int8-dispatch`` rule and the memory
        tier (``hbm-budget`` under ``hbm_budget_mb``, ``peak-temporary``)
        over the dispatch the engine is about to serve, so a quantized
        model whose kernels are not dispatching is caught at model LOAD.
        The rules need an input shape, so they run only when
        ``warmup_shape`` is set."""
        if self.config.int8 and not self.model.is_quantized:
            self.model.quantize_int8()
        checks = getattr(self.config, "graph_checks", "warn")
        shape = getattr(self.config, "warmup_shape", None)
        if shape and hasattr(self.model, "warm_up"):
            sample = np.zeros((1,) + tuple(int(d) for d in shape),
                              np.float32)
            try:
                self.model.warm_up(sample)
            except Exception:
                logger.exception("warmup predict failed (shape=%s); the "
                                 "first real request will run it instead",
                                 shape)
            budget_mb = getattr(self.config, "hbm_budget_mb", None)
            for name, kw in (("check_fused_dispatch", {}),
                             ("check_memory", {
                                 "budget_bytes": int(budget_mb * 2 ** 20)
                                 if budget_mb else None})):
                if not hasattr(self.model, name):
                    continue
                try:
                    self.graph_findings += getattr(self.model, name)(
                        sample, mode=checks, **kw)
                except Exception:
                    # a lint VERDICT fails start() in "raise" mode
                    # (GraphLintError from the check itself); a trace that
                    # fails in "warn" mode is tolerated like a failed
                    # warm-up predict: log and serve
                    if checks == "raise":
                        raise
                    logger.exception("%s failed (shape=%s); serving anyway",
                                     name, shape)
        elif self.config.int8 and checks and checks != "off":
            logger.info("graph_checks: no warmup_shape configured — the "
                        "int8 dispatch checks need an input shape and are "
                        "skipped")

    def _spawn_infer_worker(self, widx: int) -> threading.Thread:
        t = threading.Thread(target=self._infer_loop, args=(widx,),
                             daemon=True, name=f"serving-infer-{widx}")
        self._infer_threads[widx] = t
        t.start()
        return t

    def _supervise_loop(self):
        """Respawn dead model workers (the Flink task-restart analog). A
        worker whose thread died — chaos kill, OOM in user code — comes back
        in the same slot; its half-processed batch was re-queued unacked, so
        the respawned worker (or a surviving peer) re-delivers it."""
        while not self._stop.is_set():
            for widx, t in list(self._infer_threads.items()):
                if not t.is_alive() and not self._stop.is_set():
                    logger.warning("respawning dead infer worker %d", widx)
                    self.workers_respawned += 1
                    _RESPAWNS.inc()
                    self._spawn_infer_worker(widx)
            self._stop.wait(0.05)

    def start(self) -> "ClusterServing":
        """Start the pipeline (non-blocking; threads are daemons)."""
        self._stop.clear()
        self._draining.clear()
        self._killed.clear()
        self._warm_model()
        # Register the consumer group before consuming. On the SHARED client
        # stream the group starts at the TAIL (FlinkRedisSource.scala:44
        # xgroupCreate parity): a fresh job sees only traffic from now on; a
        # restarted job (same group) resumes its preserved cursor. A fleet
        # replica's dispatch stream is PRIVATE to this replica, and the
        # router may forward to it before this call lands (model load /
        # compile on spawn, or the respawn window after a failover XTRANSFER
        # deleted the stream + cursor) — tail semantics would silently skip
        # those already-acked-at-origin entries, so fleet groups replay from
        # '0' instead.
        conn = self._connect("engine.control")
        try:
            conn.call("XGROUPCREATE", self.stream, self.group,
                      "0" if self.replica_id is not None else "$")
        except RetryAbortedError:
            pass
        finally:
            conn.close()
        loops = [("source", self._source_loop),
                 ("sink", self._sink_loop),
                 ("supervisor", self._supervise_loop)]
        if self.replica_id is not None:
            loops.append(("fleet-hb", self._fleet_heartbeat_loop))
        elif getattr(self.config, "hot_swap", True) \
                and self.swapper.supported():
            # single-engine hot-swap: consume the trainer's publish stream
            # directly (fleet replicas get swap commands from the
            # RolloutController via the control hash instead)
            loops.append(("swap-listener", self._swap_listener_loop))
        for name, fn in loops:
            t = threading.Thread(target=fn, daemon=True, name=f"serving-{name}")
            t.start()
            self._threads.append(t)
        for widx in range(max(1, self.config.infer_workers)):
            self._threads.append(self._spawn_infer_worker(widx))
        return self

    # --------------------------------------------------------------- hot-swap

    @property
    def model_version(self) -> str:
        """The version id every response is tagged with: the hot-swapped
        checkpoint version, or ``"initial"`` for the boot params."""
        return getattr(self.model, "version", None) or "initial"

    def _run_swap(self, record: Dict[str, Any]) -> None:
        """Stage + swap one published version (worker thread — staging is
        OFF the hot path; only the reference flip holds the dispatch gate).
        A chaos kill inside staging is replica death mid-swap: the whole
        engine goes silent so the supervisor respawns it (and the rollout
        reconciler brings the respawn back to the correct version)."""
        if record.get("rollback"):
            self._swap_state = "staging"
            self._swap_error = None
            try:
                self.swapper.rollback()
                self._swap_state = "ok"
            except Exception as e:
                self._swap_state = "error"
                self._swap_error = f"rollback failed: {e!r}"
                logger.exception("model rollback failed")
            return
        self._swap_state = "staging"
        self._swap_error = None
        try:
            self.swapper.stage_and_swap(record,
                                        force=bool(record.get("force")))
            self._swap_state = "ok"
        except SwapRejected as e:
            self._swap_state = "error"
            self._swap_error = f"{e.reason}: {e}"
            logger.warning("model swap rejected (%s): %s", e.reason, e)
        except WorkerKilled:
            logger.warning("replica killed mid-swap (chaos)")
            self.kill()
        except Exception as e:
            self._swap_state = "error"
            self._swap_error = f"swap failed: {e!r}"
            logger.exception("model swap failed")

    def _handle_swap_command(self, swap: Dict[str, Any]) -> None:
        """One swap command from the control hash (deduped by nonce); runs
        on a dedicated thread so heartbeats keep flowing while staging. The
        nonce is published back in the heartbeat so the controller can scope
        ``swap_state``/``swap_error`` to ITS command — a stale error from a
        previously rejected version must not fail a later good rollout."""
        nonce = swap.get("nonce")
        if nonce == self._swap_nonce_seen:
            return
        if self._swap_thread is not None and self._swap_thread.is_alive():
            return          # staging busy: the command re-arrives next poll
        self._swap_nonce_seen = nonce
        self._swap_state = "staging"
        self._swap_error = None
        self._swap_thread = threading.Thread(
            target=self._run_swap, args=(dict(swap),), daemon=True,
            name="serving-swap")
        self._swap_thread.start()

    def _swap_listener_loop(self):
        """Single-engine (non-fleet) hot-swap: consume the trainer's publish
        stream directly and swap on every new version. Group-at-tail plus an
        XLAST catch-up peek — a restarted engine adopts the latest published
        version without replaying (and re-serving) the whole history."""
        conn = self._connect("engine.swap-listener")
        group = f"swap-{self.group}"
        try:
            try:
                conn.call("XGROUPCREATE", MODEL_STREAM, group, "$")
                last = conn.call("XLAST", MODEL_STREAM)
            except RetryAbortedError:
                return
            if last is not None and isinstance(last[1], dict):
                self._run_swap(last[1])
                self._report_rejection(conn, last[1])
            while not self._stop.is_set() and not self._killed.is_set():
                try:
                    entries = conn.call("XREADGROUP", MODEL_STREAM, group,
                                        1, 200)
                except RetryAbortedError:
                    break
                for entry_id, record in entries or ():
                    if isinstance(record, dict):
                        self._run_swap(record)
                        self._report_rejection(conn, record)
                    try:
                        conn.call("XACK", MODEL_STREAM, group, [entry_id])
                    except RetryAbortedError:
                        return
        finally:
            conn.close()

    def _report_rejection(self, conn: _Conn, record: Dict[str, Any]) -> None:
        """Single-engine mode has no RolloutController; a rejected publish
        still trips the rejection stream so the trainer sees it."""
        if self._swap_state != "error":
            return
        from .hotswap import MODEL_REJECT_STREAM

        try:
            conn.call("XADD", MODEL_REJECT_STREAM,
                      {"version": record.get("version"),
                       "step": record.get("step"),
                       "reason": self._swap_error,
                       "outcome": "rejected", "ts": time.time()})
        except Exception:
            logger.exception("rejection record write failed")

    # ------------------------------------------------------------- fleet mode

    def state(self) -> str:
        """Replica lifecycle state published in the fleet heartbeat:
        ``up`` → ``draining`` (drain requested, in-flight work finishing) →
        ``drained`` (nothing left; safe to stop/deregister)."""
        if self._draining.is_set():
            return "drained" if not self._busy() else "draining"
        return "up"

    def _busy(self) -> bool:
        with self._inflight_lock:
            inflight = self._inflight
        return inflight > 0 or not (self._infer_q.empty()
                                    and self._sink_q.empty())

    def drain(self) -> None:
        """Stop accepting (claiming) new requests; keep processing + acking
        what is already in flight. ``state()`` reaches ``drained`` once the
        pipeline is empty — the graceful half of a rolling restart."""
        self._draining.set()

    def drained(self) -> bool:
        return self._draining.is_set() and not self._busy()

    def kill(self) -> None:
        """Hard replica death (chaos drills, supervisor force-respawn): all
        loops exit at their next check; nothing further is sunk or acked, so
        every claimed-but-unacked request stays pending on the broker for
        the fleet's claim-transfer requeue (or, outside a fleet, for the next
        reader after ``reclaim_idle_ms``). The in-process analog of
        ``SIGKILL`` on a replica process."""
        self._killed.set()
        self._stop.set()

    def _fleet_heartbeat_loop(self):
        """Replica presence on the broker: periodically HSET
        ``fleet:hb:<replica_id>`` with a wall-clock timestamp, lifecycle
        state, and progress counters (the router's half-open probe readmission
        watches ``served`` advance), and poll ``fleet:ctl:<replica_id>`` for
        drain commands. A killed/crashed replica simply stops beating — the
        supervisor detects staleness, requeues its claimed work, respawns."""
        conn = self._connect("engine.fleet-hb")
        interval = max(0.05, float(
            getattr(self.config, "fleet_heartbeat_s", 0.5)))
        ctl_seen: Any = None
        try:
            while not self._stop.is_set() and not self._killed.is_set():
                try:
                    conn.call("HSET", FLEET_HB_PREFIX + self.replica_id,
                              {"ts": time.time(), "state": self.state(),
                               "pid": os.getpid(), "served": self.served,
                               "inflight": self._infer_q.qsize(),
                               "errors": self.errors,
                               "lat_ms": round(self._lat_ema_s * 1e3, 3),
                               "svc_ms": round(self._svc_ema.value() * 1e3,
                                               3),
                               "model_version": self.model_version,
                               "swap_state": self._swap_state,
                               "swap_error": self._swap_error,
                               "swap_nonce": self._swap_nonce_seen})
                    ctl = conn.call("HGET",
                                    FLEET_CTL_PREFIX + self.replica_id, 0)
                except RetryAbortedError:
                    break
                if isinstance(ctl, dict) and ctl != ctl_seen:
                    ctl_seen = ctl
                    if ctl.get("state") == "drain":
                        self.drain()
                if isinstance(ctl, dict) and isinstance(ctl.get("swap"),
                                                        dict):
                    # swap commands are nonce-deduped (NOT ctl_seen-deduped:
                    # a busy staging thread defers the command to the next
                    # poll instead of dropping it)
                    self._handle_swap_command(ctl["swap"])
                self._stop.wait(interval)
            # deliberate shutdown (not kill): publish a terminal state so the
            # supervisor can tell "stopped on purpose" from "went silent"
            if not self._killed.is_set():
                try:
                    conn.call("HSET", FLEET_HB_PREFIX + self.replica_id,
                              {"ts": time.time(), "state": "stopped",
                               "pid": os.getpid(), "served": self.served,
                               "inflight": 0})
                except Exception:
                    pass
        finally:
            conn.close()

    def stats(self) -> Dict[str, Any]:
        """Engine-side observability: records served, worker respawns, the
        swap state, and the model's per-bucket counters (``compiles`` flat
        under traffic: no new batch shape mid-stream), the warm-up's
        ``graph_checks`` mode and its finding count."""
        out: Dict[str, Any] = {"served": self.served,
                               "errors": self.errors,
                               "workers_respawned": self.workers_respawned,
                               "model_version": self.model_version,
                               "swap_state": self._swap_state,
                               "graph_checks": getattr(
                                   self.config, "graph_checks", "warn"),
                               "graph_findings": len(self.graph_findings)}
        if self._swap_error:
            out["swap_error"] = self._swap_error
        if hasattr(self.model, "compile_stats"):
            out.update(self.model.compile_stats())
        return out

    def run(self):  # pragma: no cover - interactive entry (ClusterServing.run)
        self.start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self.stop()

    def stop(self, drain_s: float = 1.0):
        deadline = time.time() + drain_s
        # queued OR currently inside predict (between queues)
        while time.time() < deadline and self._busy():
            time.sleep(0.01)
        self._stop.set()
        # _infer_threads may hold respawned workers not in _threads
        for t in list(self._threads) + list(self._infer_threads.values()):
            t.join(timeout=2.0)
        self._threads.clear()
        self._infer_threads.clear()
        if self.summary is not None:
            self.summary.close()
