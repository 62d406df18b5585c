"""QueueBroker — a self-contained stream broker (the Redis-streams equivalent;
port of ``analytics_zoo_tpu/serving/broker.py``, which needs no JAX: a copy,
so either package's clients talk to either package's broker, and each
replays the other's append-only file).

Parity: the reference fronts serving with Redis: clients ``XADD`` requests onto a
stream, the Flink source consumes via a consumer group (``xgroupCreate`` +
``xreadGroup`` — the reference's ``serving/engine/FlinkRedisSource.scala``:
44-59), and results land in per-request hashes read by ``OutputQueue``
(client.py:277-300). This broker provides exactly those primitives over the
versioned wire protocol of wire.py — tensor-bearing payloads ride binary
zero-copy frames (raw buffers read with ``recv_into``, optionally through a
negotiated same-host shared-memory ring), control messages stay
length-prefixed JSON, and both interoperate on one connection
(docs/serving_protocol.md):

    XADD stream payload              -> id
    XREADGROUP stream group n block  -> [(id, payload), ...]   (each entry to ONE consumer)
    HSET key mapping / HGET key / HDEL key
    LEN stream / PING / SHUTDOWN / INFO
    SHMOPEN name size                -> "OK"    (same-host zero-copy rings)

It runs in-process (``start_broker()`` returns a served port) or standalone
(``python -m analytics_zoo_tpu_torch.serving.broker --port 6380``).

Durability (the reference's Redis-persistence + consumer-group recovery story —
FlinkRedisSource.scala:44-59 resumes its group cursor after a job restart, and
``scripts/cluster-serving/cluster-serving-restart`` bounces the service): pass
``aof_path`` and every mutation is appended as a JSON line and fsync'd before
the client sees the ack. On startup the log is replayed, so acknowledged
requests and results survive a broker kill. Delivered-but-unacknowledged
entries (tracked in a per-group pending list, Redis PEL semantics — consumers
``XACK`` after writing results) are re-delivered ahead of new traffic after a
crash restart. ``python -m analytics_zoo_tpu_torch.serving.cli restart``
is the cluster-serving-restart equivalent.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..common import telemetry as _tm
from ..common.locks import traced_lock
from .schema import (DEADLINE_KEY, MODEL_VERSION_KEY, PRIORITY_KEY,
                     json_default, json_revive, payload_trace)
# wire-protocol primitives live in wire.py; re-exported here because the
# historical import surface for the framing helpers is this module
from .wire import (MAX_MSG, VERSION as WIRE_VERSION,  # noqa: F401
                   _recv_exact, received_model_version, received_qos,
                   received_trace_context, recv_msg, send_msg,
                   set_wire_model_version, wire_stats)

_KNOWN_CMDS = frozenset({"XADD", "XGROUPCREATE", "XREADGROUP", "XREAD",
                         "XLAST", "XDELSTREAM", "XTRANSFER", "XACK", "HSET",
                         "HSETNX", "HGET", "HDEL", "LEN", "PING", "SHMOPEN",
                         "INFO", "SHUTDOWN"})
# unknown verbs collapse to one label value: client-supplied strings must not
# mint unbounded counter children in the process-wide registry
_CMDS = _tm.counter("zoo_broker_commands_total",
                    "Broker commands handled, by verb", labels=("cmd",))
_AOF_REPLAYED = _tm.counter(
    "zoo_broker_aof_replayed_records_total",
    "AOF records replayed at broker startup, by record op", labels=("op",))
_SHM_NEG = _tm.counter(
    "zoo_broker_shm_negotiations_total",
    "SHMOPEN ring negotiations, by outcome (fallback/denied = connection "
    "stays socket-only; denied = host-identity mismatch, a cross-host or "
    "containerized peer)", labels=("outcome",))
_AOF_COMPACT = _tm.counter(
    "zoo_broker_aof_compactions_total",
    "AOF compactions (live-state rewrite + atomic rename) triggered by the "
    "op-count or size threshold after startup")
_DUP_DROPPED = _tm.counter(
    "zoo_fleet_duplicate_results_total",
    "HSETNX writes dropped because the key was already answered (a slow-not-"
    "dead replica double-answering a requeued request)")


class _Store:
    """Streams (bounded lists w/ per-group cursors) + hashes, one lock.

    Streams are trimmed like Redis ``XADD MAXLEN ~``: beyond ``maxlen`` entries
    the oldest are dropped and every group cursor shifts accordingly, so a
    long-running deployment holds bounded memory.
    """

    ANSWERED_MAXLEN = 65536   # dedup-tombstone LRU bound (see hsetnx)

    def __init__(self, maxlen: int = 65536, aof_path: Optional[str] = None,
                 reclaim_idle_ms: int = 60_000,
                 aof_rewrite_min_bytes: int = 64 << 20):
        # every store structure mutates under the condition below (over this
        # lock); _log/fsync-under-lock is the durability contract (fsync
        # before the client sees the ack)
        # zoo-lock: guards(streams, cursors, hashes, pending)
        # zoo-lock: guards(redeliver, deliveries, trimmed, _answered)
        self.lock = traced_lock("_Store.lock")
        self.cond = threading.Condition(self.lock)
        self.maxlen = maxlen
        # size-triggered compaction floor: once the log grows past this, the
        # next mutation rewrites live state to a fresh file (long-running
        # fleet brokers must not replay days of dead records on restart)
        self.aof_rewrite_min_bytes = aof_rewrite_min_bytes
        # delivered entries idle (unacked) past this are re-delivered to the
        # next reader — XAUTOCLAIM semantics, so a consumer that died with
        # in-flight work doesn't strand it until a broker restart
        self.reclaim_idle_ms = reclaim_idle_ms
        self.streams: Dict[str, List[Tuple[str, Any]]] = collections.defaultdict(list)
        self.cursors: Dict[Tuple[str, str], int] = collections.defaultdict(int)
        self.trimmed: Dict[str, int] = collections.defaultdict(int)
        self.hashes: Dict[str, Any] = {}
        self._seq = 0
        # PEL: delivered-but-unacked entries per (stream, group); ``redeliver``
        # holds entries recovered from the log at startup — served before the
        # cursor so a crash never drops an accepted request
        self.pending: Dict[Tuple[str, str], Dict[str, Any]] = \
            collections.defaultdict(dict)
        self.redeliver: Dict[Tuple[str, str], List[Tuple[str, Any]]] = \
            collections.defaultdict(list)
        # per-request delivery counts for delivered-but-unacked entries
        # (XAUTOCLAIM/XPENDING parity: the fleet requeue verb reports how
        # often each transferred request was already handed out). In-memory
        # only — a broker restart resets counts, redelivery itself is what
        # the AOF "R" records guarantee.
        self.deliveries: Dict[Tuple[str, str], Dict[str, int]] = \
            collections.defaultdict(dict)
        # first-write-wins tombstones for HSETNX: keys ever written (even if
        # HDEL'd since) stay "answered" while inside this bounded LRU, so a
        # slow-not-dead replica's late duplicate result is dropped instead of
        # recreating a hash the client already consumed
        self._answered: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self.compactions = 0      # post-startup AOF rewrites (INFO)
        self._aof = None
        self._aof_path = aof_path
        self._ops_since_rewrite = 0
        self._aof_base_bytes = 0  # snapshot size after the last rewrite
        # replay visibility: counts by record op, surfaced by INFO/`cli info`
        # and mirrored into the shared metric registry
        self.replayed: Dict[str, int] = {}
        if aof_path:
            if os.path.exists(aof_path):
                self._replay(aof_path)
            # compact at startup: replaying history re-runs every trim ever
            # applied; the snapshot keeps restart time bounded by LIVE state
            self._rewrite_locked(startup=True)

    # -- append-only log ------------------------------------------------------
    REWRITE_EVERY_OPS = 200_000

    def _log(self, *rec: Any) -> None:
        """Append one mutation; fsync before the caller acks the client.
        Binary-frame payloads carry raw ndarrays — ``json_default`` tags them
        so they ride the line-JSON log (revived bit-exact on replay)."""
        if self._aof is not None:
            self._aof.write(json.dumps(list(rec), default=json_default) + "\n")
            self._aof.flush()
            os.fsync(self._aof.fileno())
            self._ops_since_rewrite += 1
            # two triggers: op count (bounded replay work) and byte size
            # (bounded disk + restart time for fleet brokers whose dead
            # XDELSTREAM'd records dominate the log). The size trigger is
            # the min-bytes floor AND 2x the post-rewrite snapshot size
            # (Redis auto-aof-rewrite-percentage analog): live state bigger
            # than the floor must not make EVERY op pay a full synchronous
            # rewrite — the log has to actually grow past the snapshot
            if (self._ops_since_rewrite >= self.REWRITE_EVERY_OPS
                    or self._aof.tell() >= max(self.aof_rewrite_min_bytes,
                                               2 * self._aof_base_bytes)):
                self._rewrite_locked()

    def _rewrite_locked(self, startup: bool = False) -> None:
        """Snapshot live state into a fresh log and atomically swap it in
        (Redis BGREWRITEAOF analog, done inline — live state is bounded by
        ``maxlen`` so the rewrite is cheap). Caller holds the lock, or is the
        constructor."""
        if self._aof_path is None:
            return
        tmp = self._aof_path + ".rewrite"
        with open(tmp, "w", encoding="utf-8") as f:
            for stream, entries in self.streams.items():
                # delivered-but-unacked entries already trimmed out of the live
                # window keep their payload in the pending map; persist them as
                # "P" payload-only records (NOT appends — appending them would
                # change stream indices and misalign group cursors if maxlen
                # differs on the next start) so redelivery survives the rewrite
                live = {i for i, _ in entries}
                ghost: Dict[str, Any] = {}
                for (s, _g), ents in self.pending.items():
                    if s == stream:
                        for i, (payload, _ts) in ents.items():
                            if i not in live:
                                ghost[i] = payload
                for i in sorted(ghost, key=lambda e: int(e.split("-")[0])):
                    f.write(json.dumps(["P", stream, i, ghost[i]],
                                       default=json_default) + "\n")
                for entry_id, payload in entries:
                    f.write(json.dumps(["A", stream, entry_id, payload],
                                       default=json_default) + "\n")
            for (stream, group), cur in self.cursors.items():
                f.write(json.dumps(["G", stream, group, 0]) + "\n")
                f.write(json.dumps(["R", stream, group, cur, []]) + "\n")
            for (stream, group), ents in self.pending.items():
                if ents:
                    f.write(json.dumps(["R", stream, group,
                                        self.cursors[(stream, group)],
                                        list(ents)]) + "\n")
            for key, mapping in self.hashes.items():
                f.write(json.dumps(["H", key, mapping],
                                   default=json_default) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if self._aof is not None:
            self._aof.close()
        os.replace(tmp, self._aof_path)
        self._aof = open(self._aof_path, "a", encoding="utf-8")
        self._ops_since_rewrite = 0
        self._aof_base_bytes = self._aof.tell()
        if not startup:   # the startup snapshot is bookkeeping, not a
            self.compactions += 1            # traffic-triggered compaction
            _AOF_COMPACT.inc()

    def _replay(self, path: str) -> None:
        # payloads of replayed appends still possibly needed for redelivery,
        # keyed by id — the live stream trims to maxlen, but a delivered-but-
        # unacked entry must keep its payload even after it overflows out of
        # the stream. Acked ids are pruned (bounding replay memory by the
        # unacked set, not the whole inter-rewrite log); a later lookup for a
        # pruned id falls back to the live stream.
        all_payloads: Dict[str, Dict[str, Any]] = collections.defaultdict(dict)
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json_revive(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn final write from the crash: ignore
                op = rec[0]
                self.replayed[op] = self.replayed.get(op, 0) + 1
                _AOF_REPLAYED.labels(op=op).inc()
                if op == "A":
                    _, stream, entry_id, payload = rec
                    all_payloads[stream][entry_id] = payload
                    self._append(stream, entry_id, payload)
                    self._seq = max(self._seq, int(entry_id.split("-")[0]))
                elif op == "G":
                    self.cursors.setdefault((rec[1], rec[2]), rec[3])
                elif op == "R":
                    _, stream, group, new_cursor, ids = rec
                    key = (stream, group)
                    self.cursors[key] = new_cursor
                    by_id = all_payloads[stream]
                    live_by_id = None
                    for i in ids:
                        payload = by_id.get(i)
                        if payload is None and i not in by_id:
                            # pruned after an earlier ack but still live in
                            # the stream (another group reading it)
                            if live_by_id is None:
                                live_by_id = dict(self.streams[stream])
                            if i not in live_by_id:
                                continue
                            payload = live_by_id[i]
                        # fresh timestamp: the redeliver list below makes
                        # the first post-restart delivery; a stale ts would
                        # ALSO trip the idle-reclaim scan = double delivery
                        self.pending[key][i] = (payload, time.monotonic())
                elif op == "K":
                    _, stream, group, ids = rec
                    key = (stream, group)
                    for i in ids:
                        self.pending[key].pop(i, None)
                        # prune unless another group still holds it pending
                        if not any(i in ents for (s, g), ents
                                   in self.pending.items()
                                   if s == stream and (s, g) != key):
                            all_payloads[stream].pop(i, None)
                elif op == "P":
                    _, stream, entry_id, payload = rec
                    all_payloads[stream][entry_id] = payload
                elif op == "S":
                    stream = rec[1]
                    self.streams.pop(stream, None)
                    self.trimmed.pop(stream, None)
                    all_payloads.pop(stream, None)
                    for key in [k for k in self.cursors if k[0] == stream]:
                        del self.cursors[key]
                    for key in [k for k in self.pending if k[0] == stream]:
                        del self.pending[key]
                elif op == "H":
                    self.hashes[rec[1]] = rec[2]
                    # replayed writes re-arm the dedup tombstone: a duplicate
                    # result arriving after a broker restart is still dropped
                    self._mark_answered(rec[1])
                elif op == "D":
                    self.hashes.pop(rec[1], None)
        # anything still pending was in flight when the broker died: schedule
        # redelivery ahead of new traffic (Redis XAUTOCLAIM-on-restart analog)
        for key, ents in self.pending.items():
            if ents:
                self.redeliver[key] = [
                    (i, payload) for i, (payload, _ts) in sorted(
                        ents.items(), key=lambda kv: int(kv[0].split("-")[0]))]

    def _append(self, stream: str, entry_id: str, payload: Any) -> None:
        entries = self.streams[stream]
        entries.append((entry_id, payload))
        overflow = len(entries) - self.maxlen
        if overflow > 0:
            del entries[:overflow]
            self.trimmed[stream] += overflow
            for key in self.cursors:
                if key[0] == stream:
                    self.cursors[key] = max(0, self.cursors[key] - overflow)

    def xadd(self, stream: str, payload: Any) -> str:
        with self.cond:
            self._seq += 1
            entry_id = f"{self._seq}-0"
            self._append(stream, entry_id, payload)
            self._log("A", stream, entry_id, payload)
            self.cond.notify_all()
            return entry_id

    def xgroupcreate(self, stream: str, group: str, start: str = "$") -> None:
        """Register a consumer group. ``start='$'`` = only entries added after
        this call (Redis tail semantics); ``'0'`` = replay from the beginning.
        No-op when the group exists (cursor preserved across job restarts)."""
        with self.cond:
            key = (stream, group)
            if key not in self.cursors:
                self.cursors[key] = (len(self.streams[stream])
                                     if start == "$" else 0)
                self._log("G", stream, group, self.cursors[key])

    def xreadgroup(self, stream: str, group: str, count: int,
                   block_ms: int) -> List[Tuple[str, Any]]:
        deadline = None if block_ms <= 0 else block_ms / 1e3
        with self.cond:
            key = (stream, group)
            now = time.monotonic()
            out: List[Tuple[str, Any]] = []
            # crash-recovered in-flight entries first (stay pending until XACK)
            redo = self.redeliver.get(key)
            if redo:
                out.extend(redo[:count])
                del redo[:len(out)]
            # then idle unacked entries from a dead/stalled consumer
            # (XAUTOCLAIM semantics)
            if len(out) < count and self.reclaim_idle_ms:
                taken = {i for i, _ in out}
                for i, (payload, ts) in self.pending[key].items():
                    if len(out) >= count:
                        break
                    # `taken` guards replay double-entries: an entry served
                    # from the redeliver queue above is still in pending with
                    # its pre-serve timestamp until this call commits, so the
                    # idle scan could otherwise pick it a second time
                    if i not in taken and (now - ts) * 1e3 >= self.reclaim_idle_ms:
                        out.append((i, payload))
                        taken.add(i)

            def fresh():
                return len(self.streams[stream]) - self.cursors[key]

            if not out and fresh() == 0 and deadline:
                self.cond.wait(timeout=deadline)
            take = min(count - len(out), fresh())
            if take > 0:
                start = self.cursors[key]
                self.cursors[key] = start + take
                out.extend(self.streams[stream][start:start + take])
            if out:
                dv = self.deliveries[key]
                for i, payload in out:
                    self.pending[key][i] = (payload, now)
                    dv[i] = dv.get(i, 0) + 1
                self._log("R", stream, group, self.cursors[key],
                          [i for i, _ in out])
            return out

    def xread(self, stream: str, cursor: int, count: int,
              block_ms: int) -> Tuple[int, List[Tuple[str, Any]]]:
        """Plain cursor read (no group, no pending-entry tracking): entries
        after absolute index ``cursor``, blocking up to ``block_ms`` for new
        ones. The generation streaming path fans token-delta frames out with
        this — every reader sees every frame, cursors are client-state, and
        nothing is logged (reads mutate nothing). ``cursor`` is an absolute
        per-stream index (monotonic across trims); returns
        ``(next_cursor, entries)``."""
        deadline = None if block_ms <= 0 else block_ms / 1e3
        with self.cond:
            cursor = max(int(cursor), 0)

            # .get()-based reads: polling a not-yet-written (or deleted)
            # stream must not mint defaultdict entries that outlive it
            def avail() -> int:
                return (self.trimmed.get(stream, 0)
                        + len(self.streams.get(stream, ())) - cursor)

            if avail() <= 0 and deadline:
                self.cond.wait_for(lambda: avail() > 0, timeout=deadline)
            # entries the cursor points at that were already trimmed away are
            # skipped (the reader was too slow for the retention window)
            trimmed = self.trimmed.get(stream, 0)
            start = max(0, cursor - trimmed)
            out = self.streams.get(stream, [])[start:start + count]
            next_cursor = trimmed + start + len(out)
            return next_cursor, list(out)

    def xlast(self, stream: str) -> Optional[Tuple[str, Any]]:
        """The newest live entry of ``stream`` (or None). The catch-up peek
        for tail ('$') consumer groups: a model-update subscriber starting
        after the trainer already published sees the LATEST version without
        replaying (and re-deploying) the whole publish history."""
        with self.cond:
            entries = self.streams.get(stream)
            return tuple(entries[-1]) if entries else None

    def sdel(self, stream: str) -> None:
        """Delete a whole stream and every per-group cursor/pending record
        attached to it (the generation path's per-request ``genout:*``
        streams are deleted by their consumer after the final frame — the
        streaming twin of result-hash HDEL, keeping long-running broker
        state bounded by LIVE requests)."""
        with self.cond:
            self._sdel_locked(stream)

    def _sdel_locked(self, stream: str) -> None:
        existed = stream in self.streams
        self.streams.pop(stream, None)
        self.trimmed.pop(stream, None)
        for key in [k for k in self.cursors if k[0] == stream]:
            del self.cursors[key]
        for key in [k for k in self.pending if k[0] == stream]:
            del self.pending[key]
        for key in [k for k in self.redeliver if k[0] == stream]:
            del self.redeliver[key]
        for key in [k for k in self.deliveries if k[0] == stream]:
            del self.deliveries[key]
        if existed:
            self._log("S", stream)

    def xtransfer(self, src: str, group: str, dst: str) -> Dict[str, Any]:
        """Claim-transfer (the fleet's XAUTOCLAIM analog): atomically move
        every request still owed by ``(src, group)`` — delivered-but-unacked
        entries, crash-recovered redeliveries, and entries never delivered —
        onto ``dst`` as fresh appends, then delete ``src``. Used by the
        FleetSupervisor when a replica dies: its claimed work goes back to
        the dispatch stream instead of stranding until idle-reclaim.

        Per-entry delivery counts ride along: dict payloads are stamped with
        ``__deliveries__`` (how often the entry was already handed to a
        consumer) and the reply carries ``(new_id, deliveries)`` pairs. The
        guarantee is at-least-once — a slow-not-dead replica may still finish
        the work it claimed; result writes go through :meth:`hsetnx` so only
        the first answer per uri lands (dedup-on-uri)."""
        with self.cond:
            if src == dst:
                raise ValueError("xtransfer src and dst must differ")
            key = (src, group)
            moved: "collections.OrderedDict[str, Any]" = \
                collections.OrderedDict()
            for i, (payload, _ts) in sorted(
                    self.pending.get(key, {}).items(),
                    key=lambda kv: int(kv[0].split("-")[0])):
                moved[i] = payload
            for i, payload in self.redeliver.get(key, ()):
                moved.setdefault(i, payload)
            cur = self.cursors.get(key, 0)
            for i, payload in self.streams.get(src, [])[cur:]:
                moved.setdefault(i, payload)
            counts = dict(self.deliveries.get(key, {}))
            # delete src FIRST (logs "S"), then append to dst (logs "A"):
            # replaying that order rebuilds exactly this post-transfer state
            self._sdel_locked(src)
            out = []
            for i, payload in moved.items():
                n = counts.get(i, 0)
                if isinstance(payload, dict):
                    payload = dict(payload)
                    payload["__deliveries__"] = n
                self._seq += 1
                entry_id = f"{self._seq}-0"
                self._append(dst, entry_id, payload)
                self._log("A", dst, entry_id, payload)
                out.append((entry_id, n))
            if out:
                self.cond.notify_all()
            return {"moved": len(out), "entries": out}

    def xack(self, stream: str, group: str, ids: List[str]) -> int:
        with self.cond:
            key = (stream, group)
            n = 0
            dropped = set(ids)
            dv = self.deliveries.get(key)
            for i in ids:
                if self.pending[key].pop(i, None) is not None:
                    n += 1
                if dv:
                    dv.pop(i, None)
            # an entry acked while queued for crash redelivery (its result was
            # written before the crash) must not be served again
            redo = self.redeliver.get(key)
            if redo:
                self.redeliver[key] = [e for e in redo if e[0] not in dropped]
            if n:
                self._log("K", stream, group, list(ids))
            return n

    def _mark_answered(self, key: str) -> None:
        """Record ``key`` in the bounded first-write tombstone LRU."""
        self._answered[key] = None
        self._answered.move_to_end(key)
        while len(self._answered) > self.ANSWERED_MAXLEN:
            self._answered.popitem(last=False)

    def hset(self, key: str, mapping: Any) -> None:
        with self.cond:
            self.hashes[key] = mapping
            self._mark_answered(key)
            self._log("H", key, mapping)
            self.cond.notify_all()

    def hsetnx(self, key: str, mapping: Any) -> int:
        """First-write-wins HSET: refuses (returns 0) when ``key`` is live OR
        was EVER written within the tombstone window — even after the client
        HDEL'd it. This is the fleet's dedup-on-uri primitive: a requeued
        request answered by two replicas (the reassigned one and the slow-
        not-dead original) produces exactly one client-visible result, and
        the late duplicate can't recreate a consumed hash."""
        with self.cond:
            if key in self.hashes or key in self._answered:
                _DUP_DROPPED.inc()
                return 0
            self.hashes[key] = mapping
            self._mark_answered(key)
            self._log("H", key, mapping)
            self.cond.notify_all()
            return 1

    def hget(self, key: str, block_ms: int = 0) -> Any:
        deadline = None if block_ms <= 0 else block_ms / 1e3
        with self.cond:
            if key not in self.hashes and deadline:
                self.cond.wait_for(lambda: key in self.hashes, timeout=deadline)
            return self.hashes.get(key)

    def hdel(self, key: str) -> None:
        with self.cond:
            self.hashes.pop(key, None)
            self._log("D", key)

    def info_counts(self) -> Tuple[Dict[str, int], int, Dict[str, int]]:
        """INFO's store slice, snapshotted under the store lock:
        ``(per-stream live lengths, hash count, AOF replay counts)`` — the
        handler must not reach into the store's guarded dicts directly."""
        with self.cond:
            return ({s: len(e) for s, e in self.streams.items()},
                    len(self.hashes), dict(self.replayed))

    def slen(self, stream: str, group: Optional[str] = None) -> int:
        """Stream depth. With ``group``, counts the work OWED to that
        group's consumer: entries not yet delivered (past the group cursor,
        or queued for crash redelivery) plus delivered-but-unacked (pending)
        ones — the fleet router's least_pending signal (a replica that
        claimed a deep batch and died/stalled still owes it). The raw stream
        list retains delivered-and-acked entries until maxlen-trim, so it
        must NOT be counted wholesale: that would report cumulative dispatch
        history as load and starve replicas whose stream was reset (e.g.
        freshly respawned after an XTRANSFER)."""
        with self.cond:
            n = len(self.streams.get(stream, ()))
            if group is not None:
                key = (stream, group)
                n = max(0, n - self.cursors.get(key, 0))
                # redeliver entries stay in pending until acked; count the
                # union so neither map's stragglers are missed or doubled
                owed = set(self.pending.get(key, ()))
                owed.update(i for i, _ in self.redeliver.get(key, ()))
                n += len(owed)
            return n


# connection-scoped command sentinels (returned by _dispatch, acted on by
# handle() which owns the per-connection state)
_SHMOPEN = object()
_SHUTDOWN = object()


def _stamp_qos(payload: Any) -> Any:
    """Fold frame-header overload-QoS fields ("p"/"dl") into an XADD payload
    that does not already carry the durable twins: a sender that tags only
    the wire header still yields a priority/deadline-attributed record in
    the stream (and through AOF replay / XTRANSFER requeue — the payload is
    the copy that survives)."""
    pri, dl = received_qos()
    if (pri is None and dl is None) or not isinstance(payload, dict):
        return payload
    stamped = None
    if pri is not None and PRIORITY_KEY not in payload:
        stamped = dict(payload)
        stamped[PRIORITY_KEY] = pri
    if dl is not None and DEADLINE_KEY not in payload:
        stamped = dict(payload) if stamped is None else stamped
        stamped[DEADLINE_KEY] = dl
    return payload if stamped is None else stamped


def _stamp_version(payload: Any) -> Any:
    """Fold a frame-header model version ("v") into a hash write whose
    payload does not already carry one: an engine that tags only the wire
    header still yields version-attributed results in the durable store."""
    ver = received_model_version()
    if ver is not None and isinstance(payload, dict) \
            and MODEL_VERSION_KEY not in payload:
        payload = dict(payload)
        payload[MODEL_VERSION_KEY] = ver
    return payload


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        super().setup()
        # reply frames are small and latency-bound (see client.py _connect):
        # Nagle + the client's delayed ACK costs ~40ms per round trip
        try:
            self.request.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def handle(self):
        from ..common.chaos import chaos_point

        store: _Store = self.server.store  # type: ignore[attr-defined]
        shm_ch = None   # per-connection shared-memory ring (client-created)
        try:
            while True:
                req = recv_msg(self.request, shm=shm_ch)
                cmd = req[0]
                verb = (cmd if isinstance(cmd, str) and cmd in _KNOWN_CMDS
                        else "unknown")   # unhashable/garbage cmd must still
                                          # get the unknown-command reply
                _CMDS.labels(cmd=verb).inc()
                self.server.count_command(verb)  # type: ignore[attr-defined]
                # parent the broker-side span on the client's trace: binary
                # frames carry it in the header, JSON XADDs inside the payload
                # dict; commands without one (old clients, polls) skip the
                # span — no orphan traces from XREADGROUP idle loops
                ctx = received_trace_context()
                if ctx is None and cmd == "XADD" and len(req) > 2:
                    ctx = payload_trace(req[2])
                span_cm = (_tm.span("serving.broker.handle", remote=ctx,
                                    cmd=str(cmd)) if ctx is not None
                           else contextlib.nullcontext())
                # deterministic fault site: a "fail" rule severs this client's
                # connection mid-protocol (the except below closes it); a
                # "delay" rule models a slow broker reply
                chaos_point("broker.handle", tag=cmd)
                with span_cm:
                    resp = self._dispatch(cmd, req, store)
                    if resp is _SHMOPEN:
                        # same-host zero-copy negotiation: attach the client's
                        # ring; any failure leaves this connection on the
                        # socket path (client falls back on a non-"OK" reply).
                        # A 4-element SHMOPEN carries the client's host
                        # identity — refuse a peer in another kernel/ipc
                        # namespace BEFORE touching /dev/shm: attach() can
                        # spuriously succeed against a same-named segment in
                        # our namespace that is NOT the client's memory
                        from .shm import ShmChannel, host_identity

                        peer = req[3] if len(req) > 3 else None
                        if peer is not None and peer != host_identity():
                            _SHM_NEG.labels(outcome="denied").inc()
                            self.server.count_shm(  # type: ignore[attr-defined]
                                "denied")
                            resp = {"error": "shm denied: cross-host peer "
                                             f"{peer!r}"}
                        else:
                            try:
                                new_ch = ShmChannel.attach(req[1],
                                                           int(req[2]))
                            except Exception as e:
                                _SHM_NEG.labels(outcome="fallback").inc()
                                self.server.count_shm(  # type: ignore[attr-defined]
                                    "fallback")
                                resp = {"error": f"shm attach failed: {e}"}
                            else:
                                if shm_ch is not None:
                                    shm_ch.close()
                                shm_ch = new_ch
                                _SHM_NEG.labels(outcome="ok").inc()
                                self.server.count_shm(  # type: ignore[attr-defined]
                                    "ok")
                                resp = "OK"
                    elif resp is _SHUTDOWN:
                        send_msg(self.request, "OK")
                        threading.Thread(target=self.server.shutdown,
                                         daemon=True).start()
                        return
                    elif cmd == "INFO":
                        resp["shm_attached"] = shm_ch is not None
                # result-fetch replies re-carry the stored payload's serving
                # model version in the frame header (hot-swap end-to-end
                # tagging: engine header → stored payload → client header)
                set_wire_model_version(
                    resp.get(MODEL_VERSION_KEY)
                    if isinstance(resp, dict) else None)
                send_msg(self.request, resp, shm=shm_ch)
        except (ConnectionError, OSError):
            return
        finally:
            if shm_ch is not None:
                shm_ch.close()

    def _dispatch(self, cmd, req, store: "_Store"):
        """Store-level command handling; connection-scoped commands (SHMOPEN,
        SHUTDOWN) return sentinels for :meth:`handle` to act on."""
        if cmd == "XADD":
            return store.xadd(req[1], _stamp_qos(req[2]))
        if cmd == "XGROUPCREATE":
            store.xgroupcreate(req[1], req[2],
                               req[3] if len(req) > 3 else "$")
            return "OK"
        if cmd == "XREADGROUP":
            return store.xreadgroup(req[1], req[2], req[3], req[4])
        if cmd == "XREAD":
            return store.xread(req[1], req[2], req[3],
                               req[4] if len(req) > 4 else 0)
        if cmd == "XLAST":
            return store.xlast(req[1])
        if cmd == "XDELSTREAM":
            store.sdel(req[1])
            return "OK"
        if cmd == "XTRANSFER":
            return store.xtransfer(req[1], req[2], req[3])
        if cmd == "XACK":
            return store.xack(req[1], req[2], req[3])
        if cmd == "HSET":
            store.hset(req[1], _stamp_version(req[2]))
            return "OK"
        if cmd == "HSETNX":
            return store.hsetnx(req[1], _stamp_version(req[2]))
        if cmd == "HGET":
            return store.hget(req[1], req[2] if len(req) > 2 else 0)
        if cmd == "HDEL":
            store.hdel(req[1])
            return "OK"
        if cmd == "LEN":
            return store.slen(req[1], req[2] if len(req) > 2 else None)
        if cmd == "PING":
            return "PONG"
        if cmd == "SHMOPEN":
            return _SHMOPEN
        if cmd == "INFO":
            streams, n_hashes, replayed = store.info_counts()
            server = self.server  # type: ignore[attr-defined]
            return {"wire_version": WIRE_VERSION,
                    "streams": streams, "hashes": n_hashes,
                    "wire": wire_stats(),
                    # observability satellites: replay + ring-negotiation
                    # visibility, printed verbatim by `cli info`. These are
                    # per-BROKER-INSTANCE counts (like streams/hashes) — the
                    # registry's zoo_broker_* counters aggregate the process
                    "aof_replayed_records": replayed,
                    "aof_compactions": store.compactions,
                    "shm_negotiations": server.shm_counts(),
                    "commands": server.command_counts()}
        if cmd == "SHUTDOWN":
            return _SHUTDOWN
        return {"error": f"unknown command {cmd!r}"}


class QueueBroker(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 aof_path: Optional[str] = None,
                 reclaim_idle_ms: int = 60_000,
                 aof_rewrite_min_bytes: int = 64 << 20):
        super().__init__((host, port), _Handler)
        self.store = _Store(aof_path=aof_path, reclaim_idle_ms=reclaim_idle_ms,
                            aof_rewrite_min_bytes=aof_rewrite_min_bytes)
        # per-instance observability counts for INFO (a process can host
        # several brokers; the registry counters aggregate across them)
        # zoo-lock: guards(_commands, _shm_neg)
        self._counts_lock = traced_lock("QueueBroker._counts_lock")
        self._commands: Dict[str, int] = {}
        self._shm_neg = {"ok": 0, "fallback": 0, "denied": 0}

    def count_command(self, verb: str) -> None:
        with self._counts_lock:
            self._commands[verb] = self._commands.get(verb, 0) + 1

    def count_shm(self, outcome: str) -> None:
        with self._counts_lock:
            self._shm_neg[outcome] = self._shm_neg.get(outcome, 0) + 1

    def command_counts(self) -> Dict[str, int]:
        with self._counts_lock:
            return dict(self._commands)

    def shm_counts(self) -> Dict[str, int]:
        with self._counts_lock:
            return dict(self._shm_neg)

    @property
    def port(self) -> int:
        return self.server_address[1]


def start_broker(host: str = "127.0.0.1", port: int = 0,
                 aof_path: Optional[str] = None) -> QueueBroker:
    """Start a broker on a daemon thread; returns it (``.port`` is bound)."""
    broker = QueueBroker(host, port, aof_path=aof_path)
    threading.Thread(target=broker.serve_forever, daemon=True,
                     name="zoo-queue-broker").start()
    return broker


def main():  # pragma: no cover - exercised as a subprocess
    ap = argparse.ArgumentParser(
        description="analytics_zoo_tpu_torch queue broker")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6380)
    ap.add_argument("--aof", default=None,
                    help="append-only persistence file (replayed on start)")
    ap.add_argument("--reclaim-idle-ms", type=int, default=60_000,
                    help="redeliver entries unacked for this long (XAUTOCLAIM)")
    ap.add_argument("--aof-rewrite-min-bytes", type=int, default=64 << 20,
                    help="compact the AOF (rewrite live state, atomic rename) "
                         "once it grows past this many bytes")
    args = ap.parse_args()
    broker = QueueBroker(args.host, args.port, aof_path=args.aof,
                         reclaim_idle_ms=args.reclaim_idle_ms,
                         aof_rewrite_min_bytes=args.aof_rewrite_min_bytes)
    print(f"queue broker listening on {args.host}:{broker.port}", flush=True)
    broker.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
