"""Cross-request micro-batching for the HTTP serving path (port of
``analytics_zoo_tpu/serving/batching.py``, which needs no JAX: ordering,
shedding and bucket choice are the same pure Python; ``predict_fn`` is the
port's ``InferenceModel.predict``, which returns host numpy arrays).

Parity: the reference HTTP frontend rides an actor pipeline that coalesces
concurrent requests into Redis-stream batches consumed ``coreNum`` at a time
(serving/http/FrontEndApp.scala:45, engine/FlinkInference.scala:28-62). Here
the same effect is in-process: every request thread submits its tensors and
blocks; one batcher thread drains the queue up to ``max_batch`` (waiting at
most ``max_delay_ms`` for stragglers), stacks compatible records into ONE
device batch, and fans results back out. The model therefore sees a large
batch even when every client sends batch-1 requests.

Shape bucketing: a drained group's size depends on traffic timing, so raw
group sizes would give the model a new shape per size (an executable each in
the JAX package; a new kernel shape, and so its own K5/K6 grid, here). With ``bucket_pad`` (default)
every stacked batch is zero-padded up to the nearest power-of-two bucket
(capped at ``max_batch``) before ``predict_fn`` and the pad rows discarded on
fan-out, so at most ``log2(max_batch)+1`` distinct batch shapes ever reach
the engine and mid-traffic dispatch is a compiled-cache dict lookup.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.locks import traced_lock
from . import qos as _qos

_B_RECORDS = _tm.counter("zoo_batch_records_total",
                         "Records submitted to micro-batchers")
_B_RUNS = _tm.counter("zoo_batch_runs_total",
                      "Micro-batches dispatched to predict_fn")
_B_PADDED = _tm.counter("zoo_batch_padded_rows_total",
                        "Zero-pad rows added to reach a bucket size")
_B_CANCELLED = _tm.counter("zoo_batch_cancelled_total",
                           "Queued records dropped because their waiter "
                           "timed out/cancelled before the batcher ran them")
_B_SHED = _tm.counter("zoo_batch_shed_total",
                      "Queued records shed by the micro-batcher instead of "
                      "served, by overload class",
                      labels=("reason",))
_B_SIZE = _tm.histogram("zoo_batch_size",
                        "Records coalesced per micro-batch",
                        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_LIVE_BATCHERS: "weakref.WeakSet[MicroBatcher]" = weakref.WeakSet()
_tm.collector("zoo_batch_queue_depth",
              "Live queue depth (incl. the priority backlog) summed over "
              "this process's micro-batchers",
              lambda: [((), float(sum(b._q.qsize() + len(b._backlog)
                                      for b in list(_LIVE_BATCHERS))))])


class _Slot:
    __slots__ = ("tensors", "event", "result", "error", "cancelled",
                 "priority", "deadline", "seq")

    def __init__(self, tensors, priority=None, deadline=None, seq=0):
        self.tensors = tensors
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        # set by a timed-out/abandoning waiter: the batcher must DROP this
        # slot instead of computing it into a later batch (nobody is waiting;
        # the work and its batch space would be pure waste)
        self.cancelled = False
        # overload QoS (serving/qos.py): eligible records run in
        # (priority, deadline) order; records that provably cannot meet
        # their deadline are shed before predict_fn ever sees them
        self.priority = _qos.normalize_priority(priority)
        self.deadline = _qos.normalize_deadline(deadline)
        self.seq = seq

    @property
    def order_key(self) -> Tuple:
        return _qos.order_key(self.priority, self.deadline, self.seq)


class MicroBatcher:
    """Batch concurrent ``submit()`` calls into single ``predict_fn`` calls.

    ``predict_fn(x)`` receives a stacked array (or list of arrays for
    multi-input records) with a leading batch dim and must return array(s)
    with the same leading dim.
    """

    def __init__(self, predict_fn: Callable, max_batch: int = 32,
                 max_delay_ms: float = 2.0, bucket_pad: bool = True):
        self.predict_fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.bucket_pad = bucket_pad
        self._q: "queue.Queue[_Slot]" = queue.Queue()
        self._stop = threading.Event()
        # observability: batching efficiency for /metrics and the bench
        # (bounded — this object lives as long as the server process)
        import collections

        self.records_in = 0
        self.batches_run = 0
        self.max_batch_seen = 0
        self.batch_sizes = collections.deque(maxlen=1000)
        self.padded_rows = 0
        self.cancelled_drops = 0
        self.shed_records = 0
        # (priority, deadline)-ordered staging area between the submit queue
        # and the next wave; owned by the batcher thread (stats only reads
        # its len)
        self._backlog: List[_Slot] = []
        self._seq = 0
        # zoo-lock: guards(_seq)
        self._seq_lock = traced_lock("MicroBatcher._seq_lock")
        # measured per-BATCH service time: the evidence behind every
        # "provably cannot meet its deadline" shed and the computed
        # Retry-After handed back to the waiter
        self.service_ema = _qos.ServiceTimeEMA()
        # every (bucket, per-record signature) that reached predict_fn: with
        # bucket_pad this stays <= len(buckets) per tensor signature, which is
        # exactly the "no mid-traffic recompile" property /metrics watches
        self.batch_shapes_seen = set()
        _LIVE_BATCHERS.add(self)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-microbatcher")
        self._thread.start()

    # ------------------------------------------------------------------ client
    def submit_async(self, tensors: Dict[str, np.ndarray],
                     priority: Optional[str] = None,
                     deadline: Optional[float] = None) -> _Slot:
        """Enqueue a record; pair with :meth:`wait`. Submitting all records of
        a request before waiting lets them share one batch. ``priority``
        (critical/normal/bulk) and ``deadline`` (absolute epoch seconds)
        order eligible work and arm deadline shedding — a record the batcher
        provably cannot serve in time fails fast with
        :class:`~.qos.ShedError` instead of burning batch space."""
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        slot = _Slot(tensors, priority=priority, deadline=deadline, seq=seq)
        self._q.put(slot)
        return slot

    @staticmethod
    def wait(slot: _Slot, timeout_s: float = 30.0):
        if not slot.event.wait(timeout_s):
            # mark-then-recheck: the batcher may have completed the slot
            # between the wait expiring and the flag landing — in that case
            # the result is good and the cancel must not stand. A slot that
            # stays cancelled is dropped at drain time instead of being
            # silently computed into a later batch (the timeout leak).
            slot.cancelled = True
            if not slot.event.is_set():
                raise TimeoutError("micro-batch prediction timed out")
            slot.cancelled = False
        if slot.error is not None:
            raise slot.error
        return slot.result

    def submit(self, tensors: Dict[str, np.ndarray], timeout_s: float = 30.0):
        """Block until the batcher has run this record; returns the result."""
        return self.wait(self.submit_async(tensors), timeout_s)

    # ----------------------------------------------------------------- batcher
    @staticmethod
    def _signature(tensors: Dict[str, np.ndarray]) -> Tuple:
        # preserve the caller's key order — multi-input models bind
        # positionally in their declared input order, so reordering keys
        # (e.g. sorting) would silently swap inputs
        return tuple((k, v.shape, str(v.dtype)) for k, v in tensors.items())

    def _fill_backlog(self) -> bool:
        """Move queued submissions into the priority backlog: one blocking
        get when the backlog is empty, a bounded straggler window while a
        wave is still short, then everything else non-blocking — so the
        ordering/shed pass below always sees the WHOLE queued population,
        not a FIFO prefix of it."""
        if not self._backlog:
            try:
                self._backlog.append(self._q.get(timeout=0.1))
            except queue.Empty:
                return False
        deadline = time.monotonic() + self.max_delay_s
        while len(self._backlog) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                self._backlog.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        while True:        # opportunistic: order across the full backlog
            try:
                self._backlog.append(self._q.get_nowait())
            except queue.Empty:
                break
        return True

    def _order_and_shed(self) -> None:
        """Sort the backlog by ``(priority, deadline)``, drop cancelled
        slots, and shed every record that provably cannot meet its deadline
        — estimated wait is its position's wave count × the measured batch
        service time — answering the waiter with a computed Retry-After
        BEFORE any batch space or device time is spent on it."""
        ema = self.service_ema.value()
        now = time.time()
        depth = len(self._backlog)
        keep: List[_Slot] = []
        for s in sorted(self._backlog, key=lambda s: s.order_key):
            if s.cancelled:
                self.cancelled_drops += 1
                _B_CANCELLED.inc()
                # error BEFORE event: a waiter racing its own timeout
                # recheck must see a raised error, never result=None
                s.error = TimeoutError(
                    "record dropped: waiter timed out before the "
                    "batcher ran it")
                s.event.set()
                continue
            waves_ahead = len(keep) // self.max_batch
            if _qos.cannot_meet(s.deadline, waves_ahead * ema, ema, now=now):
                chaos_point("overload.shed", tag="batcher")
                self.shed_records += 1
                _B_SHED.labels(reason="deadline").inc()
                s.error = _qos.ShedError(
                    f"deadline cannot be met (est wait "
                    f"{waves_ahead * ema + ema:.3f}s)",
                    retry_after_s=_qos.retry_after_s(depth, ema),
                    reason="deadline")
                s.event.set()
                continue
            keep.append(s)
        self._backlog = keep

    def _loop(self):
        while not self._stop.is_set():
            if not self._fill_backlog():
                continue
            self._order_and_shed()
            wave = self._backlog[:self.max_batch]
            del self._backlog[:len(wave)]
            if not wave:
                continue
            # group by tensor signature — only same-shaped records stack
            groups: Dict[Tuple, List[_Slot]] = {}
            for s in wave:
                groups.setdefault(self._signature(s.tensors), []).append(s)
            for group in groups.values():
                self._run_group(group)

    def _bucket(self, n: int) -> int:
        """Nearest power-of-two at or above ``n``, capped at ``max_batch``."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _run_group(self, group: List[_Slot]):
        k = len(group)
        self.records_in += k
        self.batches_run += 1
        self.max_batch_seen = max(self.max_batch_seen, k)
        self.batch_sizes.append(k)
        _B_RECORDS.inc(k)
        _B_RUNS.inc()
        _B_SIZE.observe(k)
        try:
            names = list(group[0].tensors)
            arrays = [np.stack([s.tensors[n] for s in group]) for n in names]
            bucket = self._bucket(k) if self.bucket_pad else k
            if bucket > k:
                arrays = [np.pad(a, [(0, bucket - k)] + [(0, 0)] * (a.ndim - 1))
                          for a in arrays]
                self.padded_rows += bucket - k
                _B_PADDED.inc(bucket - k)
            self.batch_shapes_seen.add(
                tuple((bucket,) + a.shape[1:] + (str(a.dtype),)
                      for a in arrays))
            x = arrays[0] if len(arrays) == 1 else arrays
            t0 = time.monotonic()
            y = self.predict_fn(x)
            self.service_ema.observe(time.monotonic() - t0)
            # pad rows (indices >= k) are simply never fanned back out
            if isinstance(y, (list, tuple)):
                for i, s in enumerate(group):
                    s.result = [np.asarray(o[i]) for o in y]
                    s.event.set()
            else:
                y = np.asarray(y)
                for i, s in enumerate(group):
                    s.result = y[i]
                    s.event.set()
        except Exception as e:
            for s in group:
                s.error = e
                s.event.set()

    # ------------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        sizes = list(self.batch_sizes)
        return {
            "records": self.records_in,
            "batches": self.batches_run,
            "mean_batch_size": (float(np.mean(sizes)) if sizes else 0.0),
            "max_batch_size": self.max_batch_seen,
            "queue_depth": self._q.qsize() + len(self._backlog),
            "padded_rows": self.padded_rows,
            "cancelled_drops": self.cancelled_drops,
            "shed_records": self.shed_records,
            "service_ema_s": round(self.service_ema.value(), 6),
            "distinct_batch_shapes": len(self.batch_shapes_seen),
        }

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        # fail queued-but-never-run slots (incl. the ordered backlog)
        # immediately rather than leaving their waiters blocked until timeout
        backlog, self._backlog = self._backlog, []
        for slot in backlog:
            slot.error = RuntimeError("MicroBatcher closed before this "
                                      "record was served")
            slot.event.set()
        while True:
            try:
                slot = self._q.get_nowait()
            except queue.Empty:
                break
            slot.error = RuntimeError("MicroBatcher closed before this "
                                      "record was served")
            slot.event.set()
