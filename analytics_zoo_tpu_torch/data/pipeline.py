"""Asynchronous input pipeline (port of ``data/pipeline.py``): background
producers feeding a bounded queue, and the pinned-memory copy to the card.

- :class:`PrefetchLoader`: one producer thread walks the source's
  ``batches`` iterator in order (so the stream is byte-identical to the
  synchronous one for a given seed and epoch), applies ``put_fn`` and
  feeds a bounded queue of ``depth`` batches. ``depth=0`` produces in
  line on the consumer, with no thread. Errors of the source, of
  ``put_fn`` or of a chaos schedule (site ``data.prefetch``, once a
  produced batch) surface at the consumer's next ``__next__``; ``close()``
  is idempotent and stops a producer blocked on a full queue.
- :func:`decode_map`: an ordered map over a shared pool of daemon
  ``zoo-decode-*`` threads (``BytesFeatureSet``'s per-record decode).
- :class:`PinnedCopy`: the ``put_fn`` that moves a host batch to the card
  (a pinned staging copy, then ``non_blocking`` on a side stream, an event
  the consuming stream waits on), and :func:`device_prefetch` over it.

Telemetry, the JAX package's families on the port's registry
(``common/telemetry.py``): ``zoo_data_prefetch_producer_stall_seconds``
(a put that found the queue full, timed until it lands),
``zoo_data_prefetch_consumer_wait_seconds`` (every get from the queue,
the end-of-epoch sentinel's included) and the scrape-time collector
``zoo_data_prefetch_queue_depth`` (batches buffered across live loaders).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..common import telemetry as _tm
from ..common.chaos import chaos_point

_STALL = _tm.histogram(
    "zoo_data_prefetch_producer_stall_seconds",
    "Producer time blocked on a full prefetch queue (consumer-bound pipeline)")
_WAIT = _tm.histogram(
    "zoo_data_prefetch_consumer_wait_seconds",
    "Consumer time blocked on an empty prefetch queue (producer-bound "
    "pipeline)")

# every live loader, for the scrape-time queue-depth collector
_LIVE_LOADERS: "weakref.WeakSet[PrefetchLoader]" = weakref.WeakSet()


def _queue_depth_samples():
    return [((), float(sum(l.queue_depth() for l in list(_LIVE_LOADERS))))]


_tm.collector("zoo_data_prefetch_queue_depth",
              "Batches currently buffered across live PrefetchLoaders",
              _queue_depth_samples)

_END = object()           # producer sentinel: source exhausted


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _WorkerError:
    """Exception captured on the producer thread, re-raised at the
    consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Bounded-queue batch loader with a deterministic order.

    ``source`` is a FeatureSet (its ``batches(batch_size, epoch=...,
    shuffle=..., drop_remainder=...)`` is called on the producer thread)
    or any iterable of host batches. ``put_fn`` runs on the producer per
    batch: the place for the copy to the card, so that batch N+1's copy
    overlaps the step on batch N. Single-pass: make a loader per epoch.
    """

    _ids = itertools.count()

    def __init__(self, source, batch_size: Optional[int] = None, *,
                 epoch: int = 0, shuffle: bool = True,
                 drop_remainder: bool = True,
                 put_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2):
        self._put = put_fn
        self.depth = max(0, int(depth))
        if hasattr(source, "batches"):
            if batch_size is None:
                raise TypeError("batch_size is required for FeatureSet "
                                "sources")
            self._make_iter = lambda: source.batches(
                batch_size, epoch=epoch, shuffle=shuffle,
                drop_remainder=drop_remainder)
        else:
            src_iter = iter(source)
            self._make_iter = lambda: src_iter
        self._closed = False
        self._iterated = False
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        _LIVE_LOADERS.add(self)
        if self.depth == 0:        # synchronous control path: no thread
            return
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, name=f"zoo-prefetch-{next(self._ids)}",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _produce(self):
        try:
            for hb in self._make_iter():
                if self._stop.is_set():
                    return
                chaos_point("data.prefetch")
                item = self._put(hb) if self._put is not None else hb
                if not self._enqueue(item):
                    return
            self._enqueue(_END)
        except BaseException as e:  # chaos WorkerKilled is a BaseException
            self._enqueue(_WorkerError(e))

    def _enqueue(self, item) -> bool:
        """Stop-aware bounded put; the time a full queue holds it is the
        stall."""
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            pass
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                _STALL.observe(time.perf_counter() - t0)
                return True
            except queue.Full:
                continue
        return False

    # ------------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        if self._iterated:
            raise RuntimeError(
                "PrefetchLoader is single-pass; construct a new loader per "
                "epoch instead of re-iterating this one")
        self._iterated = True
        if self._q is None:        # depth 0: produce in line, same contract
            for hb in self._make_iter():
                chaos_point("data.prefetch")
                yield self._put(hb) if self._put is not None else hb
            return
        while True:
            t0 = time.perf_counter()
            while True:
                try:
                    item = self._q.get(timeout=0.5)
                    break
                except queue.Empty:
                    if self._closed:
                        return
                    if not self._thread.is_alive():
                        # the producer may have enqueued its last item and
                        # exited between the timeout and this check
                        try:
                            item = self._q.get_nowait()
                            break
                        except queue.Empty:
                            raise RuntimeError(
                                "prefetch producer died without a result "
                                f"(thread {self._thread.name})") from None
            _WAIT.observe(time.perf_counter() - t0)
            if item is _END:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item

    # ------------------------------------------------------------ lifecycle
    def queue_depth(self) -> int:
        """Batches buffered now (0 at depth 0)."""
        return self._q.qsize() if self._q is not None else 0

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent teardown: stop the producer, drain the queue so a
        blocked put wakes up, and join the thread."""
        self._closed = True
        if self._q is None:
            return
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # safety net; the owning loop closes explicitly
        try:
            self.close(timeout=0.0)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# shared ordered decode pool (BytesFeatureSet's per-record decode)
# ---------------------------------------------------------------------------

class _OrderedThreadPool:
    """A shared pool whose ``map`` keeps input order. Its workers are
    daemon threads named ``zoo-decode-N`` that live for the process and
    hold no state between calls (``concurrent.futures``' workers are not
    daemons, and would outlive a test session)."""

    def __init__(self, name: str = "zoo-decode"):
        self._name = name
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads: list = []
        self._lock = threading.Lock()            # guards _threads

    def ensure_workers(self, n: int) -> None:
        with self._lock:
            while len(self._threads) < n:
                t = threading.Thread(
                    target=self._worker,
                    name=f"{self._name}-{len(self._threads)}", daemon=True)
                t.start()
                self._threads.append(t)

    def _worker(self):
        while True:
            fn, arg, i, results, state, cond = self._q.get()
            try:
                results[i] = fn(arg)
                exc = None
            except BaseException as e:  # re-raised in map(); worker lives
                exc = e
            with cond:
                if exc is not None and state["exc"] is None:
                    state["exc"] = exc
                state["left"] -= 1
                if not state["left"]:
                    cond.notify_all()

    def map(self, fn: Callable, items) -> list:
        n = len(items)
        results = [None] * n
        state = {"left": n, "exc": None}
        cond = threading.Condition()
        for i in range(n):
            self._q.put((fn, items[i], i, results, state, cond))
        with cond:
            while state["left"]:
                cond.wait()
        if state["exc"] is not None:
            raise state["exc"]
        return results


_DECODE_POOL = _OrderedThreadPool()


def default_decode_workers() -> int:
    """``ZOO_TPU_DECODE_WORKERS`` (the JAX package's override), else
    ``min(8, cpu_count)``."""
    env = os.environ.get("ZOO_TPU_DECODE_WORKERS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return min(8, os.cpu_count() or 1)


def decode_map(fn: Callable, items, workers: Optional[int] = None) -> list:
    """Ordered parallel map for per-record decoders: results in input
    order, the first decoder exception re-raised at the caller.
    ``workers=None`` is :func:`default_decode_workers`; 0 or 1 (or fewer
    than 4 items) decodes in line. The batch splits into at most
    ``workers`` contiguous chunks, so the cap holds per call however
    large the shared pool has grown."""
    n_workers = default_decode_workers() if workers is None \
        else max(0, workers)
    if n_workers <= 1 or len(items) < 4:
        return [fn(x) for x in items]
    _DECODE_POOL.ensure_workers(n_workers)
    n = len(items)
    n_chunks = min(n_workers, n)
    bounds = [(i * n) // n_chunks for i in range(n_chunks + 1)]

    def run_chunk(span):
        lo, hi = span
        return [fn(items[i]) for i in range(lo, hi)]

    chunks = _DECODE_POOL.map(run_chunk, list(zip(bounds, bounds[1:])))
    return [r for chunk in chunks for r in chunk]


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------

def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor over ``a`` (a copy only where numpy's array is
    read-only, as a memmap tier's is)."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.asarray(a)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


class PinnedCopy:
    """``put_fn`` that moves a host batch (a tree of numpy arrays) to
    ``device``; it runs on the producer thread, :meth:`ready` on the
    consumer's.

    On the card each leaf is copied into a pinned staging buffer (from the
    caching host allocator, which keeps a buffer until the copy reading it
    has finished), then to the card with ``non_blocking=True`` on a side
    stream; an event recorded after the last copy is what the consumer's
    stream waits on in :meth:`ready`, so no host thread waits for a copy.
    The device tensors are allocated on the side stream and used on the
    consumer's: each is marked with ``record_stream(consumer)``, so the
    caching allocator does not hand its block out again until the
    consumer's work queued before the free has finished. On the CPU the
    leaves become tensors over the host arrays.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self.consumer = torch.cuda.current_stream(self.device)
            self.stream = torch.cuda.Stream(self.device)

    def __call__(self, batch):
        if not self._cuda:
            return _tree_map(_host_tensor, batch), None
        with torch.cuda.stream(self.stream):
            tree = _tree_map(self._put, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return tree, event

    def _put(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            pinned = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            pinned.copy_(a)
        else:
            arr = np.asarray(a)
            pinned = torch.empty(
                arr.shape, pin_memory=True,
                dtype=torch.from_numpy(np.empty((), arr.dtype)).dtype)
            np.copyto(pinned.numpy(), arr)
        out = pinned.to(self.device, non_blocking=True)
        out.record_stream(self.consumer)
        return out

    def ready(self, item):
        """The batch of ``item`` (what ``__call__`` returned), once the
        consumer's stream has been told to wait for its copies."""
        tree, event = item
        if event is not None:
            self.consumer.wait_event(event)
        return tree


def device_prefetch(batch_iter: Iterable, device, depth: int = 2):
    """Yield each host batch of ``batch_iter`` on ``device``, ``depth``
    batches in flight (a :class:`PrefetchLoader` over :class:`PinnedCopy`;
    the producer thread stages and copies, the consumer's stream waits on
    each batch's event)."""
    copy = PinnedCopy(device)
    loader = PrefetchLoader(batch_iter, put_fn=copy, depth=depth)
    try:
        for item in loader:
            yield copy.ready(item)
    finally:
        loader.close()


__all__ = ["PinnedCopy", "PrefetchLoader", "decode_map",
           "default_decode_workers", "device_prefetch"]
