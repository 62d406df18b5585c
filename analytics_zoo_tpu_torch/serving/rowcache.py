"""Host hot-row cache: serve a million-row embedding table from one card
(port of ``analytics_zoo_tpu/serving/rowcache.py``).

A serving replica is one device and need not hold a whole table there. A
two-tier store:

* **cold tier** — every row, host-side, in a :class:`~..data.featureset.
  FeatureSet` on the ``DISK_AND_DRAM`` memmap machinery. The miss path is
  :meth:`~..data.featureset.FeatureSet.row_slice`: a fill touches the bytes
  of the missed rows and nothing else.
* **hot tier** — a fixed ``(hot_rows, width)`` tensor on the device (the
  card unless the caller names another). Admission is keyed by LOOKUP
  FREQUENCY, not recency: a missed row displaces the coldest pinned row only
  once it has been asked for at least as often (recommender id traffic is
  Zipf — frequency beats plain LRU because one scan of the long tail cannot
  flush the head). Hot rows are read with ``index_select`` and written with
  ``index_copy_`` on the device.

The admission decisions are the JAX cache's: the victim is the pinned row
least by ``(frequency, row id)``. The JAX cache finds it by a scan of every
pinned row per admitted row; the port keeps the pinned rows in a heap whose
stale entries (a row looked up again since it was pushed) are refreshed when
they reach the top, so the same victim is found in logarithmic time.

Per-tier hit/miss telemetry (``zoo_embed_*``) feeds the observability plane
and the ``/debug/rowcache`` ops surface. The cache reports its host bytes
to the memory witness (site ``serving.rowcache.host``: the table's bytes
with ``budget_bytes`` as the site's budget at construction, its host bytes
after each gather), as the JAX cache does.

Row-delta publishes land here via :meth:`HostRowCache.apply_row_delta` —
touched rows overwrite the cold store and any pinned copies in place.

One admission can pin a row and evict it again for a hotter one, so a slot
can be written twice in one pass. ``index_copy_`` on the card leaves the
order of duplicate indices unspecified (as does JAX's ``.at[].set``), so
each pass writes every slot once, with its last row.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import memwitness as _mw
from ..common import telemetry as _tm
from ..nn.module import resolve_device

__all__ = ["HostRowCache", "cache_stats", "register_cache"]

_LOOKUPS = _tm.counter(
    "zoo_embed_cache_lookups_total",
    "Hot-row cache id lookups by serving tier: tier=hot was pinned in "
    "device memory, tier=cold paid a host row_slice fill", labels=("tier",))
#: the memory-witness site the cache's host bytes are recorded under
MEM_SITE = "serving.rowcache.host"

_EVICTIONS = _tm.counter(
    "zoo_embed_cache_evictions_total",
    "Hot-tier rows displaced by a more frequently looked-up row")
_FILLS = _tm.histogram(
    "zoo_embed_cache_fill_seconds",
    "Latency of one miss fill (host row_slice + device transfer)")
_HOT_ROWS = _tm.gauge(
    "zoo_embed_cache_hot_rows", "Rows currently pinned in the hot tier",
    labels=("cache",))
_HOT_BYTES = _tm.gauge(
    "zoo_embed_cache_hot_bytes",
    "Device bytes held by the hot tier", labels=("cache",))
_HOST_BYTES = _tm.gauge(
    "zoo_embed_cache_host_bytes",
    "Host bytes of the cold row store (memmap-backed)", labels=("cache",))

#: process-global registry for the /debug/rowcache ops surface
_REGISTRY: Dict[str, "HostRowCache"] = {}
_REGISTRY_LOCK = threading.Lock()


def _last_per_slot(slots: List[int], pos: List[int]
                   ) -> Tuple[List[int], List[int]]:
    """``(slots, pos)`` with each slot once, keeping its last position:
    what a sequence of writes leaves, as one write of unique indices."""
    last = dict(zip(slots, pos))
    return list(last), list(last.values())


def register_cache(cache: "HostRowCache") -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[cache.name] = cache


def cache_stats() -> Dict[str, Dict[str, Any]]:
    """``{cache_name: stats}`` for every registered cache — the payload of
    ``/debug/rowcache`` and ``cli rowcache``."""
    with _REGISTRY_LOCK:
        caches = list(_REGISTRY.values())
    return {c.name: c.stats() for c in caches}


class HostRowCache:
    """Two-tier row store for one ``(rows, width)`` embedding table.

    ``table`` is the full host-side table (any array accepted by
    ``FeatureSet``); ``hot_rows`` bounds the device tier. ``device``: where
    the hot tier lives (CUDA unless the caller names another; it raises
    without CUDA).
    """

    def __init__(self, table: np.ndarray, hot_rows: int, *,
                 memory_type: Optional[str] = None,
                 budget_bytes: Optional[int] = None,
                 name: str = "embeddings", device=None):
        from ..data.featureset import FeatureSet, MemoryType

        table = np.asarray(table)
        if table.ndim != 2:
            raise ValueError(f"HostRowCache wants a (rows, width) table, "
                             f"got shape {table.shape}")
        self.name = name
        self.rows, self.width = table.shape
        self.dtype = table.dtype
        self.hot_rows = int(max(1, min(int(hot_rows), self.rows)))
        self.budget_bytes = budget_bytes
        self.device = resolve_device(device)
        # cold tier: every row, memmap-backed unless the caller insists on
        # DRAM; row_slice is the only read path we use
        self._cold = FeatureSet(
            {"rows": table},
            memory_type=memory_type or MemoryType.DISK_AND_DRAM(1))
        # hot tier: one device block + host-side maps
        self._hot = torch.zeros((self.hot_rows, self.width),
                                dtype=torch.from_numpy(table[:0]).dtype,
                                device=self.device)
        self._slot_of: Dict[int, int] = {}        # row id -> hot slot
        self._row_of = np.full(self.hot_rows, -1, dtype=np.int64)
        self._free: List[int] = list(range(self.hot_rows - 1, -1, -1))
        self._freq: Dict[int, int] = {}           # row id -> lookup count
        # one (frequency when pushed, row id) entry per pinned row; an entry
        # whose frequency is stale is refreshed when it reaches the top
        self._heap: List[Tuple[int, int]] = []
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        host_bytes = int(table.nbytes)
        _HOST_BYTES.labels(cache=name).set(host_bytes)
        _HOT_BYTES.labels(cache=name).set(self._hot_nbytes())
        _mw.note_static(MEM_SITE, host_bytes, budget_bytes)
        _mw.record_bytes(MEM_SITE, host_bytes)
        register_cache(self)

    def _hot_nbytes(self) -> int:
        return int(self._hot.numel() * self._hot.element_size())

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- lookups
    def gather(self, ids) -> torch.Tensor:
        """Device rows for ``ids`` (1-D, repeats fine): hot rows gathered in
        place, misses filled from the cold tier and considered for
        admission. Returns a ``(len(ids), width)`` tensor on the device."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        t0 = time.perf_counter()
        with self._lock:
            for i in ids.tolist():
                self._freq[i] = self._freq.get(i, 0) + 1
            slots = np.asarray([self._slot_of.get(i, -1) for i in ids],
                               np.int64)
            hit = slots >= 0
            n_hit = int(hit.sum())
            n_miss = len(ids) - n_hit
            self._hits += n_hit
            self._misses += n_miss
        if n_hit:
            _LOOKUPS.labels(tier="hot").inc(n_hit)
        if n_miss:
            _LOOKUPS.labels(tier="cold").inc(n_miss)
        out = self._hot.index_select(
            0, self._to_device(np.where(hit, slots, 0)))
        if n_miss:
            miss_ids = ids[~hit]
            uniq, inv = np.unique(miss_ids, return_inverse=True)
            cold = self._cold.row_slice(uniq)["rows"]
            out.index_copy_(0, self._to_device(np.flatnonzero(~hit)),
                            self._to_device(cold[inv]))
            self._admit(uniq, cold)
            _FILLS.observe(time.perf_counter() - t0)
        _mw.record_bytes(MEM_SITE, self.host_bytes())
        return out

    def _coldest(self) -> int:
        """The pinned row least by ``(frequency, row id)``: the top of the
        heap once no stale entry sits there."""
        while True:
            f, rid = self._heap[0]
            cur = self._freq.get(rid, 0)
            if cur == f:
                return rid
            heapq.heapreplace(self._heap, (cur, rid))

    def _admit(self, row_ids: np.ndarray, rows: np.ndarray) -> None:
        """Frequency-keyed admission of freshly missed rows: fill free slots
        first, then displace the lowest-frequency pinned row while the
        newcomer's count is at least as high."""
        take_slots, take_pos = [], []
        with self._lock:
            order = np.argsort([-self._freq.get(int(r), 0) for r in row_ids],
                               kind="stable")
            for pos in order.tolist():
                rid = int(row_ids[pos])
                if rid in self._slot_of:
                    continue
                if self._free:
                    slot = self._free.pop()
                else:
                    victim = self._coldest()
                    if self._freq.get(victim, 0) > self._freq.get(rid, 0):
                        continue
                    heapq.heappop(self._heap)
                    slot = self._slot_of.pop(victim)
                    self._evictions += 1
                    _EVICTIONS.inc()
                self._slot_of[rid] = slot
                self._row_of[slot] = rid
                heapq.heappush(self._heap, (self._freq.get(rid, 0), rid))
                take_slots.append(slot)
                take_pos.append(pos)
            n_hot = len(self._slot_of)
        if take_slots:
            take_slots, take_pos = _last_per_slot(take_slots, take_pos)
            self._hot.index_copy_(0, self._to_device(np.asarray(take_slots)),
                                  self._to_device(rows[take_pos]))
        _HOT_ROWS.labels(cache=self.name).set(n_hot)

    # --------------------------------------------------------- row deltas
    def apply_row_delta(self, indices, rows) -> int:
        """Overwrite the rows at ``indices`` in place — cold store always,
        hot slots where pinned. Returns the number of hot rows refreshed."""
        indices = np.asarray(indices, np.int64).reshape(-1)
        rows = np.asarray(rows)
        if rows.shape != (len(indices), self.width):
            raise ValueError(f"row delta shape {rows.shape} != "
                             f"({len(indices)}, {self.width})")
        cold = self._cold.data["rows"]
        if isinstance(cold, np.memmap):
            # the FeatureSet mapping is read-only; write through a fresh r+
            # mapping of the same file — MAP_SHARED pages make the update
            # visible to every reader immediately
            w = np.lib.format.open_memmap(cold.filename, mode="r+")
            w[indices] = rows.astype(self.dtype, copy=False)
            w.flush()
            del w
        else:
            cold[indices] = rows.astype(self.dtype, copy=False)
        with self._lock:
            pinned = [(k, self._slot_of[int(i)])
                      for k, i in enumerate(indices)
                      if int(i) in self._slot_of]
        if pinned:
            slots, pos = _last_per_slot([s for _, s in pinned],
                                        [k for k, _ in pinned])
            self._hot.index_copy_(
                0, self._to_device(np.asarray(slots)),
                self._to_device(rows[list(pos)].astype(self.dtype,
                                                       copy=False)))
        return len(pinned)

    # -------------------------------------------------------------- stats
    def host_bytes(self) -> int:
        return int(self._cold.data["rows"].nbytes)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hits, misses = self._hits, self._misses
            n_hot, evictions = len(self._slot_of), self._evictions
        total = hits + misses
        return {
            "rows": self.rows, "width": self.width,
            "hot_rows": n_hot, "hot_capacity": self.hot_rows,
            "hot_bytes": self._hot_nbytes(),
            "host_bytes": self.host_bytes(),
            "budget_bytes": self.budget_bytes,
            "hits": hits, "misses": misses, "evictions": evictions,
            "hit_rate": (hits / total) if total else None,
        }
