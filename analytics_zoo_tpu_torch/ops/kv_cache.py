"""Paged KV cache (port of ``analytics_zoo_tpu/ops/kv_cache.py``).

K/V live in a preallocated pool of fixed-size pages,
``(n_layers, n_pages, page_size, n_heads, head_dim)``; a decode slot owns a
page-table row mapping its positions to pool pages, handed out by the
host-side :class:`PagePool`. Page 0 is scratch: unallocated table entries
point at it, so masked lanes write there harmlessly.

The pool is updated IN PLACE (``index_put_`` / slice assignment on the
``(L, P, page, H, D)`` tensors). That is the PyTorch counterpart of the JAX
package donating the cache into each jitted step
(``serving/generation.py``): one pool exists, never a second pool-sized
copy. The write functions still return the pool, so call sites read like
the JAX ones.

Sampling at temperature > 0 reproduces the JAX package's threefry draw bit
for bit: :func:`gumbel_max_plain` in torch ops (the CPU path and the
yardstick), :func:`gumbel_max` in one CUDA launch (``csrc/sample.cu``) for
tensors on the card.

The shared-prefix cache is host-side: :class:`PrefixCache` indexes
published page-aligned prompt blocks under a chain hash
(:func:`prefix_block_key`, the JAX package's keys byte for byte), and
:func:`copy_page` is the copy-on-write of a boundary page, in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import prng
from ..common.prng import _M32, threefry2x32
from . import _build

NEG_INF = -1e30

#: Page id every unallocated / masked table entry points at. The pool never
#: allocates it, so garbage writes from inactive lanes land in scratch.
SCRATCH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static geometry of one paged cache."""

    n_layers: int
    n_heads: int
    head_dim: int
    n_slots: int                       # concurrent decode sequences
    page_size: int = 16                # tokens per page
    pages_per_slot: int = 16           # max_seq_len = page_size * pages_per_slot
    n_pages: Optional[int] = None      # pool size incl. scratch (None = full)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.page_size < 1 or self.pages_per_slot < 1:
            raise ValueError("page_size and pages_per_slot must be >= 1")
        if self.n_pages is not None and self.n_pages < 2:
            raise ValueError("n_pages must leave room for scratch + 1 page")

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def total_pages(self) -> int:
        # +1: page 0 is reserved scratch and backs no sequence
        if self.n_pages is not None:
            return self.n_pages
        return self.n_slots * self.pages_per_slot + 1


def init_cache(cfg: KVCacheConfig, device) -> Dict[str, torch.Tensor]:
    """Preallocate the K/V page pools (zeros; contents are only ever read
    through a length mask, so stale pages are invisible)."""
    shape = (cfg.n_layers, cfg.total_pages, cfg.page_size, cfg.n_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


class PagePool:
    """Host-side REFCOUNTED free-list allocator over the cache's page pool.

    Thread-safe; page 0 (scratch) is never handed out. ``alloc`` hands out
    pages at refcount 1 and raises :class:`OutOfPages` when the pool is dry.
    ``release`` reclaims a page when its last holder lets go; releasing a
    page nobody holds raises (double free). Every page is at all times
    exactly one of *free* or *held*: ``free_count() + held_count() ==
    capacity`` (:meth:`check_conservation`).
    """

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._free: List[int] = list(range(cfg.total_pages - 1, 0, -1))
        # page id -> refcount; absent = free. alloc() starts a page at 1.
        self._refs: Dict[int, int] = {}
        self._capacity = len(self._free)

    @property
    def capacity(self) -> int:
        return self._capacity

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def held_count(self) -> int:
        """Distinct pages currently allocated (any refcount)."""
        with self._lock:
            return len(self._refs)

    def shared_count(self) -> int:
        """Pages with refcount >= 2."""
        with self._lock:
            return sum(1 for r in self._refs.values() if r >= 2)

    def ref_count(self, page: int) -> int:
        """Current refcount of ``page`` (0 = free/scratch)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def alloc(self, n: int = 1) -> List[int]:
        with self._lock:
            if n > len(self._free):
                raise OutOfPages(
                    f"requested {n} pages, {len(self._free)} free "
                    f"(capacity {self._capacity})")
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._refs[p] = 1
        return out

    def incref(self, pages: Sequence[int]) -> None:
        """Add one reference per page; increffing a free page raises."""
        with self._lock:
            for p in pages:
                p = int(p)
                if p == SCRATCH_PAGE:
                    continue
                if p not in self._refs:
                    raise ValueError(
                        f"incref of unallocated page {p} (use-after-free)")
                self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the free list
        when its LAST reference is dropped. Releasing a free page raises."""
        with self._lock:
            for p in pages:
                p = int(p)
                if p == SCRATCH_PAGE:
                    continue
                r = self._refs.get(p)
                if r is None:
                    raise ValueError(f"double free of page {p}")
                if r <= 1:
                    del self._refs[p]
                    self._free.append(p)
                else:
                    self._refs[p] = r - 1

    def check_conservation(self) -> None:
        """Raise unless every non-scratch page is exactly one of free or
        held and the two partitions sum to capacity."""
        with self._lock:
            free = set(self._free)
            held = set(self._refs)
            if free & held:
                raise AssertionError(
                    f"pages both free and held: {sorted(free & held)}")
            if len(self._free) != len(free):
                raise AssertionError("duplicate pages on the free list")
            if len(free) + len(held) != self._capacity:
                raise AssertionError(
                    f"page conservation violated: {len(free)} free + "
                    f"{len(held)} held != capacity {self._capacity}")


class OutOfPages(RuntimeError):
    """The page pool cannot satisfy an allocation (working set too big)."""


# ---------------------------------------------------------------------------
# content-addressed prefix cache — host-side index over published KV pages
# ---------------------------------------------------------------------------

def prefix_block_key(parent: Optional[str], tokens) -> str:
    """Chain hash of one page-aligned prefix block: blake2b (digest 16) of
    the parent key and the block's int32 token bytes, so a block's identity
    is the identity of the whole prefix through it (lookup is a
    longest-prefix walk) and equal blocks under different prefixes never
    collide."""
    h = hashlib.blake2b(digest_size=16)
    if parent is not None:
        h.update(parent.encode("ascii"))
    h.update(b"|")
    h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
    return h.hexdigest()


class _PrefixEntry:
    """One published block: the pages backing ``block_tokens`` tokens of
    some prompt prefix, plus the chain bookkeeping."""

    __slots__ = ("key", "parent", "pages", "n_tokens", "last_used",
                 "active", "children")

    def __init__(self, key: str, parent: Optional[str], pages: List[int],
                 n_tokens: int, last_used: int):
        self.key = key
        self.parent = parent
        self.pages = pages          # page ids this entry holds one ref each
        self.n_tokens = n_tokens    # cumulative prefix tokens through here
        self.last_used = last_used  # logical clock, bumped per hit
        self.active = 0             # streams currently matched through here
        self.children: set = set()  # keys chained directly off this block


class PrefixMatch:
    """Result of a :meth:`PrefixCache.lookup` hit. The caller OWNS one pool
    reference per page in ``pages`` (taken by lookup) and must either
    install them in a stream's table or release them."""

    __slots__ = ("keys", "pages", "n_tokens")

    def __init__(self, keys: List[str], pages: List[int], n_tokens: int):
        self.keys = keys
        self.pages = pages
        self.n_tokens = n_tokens


class PrefixCache:
    """Content-addressed index of published prefix KV pages.

    Completed prefills :meth:`publish` their full page-aligned blocks under
    the chain hash; new prefills :meth:`lookup` their prompt and get the
    longest cached prefix back as shared pages (a refcount bump, no
    compute). The cache holds its own pool reference on every published
    page, so entries outlive their publisher; eviction
    (:meth:`evict_to_budget`, :meth:`reclaim_pages`) is LRU over entries no
    live stream is matched through, leaf blocks first.

    Thread-safe: every mutation is all-or-nothing under one lock, which
    takes the pool's lock as a leaf. Published K/V depends on the weights,
    so new weights must :meth:`invalidate` it.
    """

    def __init__(self, pool: PagePool, *, block_tokens: int, page_size: int,
                 max_pages: int):
        if block_tokens < 1 or block_tokens % page_size:
            raise ValueError(
                f"prefix_block_tokens must be a positive multiple of "
                f"page_size {page_size}, got {block_tokens}")
        if max_pages < 1:
            raise ValueError(f"prefix cache budget must be >= 1 page, "
                             f"got {max_pages}")
        self.pool = pool
        self.block_tokens = int(block_tokens)
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self._lock = threading.Lock()
        self._entries: Dict[str, _PrefixEntry] = {}
        self._held_pages = 0
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evicted_pages = 0
        self.evict_sweeps = 0

    # ------------------------------------------------------------ read side

    def _pages_per_block(self) -> int:
        return self.block_tokens // self.page_size

    def lookup(self, tokens) -> Optional[PrefixMatch]:
        """Longest-prefix match of ``tokens`` against the published chains.
        On a hit, takes one pool reference per matched page for the caller
        (atomic with the walk, so no eviction can reclaim a matched page
        first) and marks each matched entry stream-active until
        :meth:`release_stream`. Returns ``None`` on a miss."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = int(tokens.size)
        bt = self.block_tokens
        with self._lock:
            keys: List[str] = []
            pages: List[int] = []
            matched = 0
            parent: Optional[str] = None
            while matched + bt <= n:
                key = prefix_block_key(parent, tokens[matched:matched + bt])
                entry = self._entries.get(key)
                if entry is None:
                    break
                keys.append(key)
                pages.extend(entry.pages)
                matched += bt
                parent = key
            if not keys:
                self.misses += 1
                return None
            self._clock += 1
            for k in keys:
                e = self._entries[k]
                e.last_used = self._clock
                e.active += 1
            self.pool.incref(pages)      # the caller's references
            self.hits += 1
            return PrefixMatch(keys, list(pages), matched)

    def release_stream(self, keys: Sequence[str]) -> None:
        """Drop a stream's active marks (retire, cancel, failed prefill).
        Keys already gone (an intervening :meth:`invalidate`) are skipped:
        the stream's own page references were its safety."""
        with self._lock:
            for k in keys:
                e = self._entries.get(k)
                if e is not None and e.active > 0:
                    e.active -= 1

    # ----------------------------------------------------------- write side

    def publish(self, tokens, n_tokens: int, pages: Sequence[int]) -> int:
        """Publish a completed prefill's FULL blocks: those wholly below
        ``n_tokens`` (decode writes start there). ``pages``: the stream's
        page ids in table order. The cache takes its own reference on every
        newly published page; blocks already present are skipped (first
        publisher wins — identical content by construction). The whole
        chain goes in under one lock hold. Returns blocks newly
        published."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bt = self.block_tokens
        ppb = self._pages_per_block()
        n_full = int(n_tokens) // bt
        if n_full < 1:
            return 0
        with self._lock:
            parent: Optional[str] = None
            fresh: List[Tuple[str, Optional[str], List[int], int]] = []
            for b in range(n_full):
                key = prefix_block_key(parent, tokens[b * bt:(b + 1) * bt])
                if key not in self._entries:
                    blk = [int(p) for p in pages[b * ppb:(b + 1) * ppb]]
                    fresh.append((key, parent, blk, (b + 1) * bt))
                parent = key
            if not fresh:
                return 0
            self._clock += 1
            for key, par, blk, ntok in fresh:
                self.pool.incref(blk)   # the cache's own references
                self._entries[key] = _PrefixEntry(key, par, blk, ntok,
                                                  self._clock)
                self._held_pages += len(blk)
                if par is not None:
                    self._entries[par].children.add(key)
        return len(fresh)

    # ------------------------------------------------------------- eviction

    def _remove_locked(self, entry: _PrefixEntry) -> None:
        del self._entries[entry.key]
        self._held_pages -= len(entry.pages)
        if entry.parent is not None:
            par = self._entries.get(entry.parent)
            if par is not None:
                par.children.discard(entry.key)
        self.pool.release(entry.pages)

    def _evict_locked(self, done) -> Tuple[int, int]:
        """LRU-evict leaf entries with no active stream until ``done()`` or
        no candidate remains. Caller holds the lock."""
        n_entries = n_pages = 0
        while not done():
            cands = [e for e in self._entries.values()
                     if not e.children and e.active == 0]
            if not cands:
                break
            victim = min(cands, key=lambda e: e.last_used)
            self._remove_locked(victim)
            n_entries += 1
            n_pages += len(victim.pages)
        return n_entries, n_pages

    def evict_to_budget(self) -> Dict[str, int]:
        """Shrink cache-held pages to ``max_pages`` (LRU, leaf-first).
        Returns the sweep's stats (zeros when already under budget)."""
        with self._lock:
            if self._held_pages <= self.max_pages:
                return {"entries": 0, "pages": 0,
                        "held_pages": self._held_pages}
            n_entries, n_pages = self._evict_locked(
                lambda: self._held_pages <= self.max_pages)
            self.evict_sweeps += 1
            self.evicted_pages += n_pages
            return {"entries": n_entries, "pages": n_pages,
                    "held_pages": self._held_pages}

    def reclaim_pages(self, need_free: int) -> int:
        """Pool-pressure valve: evict (LRU, leaf-first) until the pool has
        ``need_free`` free pages or nothing evictable remains. Returns the
        pages released."""
        with self._lock:
            _, n_pages = self._evict_locked(
                lambda: self.pool.free_count() >= need_free)
            if n_pages:
                self.evict_sweeps += 1
                self.evicted_pages += n_pages
            return n_pages

    def invalidate(self) -> int:
        """Drop every entry and the cache's page references (new weights,
        or the batcher closing). Streams matched through dropped entries
        keep their own page references. Returns pages released."""
        with self._lock:
            released = 0
            for e in self._entries.values():
                self.pool.release(e.pages)
                released += len(e.pages)
            self._entries.clear()
            self._held_pages = 0
            return released

    # ---------------------------------------------------------- diagnostics

    def held_pages(self) -> int:
        with self._lock:
            return self._held_pages

    def reclaimable_pages(self) -> int:
        """Cache-held pages whose only reference is the cache's (refcount
        1, entry not stream-active): what an eviction sweep would hand back
        to the free list now."""
        with self._lock:
            return sum(1 for e in self._entries.values() if e.active == 0
                       for p in e.pages if self.pool.ref_count(p) == 1)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = len(self._entries)
            held = self._held_pages
            active = sum(1 for e in self._entries.values() if e.active)
        total = self.hits + self.misses
        return {
            "entries": entries,
            "held_pages": held,
            "budget_pages": self.max_pages,
            "block_tokens": self.block_tokens,
            "stream_active_entries": active,
            "reclaimable_pages": self.reclaimable_pages(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "evicted_pages": self.evicted_pages,
            "evict_sweeps": self.evict_sweeps,
        }


# ---------------------------------------------------------------------------
# device ops — pools are (P, page_size, H, D) views of ONE layer, updated in
# place
# ---------------------------------------------------------------------------

def paged_write(pages: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                new: torch.Tensor, *, page_size: int) -> torch.Tensor:
    """Write one token's K or V per slot, in place.

    ``pages``: (P, page_size, H, D); ``table``: (B, pages_per_slot) int;
    ``pos``: (B,) (the position being written); ``new``: (B, H, D). Masked
    slots carry table rows full of ``SCRATCH_PAGE``."""
    pos = pos.long()
    page_ids = table.long().gather(1, (pos // page_size)[:, None])[:, 0]
    pages[page_ids, pos % page_size] = new.to(pages.dtype)
    return pages


def paged_read(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather a slot-major contiguous copy of one layer's cache:
    (P, page_size, H, D) × (B, pages_per_slot) → (B, pps * page_size, H, D).
    Positions past a slot's length surface scratch/stale values that the
    attention mask removes."""
    b, pps = table.shape
    gathered = pages[table.long()]               # (B, PPS, page, H, D)
    return gathered.reshape(b, pps * pages.shape[1], *pages.shape[2:])


def prefill_write(pages: torch.Tensor, table: torch.Tensor, kv: torch.Tensor,
                  *, page_size: int) -> torch.Tensor:
    """Scatter a whole prefill's K or V into the pool, in place. ``kv``:
    (B, T_bucket, H, D) with T_bucket a multiple of ``page_size``; table
    entries past the allocated prefix are scratch, so bucket padding lands
    there."""
    b, t, h, d = kv.shape
    if t % page_size:
        raise ValueError(f"prefill bucket {t} must divide page_size "
                         f"{page_size}")
    n_pages = t // page_size
    tiles = kv.reshape(b, n_pages, page_size, h, d).to(pages.dtype)
    pages[table[:, :n_pages].long()] = tiles
    return pages


def paged_write_multi(pages: torch.Tensor, table: torch.Tensor,
                      pos: torch.Tensor, new: torch.Tensor, *,
                      page_size: int, in_table: bool = False
                      ) -> torch.Tensor:
    """Write ``T`` consecutive tokens' K or V per slot, in place: ``new``
    (B, T, H, D) lands at positions ``pos .. pos+T-1``. A position whose
    page index falls past the table row is dropped, as the JAX package's
    scatter drops it (a suffix prefill's pow2 bucket can reach past the
    table; its padding rows are never read). ``in_table=True``: the caller
    guarantees every position is inside the table (the decode and verify
    steps), which skips the mask — on a CUDA tensor its compaction waits
    for the card."""
    t = new.shape[1]
    positions = pos.long()[:, None] + torch.arange(
        t, device=pos.device)[None]                                  # (B, T)
    page_idx = positions // page_size
    new = new.to(pages.dtype)
    if not in_table:
        keep = page_idx < table.shape[1]
        rows, cols = keep.nonzero(as_tuple=True)
        page_ids = table.long()[rows, page_idx[rows, cols]]
        pages[page_ids, positions[rows, cols] % page_size] = new[rows, cols]
        return pages
    page_ids = table.long().gather(1, page_idx)                      # (B, T)
    pages[page_ids, positions % page_size] = new
    return pages


def copy_page(cache: Dict[str, torch.Tensor], src: int, dst: int
              ) -> Dict[str, torch.Tensor]:
    """Copy one page's K and V across every layer, ``src`` -> ``dst``, in
    place — the copy-on-write of the one partially shared boundary page of
    a whole-prompt prefix hit. Returns the cache."""
    for pages in cache.values():
        pages[:, int(dst)] = pages[:, int(src)]
    return cache


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-query attention against a cached prefix, masked to each row's
    true length. ``q``: (B, H, D); ``k``/``v``: (B, T_max, H, D);
    ``lengths``: (B,) valid positions (the new token included). Softmax
    statistics in f32."""
    d = q.shape[-1]
    scores = torch.einsum("bhd,bthd->bht", q, k).float()
    scores = scores / math.sqrt(d)
    t = k.shape[1]
    mask = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bthd->bhd", probs.to(v.dtype), v)


def decode_attention_multi(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Multi-query decode attention: ``T`` new tokens per slot against the
    cached prefix. ``q``: (B, T, H, D); ``k``/``v``: (B, T_max, H, D);
    ``lengths``: (B,) valid positions INCLUDING the T new tokens. Query
    ``i`` attends to positions ``<= lengths - T + i``."""
    t_new = q.shape[1]
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bthd->bhqt", q, k).float()
    scores = scores / math.sqrt(d)
    t = k.shape[1]
    kv_pos = torch.arange(t, device=q.device)[None, None, None, :]
    q_idx = torch.arange(t_new, device=q.device)[None, None, :, None]
    bound = lengths.long()[:, None, None, None] - t_new + q_idx
    scores = scores.masked_fill(kv_pos > bound, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# sampling — per-request keys so scheduling never changes a stream, drawn
# with the JAX package's threefry bits so both packages sample alike
# ---------------------------------------------------------------------------

def _host_list(x) -> list:
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).tolist()
    return np.asarray(x).reshape(-1).tolist()


def _fold_keys(seeds, token_idx) -> List[tuple]:
    """``fold_in(PRNGKey(seed mod 2**32), idx)`` per row, on the host in
    Python ints (a few rows, no device launches)."""
    return [prng.fold_in(prng.PRNGKey(int(s) & _M32), i)
            for s, i in zip(_host_list(seeds), _host_list(token_idx))]


def sample_bits(seeds, token_idx, v: int, device=None) -> torch.Tensor:
    """``jax.random.bits(fold_in(PRNGKey(seed), token_idx), (v,), uint32)``
    for each row, as an int64 (B, v) tensor on ``device``."""
    return prng.bits_per_key(_fold_keys(seeds, token_idx), v, device)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s default ("low") transform of 32 random bits:
    a uniform in [tiny, 1) from the top 23 bits as the mantissa of a float
    in [1, 2), then ``-log(-log(u))``."""
    tiny = torch.finfo(torch.float32).tiny
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    # uniform(minval=tiny, maxval=1): the span 1 - tiny rounds to 1 in f32
    u = torch.clamp_min(mant.view(torch.float32) - 1.0 + tiny, tiny)
    return -torch.log(-torch.log(u))


def gumbel_max_plain(scaled: torch.Tensor, rows: Sequence[int], seeds,
                     token_idx) -> torch.Tensor:
    """What the sampling kernel computes, in torch ops: for each hot row
    ``rows[i]`` of the (B, V) f32 ``scaled`` logits, the argmax of
    Gumbel noise from :func:`sample_bits` plus the row — the draw of
    ``jax.random.categorical``. Returns (n,) int64 token ids."""
    bits = sample_bits(seeds, token_idx, scaled.shape[-1], scaled.device)
    idx = torch.tensor(list(rows), device=scaled.device)
    return torch.argmax(gumbel_from_bits(bits) + scaled[idx], dim=-1)


_SAMPLE_SIG = {"zoo_gumbel_max": [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p]}


def gumbel_max(scaled: torch.Tensor, rows: Sequence[int], seeds,
               token_idx) -> torch.Tensor:
    """:func:`gumbel_max_plain` in one launch of ``csrc/sample.cu``
    (threefry bits, the Gumbel transform and the row argmax fused). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``scaled`` must be a contiguous (B, V) f32 tensor."""
    if scaled.device.type == "cpu":
        return gumbel_max_plain(scaled, rows, seeds, token_idx)
    lib = _build.load_library("sample", _SAMPLE_SIG)
    if scaled.device.type != "cuda" or scaled.dtype != torch.float32 \
            or scaled.dim() != 2 or not scaled.is_contiguous():
        raise ValueError(f"gumbel_max: scaled must be a contiguous (B, V) "
                         f"f32 CUDA tensor, got {scaled.dtype}"
                         f"{tuple(scaled.shape)} on {scaled.device}")
    rows = [int(r) for r in rows]
    if not rows or not all(0 <= r < scaled.shape[0] for r in rows):
        raise ValueError(f"gumbel_max: rows {rows} not in [0, "
                         f"{scaled.shape[0]})")
    keys = _fold_keys(seeds, token_idx)
    meta = torch.tensor([[r, k1, k2] for r, (k1, k2) in zip(rows, keys)],
                        dtype=torch.int64).to(scaled.device)
    out = torch.empty(len(rows), dtype=torch.int64, device=scaled.device)
    err = lib.zoo_gumbel_max(
        scaled.data_ptr(), scaled.shape[1], meta.data_ptr(), out.data_ptr(),
        len(rows), torch.cuda.current_stream(scaled.device).cuda_stream)
    _build.check_launch(err, "gumbel_max")
    gumbel_max.launches += 1
    return out


#: sampling-kernel launches since the count was last set to 0
gumbel_max.launches = 0


def sample_tokens(logits: torch.Tensor, seeds, token_idx, temperature, *,
                  top_k: int = 0, return_probs: bool = False):
    """Sample one token per row.

    ``logits``: (B, V), upcast to f32. ``seeds``/``token_idx``: (B,) ints —
    the request's seed and the token's ordinal in the stream;
    ``temperature``: (B,); rows at <= 0 take argmax (greedy, first index on
    ties, as in the JAX package). ``top_k``: 0 = full distribution, else
    only the k highest logits. Rows at temperature > 0 draw as
    ``jax.random.categorical(fold_in(PRNGKey(seed), token_idx), row)`` does
    — Gumbel-max over :func:`sample_bits`, through :func:`gumbel_max` — so
    a stream's tokens are the JAX package's and do not depend on the slot
    or the decode step.

    ``return_probs``: also return the (B, V) f32 post-temperature/top_k
    distribution.
    """
    logits = logits.float()
    temp = torch.tensor(_host_list(temperature), dtype=torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / temp.clamp_min(1e-6).to(logits.device)[:, None]
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, NEG_INF))
    tokens = greedy.clone()
    hot = [i for i, t in enumerate(temp.tolist()) if t > 0]
    if hot:
        seeds, token_idx = _host_list(seeds), _host_list(token_idx)
        tokens[torch.tensor(hot, device=logits.device)] = gumbel_max(
            scaled.contiguous(), hot, [seeds[i] for i in hot],
            [token_idx[i] for i in hot])
    tokens = tokens.to(torch.int32)
    if not return_probs:
        return tokens
    return tokens, torch.softmax(scaled, dim=-1)


__all__ = [
    "KVCacheConfig", "OutOfPages", "PagePool", "PrefixCache", "PrefixMatch",
    "SCRATCH_PAGE", "copy_page", "decode_attention",
    "decode_attention_multi", "gumbel_max", "gumbel_max_plain",
    "init_cache", "paged_read", "paged_write", "paged_write_multi",
    "prefill_write", "prefix_block_key", "sample_bits", "sample_tokens",
    "threefry2x32",
]
