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

Not ported yet: ``PrefixCache``, ``prefix_block_key`` and ``copy_page``
(the shared-prefix cache).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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
                      page_size: int) -> torch.Tensor:
    """Write ``T`` consecutive tokens' K or V per slot, in place: ``new``
    (B, T, H, D) lands at positions ``pos .. pos+T-1``. The caller keeps
    ``pos + T <= pages_per_slot * page_size``."""
    t = new.shape[1]
    positions = pos.long()[:, None] + torch.arange(
        t, device=pos.device)[None]                                  # (B, T)
    page_ids = table.long().gather(1, positions // page_size)        # (B, T)
    pages[page_ids, positions % page_size] = new.to(pages.dtype)
    return pages


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

_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _host_list(x) -> list:
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).tolist()
    return np.asarray(x).reshape(-1).tolist()


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as ``jax.random`` computes it:
    uint32 arithmetic carried in Python ints or int64 tensors (every value
    in ``[0, 2**32)``, masked after each add). Tensor arguments broadcast;
    returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _fold_keys(seeds, token_idx) -> List[tuple]:
    """``fold_in(PRNGKey(seed), idx)`` per row, on the host in Python ints
    (a few rows, no device launches): the key ``(0, seed mod 2**32)``
    hashes the count pair ``(0, idx)``."""
    return [threefry2x32(0, int(s) & _M32, 0, int(i) & _M32)
            for s, i in zip(_host_list(seeds), _host_list(token_idx))]


def sample_bits(seeds, token_idx, v: int, device=None) -> torch.Tensor:
    """``jax.random.bits(fold_in(PRNGKey(seed), token_idx), (v,), uint32)``
    for each row, as an int64 (B, v) tensor on ``device``: with
    ``jax_threefry_partitionable`` (the default of the JAX the package is
    tested against) element ``j`` is the xor of the two words hashed from
    the count pair ``(0, j)`` under the folded key."""
    keys = _fold_keys(seeds, token_idx)
    k1, k2 = (torch.tensor([k[w] for k in keys], dtype=torch.int64,
                           device=device)[:, None] for w in (0, 1))
    j = torch.arange(v, dtype=torch.int64, device=device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(j), j)
    return b1 ^ b2


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
    "KVCacheConfig", "OutOfPages", "PagePool", "SCRATCH_PAGE",
    "decode_attention", "decode_attention_multi", "gumbel_max",
    "gumbel_max_plain", "init_cache", "paged_read",
    "paged_write", "paged_write_multi", "prefill_write", "sample_bits",
    "sample_tokens", "threefry2x32",
]
