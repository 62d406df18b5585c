"""Fused paged attention: the K2 kernel, its wrapper and its plain version.

Port of ``analytics_zoo_tpu/ops/paged_attention.py``. The kernel
(``csrc/paged_attention.cu``) replaces the Pallas ``_paged_kernel``:
attention read straight from the page pool through the page table, so the
``(B, pages_per_slot * page_size, H, D)`` contiguous copy that
``paged_read`` makes never exists, and K/V are read in the pool's dtype
(no ``.astype`` copy of the pool either).

Semantics match ``decode_attention_multi``: ``lengths[b]`` counts valid
positions INCLUDING the q_len new tokens, and query ``i`` attends to
positions ``<= lengths[b] - q_len + i``. Positions past the length are never
read, and a row with no valid position (an inactive slot, length 0) is 0.
q_len is 1 at decode and any positive count for the speculative verify
and prefill chunks (48, 64, 128 in the JAX package's benchmarks); the
head dim is any from 1 (``attention.kernel_envelope``).

bf16 runs split across the context on the tensor cores: one block per
(head, slot, span of ``SPLIT_POSITIONS`` positions rounded up to whole
pages, 16-row q tile) writes an f32 partial (m, l, acc), and the last
split of a (head, slot, q tile) to finish, counted by an atomic counter,
folds the partials into the output. The partials and the counters (which
every launch leaves at 0) are made once per (device, stream) and reused:
the wrapper runs once per layer and decode step in a host-bound loop, so
it allocates nothing but the output and adds no launch, sync or pass
over the data. f32 runs one FMA block per (head, slot, q tile). A bf16
pool there must start 16-byte aligned with (page, position, head) strides
that are multiples of 8 elements: ``cp.async`` moves 16-byte chunks.
Above head dim 256 (both dtypes), and at a bf16 head dim that is not a
multiple of 8 (whose pool rows are not whole 16-byte chunks; the pool is
neither copied nor allocated wider for it), K2 runs its wide FMA kernel
(``csrc/attn_wide.cuh``), which takes any head dim and any strides.

There is no routing switch: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import TILE_MAX_HEAD_DIM, kernel_envelope
from .flash_attention import _check_aligned
from .kv_cache import decode_attention_multi, paged_read

#: positions one split of the bf16 kernel covers, rounded up to whole pages
SPLIT_POSITIONS = 128
#: query rows a block of either kernel owns
_Q_TILE = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"zoo_paged_attention": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p]}
#: the bf16 kernel's scratch by (device, stream), made once and grown as
#: calls need: (B*H*q-tile split counters, zero when made and left at zero
#: by every launch; the splits' f32 partials). Launches in one stream's
#: order share it.
_SCRATCH = {}


def _scratch(device, stream: int, n_done: int, n_work: int):
    """Pointers to at least ``n_done`` zero counters and ``n_work`` f32
    partials for a launch on ``stream``; grown (both anew) when short."""
    done, work = _SCRATCH.get((device, stream), (None, None))
    if done is None or done.numel() < n_done or work.numel() < n_work:
        if done is not None:
            n_done = max(n_done, done.numel())
            n_work = max(n_work, work.numel())
        done = torch.zeros(n_done, dtype=torch.int32, device=device)
        work = torch.empty(n_work, dtype=torch.float32, device=device)
        _SCRATCH[(device, stream)] = done, work
    return done.data_ptr(), work.data_ptr()


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          lengths: torch.Tensor, *,
                          page_size: int) -> torch.Tensor:
    """What K2 computes, step by step: gather the slot-major cache
    (``paged_read``), masked multi-query attention
    (``decode_attention_multi``), and zeros for rows with no valid
    position."""
    del page_size  # implied by the pool's shape
    ks = paged_read(k_pages, table).to(q.dtype)
    vs = paged_read(v_pages, table).to(q.dtype)
    out = decode_attention_multi(q, ks, vs, lengths)
    q_len = q.shape[1]
    bound = lengths.long()[:, None] - q_len + torch.arange(
        q_len, device=q.device)[None]                            # (B, q_len)
    return out.masked_fill((bound < 0)[:, :, None, None], 0.0)


def _check(q, k_pages, v_pages, table, lengths, page_size):
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("lengths", lengths)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"paged_attention: {name} must be a CUDA tensor "
                             f"on {dev}, got {t.device}")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: q must be (B, q_len, H, D) and "
                         f"pages (P, page_size, H, D); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    b, q_len, h, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != page_size \
            or k_pages.shape[2:] != (h, d):
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)} at page_size {page_size}")
    if k_pages.stride() != v_pages.stride() or k_pages.stride(-1) != 1 \
            or q.stride(-1) != 1:
        raise ValueError("paged_attention: head dims must be contiguous and "
                         "k/v pages must share strides")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: q and the pool must share one "
                         f"dtype of float32/bfloat16, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    why = kernel_envelope(d, q_len, q.dtype)
    if why:
        raise ValueError(f"paged_attention: {why}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != b \
            or tuple(lengths.shape) != (b,) or not table.is_contiguous() \
            or not lengths.is_contiguous():
        raise ValueError(f"paged_attention: table must be a contiguous "
                         f"(B, pages_per_slot) int32 and lengths a (B,) "
                         f"int32; got {table.dtype}{tuple(table.shape)}, "
                         f"{lengths.dtype}{tuple(lengths.shape)}")
    if _on_tensor_cores(q):
        _check_aligned("paged_attention", k_pages=k_pages, v_pages=v_pages)


def _on_tensor_cores(q: torch.Tensor) -> bool:
    """Whether K2 runs its bf16 tensor-core kernel (split across the
    context, with scratch) rather than an FMA kernel for ``q``."""
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and d % 8 == 0 \
        and d <= TILE_MAX_HEAD_DIM


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, *, page_size: int) -> torch.Tensor:
    """Fused page-gather attention. ``q``: (B, q_len, H, D);
    ``k_pages``/``v_pages``: (P, page_size, H, D) — ONE layer's pool;
    ``table``: (B, pages_per_slot) int32; ``lengths``: (B,) int32 valid
    positions INCLUDING the q_len new tokens. Returns (B, q_len, H, D)."""
    if q.is_cpu and k_pages.is_cpu and v_pages.is_cpu and table.is_cpu \
            and lengths.is_cpu:
        return paged_attention_plain(q, k_pages, v_pages, table, lengths,
                                     page_size=page_size)
    lib = _build.load_library("paged_attention", _SIG)
    _check(q, k_pages, v_pages, table, lengths, page_size)
    b, q_len, h, d = q.shape
    pps = table.shape[1]
    out = torch.empty((b, q_len, h, d), dtype=q.dtype, device=q.device)
    # the current stream's handle, without building a torch Stream (what
    # torch's own compiled kernels read)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    span, done, work = 0, None, None
    if _on_tensor_cores(q):
        # (m, l, acc) in f32 for each (slot, head, split, row)
        span = page_size * -(-SPLIT_POSITIONS // page_size)
        n_split = -(-(pps * page_size) // span)
        done, work = _scratch(q.device, stream, b * h * -(-q_len // _Q_TILE),
                              b * h * n_split * q_len * (d + 2))
    err = lib.zoo_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), work, done,
        _DTYPE_CODES[q.dtype], b, h, d, q_len, page_size, pps, span,
        q.stride(0), q.stride(1), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        1.0 / math.sqrt(d), stream)
    _build.check_launch(err, "paged_attention")
    paged_attention.launches += 1
    return out


#: K2 launches since the count was last set to 0
paged_attention.launches = 0


def synthetic_paged_case(n_slots: int, pages_per_slot: int, page_size: int,
                         h: int, d: int, *, q_len: int = 1,
                         dtype=torch.float32, lengths=None, device="cpu",
                         generator: torch.Generator = None):
    """Random ``(q, k_pages, v_pages, table, lengths)`` laid out like the
    serving cache (the JAX package's fixture of the same name): page 0
    scratch, each slot's valid prefix on sequentially allocated pages,
    unallocated entries scratch. ``lengths`` defaults to a half-full ladder;
    rows at 0 get all-scratch tables."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    n_pages = n_slots * pages_per_slot + 1
    q = torch.randn((n_slots, q_len, h, d), generator=g).to(dtype)
    k_pages = torch.randn((n_pages, page_size, h, d), generator=g).to(dtype)
    v_pages = torch.randn((n_pages, page_size, h, d), generator=g).to(dtype)
    max_len = pages_per_slot * page_size
    if lengths is None:
        lengths = [max(q_len, (i + 1) * max_len // (2 * n_slots))
                   for i in range(n_slots)]
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    table = torch.zeros((n_slots, pages_per_slot), dtype=torch.int32)
    nxt = 1
    for i in range(n_slots):
        for j in range(-(-int(lengths[i]) // page_size)):
            table[i, j] = nxt
            nxt += 1
    return tuple(t.to(device) for t in (q, k_pages, v_pages, table, lengths))


__all__ = ["SPLIT_POSITIONS", "paged_attention",
           "paged_attention_plain", "synthetic_paged_case"]
