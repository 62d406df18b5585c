"""Attention with a selectable strategy (port of ``ops/attention.py``).

``full_attention`` is plain differentiable PyTorch: the "full" strategy,
and the oracle the flash kernels are tested against. Over a mesh's ``sp``
axis (one rank a sequence block; ``parallel/comm.py``):

* ``ring`` — K/V blocks rotate round the ring (``ppermute``). The flash
  ring (:class:`_RingFlash`) runs K1 once per visiting block: causal on
  the diagonal block, dense on past blocks, future blocks skipped; the
  blocks' outputs merge by their LSEs (:func:`_merge_blocks`). Its
  backward is a second ring of ``(k, v, dk, dv)``: K3 and K4 once per
  block against the GLOBAL lse and δ = rowsum(dO∘O) of the GLOBAL output,
  so P = exp(S − lse) is exact for every block; after n rotations each
  dK/dV bundle is home.
* ``zigzag`` — the causal ring over the zigzag layout (rank d holds the
  chunk pair (d, 2n−1−d)), which balances the causal work: every rank
  runs 2n+1 half-blocks. Non-causal attention, or a T that does not
  split into 2·sp chunks, runs ``ring``. The JAX package also falls back
  when its TPU blocks do not tile a half-chunk; the port's kernels take
  any length, so that rule is dropped.
* ``ulysses`` — an ``all_to_all`` from sequence-split to head-split, the
  flash kernels over the whole sequence, and the inverse ``all_to_all``.

Each rank's q/k/v and output outside the strategy are replicated over
``sp`` (the JAX global arrays): :func:`sharded_attention` takes the
rank's sequence block with ``comm.shard_along`` and puts the output
together with ``comm.gather_along``. The kernels' wrappers run their plain
versions on CPU tensors and K1/K3/K4 (or raise) on CUDA tensors, so every
strategy runs the same schedule on both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30

#: the largest head dim the attention kernels' compile-time tiles hold
#: (bf16 on the tensor cores, f32 on FMA loops); above it every family (K1-K4)
#: runs its wide FMA kernel, which takes any head dim
TILE_MAX_HEAD_DIM = 256

#: Shortest query length at which ``attn_strategy="auto"`` takes the flash
#: kernel on CUDA. The JAX rule's TPU threshold (2048) does not carry over;
#: until the port has H100 numbers comparing the kernel with plain attention
#: over prompt lengths, "auto" behaves like "flash" on CUDA (every T > 1).
FLASH_MIN_T_CUDA = 2


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False) -> torch.Tensor:
    """Reference attention: softmax(q k^T / sqrt(d)) v, (B, T, H, D)
    layout; softmax in f32, probabilities cast back to q's dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=q.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def kernel_envelope(d: int, q_len: int = 1,
                    dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """What the card's attention kernels (flash K1, K3, K4 and paged K2)
    take: ``None`` when they take head dim ``d`` at ``q_len`` query rows in
    ``dtype``, else why not. They take every head dim from 1, any q_len
    from 1, and float32 or bfloat16. Up to ``TILE_MAX_HEAD_DIM`` a head dim
    runs on compile-time column tiles with the columns past d zero (bf16
    flash operands at a head dim that is not a multiple of 8 go through one
    zero-padded copy, ``flash_attention.pad_head_dim``; K2 runs such a bf16
    head dim on its wide kernel); above it every family runs its wide
    kernel (``csrc/attn_wide.cuh``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return f"dtype {dtype} is not float32/bfloat16"
    if d < 1:
        return f"head dim {d} is not positive"
    if q_len < 1:
        return f"q_len {q_len} is not positive"
    return None


def prefer_flash_single_device(t: int, device: torch.device) -> bool:
    """The "auto" dispatch rule: flash from a length threshold up, on CUDA
    only (plain attention on the CPU). Query length 1 — the decode step —
    never takes the flash kernel."""
    if t <= 1:
        return False
    return torch.device(device).type == "cuda" and t >= FLASH_MIN_T_CUDA


# ------------------------------------------------------------- ring attention
def _merge_blocks(o, lse, o_blk, lse_blk):
    """Fold one normalized block result into the running ``(o, lse)``:
    weights e^(lse − lse_new), a stable convex combination; NEG_INF is
    finite, so an empty block merges with weight 0."""
    m = torch.maximum(lse, lse_blk)
    w_old = torch.exp(lse - m)
    w_new = torch.exp(lse_blk - m)
    lse_new = m + torch.log(w_old + w_new)

    def tr(w):
        return w.transpose(1, 2)[..., None]

    o_new = (o * tr(w_old) + o_blk.float() * tr(w_new)) / tr(w_old + w_new)
    return o_new, lse_new


def _case(src: int, idx: int, causal: bool) -> Optional[bool]:
    """A visiting block's relation to the local q block: ``True`` the
    diagonal (causal mask), ``False`` strictly past (dense), ``None``
    strictly future (skipped)."""
    if not causal or src < idx:
        return False
    return True if src == idx else None


def _block_bwd(q, k, v, g, lse, delta, causal_flag):
    """K3 and K4 for one (q, visiting block) pair: ``(dq, dk, dv)``."""
    from .flash_attention import (flash_attention_bwd_dkv,
                                  flash_attention_bwd_dq)

    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal_flag)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal_flag)
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    """Ring attention with K1 per visiting block; the backward ring runs
    K3/K4 per block (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, mesh):
        from ..parallel import comm
        from .flash_attention import flash_attention_fwd

        n = comm.axis_size(axis, mesh)
        idx = comm.axis_index(axis, mesh)
        b, t_q, h, d = q.shape
        o = torch.zeros((b, t_q, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, t_q), NEG_INF, dtype=torch.float32,
                         device=q.device)
        perm = comm.ring_perm(n)
        kv = torch.stack([k, v])
        for i in range(n):
            flag = _case((idx - i) % n, idx, causal)
            if flag is not None:
                o_blk, lse_blk = flash_attention_fwd(q, kv[0], kv[1], flag)
                o, lse = _merge_blocks(o, lse, o_blk, lse_blk)
            if i < n - 1:
                kv = comm.ppermute(kv, axis, perm, mesh=mesh)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.mesh = axis, causal, mesh
        return out

    @staticmethod
    def backward(ctx, g):
        from ..parallel import comm
        from .flash_attention import flash_bwd_delta, grad_layout

        q, k, v, out, lse = ctx.saved_tensors
        axis, causal, mesh = ctx.axis, ctx.causal, ctx.mesh
        g = grad_layout(g)
        n = comm.axis_size(axis, mesh)
        idx = comm.axis_index(axis, mesh)
        perm = comm.ring_perm(n)
        delta = flash_bwd_delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            flag = _case((idx - i) % n, idx, causal)
            if flag is not None:
                dq_c, dk_c, dv_c = _block_bwd(q, kv[0], kv[1], g, lse,
                                              delta, flag)
                dq += dq_c.float()
                dkv[0] += dk_c.float()
                dkv[1] += dv_c.float()
            if i < n - 1:
                kv = comm.ppermute(kv, axis, perm, mesh=mesh)
            dkv = comm.ppermute(dkv, axis, perm, mesh=mesh)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention_local(q, k, v, *, axis_name: str = "sp",
                         causal: bool = False, mesh=None):
    """Ring attention over ``axis_name`` on this rank's blocks (B,
    T_local, H, D): the flash ring, K1/K3/K4 per block."""
    return _RingFlash.apply(q, k, v, axis_name, causal, mesh)


# ----------------------------------------------------------- zigzag ring
def zigzag_permutation(t: int, n: int) -> np.ndarray:
    """The sequence permutation that puts the chunk pair (d, 2n−1−d) of
    2n chunks on rank d; invert it with ``np.argsort``."""
    if t % (2 * n):
        raise ValueError(f"zigzag needs seq len divisible by 2*sp ({2 * n}); "
                         f"got {t}")
    c = t // (2 * n)
    order = []
    for d in range(n):
        order += [d, 2 * n - 1 - d]
    return np.concatenate([np.arange(c) + ch * c for ch in order])


def _zigzag_pairs(src: int, idx: int):
    """The (q half, k half, causal flag) pairs a visiting block from
    ``src`` contributes to: q_hi × k_lo always past; q_lo × k_lo by
    src vs idx; q_hi × k_hi by idx vs src (hi chunks run backwards);
    q_lo × k_hi always future."""
    pairs = [(1, 0, False)]
    lo = _case(src, idx, True)
    if lo is not None:
        pairs.append((0, 0, lo))
    hi = _case(idx, src, True)
    if hi is not None:
        pairs.append((1, 1, hi))
    return pairs


class _ZigzagFlash(torch.autograd.Function):
    """The causal ring over the zigzag layout, K1 per (q half, k half)
    pair; the backward ring runs K3/K4 per pair."""

    @staticmethod
    def forward(ctx, q, k, v, axis, mesh):
        from ..parallel import comm
        from .flash_attention import flash_attention_fwd

        n = comm.axis_size(axis, mesh)
        idx = comm.axis_index(axis, mesh)
        b, t_loc, h, d = q.shape
        c = t_loc // 2
        qh = (q[:, :c].contiguous(), q[:, c:].contiguous())
        o = [torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device)
             for _ in range(2)]
        lse = [torch.full((b, h, c), NEG_INF, dtype=torch.float32,
                          device=q.device) for _ in range(2)]
        kv = torch.stack([k, v]).reshape(2, b, 2, c, h, d)
        perm = comm.ring_perm(n)
        for i in range(n):
            for qi, ki, flag in _zigzag_pairs((idx - i) % n, idx):
                o_blk, lse_blk = flash_attention_fwd(
                    qh[qi], kv[0, :, ki], kv[1, :, ki], flag)
                o[qi], lse[qi] = _merge_blocks(o[qi], lse[qi], o_blk,
                                               lse_blk)
            if i < n - 1:
                kv = comm.ppermute(kv, axis, perm, mesh=mesh)
        out = torch.cat(o, 1).to(q.dtype)
        lse = torch.cat(lse, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.mesh = axis, mesh
        return out

    @staticmethod
    def backward(ctx, g):
        from ..parallel import comm
        from .flash_attention import flash_bwd_delta, grad_layout

        q, k, v, out, lse = ctx.saved_tensors
        axis, mesh = ctx.axis, ctx.mesh
        g = grad_layout(g)
        n = comm.axis_size(axis, mesh)
        idx = comm.axis_index(axis, mesh)
        b, t_loc, h, d = q.shape
        c = t_loc // 2
        delta = flash_bwd_delta(out, g)
        half = [(q[:, s].contiguous(), g[:, s].contiguous(),
                 lse[:, :, s].contiguous(), delta[:, :, s].contiguous())
                for s in (slice(0, c), slice(c, 2 * c))]
        dq = torch.zeros((2, b, c, h, d), dtype=torch.float32,
                         device=q.device)
        kv = torch.stack([k, v]).reshape(2, b, 2, c, h, d)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        perm = comm.ring_perm(n)
        for i in range(n):
            for qi, ki, flag in _zigzag_pairs((idx - i) % n, idx):
                qh, gh, lh, dh = half[qi]
                dq_c, dk_c, dv_c = _block_bwd(
                    qh, kv[0, :, ki].contiguous(), kv[1, :, ki].contiguous(),
                    gh, lh, dh, flag)
                dq[qi] += dq_c.float()
                dkv[0, :, ki] += dk_c.float()
                dkv[1, :, ki] += dv_c.float()
            if i < n - 1:
                kv = comm.ppermute(kv, axis, perm, mesh=mesh)
            dkv = comm.ppermute(dkv, axis, perm, mesh=mesh)
        dq = torch.cat([dq[0], dq[1]], 1).to(q.dtype)
        dkv = dkv.reshape(2, b, t_loc, h, d)
        return dq, dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None


def zigzag_ring_attention_local(q, k, v, *, axis_name: str = "sp",
                                causal: bool = True, mesh=None):
    """The load-balanced causal ring on this rank's zigzag blocks
    (:func:`zigzag_permutation`); non-causal runs the plain ring order."""
    if not causal:
        return ring_attention_local(q, k, v, axis_name=axis_name,
                                    causal=False, mesh=mesh)
    if q.shape[1] % 2:
        raise ValueError("zigzag local block needs an even sequence length")
    return _ZigzagFlash.apply(q, k, v, axis_name, mesh)


def ulysses_attention_local(q, k, v, *, axis_name: str = "sp",
                            causal: bool = False, mesh=None):
    """Ulysses: (B, T/n, H, D) → (B, T, H/n, D) by ``all_to_all``, flash
    attention over the whole sequence (K1, K3/K4 on the card), and the
    inverse ``all_to_all``. The head count must divide by the axis."""
    from ..parallel import comm
    from .flash_attention import flash_attention

    n = comm.axis_size(axis_name, mesh)
    if q.shape[2] % n:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by "
                         f"{axis_name}={n}")

    def a2a(x, split, concat):
        return comm.all_to_all(x, axis_name, split, concat, mesh=mesh)

    o = flash_attention(a2a(q, 2, 1).contiguous(), a2a(k, 2, 1).contiguous(),
                        a2a(v, 2, 1).contiguous(), causal)
    return a2a(o, 1, 2)


STRATEGIES = ("auto", "full", "flash", "ring", "zigzag", "ulysses")


def sharded_attention(q, k, v, mesh, *, strategy: str = "auto",
                      causal: bool = False, seq_axis: str = "sp"):
    """Attention under ``mesh`` on this rank's replicated (over
    ``seq_axis``) q/k/v: with ``sp > 1`` the chosen sequence-parallel
    strategy on the rank's sequence block, the output put back together
    (module docstring); with ``sp == 1`` single-device attention."""
    from ..parallel import comm

    if strategy not in STRATEGIES:
        raise ValueError(f"unknown attention strategy {strategy!r}; known: "
                         f"{', '.join(STRATEGIES)}")
    sp = mesh.shape.get(seq_axis, 1)
    t = q.shape[1]
    if strategy == "auto":
        if sp > 1:
            strategy = ("zigzag" if causal and t % (2 * sp) == 0
                        else "ring")
        else:
            strategy = ("flash" if prefer_flash_single_device(t, q.device)
                        else "full")
    if strategy == "flash":
        if sp > 1:
            raise ValueError(
                "strategy='flash' is a single-device kernel; on a sequence-"
                "parallel mesh (sp>1) use 'ring' or 'ulysses'")
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal)
    if strategy == "full" or sp == 1:
        return full_attention(q, k, v, causal=causal)
    if strategy == "zigzag" and (not causal or t % (2 * sp)):
        strategy = "ring"
    if strategy == "zigzag":
        perm = torch.as_tensor(zigzag_permutation(t, sp), device=q.device)
        inv = torch.argsort(perm)
        q, k, v = (x.index_select(1, perm) for x in (q, k, v))
    blocks = [comm.shard_along(x, seq_axis, 1, mesh=mesh) for x in (q, k, v)]
    if strategy == "ring":
        o = ring_attention_local(*blocks, axis_name=seq_axis, causal=causal,
                                 mesh=mesh)
    elif strategy == "zigzag":
        o = zigzag_ring_attention_local(*blocks, axis_name=seq_axis,
                                        causal=True, mesh=mesh)
    else:
        o = ulysses_attention_local(*blocks, axis_name=seq_axis,
                                    causal=causal, mesh=mesh)
    o = comm.gather_along(o, seq_axis, 1, mesh=mesh)
    return o.index_select(1, inv) if strategy == "zigzag" else o


__all__ = ["FLASH_MIN_T_CUDA", "NEG_INF", "STRATEGIES", "TILE_MAX_HEAD_DIM",
           "full_attention", "kernel_envelope", "prefer_flash_single_device",
           "ring_attention_local", "sharded_attention",
           "ulysses_attention_local", "zigzag_permutation",
           "zigzag_ring_attention_local"]
