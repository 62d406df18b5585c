"""Single-device attention (port of the parts of ``ops/attention.py`` the
serving and training paths use). ``full_attention`` is plain differentiable
PyTorch: the "full" strategy, and the oracle the flash kernels are tested
against. The sequence-parallel strategies (ring, zigzag, Ulysses) are not
ported yet."""

from __future__ import annotations

from typing import Optional

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


__all__ = ["FLASH_MIN_T_CUDA", "NEG_INF", "TILE_MAX_HEAD_DIM",
           "full_attention", "kernel_envelope", "prefer_flash_single_device"]
