"""Single-device attention (port of the parts of ``ops/attention.py`` the
serving and training paths use). ``full_attention`` is plain differentiable
PyTorch: the "full" strategy, and the oracle the flash kernels are tested
against. The sequence-parallel strategies (ring, zigzag, Ulysses) are not
ported yet."""

from __future__ import annotations

import torch

NEG_INF = -1e30

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


def prefer_flash_single_device(t: int, device: torch.device) -> bool:
    """The "auto" dispatch rule: flash from a length threshold up, on CUDA
    only (plain attention on the CPU). Query length 1 — the decode step —
    never takes the flash kernel."""
    if t <= 1:
        return False
    return torch.device(device).type == "cuda" and t >= FLASH_MIN_T_CUDA


__all__ = ["FLASH_MIN_T_CUDA", "NEG_INF", "full_attention",
           "prefer_flash_single_device"]
