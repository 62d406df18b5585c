"""Flash-attention forward: the K1 kernel, its wrapper and its plain version.

Port of the forward half of ``analytics_zoo_tpu/ops/flash_attention.py``.
The kernel (``csrc/flash_fwd.cu``) replaces the Pallas ``_fwd_kernel``: a
tiled online-softmax attention that never materializes the (T, T) scores,
skips K tiles wholly in the future under the causal mask, and writes the
output in the storage dtype plus the f32 row log-sum-exp (B, H, T). The LSE
is part of the contract: ring attention and rematerialization in later
slices consume it. Unlike the JAX entry point, a T that does not divide the
tile is masked inside the kernel; there is no fall back to full attention.

The backward kernels (K3, K4) are not ported yet.

Layout (B, T, H, D) as everywhere in the package. The wrapper takes any
strides with a contiguous head dim, so q/k/v sliced out of the fused QKV
projection go in without a copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build
from .attention import NEG_INF

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_SIG = {"zoo_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p]}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes, step by step in plain PyTorch: f32 scores, the
    causal mask on absolute positions, the row log-sum-exp, normalized
    probabilities times V. Returns ``(out in q's dtype, lse (B, H, Tq)
    f32)``. Used for CPU tensors and as the kernel's yardstick in tests."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                      # (B, H, Tq)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"on {q.device}, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, T, H, D), "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_attention: q, k, v must share one dtype "
                             f"of float32/bfloat16, got {q.dtype}, {k.dtype},"
                             f" {v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous (stride {t.stride(-1)})")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)}/"
                         f"{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported "
                         f"(kernel takes {_HEAD_DIMS})")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward, (B, T, H, D) → ``(out (B, Tq, H, D), lse (B, H, Tq)
    f32)``. CPU tensors take :func:`flash_attention_plain`; CUDA tensors
    launch K1 or raise."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal)
    lib = _build.load_library("flash_fwd", _SIG)
    _check(q, k, v)
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    out = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.zoo_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, t_q, t_k, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), 1.0 / math.sqrt(d), stream)
    _build.check_launch(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


#: K1 launches since the count was last set to 0
flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise attention, (B, T, H, D) → (B, T, H, D)."""
    return flash_attention_fwd(q, k, v, causal)[0]


__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain"]
