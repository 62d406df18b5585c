"""Flash attention: the K1 forward and K3/K4 backward kernels, their
wrappers, their plain versions and the autograd Function joining them.

Port of ``analytics_zoo_tpu/ops/flash_attention.py``. K1
(``csrc/flash_fwd.cu``) replaces the Pallas ``_fwd_kernel``: a tiled
online-softmax attention that never materializes the (T, T) scores, skips K
tiles wholly in the future under the causal mask, and writes the output in
the storage dtype plus the f32 row log-sum-exp (B, H, T). K3 and K4
(``csrc/flash_bwd.cu``) replace ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``:
they recompute P = exp(S - lse) tile by tile from the saved LSE, so the
backward never holds the (T, T) probabilities either. δ = rowsum(dO∘O) is a
plain op outside the kernels, as in JAX. Unlike the JAX entry point, a T
that does not divide the tile is masked inside the kernels; there is no fall
back to full attention.

:class:`FlashAttentionFunction` is the counterpart of the JAX custom VJP:
K1 forward, saving ``(q, k, v, out, lse)``; K3 + K4 backward. Because the
Function keeps its own saved tensors, a block checkpointed around it (the
``remat="flash"`` mode of ``TransformerLM``) never re-runs K1 in backward —
what ``FLASH_REMAT_POLICY`` guarantees in JAX.

bf16 runs on the tensor cores: K1, K3 and K4 on ``wgmma`` fed by TMA
(persistent blocks, a producer warpgroup and two consumer warpgroups);
f32 runs on FMA kernels. Every head dim from 1 runs on the card
(``attention.kernel_envelope``): up to 256 on the smallest compile-time
tile that holds it, the columns past it zero; above 256, in both dtypes,
on the wide FMA kernels (``csrc/attn_wide.cuh``). A bf16 head dim up to
256 that is not a multiple of 8 goes through one zero-padded copy of each
operand at the next multiple of 8 (:func:`pad_head_dim`), with the scale
kept at 1/√d of the true d; the outputs' padded columns come out zero and
are sliced off.

Layout (B, T, H, D) as everywhere in the package. The wrapper takes any
strides with a contiguous head dim, so q/k/v sliced out of the fused QKV
projection go in without a copy. A bf16 operand of the tensor-core kernels
must also start on a 16-byte boundary with (batch, position, head) strides
that are multiples of 8 elements: TMA's tensor maps take no other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import NEG_INF, TILE_MAX_HEAD_DIM, kernel_envelope

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"zoo_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p]}
_TAIL = [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p]
_BWD_SIG = {"zoo_flash_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + _TAIL,
            "zoo_flash_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + _TAIL}


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes, step by step in plain PyTorch: f32 scores times
    ``scale`` (default 1/√d), the causal mask on absolute positions,
    e = exp(s − rowmax) rounded to v's dtype before e·V (as the JAX kernel
    rounds P; a no-op in f32), divided by the f32 row sum of e, and the row
    log-sum-exp. Returns ``(out in q's dtype, lse (B, H, Tq) f32)``. Used
    for CPU tensors and as the kernel's yardstick in tests."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(
        q, scale)
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1)                                     # (B, H, Tq)
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    out = (out / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m[..., 0] + torch.log(l)


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
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
    why = kernel_envelope(d, q.shape[1], q.dtype)
    if why:
        raise ValueError(f"flash_attention: {why}")


def _check_aligned(what: str, **tensors: torch.Tensor) -> None:
    """bf16 operands of the tensor-core kernels feed TMA or ``cp.async``'s
    16-byte copies: each must start on a 16-byte boundary, and its first
    three strides ((batch, position, head), or a pool's (page, position,
    head)), where the dim has more than one entry, must be multiples of 8
    elements."""
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            continue
        sh, st = t.shape, t.stride()
        if t.data_ptr() % 16 or (sh[0] > 1 and st[0] % 8) \
                or (sh[1] > 1 and st[1] % 8) or (sh[2] > 1 and st[2] % 8):
            raise ValueError(
                f"{what}: bf16 {name} must start 16-byte aligned with its "
                f"first three strides multiples of 8 elements; got "
                f"data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()}")


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim the flash kernels run a head dim ``d`` at: a bf16 head
    dim up to ``TILE_MAX_HEAD_DIM`` that is not a multiple of 8 rounds up
    to the next multiple of 8 (the rows of TMA's tiles are whole 16-byte
    chunks); every other head dim runs as it is."""
    if dtype == torch.bfloat16 and d % 8 and d <= TILE_MAX_HEAD_DIM:
        return -(-d // 8) * 8
    return d


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its head dim zero-padded to ``width``: one contiguous
    copy, or ``t`` itself when it has that width. Zero columns change
    neither Q·Kᵀ nor any kept output column, and the outputs' padded
    columns come out zero."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _prepare(what: str, **tensors: torch.Tensor):
    """The operands at the kernels' head dim (:func:`kernel_head_dim`),
    checked for the tensor-core kernels' alignment where they take them.
    Returns ``(head dim, width, operands)``."""
    first = next(iter(tensors.values()))
    d = first.shape[-1]
    width = kernel_head_dim(d, first.dtype)
    if width != d:
        tensors = {n: pad_head_dim(t, width) for n, t in tensors.items()}
    if width <= TILE_MAX_HEAD_DIM:
        _check_aligned(what, **tensors)
    return d, width, tensors.values()


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """An output's first ``d`` columns (itself when it has no others)."""
    return t if t.shape[-1] == d else t[..., :d]


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
    b, t_q, h, _ = q.shape
    t_k = k.shape[1]
    d, width, (q, k, v) = _prepare("flash_attention", q=q, k=k, v=v)
    out = torch.empty((b, t_q, h, width), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.zoo_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, t_q, t_k, width,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), 1.0 / math.sqrt(d), stream)
    _build.check_launch(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return _unpad(out, d), lse


#: K1 launches since the count was last set to 0
flash_attention_fwd.launches = 0


def _bwd_p_ds_plain(q, k, v, g, lse, delta, causal: bool, scale=None):
    """The shared backward tile math of ``_bwd_p_ds``, over whole rows: P
    recomputed from the saved LSE and dS = P∘(dP − δ)·scale, both
    (B, H, Tq, Tk) f32. Storage-dtype operands are multiplied in f32 (a
    bf16×bf16 product is exact there) and summed in f32."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO∘O) in f32 as a contiguous (B, H, Tq) tensor — a plain
    op outside the kernels, as in JAX (O(T·D))."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _dq_from(ds, q, k):
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                        k.float()).to(q.dtype)


def _dkv_from(p, ds, q, k, v, g):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, causal=False,
                                 scale=None):
    """What K3 computes: dQ = dS·K with dS rounded to k's dtype first."""
    _, ds = _bwd_p_ds_plain(q, k, v, g, lse, delta, causal, scale)
    return _dq_from(ds, q, k)


def flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, causal=False,
                                  scale=None):
    """What K4 computes: dV = Pᵀ·dO and dK = dSᵀ·Q, with P and dS rounded
    to the operand dtype first. Returns ``(dk, dv)``."""
    p, ds = _bwd_p_ds_plain(q, k, v, g, lse, delta, causal, scale)
    return _dkv_from(p, ds, q, k, v, g)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, g: torch.Tensor,
                              causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """What K3 and K4 compute together, step by step as ``_bwd_p_ds``
    does: δ, then P recomputed from the saved LSE, dS = P∘(dP − δ)·scale,
    and P/dS rounded to the operand dtype before each product. Returns
    ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    delta = flash_bwd_delta(out, g)
    p, ds = _bwd_p_ds_plain(q, k, v, g, lse, delta, causal)
    return (_dq_from(ds, q, k), *_dkv_from(p, ds, q, k, v, g))


def _check_bwd(q, k, v, g, lse, delta) -> None:
    _check(q, k, v)
    b, t_q, h, _ = q.shape
    if g.device != q.device or g.shape != q.shape or g.dtype != q.dtype \
            or g.stride(-1) != 1:
        raise ValueError(f"flash_attention_bwd: g must be a (B, Tq, H, D) "
                         f"CUDA tensor like q, in its dtype, with a "
                         f"contiguous head dim; got {g.dtype}"
                         f"{tuple(g.shape)} on {g.device}, stride "
                         f"{g.stride()}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or t.dtype != torch.float32 \
                or t.shape != (b, h, t_q) or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous (B, H, Tq) f32 CUDA tensor, got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")


def _bwd_args(q, k, v, g, lse, delta, causal, scale):
    """The C entries' pointers and the rest of their arguments, for
    operands already at the kernels' head dim."""
    b, t_q, h, width = q.shape
    strides = []
    for t in (q, k, v, g):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (_DTYPE_CODES[q.dtype], b, h, t_q, k.shape[1], width, *strides,
             int(bool(causal)), scale,
             torch.cuda.current_stream(q.device).cuda_stream))


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, g: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool = False) -> torch.Tensor:
    """K3: dQ (B, Tq, H, D) in q's dtype from the saved LSE and δ. CPU
    tensors take :func:`flash_attention_bwd_dq_plain`; CUDA tensors launch
    K3 or raise."""
    if all(t.device.type == "cpu" for t in (q, k, v, g, lse, delta)):
        return flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, causal)
    lib = _build.load_library("flash_bwd", _BWD_SIG)
    _check_bwd(q, k, v, g, lse, delta)
    d, _, (q, k, v, g) = _prepare("flash_attention_bwd", q=q, k=k, v=v,
                                  g=g)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ptrs, rest = _bwd_args(q, k, v, g, lse, delta, causal,
                           1.0 / math.sqrt(d))
    err = lib.zoo_flash_bwd_dq(*ptrs, dq.data_ptr(), *rest)
    _build.check_launch(err, "flash_attention_bwd_dq (K3)")
    flash_attention_bwd_dq.launches += 1
    return _unpad(dq, d)


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(dk, dv)``, each (B, Tk, H, D) in k's/v's dtype. CPU tensors
    take :func:`flash_attention_bwd_dkv_plain`; CUDA tensors launch K4 or
    raise."""
    if all(t.device.type == "cpu" for t in (q, k, v, g, lse, delta)):
        return flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, causal)
    lib = _build.load_library("flash_bwd", _BWD_SIG)
    _check_bwd(q, k, v, g, lse, delta)
    d, _, (q, k, v, g) = _prepare("flash_attention_bwd", q=q, k=k, v=v,
                                  g=g)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    ptrs, rest = _bwd_args(q, k, v, g, lse, delta, causal,
                           1.0 / math.sqrt(d))
    err = lib.zoo_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    _build.check_launch(err, "flash_attention_bwd_dkv (K4)")
    flash_attention_bwd_dkv.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


#: K3 / K4 launches since the count was last set to 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward from K1's ``out`` and ``lse`` (B, H, Tq) f32 and the
    output grad ``g`` → ``(dq, dk, dv)``. CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch K3 then K4 or
    raise."""
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, g)):
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal)
    if out.shape != q.shape or out.device != q.device:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} on "
                         f"{out.device} does not match q {tuple(q.shape)}")
    delta = flash_bwd_delta(out, g)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


def grad_layout(g: torch.Tensor) -> torch.Tensor:
    """An incoming output grad laid out for the backward kernels: itself
    when contiguous and 16-byte aligned, else a contiguous copy (one
    broadcast from ``.sum()`` has stride 0; the kernels take a contiguous
    head dim and, in bf16, 16-byte-aligned rows)."""
    if not g.is_contiguous() or g.data_ptr() % 16:
        g = g.clone(memory_format=torch.contiguous_format)
    return g


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward saving ``(q, k, v, out, lse)``; K3 + K4 backward (the
    port of the JAX custom VJP). On CPU tensors both halves take their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_layout(g),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise attention, (B, T, H, D) → (B, T, H, D); differentiable
    through :class:`FlashAttentionFunction`."""
    return FlashAttentionFunction.apply(q, k, v, causal)


__all__ = ["FlashAttentionFunction", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_plain", "flash_bwd_delta",
           "grad_layout",
           "kernel_head_dim", "pad_head_dim"]
