"""Fused int8 matmul and conv: the K5 and K6 kernels, their wrappers and
their plain versions.

Port of ``analytics_zoo_tpu/ops/int8_fused.py``. K5 (``csrc/int8_matmul.cu``)
replaces the Pallas ``_int8_matmul_kernel`` and K6 (``csrc/int8_conv.cu``)
replaces ``_int8_conv_kernel``: the activations are quantized in the
wrapper's quantize pass, the products run in int32, and the per-row (or
per-pixel) scale and the per-channel weight scale are applied on the f32
accumulator. The int8 codes and their scales cross device memory once,
inside the wrapper: the quantize pass writes them to the wrapper's own
scratch and the product reads them back (below); no dequantized
intermediate reaches device memory, and no int8 tensor leaves the
wrapper.

The JAX package has two routes with different arithmetic, and the port
reproduces each as the TPU takes it (``fused_mode() == "compiled"``, the
default blocks, no tuning cache, no env override):

* the **fused** route: a matmul's activation scale is per (row, ``block_k``
  segment) with ``block_k`` from :func:`resolve_blocks`, a conv's per input
  pixel, and the scale is ``max(amax, 1e-12) * (1/127)`` (rule
  ``"fused"``);
* the **lax** route (``ops/int8.py``'s ``int8_matmul_unfused`` /
  ``int8_conv2d_unfused``): a matmul's scale is per whole row, a conv's per
  pixel at any stride, and the scale is ``max(amax, 1e-12) / 127`` (rule
  ``"lax"``), which can differ from the fused rule by one ulp.

``torch.matmul`` cannot multiply int8 on CUDA, so on the card both routes
run on the kernels: K5 takes the scale-group length (``block_k`` on the
fused route, K on the lax one) and K6 the stride and the rule. There is no
routing switch: CPU tensors take the plain versions, CUDA tensors launch
the kernel or raise.

On the card each wrapper call is two launches on the current stream (one
count): a quantize pass that writes every activation's int8 code and every
group's scale once to scratch from ``torch.empty`` (each group padded with
zero codes to ``DEPTH`` bytes; a conv's pixels at 4 bytes when Cin <= 4),
then the int8 tensor-core product, which reads the weights kernel-major
(k contiguous: :func:`kernel_major`, made once where a layer is packed and
passed as ``packed["qt"]``; made per call when the dict has none). While a
trace records in this thread (``analysis/trace.py``), a wrapper records
one site (K5, K6) whose scratch is those codes, scales and per-call
weight copies, and launches nothing.

The plain versions compute the integer products in float64, which is exact
(|sum| <= 127^2 * K < 2^53) and runs on CUDA too, then round to f32 as
``part.astype(f32)`` does, and fold segments and taps in JAX's order with
one rounding per multiply and per add.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ..analysis import trace as _trace

#: The TPU route's fixed schedule (``DEFAULT_BLOCK_M/N/K``) and its tiling
#: floors (``_MIN_M/N/K``): the shapes that tile there take the fused route.
DEFAULT_BLOCK_M, DEFAULT_BLOCK_N, DEFAULT_BLOCK_K = 256, 256, 512
_MIN_M, _MIN_N, _MIN_K = 8, 128, 128

RULES = ("fused", "lax")
_RULE_CODES = {"fused": 0, "lax": 1}
_RECIP127 = float(np.float32(1.0 / 127.0))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = (2 ** 31 - 1) // (127 * 127)    # int32 partials cannot overflow
_STEM_MAX_K = 32      # K6's window at Cin <= 4: rows and columns of a mask
# serving threads launch concurrently; a count must not lose an increment
_COUNT_LOCK = threading.Lock()

#: bytes of k one int8 tensor-core product takes: a scale group's codes
#: and weights are padded with zeros to a multiple of it
DEPTH = 32

_SIG_MM = {"zoo_int8_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
           + [ctypes.c_float, ctypes.c_void_p],
           "zoo_int8_quantize": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
           + [ctypes.c_float, ctypes.c_void_p]}
_SIG_CONV = {"zoo_int8_conv": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
             + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]}


def _pow2_floor(v: int) -> int:
    return 1 << (int(v).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << (int(v) - 1).bit_length() if v > 1 else 1


def _shrink_to_divisor(dim: int, block: int, floor: int) -> Optional[int]:
    """Largest power of two <= ``block`` that divides ``dim`` and is >=
    ``floor``; None when there is none."""
    b = _pow2_floor(block)
    while b >= floor:
        if dim % b == 0:
            return b
        b //= 2
    return None


def resolve_blocks(m: int, n: int, k: int) -> Optional[Tuple[int, int, int]]:
    """The TPU's ``(block_m, block_n, block_k)`` for an (M, K) x (K, N)
    fused matmul, or None when N or K cannot tile (the lax route). Pinned
    to the TPU's default decision: the defaults 256/256/512 and the floors
    8/128/128, with no env override and no tuning cache. Only ``block_k``
    changes the arithmetic (it is the scale-group length)."""
    bm = max(min(_pow2_floor(DEFAULT_BLOCK_M), _pow2_ceil(max(m, 1))), _MIN_M)
    bn = _shrink_to_divisor(n, min(DEFAULT_BLOCK_N, n), _MIN_N)
    bk = _shrink_to_divisor(k, min(DEFAULT_BLOCK_K, k), _MIN_K)
    if bn is None or bk is None:
        return None
    return bm, bn, bk


def _check_rule(rule: str) -> None:
    if rule not in _RULE_CODES:
        raise ValueError(f"rule must be one of {RULES}, got {rule!r}")


def group_scale(amax: torch.Tensor, rule: str) -> torch.Tensor:
    """The activation scale of a group from its f32 abs-max: ``max(amax,
    1e-12) * f32(1/127)`` (rule "fused") or ``/ 127`` (rule "lax"). Both
    operands are full tensors on amax's device, so neither side turns the
    division into a multiply by a reciprocal (CUDA does for a host
    scalar)."""
    m = torch.clamp_min(amax, 1e-12)
    if rule == "fused":
        return m * torch.full_like(m, _RECIP127)
    return m / torch.full_like(m, 127.0)


def quantize_groups(xf: torch.Tensor, rule: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of ``xf`` (f32) with one abs-max scale per
    slice along the last dim: ``(codes as f32, scale (..., 1) f32)``;
    ``round`` is half to even, as ``jnp.round``."""
    scale = group_scale(xf.abs().amax(dim=-1, keepdim=True), rule)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q, scale


def depth_of(n: int) -> int:
    """``n`` rounded up to a multiple of :data:`DEPTH`."""
    return -(-int(n) // DEPTH) * DEPTH


def kernel_major(wq: torch.Tensor) -> torch.Tensor:
    """The int8 weights with k contiguous, as the tensor cores take them:
    (K, N) -> (N, K) and (KH, KW, Cin, Cout) -> (KH, KW, Cout, Cin)."""
    return wq.transpose(-1, -2).contiguous()


def quantize_rows_plain(x2: torch.Tensor, g: int, rule: str
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernels' quantize pass writes for the rows of ``x2`` (R,
    L): int8 codes (R, L / g * depth_of(g)), each group's codes followed by
    zeros to ``depth_of(g)`` bytes, and f32 scales (R, L / g), by
    :func:`quantize_groups`."""
    _check_rule(rule)
    r, k = x2.shape
    if k % g:
        raise ValueError(f"group {g} does not divide {k}")
    q, scale = quantize_groups(x2.float().reshape(r, k // g, g), rule)
    codes = F.pad(q.to(torch.int8), (0, depth_of(g) - g))
    return codes.reshape(r, -1), scale.reshape(r, k // g)


def int8_quantize_rows(x2: torch.Tensor, g: int, rule: str = "fused"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' quantize pass alone, for checking it: CPU tensors take
    :func:`quantize_rows_plain`, CUDA tensors launch the pass K5 launches
    or raise."""
    if x2.device.type == "cpu":
        return quantize_rows_plain(x2, g, rule)
    _check_rule(rule)
    lib = _build.load_library("int8_matmul", _SIG_MM)
    if x2.device.type != "cuda" or x2.dtype not in _DTYPE_CODES \
            or x2.dim() != 2 or x2.shape[0] == 0:
        raise ValueError(f"int8_quantize_rows: x must be a non-empty 2-d "
                         f"float32/bfloat16 CUDA tensor, got {x2.dtype}"
                         f"{tuple(x2.shape)} on {x2.device}")
    r, k = x2.shape
    if not 1 <= g <= _MAX_GROUP or k % g:
        raise ValueError(f"int8_quantize_rows: group {g} must divide {k} "
                         f"and be at most {_MAX_GROUP}")
    x2 = x2.contiguous()
    codes = torch.empty((r, k // g * depth_of(g)), dtype=torch.int8,
                        device=x2.device)
    scales = torch.empty((r, k // g), dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = lib.zoo_int8_quantize(x2.data_ptr(), codes.data_ptr(),
                                scales.data_ptr(), _DTYPE_CODES[x2.dtype], r,
                                k, g, _RULE_CODES[rule], _RECIP127, stream)
    _build.check_launch(err, "int8_quantize_rows")
    return codes, scales


# ----------------------------------------------------------------- K5 matmul

def int8_matmul_fused_plain(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                            block_k: int, rule: str = "fused") -> torch.Tensor:
    """What K5 computes, step by step: for each ``block_k`` segment of K,
    quantize x's rows over the segment, multiply the codes by the int8
    weights exactly, add ``f32(part) * scale`` to the f32 accumulator; then
    ``* s_channel`` and cast to x's dtype. ``block_k = K`` with rule "lax"
    is ``int8_matmul_unfused``."""
    _check_rule(rule)
    wq = packed["q"]
    k, n = wq.shape
    if k % block_k:
        raise ValueError(f"block_k {block_k} does not divide K={k}")
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k).float()
    w = wq.to(torch.float64)
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for s0 in range(0, k, block_k):
        q, scale = quantize_groups(x2[:, s0:s0 + block_k], rule)
        part = (q.to(torch.float64) @ w[s0:s0 + block_k]).to(torch.float32)
        acc = acc + part * scale
    ws = packed["scale"].reshape(-1).float()
    return (acc * ws).to(x.dtype).reshape(lead + (n,))


def _check_packed(packed, ndim: int, what: str, dev) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    wq, ws = packed["q"], packed["scale"]
    if wq.dtype != torch.int8 or wq.dim() != ndim or not wq.is_contiguous():
        raise ValueError(f"{what}: packed['q'] must be a contiguous "
                         f"{ndim}-d int8 tensor, got {wq.dtype}"
                         f"{tuple(wq.shape)}")
    ws = ws.reshape(-1)
    if ws.dtype != torch.float32 or ws.numel() != wq.shape[-1] \
            or not ws.is_contiguous():
        raise ValueError(f"{what}: packed['scale'] must hold {wq.shape[-1]} "
                         f"f32 channel scales, got {ws.dtype}"
                         f"{tuple(packed['scale'].shape)}")
    for name, t in (("q", wq), ("scale", ws)):
        if t.device != dev:
            raise ValueError(f"{what}: packed[{name!r}] lives on {t.device}, "
                             f"x on {dev}")
    return wq, ws


def _weights_kernel_major(packed, wq: torch.Tensor, what: str
                          ) -> torch.Tensor:
    """``packed["qt"]`` checked against ``kernel_major(q)``'s geometry, or
    that copy made now when the dict has none."""
    qt = packed.get("qt")
    if qt is None:
        return kernel_major(wq)
    want = wq.shape[:-2] + (wq.shape[-1], wq.shape[-2])
    if qt.dtype != torch.int8 or tuple(qt.shape) != tuple(want) \
            or not qt.is_contiguous() or qt.device != wq.device \
            or qt.data_ptr() % 16:
        raise ValueError(f"{what}: packed['qt'] must be q kernel-major, a "
                         f"contiguous 16-byte aligned int8 {tuple(want)} on "
                         f"{wq.device}, got {qt.dtype}{tuple(qt.shape)} on "
                         f"{qt.device}")
    return qt


def int8_matmul_fused(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                      block_k: int, rule: str = "fused") -> torch.Tensor:
    """``x @ W`` over a packed (K, N) int8 kernel with the activations
    quantized per (row, ``block_k`` segment) inside the kernel. Returns
    ``x.shape[:-1] + (N,)`` in x's dtype. CPU tensors take
    :func:`int8_matmul_fused_plain`; CUDA tensors launch K5 or raise."""
    if _trace.RECORDING and _trace.recording():
        return _trace.kernel_site(
            "K5", int8_matmul_fused_plain, x, packed, block_k, rule,
            scratch_bytes=_matmul_scratch_bytes(x, packed, block_k))
    if x.device.type == "cpu":
        return int8_matmul_fused_plain(x, packed, block_k, rule)
    _check_rule(rule)
    lib = _build.load_library("int8_matmul", _SIG_MM)
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul_fused: x must be a float32/bfloat16 "
                         f"CUDA tensor, got {x.dtype} on {x.device}")
    wq, ws = _check_packed(packed, 2, "int8_matmul_fused", x.device)
    k, n = wq.shape
    if x.shape[-1] != k:
        raise ValueError(f"int8_matmul_fused: x's last dim {x.shape[-1]} != "
                         f"K={k}")
    if not 1 <= block_k <= _MAX_GROUP or k % block_k:
        raise ValueError(f"int8_matmul_fused: block_k {block_k} must divide "
                         f"K={k} and be at most {_MAX_GROUP}")
    lead = tuple(x.shape[:-1])
    if math.prod(lead) == 0:
        return torch.empty(lead + (n,), dtype=x.dtype, device=x.device)
    qt = _weights_kernel_major(packed, wq, "int8_matmul_fused")
    y = _matmul_on(lib, x.reshape(-1, k), qt, ws, block_k, rule)
    with _COUNT_LOCK:
        int8_matmul_fused.launches += 1
    return y.reshape(lead + (n,))


def _matmul_scratch_bytes(x: torch.Tensor, packed, block_k: int) -> int:
    """The bytes a K5 call allocates besides its output: the quantize
    pass's codes and scales, the kernel-major weights when ``packed`` has
    none, and their per-group padding when ``block_k`` is off the depth."""
    k, n = packed["q"].shape
    m = math.prod(tuple(x.shape[:-1]))
    if k % block_k:
        return 0                      # the plain version raises
    gp = depth_of(block_k)
    out = m * (k // block_k) * (gp + 4)
    if packed.get("qt") is None:
        out += n * k
    if gp != block_k:
        out += n * (k // block_k) * gp
    return out


def _matmul_on(lib, x2: torch.Tensor, qt: torch.Tensor, ws: torch.Tensor,
               block_k: int, rule: str) -> torch.Tensor:
    """K5's launch through ``lib``'s C entry (this tree's library, or an
    edited copy's in ``scripts/torch_int8_variants.py``): x2 (M, K) on the
    card, qt the kernel-major (N, K) weights; returns y (M, N)."""
    (m, k), n = x2.shape, qt.shape[0]
    gp = depth_of(block_k)
    if gp != block_k:                 # each group padded to the depth
        qt = F.pad(qt.view(n, k // block_k, block_k),
                   (0, gp - block_k)).reshape(n, -1)
    x2 = x2.contiguous()
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    codes = torch.empty((m, k // block_k * gp), dtype=torch.int8,
                        device=x2.device)
    scales = torch.empty((m, k // block_k), dtype=torch.float32,
                         device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = lib.zoo_int8_matmul(x2.data_ptr(), qt.data_ptr(), ws.data_ptr(),
                              y.data_ptr(), codes.data_ptr(),
                              scales.data_ptr(), _DTYPE_CODES[x2.dtype], m,
                              n, k, block_k, _RULE_CODES[rule], _RECIP127,
                              stream)
    _build.check_launch(err, "int8_matmul_fused")
    return y


#: K5 launches since the count was last set to 0
int8_matmul_fused.launches = 0


# ------------------------------------------------------------------- K6 conv

def conv_out_size(size: int, k: int, stride: int, pad: Tuple[int, int]
                  ) -> int:
    return (size + pad[0] + pad[1] - k) // stride + 1


def same_pads(in_hw: Sequence[int], k_hw: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """TF-style SAME padding (``lax.padtype_to_pads``): the output is
    ceil(in / stride), the extra pixel goes to the bottom/right."""
    pads = []
    for size, k, s in zip(in_hw, k_hw, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv_pads(padding, in_hw: Sequence[int], k_hw: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Each spatial dim's (low, high) padding for ``padding``: "SAME"
    (TF-style), "VALID", or explicit pairs."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pads(in_hw, k_hw, strides)
        if padding.upper() == "VALID":
            return ((0, 0),) * len(in_hw)
        raise ValueError(f"unknown padding {padding!r}")
    return tuple(tuple(int(v) for v in p) for p in padding)


def conv_scratch(b: int, h: int, w: int, cin: int, ho: int, wo: int,
                 kh: int, kw: int, stride: Sequence[int], pad_top: int,
                 pad_left: int) -> Tuple[int, int]:
    """The rows and the pitch in bytes of the codes K6's quantize pass
    writes: a 1x1 window at Cin > 4 that reads no padding codes only the
    pixels it reads (B * Ho * Wo rows: a quarter at stride 2), every other
    conv every input pixel (B * H * W); a row is Cin rounded up to
    :data:`DEPTH` bytes, or one 4-byte word at Cin <= 4 (the __dp4a
    kernel's)."""
    sh, sw = stride
    direct = (cin > 4 and kh == kw == 1 and pad_top == pad_left == 0
              and (ho - 1) * sh < h and (wo - 1) * sw < w)
    rows = b * ho * wo if direct else b * h * w
    return rows, (4 if cin <= 4 else depth_of(cin))


def int8_conv2d_fused_plain(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                            stride: Sequence[int] = (1, 1),
                            pads=((0, 0), (0, 0)),
                            rule: str = "fused") -> torch.Tensor:
    """What K6 computes, step by step: quantize each input pixel over its
    channels, zero-pad, and for each tap t = kh·KW + kw in order multiply
    the tap's strided window by the tap's (Cin, Cout) int8 slice exactly and
    add ``f32(part) * pixel scale`` to the f32 accumulator; then ``*
    s_channel`` and cast to x's dtype. With rule "lax" at any stride this
    is ``int8_conv2d_unfused``."""
    _check_rule(rule)
    wq = packed["q"]
    kh, kw, _, cout = wq.shape
    sh, sw = tuple(stride)
    (pt, pb), (pl, pr) = pads
    b, h, w, _ = x.shape
    ho = conv_out_size(h, kh, sh, (pt, pb))
    wo = conv_out_size(w, kw, sw, (pl, pr))
    if ho < 1 or wo < 1:
        raise ValueError(f"int8 conv: window {kh}x{kw} larger than the "
                         f"padded input {h}x{w}")
    q, scale = quantize_groups(x.float(), rule)           # per pixel
    q = F.pad(q, (0, 0, pl, pr, pt, pb))
    scale = F.pad(scale, (0, 0, pl, pr, pt, pb), value=1.0)
    w64 = wq.to(torch.float64)
    acc = torch.zeros((b, ho, wo, cout), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            rows = slice(i, i + (ho - 1) * sh + 1, sh)
            cols = slice(j, j + (wo - 1) * sw + 1, sw)
            part = (q[:, rows, cols, :].to(torch.float64) @ w64[i, j]).to(
                torch.float32)
            acc = acc + part * scale[:, rows, cols, :]
    ws = packed["scale"].reshape(-1).float()
    return (acc * ws).to(x.dtype)


def int8_conv2d_fused(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                      stride: Sequence[int] = (1, 1), pads=((0, 0), (0, 0)),
                      rule: str = "fused") -> torch.Tensor:
    """NHWC x HWIO int8 conv with per-pixel activation quantization inside
    the kernel; ``pads`` ((top, bottom), (left, right)) are zeros the
    kernel reads without a padded copy of x. Returns (B, Ho, Wo, Cout) in
    x's dtype. CPU tensors take :func:`int8_conv2d_fused_plain`; CUDA
    tensors launch K6 or raise."""
    if _trace.RECORDING and _trace.recording():
        return _trace.kernel_site(
            "K6", int8_conv2d_fused_plain, x, packed, stride, pads, rule,
            scratch_bytes=_conv_scratch_bytes(x, packed, stride, pads))
    if x.device.type == "cpu":
        return int8_conv2d_fused_plain(x, packed, stride, pads, rule)
    _check_rule(rule)
    lib = _build.load_library("int8_conv", _SIG_CONV)
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODES \
            or x.dim() != 4:
        raise ValueError(f"int8_conv2d_fused: x must be a (B, H, W, Cin) "
                         f"float32/bfloat16 CUDA tensor, got {x.dtype}"
                         f"{tuple(x.shape)} on {x.device}")
    wq, ws = _check_packed(packed, 4, "int8_conv2d_fused", x.device)
    kh, kw, cin, cout = wq.shape
    b, h, w, c = x.shape
    sh, sw = (int(s) for s in stride)
    (pt, pb), (pl, pr) = pads
    if c != cin or sh < 1 or sw < 1 or min(pt, pb, pl, pr) < 0 \
            or cin > _MAX_GROUP or (cin <= 4 and max(kh, kw) > _STEM_MAX_K):
        raise ValueError(f"int8_conv2d_fused: x {tuple(x.shape)} vs kernel "
                         f"{tuple(wq.shape)}, stride {stride}, pads {pads}")
    ho = conv_out_size(h, kh, sh, (pt, pb))
    wo = conv_out_size(w, kw, sw, (pl, pr))
    if ho < 1 or wo < 1:
        raise ValueError(f"int8 conv: window {kh}x{kw} larger than the "
                         f"padded input {h}x{w}")
    if b == 0:
        return torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    qt = _weights_kernel_major(packed, wq, "int8_conv2d_fused")
    y = _conv_on(lib, x, qt, ws, (sh, sw), pads, rule)
    with _COUNT_LOCK:
        int8_conv2d_fused.launches += 1
    return y


def _conv_scratch_bytes(x: torch.Tensor, packed, stride, pads) -> int:
    """The bytes a K6 call allocates besides its output: the quantize
    pass's codes and scales (:func:`conv_scratch`), the kernel-major
    weights when ``packed`` has none, and their Cin padding."""
    kh, kw, cin, cout = packed["q"].shape
    b, h, w, _ = x.shape
    sh, sw = (int(s) for s in stride)
    (pt, pb), (pl, pr) = pads
    ho = conv_out_size(h, kh, sh, (pt, pb))
    wo = conv_out_size(w, kw, sw, (pl, pr))
    if ho < 1 or wo < 1:
        return 0                      # the plain version raises
    rows, pitch = conv_scratch(b, h, w, cin, ho, wo, kh, kw, (sh, sw), pt,
                               pl)
    out = rows * (pitch + 4)
    if packed.get("qt") is None:
        out += kh * kw * cout * cin
    if cin > 4 and pitch != cin:
        out += kh * kw * cout * pitch
    return out


def _conv_on(lib, x: torch.Tensor, qt: torch.Tensor, ws: torch.Tensor,
             stride: Tuple[int, int], pads, rule: str) -> torch.Tensor:
    """K6's launch through ``lib``'s C entry (this tree's library, or an
    edited copy's in ``scripts/torch_int8_variants.py``): x (B, H, W, Cin)
    on the card, qt the kernel-major (KH, KW, Cout, Cin) weights; returns
    y (B, Ho, Wo, Cout)."""
    kh, kw, cout, cin = qt.shape
    b, h, w, _ = x.shape
    (sh, sw), ((pt, pb), (pl, pr)) = stride, pads
    ho = conv_out_size(h, kh, sh, (pt, pb))
    wo = conv_out_size(w, kw, sw, (pl, pr))
    rows, pitch = conv_scratch(b, h, w, cin, ho, wo, kh, kw, (sh, sw), pt,
                               pl)
    if cin > 4 and pitch != cin:      # Cin padded to the depth
        qt = F.pad(qt, (0, pitch - cin))
    x = x.contiguous()
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    codes = torch.empty((rows, pitch), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.zoo_int8_conv(x.data_ptr(), qt.data_ptr(), ws.data_ptr(),
                            y.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                            _DTYPE_CODES[x.dtype], b, h, w, cin, ho, wo, cout,
                            kh, kw, sh, sw, pt, pl, _RULE_CODES[rule],
                            _RECIP127, rows, pitch, stream)
    _build.check_launch(err, "int8_conv2d_fused")
    return y


#: K6 launches since the count was last set to 0
int8_conv2d_fused.launches = 0


__all__ = ["DEFAULT_BLOCK_K", "DEFAULT_BLOCK_M", "DEFAULT_BLOCK_N", "DEPTH",
           "RULES", "conv_out_size", "conv_pads", "conv_scratch", "depth_of",
           "group_scale", "int8_conv2d_fused", "int8_conv2d_fused_plain",
           "int8_matmul_fused", "int8_matmul_fused_plain",
           "int8_quantize_rows", "kernel_major", "quantize_groups",
           "quantize_rows_plain", "resolve_blocks", "same_pads"]
