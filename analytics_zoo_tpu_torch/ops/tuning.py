"""The Hopper tile table: which compiled tile each tiled kernel runs at a
shape, swept on the card and kept in an on-disk cache.

Port of ``analytics_zoo_tpu/ops/tuning.py``, with its public names and its
file schema. K1 with K3/K4 (op ``flash``), K2 (op ``paged``) and K5 (op
``int8_matmul``) each compile a short list of tiles (``FLASH_CANDIDATES``,
``PAGED_CANDIDATES``, ``MATMUL_CANDIDATES``); each kernel's C entry takes
the list's index and refuses one past it. Entry 0 is the tile each kernel
ran before it had a table, and it is what every call runs when the table
has no entry: with an empty cache the port computes what it computed
without one, launch for launch.

A sweep (:func:`tune_flash_blocks`, :func:`tune_paged_attention`,
:func:`tune_int8_matmul`) runs on the card only. It times each candidate
with CUDA events over a few launches, L2 flushed before each and the call
queued behind a spinning kernel, so that the events hold the device's
time and not the wrapper's host work, through the same wrapper the main
path calls, and holds each one to the kernel's plain
version at the swept shape (int8 bit for bit; attention 1e-4 in f32, 2e-2
in bf16). A candidate that disagrees or cannot launch is recorded with an
``error`` and never wins. The winner is written with ``swept``,
``elapsed_ms`` and, in place of the JAX entry's ``hbm``, its instance's
registers and shared memory (``cudaFuncGetAttributes``).

The table chooses a tile and never the arithmetic: K5's scale-group
length (``block_k``, from ``int8_fused.resolve_blocks``) stays the TPU's
default decision, where the JAX table's entry would change it.

Cache location: ``ZOO_TPU_TUNING_CACHE`` env, else
``~/.cache/analytics_zoo_tpu_torch/tuning.json``. Schema::

    {"version": 1,
     "devices": {"<torch.cuda.get_device_name()>": {
        "int8_matmul": {"<Mbucket>x<N>x<K>/<dtype>":
            {"tile": 1, "candidate": "wgmma 128x128, 4 stages",
             "elapsed_ms": 0.106, "regs": 168, "static_smem": 64,
             "dynamic_smem": 132096, "swept": [...]}},
        "flash": {"<Tq>x<Tk>x<d>/<dtype>": {"tile": 0, ...}},
        "paged": {"<q_len>x<pages>x<page>x<H>x<D>/<dtype>": {...}}}}}

The wrappers resolve their tile once per distinct shape and process into
an in-memory memo (one dict read after the first), so the hit and miss
counters (``zoo_kernel_tuning_cache_hits_total``, ``..._misses_total``)
count once per distinct key in a process, where JAX's count once per
trace. :func:`invalidate` drops the memo and the parsed file.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import telemetry as _tm

log = logging.getLogger("analytics_zoo_tpu_torch.ops.tuning")

_SWEEPS = _tm.counter("zoo_kernel_tuning_sweeps_total",
                      "Autotuner candidate sweeps executed (one per "
                      "(op, shape-bucket, dtype) tuned this process)",
                      labels=("op",))
_HITS = _tm.counter("zoo_kernel_tuning_cache_hits_total",
                    "Kernel-schedule lookups answered from the tuning cache",
                    labels=("op",))
_MISSES = _tm.counter("zoo_kernel_tuning_cache_misses_total",
                      "Kernel-schedule lookups that fell back to the fixed "
                      "default blocks (shape/device never tuned)",
                      labels=("op",))

_CACHE_VERSION = 1
_memo: Dict[str, dict] = {}              # path -> parsed cache
#: the wrappers' memo: (op, the tensor's device index, *shape, dtype) ->
#: tile index
_tiles: Dict[tuple, int] = {}
_LOCK = threading.Lock()


def cache_path() -> str:
    return os.environ.get(
        "ZOO_TPU_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "analytics_zoo_tpu_torch", "tuning.json"))


def device_kind(device=None) -> str:
    """Cache key: the card's name (``torch.cuda.get_device_name``), so a
    TPU's or another card's entries never apply; ``cpu`` on a host without
    CUDA (where no kernel reads the table)."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def invalidate() -> None:
    """Drop the parsed cache and the wrappers' tile memo (tests; an
    external re-tune)."""
    with _LOCK:
        _memo.clear()
        _tiles.clear()


def _load(path: str) -> dict:
    cached = _memo.get(path)
    if cached is not None:
        return cached
    data: dict = {"version": _CACHE_VERSION, "devices": {}}
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict) and raw.get("version") == _CACHE_VERSION:
            data = raw
    except (OSError, ValueError):
        pass
    _memo[path] = data
    return data


def _store(path: str, data: dict) -> None:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)        # atomic: a killed sweep can't corrupt
    except OSError:
        pass                         # the cache is a choice, never a fault
    _memo[path] = data


def bucket(n: int) -> int:
    """Power-of-two shape bucket (the serving batcher's ladder, so one
    entry covers every batch the bucket admits)."""
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype                 # numpy knows it only with ml_dtypes
    return np.dtype(dtype).name


def shape_key(*dims: int, dtype=None) -> str:
    key = "x".join(str(int(d)) for d in dims)
    return f"{key}/{_dtype_name(dtype)}" if dtype is not None else key


def lookup(op: str, key: str, device=None) -> Optional[dict]:
    """Cached entry for (device kind, op, key), or None. Counts a hit or a
    miss."""
    with _LOCK:
        entry = (_load(cache_path()).get("devices", {})
                 .get(device_kind(device), {}).get(op, {}).get(key))
    (_HITS if entry else _MISSES).labels(op=op).inc()
    return entry


def record(op: str, key: str, entry: dict, device=None) -> None:
    path = cache_path()
    kind = device_kind(device)
    with _LOCK:
        # read-modify-write against the CURRENT file, not the memo: another
        # process may have written winners since our first read
        _memo.pop(path, None)
        data = _load(path)
        data.setdefault("devices", {}).setdefault(kind, {}).setdefault(
            op, {})[key] = entry
        _store(path, data)
        _tiles.clear()               # the next call reads the new entry


def _entry_tile(op: str, key: str, entry: Optional[dict],
                n_tiles: int) -> Optional[int]:
    """The tile index an entry holds, or None when there is no entry or it
    is refused: an index outside the compiled list (logged; the default
    tile runs)."""
    if not entry:
        return None
    tile = entry.get("tile") if isinstance(entry, dict) else None
    if isinstance(tile, int) and not isinstance(tile, bool) \
            and 0 <= tile < n_tiles:
        return tile
    log.warning("tuning cache entry %s/%s holds tile %r outside the %d "
                "compiled tiles; refused, the default tile runs", op, key,
                tile, n_tiles)
    return None


def _read_tile(memo_key: tuple, op: str, key: str, n_tiles: int,
               device) -> int:
    """A memo miss: the cache's tile for ``key`` (read and counted once),
    entry 0 without one; stored in the memo under ``memo_key``. The
    ``*_tile`` functions read the memo first: on the hot path a call costs
    one tuple and one dict read."""
    tile = _entry_tile(op, key, lookup(op, key, device), n_tiles)
    tile = _tiles[memo_key] = 0 if tile is None else tile
    return tile


# ------------------------------------------------------------ int8 matmul op

MATMUL_OP = "int8_matmul"

#: K5's tiles (``csrc/int8_matmul.cu``, ``MatmulTile``): 0 the shape's own
#: choice (the wgmma GEMM where groups are whole 128-byte chunks and
#: 128 x 128 tiles fill the SMs, else the largest mma.sync tile giving two
#: blocks an SM), then the wgmma GEMM (groups of whole 128-byte chunks
#: only) and the mma.sync GEMM at 128 x 128 and 64 x 64 (BK 256, 128 or
#: 64 bytes by the group's depth). Every tile computes the same bits.
MATMUL_CANDIDATES: Sequence[str] = (
    "auto", "wgmma 128x128, 4 stages", "mma.sync 128x128",
    "mma.sync 64x64")


def matmul_key(m: int, n: int, k: int, dtype) -> str:
    return shape_key(bucket(m), n, k, dtype=dtype)


def matmul_lookup(m: int, n: int, k: int, dtype, device=None
                  ) -> Optional[int]:
    """The cached K5 tile index for an (M, K) x (K, N) product at this
    shape bucket, or None (callers run entry 0)."""
    key = matmul_key(m, n, k, dtype)
    return _entry_tile(MATMUL_OP, key, lookup(MATMUL_OP, key, device),
                       len(MATMUL_CANDIDATES))


def matmul_tile(m: int, n: int, k: int, dtype: torch.dtype,
                device: torch.device) -> int:
    """K5's tile for a call, from the memo after the first."""
    mb = bucket(m)
    memo = (MATMUL_OP, device.index, mb, n, k, dtype)
    tile = _tiles.get(memo)
    if tile is None:
        tile = _read_tile(memo, MATMUL_OP, shape_key(mb, n, k, dtype=dtype),
                          len(MATMUL_CANDIDATES), device)
    return tile


# ------------------------------------------------------------------- flash op

FLASH_OP = "flash"

#: K1/K3/K4's bf16 tiles a head-dim class (the kernels' head dim, a
#: multiple of 8, up to 64, 128 or 256): (K1's K/V tile keys, K1's ring
#: stages, K3/K4's ring stages). One index picks the three kernels'
#: instances (``with_wgmma_tile`` in ``csrc/flash_fwd.cu``,
#: ``with_dq_tile``/``with_dkv_tile`` in ``csrc/flash_bwd.cu``). f32 and
#: head dims past 256 run one tile and read no table.
FLASH_CANDIDATES: Dict[int, Sequence[Tuple[int, int, int]]] = {
    64: ((128, 2, 3), (128, 3, 2), (64, 2, 3)),
    128: ((128, 2, 3), (64, 3, 2)),
    256: ((32, 2, 3), (32, 3, 2)),
}


def flash_class(width: int, dtype) -> Optional[int]:
    """The head-dim class of the bf16 tensor-core kernels at the kernels'
    head dim ``width``, or None where the table does not apply."""
    if _dtype_name(dtype) != "bfloat16" or width % 8 or width > 256:
        return None
    return 64 if width <= 64 else 128 if width <= 128 else 256


def flash_key(t_q: int, t_k: int, dtype, *, d: Optional[int] = None) -> str:
    """JAX's ``<Tq>x<Tk>/<dtype>``; with ``d``, ``<Tq>x<Tk>x<d>/<dtype>``.
    The port's table keys on the head dim as well (the deliberate
    difference: a Hopper tile's shared memory and registers grow with it,
    where JAX's blocks do not depend on it)."""
    dims = (t_q, t_k) if d is None else (t_q, t_k, d)
    return shape_key(*dims, dtype=dtype)


def flash_lookup(t_q: Optional[int], t_k: Optional[int],
                 dtype=torch.bfloat16, *, d: int = 64,
                 device=None) -> Optional[int]:
    """The cached flash tile index for a (T_q, T_k, d) call, or None."""
    cls = flash_class(-(-d // 8) * 8 if d <= 256 else d, dtype)
    if not t_q or not t_k or cls is None:
        return None
    key = flash_key(t_q, t_k, dtype, d=d)
    return _entry_tile(FLASH_OP, key, lookup(FLASH_OP, key, device),
                       len(FLASH_CANDIDATES[cls]))


def flash_tile(t_q: int, t_k: int, d: int, width: int, dtype: torch.dtype,
               device: torch.device) -> int:
    """K1/K3/K4's tile for a call at head dim ``d`` (the kernels run it at
    ``width``), from the memo after the first; 0 outside the table (no
    lookup, no count)."""
    memo = (FLASH_OP, device.index, t_q, t_k, d, dtype)
    tile = _tiles.get(memo)
    if tile is None:
        cls = flash_class(width, dtype)
        if cls is None:
            tile = _tiles[memo] = 0
        else:
            tile = _read_tile(memo, FLASH_OP,
                              flash_key(t_q, t_k, dtype, d=d),
                              len(FLASH_CANDIDATES[cls]), device)
    return tile


# ------------------------------------------------------------------ paged op

PAGED_OP = "paged"

#: K2's bf16 tiles: the positions a split of the context covers, rounded
#: up to whole pages and capped at 128 pages (``kSplitPositions`` in
#: ``csrc/paged_attention.cu``). Entry 0 is the kernel's default.
PAGED_CANDIDATES: Sequence[int] = (128, 256, 512, 1024)
_MAX_SPAN_PAGES = 128


def split_span(page_size: int, tile: int) -> int:
    """Positions a split of tile ``tile`` covers (the C entry's
    ``split_span``)."""
    pages = -(-PAGED_CANDIDATES[tile] // page_size)
    return page_size * min(pages, _MAX_SPAN_PAGES)


def paged_key(q_len: int, pages_per_slot: int, page_size: int, h: int,
              d: int, dtype) -> str:
    return shape_key(q_len, pages_per_slot, page_size, h, d, dtype=dtype)


def paged_lookup(q_len: int, pages_per_slot: int, page_size: int, h: int,
                 d: int, dtype, device=None) -> Optional[int]:
    """The cached K2 tile index at this cache geometry, or None."""
    key = paged_key(q_len, pages_per_slot, page_size, h, d, dtype)
    return _entry_tile(PAGED_OP, key, lookup(PAGED_OP, key, device),
                       len(PAGED_CANDIDATES))


def paged_tile(q_len: int, pages_per_slot: int, page_size: int, h: int,
               d: int, dtype: torch.dtype, device: torch.device) -> int:
    """K2's tile for a call, from the memo after the first."""
    memo = (PAGED_OP, device.index, q_len, pages_per_slot, page_size, h, d,
            dtype)
    tile = _tiles.get(memo)
    if tile is None:
        tile = _read_tile(memo, PAGED_OP,
                          paged_key(q_len, pages_per_slot, page_size, h, d,
                                    dtype),
                          len(PAGED_CANDIDATES), device)
    return tile


# ------------------------------------------------------------------- sweeps

def _cuda(device) -> torch.device:
    """The sweep's card; raises without one (a sweep times the card)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"a tile sweep runs on a CUDA card; got {device} "
                           f"(CUDA available: {torch.cuda.is_available()})")
    return device


#: cycles the card spins before each timed call (~1 ms): longer than any
#: wrapper's host work, so the call's launches are queued before the start
#: event fires and the events hold device time only
_SPIN_CYCLES = 2_000_000


def _device_ms(fn: Callable[[], Any], device, iters: int) -> float:
    """Median device ms of ``fn`` over ``iters`` calls, each between two
    CUDA events after an L2 flush (a 64 MB write) and a spin kernel
    (``torch.cuda._sleep``), both outside the events."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    fn()                                      # build, grant, warm
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max(1, max |ref|), in f32."""
    g, r = got.float(), ref.float()
    return float((g - r).abs().max()) / max(1.0, float(r.abs().max()))


def _attrs(fn: Callable, *args) -> dict:
    """An instance's registers and shared memory from its library's
    ``*_attrs`` entry, or {} where it has none."""
    import ctypes

    out = (ctypes.c_int * 3)()
    if fn(*args, out) != 0:
        return {}
    return {"regs": out[0], "static_smem": out[1], "dynamic_smem": out[2]}


def _sweep(op: str, key: str, tiles: Sequence[int], describe, run,
           check, attrs, device, iters: int,
           extra: Optional[dict] = None) -> Optional[dict]:
    """Time and check each tile; record (with ``extra``) and return the
    fastest that holds to the plain version, or None when none does."""
    _SWEEPS.labels(op=op).inc()
    swept: List[dict] = []
    for tile in tiles:
        entry = {"tile": tile, "candidate": describe(tile)}
        try:
            err = check(run(tile))
            if err is not None:
                entry["error"] = err
            else:
                entry["elapsed_ms"] = round(
                    _device_ms(lambda t=tile: run(t), device, iters), 5)
        except (RuntimeError, ValueError) as e:  # cannot launch: skip it
            entry["error"] = str(e)[:200]
        swept.append(entry)
    timed = [e for e in swept if "elapsed_ms" in e]
    if not timed:
        return None
    best = dict(min(timed, key=lambda e: e["elapsed_ms"]))
    best.update(attrs(best["tile"]))
    best.update(extra or {})
    best["swept"] = swept
    record(op, key, best, device)
    return best


def tune_int8_matmul(m: int, n: int, k: int, dtype=torch.float32, *,
                     candidates: Optional[Sequence[int]] = None,
                     iters: int = 3, device="cuda") -> Optional[dict]:
    """Sweep K5's tiles for one (M bucket, N, K, dtype) on the card: each
    through ``int8_matmul_fused`` on the route the shape takes on the main
    path (``ops/int8.py``: the fused route at the TPU's ``block_k`` where
    ``resolve_blocks`` tiles, else the lax route, one group of K) and held
    to ``int8_matmul_fused_plain`` bit for bit. Records and returns the
    winner, or None where no tile holds."""
    from . import int8_fused
    from .int8 import quantize_weight

    device = _cuda(device)
    mb = bucket(m)
    blocks = int8_fused.resolve_blocks(mb, n, k)
    block_k, rule = (blocks[2], "fused") if blocks else (k, "lax")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(mb, k)).astype(np.float32)).to(
        device=device, dtype=dtype)
    w = quantize_weight(rng.normal(size=(k, n)).astype(np.float32))
    packed = {"q": torch.as_tensor(w["q"]).to(device),
              "scale": torch.as_tensor(w["scale"]).to(device)}
    packed["qt"] = int8_fused.kernel_major(packed["q"])
    ref = int8_fused.int8_matmul_fused_plain(x, packed, block_k, rule)
    lib = int8_fused._build.load_library("int8_matmul",
                                         int8_fused._SIG_MM)

    def check(y):
        return None if torch.equal(y, ref) else \
            f"differs from the plain version: max |d| " \
            f"{float((y.float() - ref.float()).abs().max())}"

    return _sweep(
        MATMUL_OP, matmul_key(m, n, k, dtype),
        candidates if candidates is not None
        else range(len(MATMUL_CANDIDATES)),
        lambda t: MATMUL_CANDIDATES[t],
        lambda t: int8_fused.int8_matmul_fused(x, packed, block_k, rule,
                                               tile=t),
        check,
        lambda t: _attrs(lib.zoo_int8_matmul_attrs,
                         int8_fused._DTYPE_CODES[dtype], mb, n, k, block_k,
                         t),
        device, iters, extra={"group": block_k, "rule": rule})


def tune_flash_blocks(t_q: int, t_k: int, *, batch: int = 1,
                      heads: int = 8, d: int = 128, dtype=torch.bfloat16,
                      causal: bool = True, with_backward: bool = True,
                      candidates: Optional[Sequence[int]] = None,
                      iters: int = 3, device="cuda") -> Optional[dict]:
    """Sweep K1's (and, ``with_backward``, K3's and K4's) tiles at one
    (T_q, T_k, d) on the card, timing forward plus backward as JAX's
    sweep does; each tile held to the plain versions (1e-4 in f32, 2e-2
    in bf16, relative to max(1, max |ref|)). Records and returns the
    winner, or None where the head dim has no table or no tile holds."""
    from . import flash_attention as fa

    device = _cuda(device)
    width = fa.kernel_head_dim(d, dtype)
    cls = flash_class(width, dtype)
    if cls is None:
        return None
    rng = np.random.default_rng(0)

    def make(t):
        return torch.as_tensor(rng.normal(size=(batch, t, heads, d)).astype(
            np.float32)).to(device=device, dtype=dtype)

    q, k, v, g = make(t_q), make(t_k), make(t_k), make(t_q)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal)
    refs = (ref_out, ref_lse)
    if with_backward:
        refs += fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, g,
                                             causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4

    def run(tile):
        out, lse = fa.flash_attention_fwd(q, k, v, causal, tile=tile)
        if not with_backward:
            return out, lse
        return (out, lse) + fa.flash_attention_bwd(q, k, v, out, lse, g, causal,
                                               tile=tile)

    def check(outs):
        errs = [_rel_err(a, b) for a, b in zip(outs, refs)]
        bad = max(errs)
        return None if bad <= tol else \
            f"differs from the plain version: error {bad:.3g} > {tol}"

    fwd = fa._build.load_library("flash_fwd", fa._SIG)
    bwd = fa._build.load_library("flash_bwd", fa._BWD_SIG)

    def attrs(tile):
        out = {"fwd": _attrs(fwd.zoo_flash_fwd_attrs, width, tile)}
        if with_backward:
            out["bwd_dq"] = _attrs(bwd.zoo_flash_bwd_dq_attrs, width, tile)
            out["bwd_dkv"] = _attrs(bwd.zoo_flash_bwd_dkv_attrs, width, tile)
        return out

    table = FLASH_CANDIDATES[cls]
    return _sweep(FLASH_OP, flash_key(t_q, t_k, dtype, d=d),
                  candidates if candidates is not None
                  else range(len(table)),
                  lambda t: {"kv_tile": table[t][0], "stages": table[t][1],
                             "bwd_stages": table[t][2]},
                  run, check, attrs, device, iters,
                  extra={"with_backward": with_backward})


def tune_paged_attention(q_len: int, pages_per_slot: int, page_size: int,
                         h: int, d: int, dtype=torch.bfloat16, *,
                         n_slots: int = 8,
                         candidates: Optional[Sequence[int]] = None,
                         iters: int = 3, device="cuda") -> Optional[dict]:
    """Sweep K2's split spans at one cache geometry on the card (B =
    n_slots, half-full slots: ``synthetic_paged_case``), each held to
    ``paged_attention_plain`` (1e-4 in f32, 2e-2 in bf16). Records and
    returns the winner, or None where K2 runs an FMA kernel (no table)
    or no tile holds."""
    from . import paged_attention as pa

    device = _cuda(device)
    if _dtype_name(dtype) != "bfloat16" or d % 8 or d > 256:
        return None
    case = pa.synthetic_paged_case(
        n_slots, pages_per_slot, page_size, h, d, q_len=q_len, dtype=dtype,
        device=device, generator=torch.Generator().manual_seed(0))
    ref = pa.paged_attention_plain(*case, page_size=page_size)
    lib = pa._build.load_library("paged_attention", pa._SIG)

    def check(out):
        err = _rel_err(out, ref)
        return None if err <= 2e-2 else \
            f"differs from the plain version: error {err:.3g} > 2e-2"

    return _sweep(
        PAGED_OP, paged_key(q_len, pages_per_slot, page_size, h, d, dtype),
        candidates if candidates is not None
        else range(len(PAGED_CANDIDATES)),
        lambda t: {"split_positions": PAGED_CANDIDATES[t],
                   "span": split_span(page_size, t)},
        lambda t: pa.paged_attention(*case, page_size=page_size, tile=t),
        check, lambda t: _attrs(lib.zoo_paged_attention_attrs, d, t),
        device, iters)


__all__ = ["FLASH_CANDIDATES", "FLASH_OP", "MATMUL_CANDIDATES", "MATMUL_OP",
           "PAGED_CANDIDATES", "PAGED_OP", "bucket", "cache_path",
           "device_kind", "flash_class", "flash_key", "flash_lookup",
           "flash_tile", "invalidate", "lookup", "matmul_key",
           "matmul_lookup", "matmul_tile", "paged_key", "paged_lookup",
           "paged_tile", "record", "shape_key", "split_span",
           "tune_flash_blocks", "tune_int8_matmul", "tune_paged_attention"]
