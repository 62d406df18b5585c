"""ctypes loader and Python wrappers for the host runtime
``csrc/zoo_native.cpp`` (port of ``analytics_zoo_tpu/native/lib.py``).

The library is built with ``g++`` at first use into the git-ignored
``analytics_zoo_tpu_torch/_build/``, named by a hash of the source and
flags (an edited source rebuilds; builds from several processes race
safely: per-process temp files and an atomic rename), and checked for ABI
version 1. Where no compiler is present or the build or the load fails,
every API keeps working on numpy (``native_available()`` is False), as the
JAX package's does: the fallback is the host tier's documented contract,
it runs no device code, and it is logged.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..common.locks import traced_lock

log = logging.getLogger("analytics_zoo_tpu_torch.native")

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "zoo_native.cpp"
_SO_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_ABI_VERSION = 1

_lib = None
# zoo-lock: leaf
_lib_lock = traced_lock("native._lib_lock")
_build_failed = False


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _SO_DIR / f"zoo_native_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> Optional[Path]:
    _SO_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        log.warning("native build unavailable (%s); using numpy fallback", e)
        return None
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        log.warning("native build failed; using numpy fallback:\n%s",
                    r.stderr.decode()[-2000:])
        return None
    os.replace(tmp, so)
    return so


def _bind(lib):
    """Declare the signatures and check the ABI; raises on a mismatch."""
    lib.arena_create.restype = ctypes.c_void_p
    lib.arena_create.argtypes = [ctypes.c_size_t, ctypes.c_char_p]
    lib.arena_alloc.restype = ctypes.c_int64
    lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.arena_base.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.arena_base.argtypes = [ctypes.c_void_p]
    for fn in ("arena_used", "arena_capacity"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.arena_reset.argtypes = [ctypes.c_void_p]
    lib.arena_destroy.argtypes = [ctypes.c_void_p]
    lib.arena_flush.restype = ctypes.c_int
    lib.arena_flush.argtypes = [ctypes.c_void_p]
    lib.gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.scale_shift_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_int]
    lib.zoo_native_abi_version.restype = ctypes.c_int
    if lib.zoo_native_abi_version() != _ABI_VERSION:
        raise RuntimeError("zoo_native ABI version mismatch")
    return lib


def _load():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        if not _SRC.is_file():
            log.warning("native source %s missing; using numpy fallback",
                        _SRC)
            _build_failed = True
            return None
        so = _so_path()
        for attempt in range(2):
            if not so.is_file() and _compile(so) is None:
                break
            try:
                _lib = _bind(ctypes.CDLL(str(so)))
                return _lib
            except (OSError, AttributeError, RuntimeError) as e:
                # a stale or foreign library: rebuild it once
                log.warning("native lib %s unusable (%s)%s", so, e,
                            "; rebuilding" if attempt == 0 else
                            "; using numpy fallback")
                so.unlink(missing_ok=True)
        _build_failed = True
        return None


def native_available() -> bool:
    return _load() is not None


def num_gather_threads() -> int:
    env = os.environ.get("ZOO_TPU_GATHER_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(8, (os.cpu_count() or 2) // 2))


class HostArena:
    """64-byte-aligned bump allocator over one mmap region; file-backed when
    ``backing_path`` is given (NVMe/pmem-mount tier). Allocations return
    numpy views into the arena (zero-copy)."""

    def __init__(self, capacity_bytes: int,
                 backing_path: Optional[str] = None):
        self._lib = _load()
        self.capacity = int(capacity_bytes)
        self.backing_path = backing_path
        if self._lib is None:
            self._handle = None
            self._buf = (np.memmap(backing_path, dtype=np.uint8, mode="w+",
                                   shape=(self.capacity,))
                         if backing_path
                         else np.zeros(self.capacity, np.uint8))
            self._used = 0
        else:
            self._handle = ctypes.c_void_p(self._lib.arena_create(
                self.capacity,
                backing_path.encode() if backing_path else None))
            if not self._handle.value:
                raise MemoryError(f"arena_create({capacity_bytes}) failed")
            base = self._lib.arena_base(self._handle)
            self._buf = np.ctypeslib.as_array(base, shape=(self.capacity,))

    def alloc(self, shape, dtype=np.float32) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self._lib is None:
            aligned = (self._used + 63) & ~63
            if aligned + nbytes > self.capacity:
                raise MemoryError("arena full")
            self._used = aligned + nbytes
            view = self._buf[aligned:aligned + nbytes]
        else:
            off = self._lib.arena_alloc(self._handle, nbytes)
            if off < 0:
                raise MemoryError("arena full")
            view = self._buf[off:off + nbytes]
        return view.view(dtype).reshape(shape)

    @property
    def used(self) -> int:
        if self._lib is None:
            return self._used
        return int(self._lib.arena_used(self._handle))

    def reset(self):
        if self._lib is None:
            self._used = 0
        else:
            self._lib.arena_reset(self._handle)

    def flush(self):
        """msync file-backed contents (the durability point)."""
        if self._lib is None:
            if hasattr(self._buf, "flush"):
                self._buf.flush()
        elif self._lib.arena_flush(self._handle) != 0:
            raise OSError("msync failed")

    def close(self):
        """Unmap the arena explicitly. Every array :meth:`alloc` returned
        becomes invalid. There is deliberately no ``__del__``: unmapping at
        collection under live numpy views would crash; an unclosed arena is
        reclaimed at process exit."""
        if self._lib is not None and self._handle and self._handle.value:
            self._lib.arena_destroy(self._handle)
            self._handle = ctypes.c_void_p(None)
        self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def gather_rows(src: np.ndarray, indices: np.ndarray,
                out: Optional[np.ndarray] = None,
                threads: Optional[int] = None) -> np.ndarray:
    """``out[i] = src[indices[i]]`` over axis 0: a threaded memcpy when the
    native library is available, ``src[indices]`` otherwise."""
    src = np.ascontiguousarray(src)
    if src.dtype.hasobject:
        # the C++ path would copy PyObject pointers without increfs, and
        # freeing the gathered array would then decref objects it never
        # owned
        res = src[np.asarray(indices, dtype=np.int64)]
        if out is not None:
            out[...] = res
            return out
        return res
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    n_rows = len(src)
    # numpy's semantics for negative indices, and its bounds check before
    # the native call (memcpy would read out of bounds instead of raising)
    if idx.size:
        idx = np.where(idx < 0, idx + n_rows, idx)
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n_rows:
            raise IndexError(f"index {hi if hi >= n_rows else lo - n_rows} "
                             f"out of bounds for axis 0 with size {n_rows}")
    lib = _load()
    if lib is None:
        res = src[idx]
        if out is not None:
            out[...] = res
            return out
        return res
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be C-contiguous")
    lib.gather_rows(src.ctypes.data, row_bytes, idx.ctypes.data, len(idx),
                    out.ctypes.data, threads or num_gather_threads())
    return out


def _flatten(tree):
    """``(leaves, rebuild)`` of a tree of dicts, lists and tuples: what the
    JAX package's ``jax.tree_util.tree_flatten`` gives the sample cache."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
        counts = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (_, r), n in zip(keys, parts, counts):
                out[k] = r(leaves[i:i + n])
                i += n
            return out
        return [x for p in parts for x in p[0]], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        counts = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, i = [], 0
            for (_, r), n in zip(parts, counts):
                out.append(r(leaves[i:i + n]))
                i += n
            return type(tree)(out)
        return [x for p in parts for x in p[0]], rebuild
    return [tree], lambda leaves: leaves[0]


class NativeSampleCache:
    """Arena-resident copy of an array tree with double-buffered batch
    staging: ``batch(indices)`` gathers rows into one of two reusable
    staging buffers (threaded), so consecutive batches do not allocate and
    the previous batch stays valid while the device copy of the current
    one is in flight."""

    def __init__(self, arrays, backing_path: Optional[str] = None,
                 batch_capacity: int = 0):
        leaves, self._rebuild = _flatten(arrays)
        leaves = [np.asarray(a) for a in leaves]
        total = sum(a.nbytes + 64 for a in leaves)
        self.arena = HostArena(total + 4096, backing_path)
        self._store = []
        for a in leaves:
            dst = self.arena.alloc(a.shape, a.dtype)
            np.copyto(dst, a)
            self._store.append(dst)
        self._staging = [None, None]
        self._flip = 0
        self._batch_capacity = batch_capacity

    @property
    def arrays(self):
        return self._rebuild(self._store)

    def batch(self, indices: np.ndarray):
        n = len(indices)
        cap = max(n, self._batch_capacity)
        if self._staging[self._flip] is None or \
                len(self._staging[self._flip][0]) < n:
            self._staging[self._flip] = [
                np.empty((cap,) + a.shape[1:], dtype=a.dtype)
                for a in self._store]
        bufs = self._staging[self._flip]
        self._flip ^= 1
        return self._rebuild([gather_rows(a, indices, out=b[:n])
                              for a, b in zip(self._store, bufs)])

    def close(self):
        self._store = []
        self.arena.close()
