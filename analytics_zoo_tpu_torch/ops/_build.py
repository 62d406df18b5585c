"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
which the kernel's wrapper loads with ``ctypes``. Libraries go to
``analytics_zoo_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Builds happen at first use, never at import.

A failed build raises with nvcc's stderr. There is no fallback: a CUDA
tensor either goes through its kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("flash_fwd", "flash_bwd", "paged_attention", "sample",
           "int8_matmul", "int8_conv")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas' report (registers, shared memory, spills) of each build this
#: process ran, by kernel name
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    cands: List[str] = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the CUDA kernels: no nvcc found (looked at "
        f"{', '.join(cands)}); the port has no fallback for CUDA tensors")


def _sources(name: str) -> List[Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    return [src] + sorted(CSRC_DIR.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together. Returns the seconds each build took (0.0 for a
    library already built). Raises with nvcc's stderr if any build fails."""
    names = list(KERNELS if names is None else names)
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.is_file()}
    secs: Dict[str, float] = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        secs[n] = time.perf_counter() - t0
        BUILD_LOG[n] = stderr
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load_library(name: str,
                 signatures: Optional[Dict[str, Sequence]] = None
                 ) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library. Every C
    entry named in ``signatures`` gets those ``argtypes`` and an ``int``
    return (the ``cudaError_t`` of its launch)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in (signatures or {}).items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry's launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


__all__ = ["BUILD_DIR", "BUILD_LOG", "CSRC_DIR", "KERNELS", "build",
           "check_launch", "library_path", "load_library", "nvcc_path"]
