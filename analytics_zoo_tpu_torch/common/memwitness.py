"""Run-time allocation witness: sampled device-memory truth for the memory
lint (port of ``analytics_zoo_tpu/common/memwitness.py``).

The static memory tier (:mod:`analytics_zoo_tpu_torch.analysis.memory`)
estimates a call's device peak from its recorded trace; it cannot see
allocator fragmentation, a second model in the same process, tensors kept
past their use, or a leak that only shows under real traffic. This module
is the dynamic half — the lock witness's pattern applied to memory:

* ``ZOO_TPU_MEM_WITNESS=<path.jsonl>`` opts in. With it unset, every call
  here is a no-op after one cached boolean.
* :func:`sample` is called at **step and dispatch boundaries** (the
  Estimator at log points and epoch ends, ``InferenceModel`` dispatch, the
  continuous batcher's decode step) with the tensors the site holds. On a
  CUDA device it reads the caching allocator: ``torch.cuda.memory_allocated``
  as the live bytes and ``max_memory_allocated`` as the peak in use. On the
  CPU there is no device allocator to read: the live bytes are the unique
  storages among the tensors the site hands over (its weights, its cache),
  and there is no peak. Samples aggregate per site (count / min / max /
  last), never per sample, so the witness stays bounded.
* :func:`note_static` lets a static analysis running in the same process
  (fit-start graph checks, decode warmup) record its peak estimate and the
  declared budget alongside the measurements.
* The witness appends to the JSONL at process exit (``O_APPEND`` single
  write, like the lock witness — subprocess replicas inherit the env and
  contribute their own lines) in the JAX package's schema, and
  ``python -m analytics_zoo_tpu_torch.analysis --mem-witness <path>`` (or
  the JAX package's CLI: the same format) replays it through
  :func:`analytics_zoo_tpu_torch.analysis.memory.check_memory_witness`.

Telemetry: ``zoo_mem_witness_samples_total{site}``, ``zoo_mem_live_bytes``
(last sample), ``zoo_mem_peak_live_bytes`` (watermark).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

from . import telemetry as _tm

__all__ = [
    "dump_witness", "enabled", "load_witness", "note_static", "record_bytes",
    "reset_witness", "sample", "witness_samples", "witness_statics",
    "witness_path",
]

_SAMPLES = _tm.counter(
    "zoo_mem_witness_samples_total",
    "Memory-witness samples taken at step/dispatch boundaries "
    "(ZOO_TPU_MEM_WITNESS=<path> opts in)", labels=("site",))
_LIVE = _tm.gauge(
    "zoo_mem_live_bytes",
    "Live device bytes at the last memory-witness sample")
_PEAK = _tm.gauge(
    "zoo_mem_peak_live_bytes",
    "High-water live device bytes over all memory-witness samples")


def witness_path() -> Optional[str]:
    return os.environ.get("ZOO_TPU_MEM_WITNESS") or None


#: cached enablement; reset by :func:`reset_witness` (tests re-point the env)
_enabled_cache: Optional[bool] = None


def enabled() -> bool:
    """True when ``ZOO_TPU_MEM_WITNESS`` names a dump path (cached)."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = bool(witness_path())
    return _enabled_cache


class _MemWitness:
    """Per-site aggregates. Its lock is plain and terminal — taken briefly
    around dict updates, acquires nothing itself."""

    def __init__(self):
        self._lock = threading.Lock()
        # site -> [n, min_live, max_live, last_live, max_in_use]
        self._sites: Dict[str, list] = {}
        self._statics: Dict[str, Dict[str, Any]] = {}
        self._peak_live = 0

    def record(self, site: str, live_bytes: int,
               in_use: Optional[int]) -> None:
        with self._lock:
            agg = self._sites.get(site)
            if agg is None:
                self._sites[site] = [1, live_bytes, live_bytes, live_bytes,
                                     in_use or 0]
            else:
                agg[0] += 1
                agg[1] = min(agg[1], live_bytes)
                agg[2] = max(agg[2], live_bytes)
                agg[3] = live_bytes
                if in_use:
                    agg[4] = max(agg[4], in_use)
            if live_bytes > self._peak_live:
                self._peak_live = live_bytes
                peak = self._peak_live
            else:
                peak = None
        _LIVE.set(live_bytes)
        if peak is not None:
            _PEAK.set(peak)

    def note_static(self, site: str, peak_bytes: int,
                    budget_bytes: Optional[int]) -> None:
        with self._lock:
            rec = self._statics.setdefault(site, {})
            rec["peak_bytes"] = max(int(rec.get("peak_bytes", 0)),
                                    int(peak_bytes))
            if budget_bytes is not None:
                rec["budget_bytes"] = int(budget_bytes)

    def samples(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {s: {"n": a[0], "min_live_bytes": a[1],
                        "max_live_bytes": a[2], "last_live_bytes": a[3],
                        "max_bytes_in_use": a[4] or None}
                    for s, a in self._sites.items()}

    def statics(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {s: dict(r) for s, r in self._statics.items()}

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()
            self._statics.clear()
            self._peak_live = 0


_WITNESS = _MemWitness()


Tensors = Union[Iterable[Any], Callable[[], Iterable[Any]]]


def _measure(tensors) -> Tuple[int, Optional[int]]:
    """(live bytes, allocator peak in use or None) for a site holding
    ``tensors`` (tensors, or trees of dicts, lists and tuples of them)."""
    import torch
    from torch.utils._pytree import tree_flatten

    leaves, _ = tree_flatten(list(tensors))
    leaves = [t for t in leaves if isinstance(t, torch.Tensor)]
    cuda = next((t.device for t in leaves if t.device.type == "cuda"), None)
    if cuda is not None:
        return (int(torch.cuda.memory_allocated(cuda)),
                int(torch.cuda.max_memory_allocated(cuda)) or None)
    seen: Dict[int, int] = {}
    for t in leaves:
        st = t.untyped_storage()
        seen[st.data_ptr() or id(st)] = int(st.nbytes())
    return sum(seen.values()), None


def sample(site: str, tensors: Tensors = ()) -> None:
    """Record one boundary sample for ``site`` holding ``tensors`` (or a
    callable returning them, called only when enabled); no-op unless
    enabled."""
    if not enabled():
        return
    if callable(tensors):
        tensors = tensors()
    live, in_use = _measure(tensors)
    _WITNESS.record(site, live, in_use)
    _SAMPLES.labels(site=site).inc()
    _arm_atexit_dump()


def record_bytes(site: str, live_bytes: int) -> None:
    """Record an explicitly measured byte count for ``site``.

    The host-tier escape hatch: the device allocator cannot see
    host-resident allocations (the serving hot-row cache's DRAM tier, a
    memmap's resident pages), so components that know their own footprint
    report it here and the same per-site budget gate
    (:func:`~analytics_zoo_tpu_torch.analysis.memory.check_memory_witness`)
    applies. No-op unless enabled."""
    if not enabled():
        return
    _WITNESS.record(site, int(live_bytes), None)
    _SAMPLES.labels(site=site).inc()
    _arm_atexit_dump()


def note_static(site: str, peak_bytes: int,
                budget_bytes: Optional[int] = None) -> None:
    """Record a static peak estimate (and optional budget) for ``site`` so
    the witness check can cross-reference measured against promised; no-op
    unless enabled."""
    if not enabled():
        return
    _WITNESS.note_static(site, peak_bytes, budget_bytes)
    _arm_atexit_dump()


def witness_samples() -> Dict[str, Dict[str, Any]]:
    return _WITNESS.samples()


def witness_statics() -> Dict[str, Dict[str, Any]]:
    return _WITNESS.statics()


def reset_witness() -> None:
    """Drop all aggregates AND re-read the env (tests re-point the path)."""
    global _enabled_cache
    _enabled_cache = None
    _WITNESS.reset()


def dump_witness(path: str) -> None:
    """Append the witness as JSONL in one ``O_APPEND`` write (concurrent
    replica exits must not tear each other's lines)."""
    samples = _WITNESS.samples()
    statics = _WITNESS.statics()
    if not samples and not statics:
        return
    lines = [json.dumps({"mem_site": s, **agg})
             for s, agg in sorted(samples.items())]
    lines += [json.dumps({"mem_static": s, **rec})
              for s, rec in sorted(statics.items())]
    payload = ("\n".join(lines) + "\n").encode("utf-8")
    fd = os.open(path, os.O_APPEND | os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)


def load_witness(path: str) -> Tuple[Dict[str, Dict[str, Any]],
                                     Dict[str, Dict[str, Any]]]:
    """Parse a witness JSONL back into ``(samples, statics)``; several
    processes' dumps merge (counts sum, maxes max, mins min)."""
    samples: Dict[str, Dict[str, Any]] = {}
    statics: Dict[str, Dict[str, Any]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue        # torn concurrent append
            if "mem_site" in rec:
                s = str(rec["mem_site"])
                agg = samples.get(s)
                if agg is None:
                    samples[s] = {
                        "n": int(rec.get("n", 1)),
                        "min_live_bytes": int(rec.get("min_live_bytes", 0)),
                        "max_live_bytes": int(rec.get("max_live_bytes", 0)),
                        "last_live_bytes": int(rec.get("last_live_bytes", 0)),
                        "max_bytes_in_use":
                            rec.get("max_bytes_in_use") or None}
                else:
                    agg["n"] += int(rec.get("n", 1))
                    agg["min_live_bytes"] = min(
                        agg["min_live_bytes"],
                        int(rec.get("min_live_bytes", 0)))
                    agg["max_live_bytes"] = max(
                        agg["max_live_bytes"],
                        int(rec.get("max_live_bytes", 0)))
                    agg["last_live_bytes"] = int(rec.get("last_live_bytes", 0))
                    new_use = rec.get("max_bytes_in_use") or 0
                    agg["max_bytes_in_use"] = (
                        max(agg["max_bytes_in_use"] or 0, new_use) or None)
            elif "mem_static" in rec:
                s = str(rec["mem_static"])
                cur = statics.setdefault(s, {})
                cur["peak_bytes"] = max(int(cur.get("peak_bytes", 0)),
                                        int(rec.get("peak_bytes", 0)))
                if rec.get("budget_bytes") is not None:
                    cur["budget_bytes"] = int(rec["budget_bytes"])
    return samples, statics


_atexit_armed = False


def _arm_atexit_dump() -> None:
    global _atexit_armed
    if _atexit_armed:
        return
    _atexit_armed = True

    def _dump():
        path = witness_path()
        if path:
            try:
                dump_witness(path)
            except OSError:
                pass

    atexit.register(_dump)
