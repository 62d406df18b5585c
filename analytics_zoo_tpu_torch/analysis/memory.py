"""Memory layer: static live-range analysis of a recorded call, and the
allocation-witness check (port of ``analytics_zoo_tpu/analysis/memory.py``).

* **Live-range walk** — :func:`profile_trace` walks a
  :class:`~analysis.trace.Trace` in order, over the ops outside kernel
  sites, tracking the live set: the argument storages (weights, state, the
  KV pool) are live throughout; a temporary is born at the op whose output
  is a storage not seen before and dies after its last use; the trace's
  outputs live to the end. In-place writes and views allocate nothing —
  the port's counterpart of the JAX package's donation credit, which is
  how the decode step's page pool avoids a second pool-sized buffer. A
  kernel site adds its outputs and, for the length of the site, the
  scratch its wrapper allocates (K2's split partials and counters, K5/K6's
  quantize codes and scales); the plain version's ops inside the site
  hold nothing (a kernel's registers and shared memory). Ops on host
  values (:mod:`analysis.trace`) hold no device memory. The result is an
  **estimate** of the call's device high-water mark (the caching
  allocator rounds and keeps freed blocks, Python frees later than the
  last use), deterministic and computed without running anything — what a
  budget gate needs.
* **Buffer table** — :func:`memory_fields`: the argument, output,
  temporary and alias bytes of a recorded call, in the field names of the
  JAX package's compiled memory analysis (``alias_size_in_bytes``: outputs
  that are arguments written in place).
* **Witness check** — :func:`check_memory_witness` cross-checks the
  run-time allocation witness (:mod:`analytics_zoo_tpu_torch.common.
  memwitness`, ``ZOO_TPU_MEM_WITNESS``) against the static peaks and the
  declared budget.

The JAX package's XLA dump parser (``parse_xla_memory_analysis``) has no
counterpart: the port compiles no XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .core import Finding, finding
from .trace import Trace

__all__ = [
    "DIVERGENCE_FACTOR", "DIVERGENCE_MIN_BYTES", "MemoryProfile",
    "Temporary", "check_memory_witness", "memory_fields", "profile_trace",
]


@dataclasses.dataclass
class Temporary:
    """One intermediate storage the walk saw born in device memory."""

    nbytes: int
    primitive: str                # the op's short name, or the kernel's
    shape: Tuple[int, ...]
    dtype: str
    op: int                       # the op's index in the trace
    in_loop: bool = False         # inside the accumulation loop

    def as_dict(self) -> Dict[str, Any]:
        return {"nbytes": self.nbytes, "primitive": self.primitive,
                "shape": list(self.shape), "dtype": self.dtype,
                "op": self.op, "in_loop": self.in_loop}


@dataclasses.dataclass
class MemoryProfile:
    """Static live-range estimate for one recorded call."""

    peak_live_bytes: int = 0            # resident + worst concurrent set
    peak_op: Optional[Tuple[int, str]] = None    # (op index, name)
    resident_bytes: int = 0             # argument storages (always live)
    arg_bytes: int = 0                  # all argument leaves
    written_arg_bytes: int = 0          # argument storages written in place
    out_bytes: int = 0                  # output leaves
    aliased_out_bytes: int = 0          # outputs that are argument storages
    largest_arg_leaf_bytes: int = 0
    temporaries: List[Temporary] = dataclasses.field(default_factory=list)
    n_ops: int = 0

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["temporaries"] = [t.as_dict() for t in self.temporaries]
        return d


def profile_trace(trace: Trace, top_k: int = 8) -> MemoryProfile:
    """The static live-range profile of ``trace`` (module docstring);
    ``peak_live_bytes`` is the device high-water estimate the
    ``hbm-budget`` rule compares against the declared budget. Memoized on
    the trace."""
    memo = getattr(trace, "_profile", None)
    if memo is not None and memo[0] == top_k:
        return memo[1]
    prof = MemoryProfile()
    sizes: Dict[int, int] = {}
    for a in trace.args:
        prof.arg_bytes += a.nbytes
        prof.largest_arg_leaf_bytes = max(prof.largest_arg_leaf_bytes,
                                          a.nbytes)
        sizes[a.storage] = a.storage_nbytes
    resident = sum(sizes.values())
    prof.resident_bytes = resident
    arg_storages = set(sizes)
    out_storages = {o.storage for o in trace.outputs}
    for o in trace.outputs:
        prof.out_bytes += o.nbytes
        if o.storage in arg_storages:
            prof.aliased_out_bytes += o.nbytes
    ops = [op for op in trace.ops if not op.in_kernel]
    # the last op that reads or writes each storage; outputs live to the end
    last: Dict[int, int] = {}
    for i, op in enumerate(ops):
        for t in op.inputs + op.outputs:
            last[t.storage] = i
    for s in out_storages:
        last[s] = len(ops)
    written = set()
    alive: Dict[int, int] = {}
    known = set(arg_storages)
    peak, peak_op = resident, None
    temps: List[Temporary] = []
    for i, op in enumerate(ops):
        written |= op.written & arg_storages
        born = {}
        for t in op.outputs:
            if t.storage not in known:
                known.add(t.storage)
                born[t.storage] = t.storage_nbytes
                if t.storage not in out_storages and t.storage_nbytes:
                    temps.append(Temporary(t.storage_nbytes, op.kind,
                                           t.shape, t.dtype, op.index,
                                           op.in_loop))
        concurrent = (resident + sum(alive.values()) + sum(born.values())
                      + op.scratch_bytes)
        if concurrent > peak:
            peak, peak_op = concurrent, (op.index, op.kind)
        for s in [s for s in alive if last.get(s, -1) <= i]:
            del alive[s]
        for s, b in born.items():
            if last.get(s, -1) > i:
                alive[s] = b
    prof.written_arg_bytes = sum(sizes[s] for s in written)
    prof.peak_live_bytes = peak
    prof.peak_op = peak_op
    prof.n_ops = len(ops)
    temps.sort(key=lambda t: -t.nbytes)
    prof.temporaries = temps[:max(1, top_k)]
    trace._profile = (top_k, prof)
    return prof


def memory_fields(trace: Trace) -> Dict[str, int]:
    """The JAX package's compiled memory-analysis fields for a recorded
    call: ``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``alias_size_in_bytes`` (outputs that are arguments written in place:
    the donated pool's counterpart), ``temp_size_in_bytes`` (the peak's
    part above the arguments) and ``hbm_peak_bytes``."""
    prof = profile_trace(trace)
    return {"argument_size_in_bytes": prof.resident_bytes,
            "output_size_in_bytes": prof.out_bytes,
            "alias_size_in_bytes": prof.aliased_out_bytes,
            "temp_size_in_bytes": prof.peak_live_bytes - prof.resident_bytes,
            "hbm_peak_bytes": prof.peak_live_bytes}


# --------------------------------------------------------------------------
# witness cross-check (the CI gate's offline half; the run-time sampler
# lives in common/memwitness.py)
# --------------------------------------------------------------------------

#: measured-over-static slack before the divergence warning fires: the
#: witness sees the whole process (every model, cache and dataset on the
#: device), the static profile one call — a factor two is ordinary, an
#: order of magnitude means something big escaped the trace.
DIVERGENCE_FACTOR = 2.0
#: ...and an absolute floor on the gap: a test-sized process kilobytes over
#: a toy estimate is trivia, not a finding.
DIVERGENCE_MIN_BYTES = 64 << 20


def check_memory_witness(samples: Dict[str, Dict[str, Any]],
                         statics: Optional[Dict[str, Dict[str, Any]]] = None,
                         budget_bytes: Optional[int] = None,
                         divergence_factor: float = DIVERGENCE_FACTOR,
                         divergence_min_bytes: int = DIVERGENCE_MIN_BYTES,
                         where: str = "witness") -> List[Finding]:
    """Cross-check a loaded memory witness against budgets and static
    peaks.

    ``samples``: per-site aggregates from
    :func:`analytics_zoo_tpu_torch.common.memwitness.load_witness` —
    ``{"n", "max_live_bytes", "min_live_bytes", "max_bytes_in_use"}``.
    ``statics``: per-site ``{"peak_bytes", "budget_bytes"}`` records the
    static analysis noted while witnessing. ``budget_bytes`` is a global
    fallback budget (the CLI's ``--budget-mb``).

    Emits ``hbm-budget`` errors when a site's measured peak (the larger of
    its live bytes and the allocator's peak) exceeds its budget, and
    ``mem-witness-divergence`` warnings when the measured peak exceeds
    ``divergence_factor x`` the site's static estimate AND the gap tops
    ``divergence_min_bytes``."""
    out: List[Finding] = []
    statics = statics or {}
    for site, agg in sorted(samples.items()):
        measured = max(int(agg.get("max_live_bytes") or 0),
                       int(agg.get("max_bytes_in_use") or 0))
        static = statics.get(site, {})
        budget = static.get("budget_bytes") or budget_bytes
        if budget and measured > budget:
            out.append(finding(
                "hbm-budget", "error", f"witness:{where}:{site}",
                f"measured peak device bytes {measured} exceed the "
                f"declared per-device budget {int(budget)} at {site} — the "
                f"run-time allocation witness saw what the static estimate "
                f"promised would not happen",
                site=site, measured_bytes=measured,
                budget_bytes=int(budget)))
        peak = static.get("peak_bytes")
        if peak and measured > divergence_factor * int(peak) \
                and measured - int(peak) > divergence_min_bytes:
            out.append(finding(
                "mem-witness-divergence", "warning",
                f"witness:{where}:{site}",
                f"measured peak {measured} bytes is more than "
                f"{divergence_factor:g}x the static estimate {int(peak)} at "
                f"{site} — allocation invisible to the traced call (a "
                f"second model, allocator fragmentation, tensors kept past "
                f"their use)",
                site=site, measured_bytes=measured,
                static_peak_bytes=int(peak),
                factor=round(measured / max(1, int(peak)), 2)))
    return out
