"""The fused-int8 dispatch structure rule (port of
``analytics_zoo_tpu/analysis/rules/fused_int8.py``).

The int8 tier's cost rests on three structural facts about the call
``InferenceModel.predict`` dispatches (``ops/int8_fused.py``): the K5/K6
kernels actually run; no standalone quantize op (``round``/``clamp``, the
unfused path's activation quantization in device memory) runs outside a
kernel site; and no int8 tensor is allocated outside one (the weights
enter as int8 arguments; an int8 tensor made between ops is an int8 round
trip through device memory). The codes and scales a K5/K6 wrapper writes
to its own scratch between its two launches are the kernel's, as a Pallas
kernel's VMEM is: they live inside the site. Run at model load
(``InferenceModel.check_fused_dispatch``, the serving engine's
``_warm_model``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from ..core import Finding, Rule, RuleContext, register
from ..trace import Trace

_QUANTIZE_OPS = frozenset(("round", "clamp"))
#: the int8 kernels' site names
INT8_KERNELS = ("K5", "K6")


def fused_structure_counts(trace: Trace) -> Dict[str, Any]:
    """The census the rule reports: K5/K6 sites (``kernel_calls``, and by
    kernel), quantize ops and int8 allocations outside kernel sites, and
    the combined ``fused_invariants_hold`` verdict. ``kernel_calls`` is
    the JAX census's ``pallas_calls``."""
    known = {a.storage for a in trace.args}
    by_kernel = {k: 0 for k in INT8_KERNELS}
    counts = {"kernel_calls": 0, "quantize_ops_outside_kernels": 0,
              "int8_intermediates_outside_kernels": 0}
    for op in trace.outside():
        if op.site == "kernel" and op.name in by_kernel:
            by_kernel[op.name] += 1
            counts["kernel_calls"] += 1
        if op.site is None and op.kind in _QUANTIZE_OPS:
            counts["quantize_ops_outside_kernels"] += 1
        for t in op.outputs:
            if t.storage in known:
                continue
            known.add(t.storage)
            if op.site is None and t.dtype == "int8":
                counts["int8_intermediates_outside_kernels"] += 1
    counts["fused_invariants_hold"] = bool(
        counts["kernel_calls"] >= 1
        and counts["quantize_ops_outside_kernels"] == 0
        and counts["int8_intermediates_outside_kernels"] == 0)
    counts["kernels"] = by_kernel
    return counts


@register
class FusedDispatchRule(Rule):
    """Fused-int8 dispatch structure (active when ``ctx.fused_expected``)."""

    id = "fused-int8-dispatch"
    layer = "trace"
    severity = "error"
    doc = ("With the int8 kernels expected: the dispatch must reach K5/K6, "
           "with no standalone quantize ops and no int8 tensors allocated "
           "outside the kernel sites (the device-memory round-trip shape)")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        if not ctx.fused_expected:
            return []
        c = fused_structure_counts(trace)
        out: List[Finding] = []
        if c["kernel_calls"] < 1:
            out.append(self.emit(
                ctx, "int8 kernels expected but no K5/K6 site in the "
                     "dispatch — the kernels are not dispatching (a layer "
                     "fell back to a plain path, or routing is broken)",
                kernel_calls=0))
        if c["quantize_ops_outside_kernels"]:
            out.append(self.emit(
                ctx, f"{c['quantize_ops_outside_kernels']} standalone "
                     f"quantize op(s) (round/clamp) outside kernel sites — "
                     f"activation quantization is materializing in device "
                     f"memory",
                count=c["quantize_ops_outside_kernels"]))
        if c["int8_intermediates_outside_kernels"]:
            out.append(self.emit(
                ctx, f"{c['int8_intermediates_outside_kernels']} int8 "
                     f"tensor(s) allocated outside kernel sites — int8 "
                     f"tensors are round-tripping device memory",
                count=c["int8_intermediates_outside_kernels"]))
        return out


def trace_dispatch(im, x) -> Trace:
    """Record the call ``InferenceModel.predict`` dispatches
    (``im.device_apply()`` on ``x``)."""
    from ..trace import trace_call

    apply, params, state = im.device_apply()
    return trace_call(apply, params, state, x)


def lint_fused_dispatch(im, x, ctx: Optional[RuleContext] = None
                        ) -> List[Finding]:
    """Run the fused-dispatch rule over an ``InferenceModel``'s dispatch
    (the model-load check). Returns findings."""
    from ..graphlint import lint_trace

    ctx = ctx or RuleContext(where="int8.dispatch", fused_expected=True)
    return lint_trace(trace_dispatch(im, x), ctx=ctx,
                      rules=["fused-int8-dispatch"])


def fused_dispatch_report(im, x, ctx: Optional[RuleContext] = None
                          ) -> Dict[str, Any]:
    """The census of an ``InferenceModel``'s dispatch on ``x`` plus the
    rule's findings (``"findings"``, as dicts)."""
    from ..graphlint import lint_trace

    trace = trace_dispatch(im, x)
    ctx = ctx or RuleContext(where="int8.dispatch", fused_expected=True)
    findings = lint_trace(trace, ctx=ctx, rules=["fused-int8-dispatch"])
    out = fused_structure_counts(trace)
    out["findings"] = [f.as_dict() for f in findings]
    return out


__all__ = ["FusedDispatchRule", "INT8_KERNELS", "fused_dispatch_report",
           "fused_structure_counts", "lint_fused_dispatch", "trace_dispatch"]
