"""Graph hygiene rules: host round-trips, uploaded weights, dtype leaks,
recompilation hazards (port of
``analytics_zoo_tpu/analysis/rules/graph_hygiene.py``).

The "slow but correct" hazards — nothing crashes, the profile quietly
decays:

* ``host-transfer`` — a traced tensor read on the host inside the step
  (``.item()``, ``.tolist()``, ``.cpu()`` of a device value): the host
  waits for the card every step. Host values the caller passes (numpy,
  lists) and the tensors made from them are arguments, not findings
  (:mod:`analysis.trace`);
* ``large-constant`` — a host array of at least ``const_bytes_limit``
  uploaded inside the step: the eager form of the JAX package's
  closure-captured weight, re-sent every step instead of living on the
  device as an argument;
* ``dtype-discipline`` — an f32 matmul or convolution inside a declared
  bf16 region runs at a fraction of the tensor cores' bf16 rate; any f64
  output runs off them entirely;
* ``recompile-hazard`` — a dispatch site whose distinct signatures outgrow
  the pow2 bucket ladder.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Sequence

from ..core import Finding, Rule, RuleContext, register
from ..trace import Trace

#: contraction ops the compute-dtype policy governs (aten short names)
_MATMUL_OPS = frozenset(("mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul",
                         "dot", "mv", "linear", "convolution",
                         "_convolution", "conv2d", "einsum"))


@register
class HostTransferRule(Rule):
    """Device-to-host reads inside a traced call."""

    id = "host-transfer"
    layer = "trace"
    severity = "error"
    doc = ("A traced tensor read on the host inside the step (.item(), "
           ".tolist(), .cpu() of a device value) — every step waits for "
           "the card")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for r in trace.host_reads:
            if r.in_kernel:
                continue
            out.append(self.emit(
                ctx, f"{r.what} of a traced {r.tensor.dtype}"
                     f"{r.tensor.shape} on {r.tensor.device} inside the "
                     f"traced call — host round-trip on every dispatch"
                     + (" (inside the accumulation loop: per micro-step!)"
                        if r.in_loop else ""),
                primitive=r.what, in_loop=r.in_loop))
        return out


@register
class LargeConstantRule(Rule):
    """Large host arrays uploaded inside the traced call."""

    id = "large-constant"
    layer = "trace"
    severity = "error"
    doc = ("Host arrays >= const_bytes_limit uploaded inside the traced "
           "call (weights captured by closure instead of living on the "
           "device as arguments): re-sent every step")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for u in trace.uploads:
            if u.in_kernel or u.tensor.nbytes < ctx.const_bytes_limit:
                continue
            out.append(self.emit(
                ctx, f"host array {u.tensor.dtype}{u.tensor.shape} "
                     f"({u.tensor.nbytes} bytes) uploaded inside the traced "
                     f"call by {u.op} — pass it as an argument (a module "
                     f"parameter or buffer) instead of capturing it",
                nbytes=int(u.tensor.nbytes), shape=u.tensor.shape,
                dtype=u.tensor.dtype))
        return out


@register
class DtypeDisciplineRule(Rule):
    """bf16-region f32 compute leaks and silent f64 promotion."""

    id = "dtype-discipline"
    layer = "trace"
    severity = "warning"
    doc = ("f32 matmul/conv ops inside a declared-bf16 region (a fraction "
           "of the bf16 tensor-core rate) and f64 outputs anywhere (error)")

    def check(self, trace: Trace, ctx: RuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        want_bf16 = str(ctx.compute_dtype or "") in ("bfloat16", "bf16")
        f32_mm = 0
        for op in trace.outside():
            if op.site is not None:
                continue
            if any(t.dtype == "float64" for t in op.outputs):
                out.append(self.emit(
                    ctx, f"float64 output of {op.kind} — silent f64 "
                         f"promotion (runs off the tensor cores)",
                    severity="error", primitive=op.kind))
            if want_bf16 and op.kind in _MATMUL_OPS:
                dts = {t.dtype for t in op.inputs if t.shape}
                if dts and dts <= {"float32"}:
                    f32_mm += 1
        if f32_mm:
            out.append(self.emit(
                ctx, f"{f32_mm} f32 contraction op(s) inside a "
                     f"declared-bfloat16 region — the compute-dtype policy "
                     f"is not reaching them",
                count=f32_mm))
        return out


@register
class RecompileRule(Rule):
    """Distinct dispatch signatures vs the bucket-ladder bound."""

    id = "recompile-hazard"
    layer = "signatures"
    severity = "warning"
    doc = ("A dispatch site's distinct (shape, dtype) signatures exceed the "
           "pow2 bucket-ladder bound — it meets new shapes mid-traffic")

    def check(self, signatures: Sequence[Any],
              ctx: RuleContext) -> Iterable[Finding]:
        if ctx.max_signatures is None:
            return []
        n = len(set(signatures))
        if n <= ctx.max_signatures:
            return []
        return [self.emit(
            ctx, f"{n} distinct dispatch signatures exceed the bucket-"
                 f"ladder bound of {ctx.max_signatures} — this site meets "
                 f"new shapes under live traffic (bucket/pad its inputs)",
            distinct=n, bound=ctx.max_signatures)]
