"""Unified telemetry: metric registry + trace spans (port of
``analytics_zoo_tpu/common/telemetry.py``, which needs no JAX).

Two halves:

* **Metric registry** — ``Counter`` / ``Gauge`` / ``Histogram`` families with
  label sets. The hot path is lock-free: every incrementing thread writes its
  own shard cell (created once per thread under a lock, then updated with
  plain ``+=`` — safe because the cell belongs to exactly one writer) and a
  scrape merges the shards. Exposition is Prometheus text format
  (:meth:`MetricRegistry.render_prometheus`, read back by
  :func:`parse_prometheus`) and JSONL snapshots; ``collector`` families
  compute their samples at scrape time (breaker states, heartbeat
  liveness, active decode slots).
* **Trace spans** — ``with span("serving.gen.prefill"):`` opens a span tied
  to the ambient trace (contextvar-propagated within a thread, or an
  explicit ``remote=`` wire context across processes). Every finished span
  lands in a bounded in-process recorder (``spans()``), observes the
  ``zoo_span_duration_seconds{span=...}`` histogram, and — when torch is
  already loaded — also enters a ``torch.profiler.record_function`` so the
  same region shows up in a profiler trace. ``Span.wire_context()`` is the
  ``{"t": trace_id, "s": span_id}`` dict a peer passes on; missing context
  is always tolerated.

This module is the port's own registry: a process that imports both
packages holds two registries, one per module object, and the same
family names never clash between them. Families and their rendered text
are the JAX package's, so a scrape of either parses the same way.

Metric naming: ``zoo_<area>_<what>_<unit>``, counters end in ``_total``,
durations are seconds-based histograms. The registry, family and shard
locks are plain terminal ``threading.Lock()``s: nothing is acquired under
them, and the lock witness itself reports through this registry.
"""

from __future__ import annotations

import contextvars
import json
import os
import re
import sys
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "TelemetryError",
    "TraceContext", "Span", "SpanRecord", "counter", "gauge", "histogram",
    "collector", "default_registry", "render_prometheus", "snapshot",
    "write_jsonl", "parse_prometheus", "span", "record_span", "spans",
    "trace_ids", "protected_trace_ids", "pin_trace", "current_span",
    "current_wire_context", "reset_telemetry", "DEFAULT_BUCKETS",
]


class TelemetryError(ValueError):
    """Invalid metric/label name, kind mismatch, or malformed exposition."""


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-oriented default buckets (seconds): micro-batch waits are sub-ms,
# tunnel RTTs reach hundreds of ms, training steps seconds
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


# ---------------------------------------------------------------------------
# per-thread shards: the lock-free hot path
# ---------------------------------------------------------------------------

class _CellAnchor:
    """Holds one thread's cell in that thread's local storage; when the
    thread dies its locals are torn down and the finalizer folds the cell
    into the shard set's retired accumulator — thread-per-connection servers
    must not grow a permanent cell per connection ever handled."""

    __slots__ = ("shards", "cell")

    def __init__(self, shards: "_Shards", cell):
        self.shards = shards
        self.cell = cell

    def __del__(self):
        try:
            self.shards._retire(self.cell)
        except Exception:       # interpreter teardown: modules half-gone
            pass


class _Shards:
    """One accumulation cell per writing thread, merged on scrape.

    ``cell()`` is the hot path: after the first call per thread it is a plain
    attribute read — no lock. The registration of a fresh cell (once per
    thread per metric child) takes the lock; ``cells()`` (scrape) copies the
    list under it. A dead thread's cell is folded into ``_retired`` (its
    contribution is monotonic history) so memory and scrape cost stay bounded
    by LIVE threads, not threads ever created.
    """

    __slots__ = ("_make", "_local", "_all", "_retired", "_lock")

    def __init__(self, make_cell: Callable[[], Any]):
        self._make = make_cell
        self._local = threading.local()
        self._all: List[Any] = []
        self._retired = make_cell()
        self._lock = threading.Lock()

    def cell(self):
        anchor = getattr(self._local, "a", None)
        if anchor is None:
            c = self._make()
            with self._lock:
                self._all.append(c)
            self._local.a = anchor = _CellAnchor(self, c)
        return anchor.cell

    def _retire(self, cell) -> None:
        with self._lock:
            try:
                self._all.remove(cell)
            except ValueError:      # already retired (reset() raced teardown)
                return
            self._retired.merge(cell)

    def cells(self) -> List[Any]:
        with self._lock:
            return list(self._all) + [self._retired]

    def reset(self) -> None:
        """Zero every shard in place (cells stay owned by their threads)."""
        with self._lock:
            for c in self._all:
                c.zero()
            self._retired.zero()


class _CounterCell:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def zero(self):
        self.v = 0.0

    def merge(self, other: "_CounterCell"):
        self.v += other.v


class _HistCell:
    __slots__ = ("counts", "sum", "ex")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        # per-bucket last exemplar (trace_id, value, wall_ts) or None —
        # allocated lazily so exemplar-free histograms pay nothing
        self.ex: Optional[List[Optional[Tuple[str, float, float]]]] = None

    def zero(self):
        self.counts = [0] * len(self.counts)
        self.sum = 0.0
        self.ex = None

    def merge(self, other: "_HistCell"):
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        self.sum += other.sum
        if other.ex is not None:
            if self.ex is None:
                self.ex = [None] * len(self.counts)
            for i, e in enumerate(other.ex):
                if e is not None and (self.ex[i] is None
                                      or e[2] >= self.ex[i][2]):
                    self.ex[i] = e


# ---------------------------------------------------------------------------
# metric children (one per label-value combination)
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter. ``inc()`` is lock-free after first touch per
    thread."""

    __slots__ = ("_shards",)

    def __init__(self):
        self._shards = _Shards(_CounterCell)

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise TelemetryError("counters only go up")
        self._shards.cell().v += v

    def value(self) -> float:
        return sum(c.v for c in self._shards.cells())


class Gauge:
    """Point-in-time value. Sets are rare (not hot-path), so a plain lock."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._v += v

    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Cumulative-bucket histogram; ``observe()`` is lock-free per thread."""

    __slots__ = ("buckets", "_shards")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise TelemetryError("histogram needs at least one bucket")
        self.buckets = tuple(bs)
        n = len(bs) + 1          # trailing slot = +Inf
        self._shards = _Shards(lambda: _HistCell(n))

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        cell = self._shards.cell()
        idx = bisect_left(self.buckets, v)
        cell.counts[idx] += 1
        cell.sum += v
        if exemplar:
            # OpenMetrics exemplar: the last trace that landed in this bucket
            # (per-thread cell write — lock-free like the count itself)
            if cell.ex is None:
                cell.ex = [None] * len(cell.counts)
            cell.ex[idx] = (str(exemplar), float(v), time.time())

    def snapshot(self) -> Dict[str, Any]:
        """Merged ``{"buckets": [(le, cumulative), ...], "sum": s,
        "count": n, "exemplars": [(le, trace_id, value, ts), ...]}`` —
        ``exemplars`` lists only buckets that hold one."""
        counts = [0] * (len(self.buckets) + 1)
        ex: List[Optional[Tuple[str, float, float]]] = \
            [None] * (len(self.buckets) + 1)
        total = 0.0
        for c in self._shards.cells():
            for i, n in enumerate(c.counts):
                counts[i] += n
            total += c.sum
            if c.ex is not None:
                for i, e in enumerate(c.ex):
                    if e is not None and (ex[i] is None or e[2] >= ex[i][2]):
                        ex[i] = e
        cum, out = 0, []
        for le, n in zip(self.buckets, counts):
            cum += n
            out.append((le, cum))
        cum += counts[-1]
        out.append((float("inf"), cum))
        les = list(self.buckets) + [float("inf")]
        exemplars = [(les[i], e[0], e[1], e[2])
                     for i, e in enumerate(ex) if e is not None]
        return {"buckets": out, "sum": total, "count": cum,
                "exemplars": exemplars}

    def count(self) -> int:
        return self.snapshot()["count"]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """A named metric plus its labeled children."""

    def __init__(self, name: str, help: str, kind: str,
                 label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise TelemetryError(f"invalid metric name {name!r}")
        for l in label_names:
            if not _LABEL_RE.match(l):
                raise TelemetryError(f"invalid label name {l!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        # normalized (sorted) ladder for histograms, None otherwise — the
        # registry compares re-registrations against this
        self.buckets = tuple(sorted(
            float(b) for b in (buckets if buckets is not None
                               else DEFAULT_BUCKETS))) \
            if kind == "histogram" else None
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.label_names:         # unlabeled: the family IS the child
            # constructor-time write: the family is not yet published to the
            # registry, so no scrape can race this
            # zoo-lint: disable=telemetry-lock — object not yet shared
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets)
        return _KINDS[self.kind]()

    def labels(self, *values, **kv):
        """Child for one label-value combination (created on first use)."""
        if kv:
            if values:
                raise TelemetryError("pass label values positionally OR by "
                                     "name, not both")
            try:
                values = tuple(str(kv[l]) for l in self.label_names)
            except KeyError as e:
                raise TelemetryError(f"missing label {e.args[0]!r} for "
                                     f"{self.name}") from None
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise TelemetryError(
                f"{self.name} takes labels {self.label_names}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._make_child()
        return child

    # unlabeled convenience: family.inc()/set()/observe() hit the () child
    def inc(self, v: float = 1.0):
        self.labels().inc(v)

    def set(self, v: float):
        self.labels().set(v)

    def add(self, v: float):
        self.labels().add(v)

    def observe(self, v: float, exemplar: Optional[str] = None):
        self.labels().observe(v, exemplar=exemplar)

    def value(self) -> float:
        return self.labels().value()

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:                 # NaN (e.g. a diverged loss mirrored into a
        return "NaN"           # gauge) must not break the whole scrape
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(names: Sequence[str], values: Sequence[str],
                extra: Sequence[Tuple[str, str]] = ()) -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    parts += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricRegistry:
    """Process-wide family registry with Prometheus/JSONL exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}
        # collectors: name -> (help, kind, label_names, fn) where fn() yields
        # (label_values_tuple, value) pairs computed at scrape time
        self._collectors: Dict[str, Tuple[str, str, Tuple[str, ...],
                                          Callable]] = {}

    def _family(self, name: str, help: str, kind: str,
                label_names: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(label_names):
                    raise TelemetryError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(label_names)} but exists as {fam.kind}"
                        f"{fam.label_names}")
                # an EXPLICIT bucket ladder that disagrees with the existing
                # family must fail loudly — silently keeping the first
                # registrant's buckets would collapse out-of-range
                # observations into +Inf with no signal (buckets=None means
                # "whatever the family has")
                if (kind == "histogram" and buckets is not None
                        and tuple(sorted(float(b) for b in buckets))
                        != (fam.buckets or ())):
                    raise TelemetryError(
                        f"histogram {name!r} re-registered with buckets "
                        f"{tuple(buckets)} but exists with {fam.buckets}")
                return fam
            if name in self._collectors:
                raise TelemetryError(f"{name!r} is already a collector")
            fam = MetricFamily(name, help, kind, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        """``buckets=None`` = DEFAULT_BUCKETS on creation / accept the
        existing ladder on re-registration; an explicit ladder that disagrees
        with an existing family raises."""
        return self._family(name, help, "histogram", labels, buckets)

    def collector(self, name: str, help: str, fn: Callable,
                  labels: Sequence[str] = (), kind: str = "gauge") -> None:
        """Register a scrape-time sample source: ``fn()`` returns an iterable
        of ``(label_values_tuple, value)``. Re-registering a name replaces the
        previous collector (module reloads in tests)."""
        if not _NAME_RE.match(name):
            raise TelemetryError(f"invalid metric name {name!r}")
        with self._lock:
            if name in self._families:
                raise TelemetryError(f"{name!r} is already a metric family")
            self._collectors[name] = (help, kind, tuple(labels), fn)

    # -- exposition ----------------------------------------------------------
    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition. ``openmetrics=True`` additionally
        emits exemplar trailers on histogram bucket lines — exemplars are
        only legal in the OpenMetrics format, so the default (0.0.4
        text) stays consumable by stock Prometheus scrapers; the HTTP
        frontend negotiates via the Accept header."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.items())
            collectors = sorted(self._collectors.items())
        for name, fam in families:
            lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for values, child in sorted(fam.children()):
                ls = _labels_str(fam.label_names, values)
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    ex_by_le = {le: (tid, v, ts) for le, tid, v, ts
                                in snap.get("exemplars", ())} \
                        if openmetrics else {}
                    for le, cum in snap["buckets"]:
                        bl = _labels_str(fam.label_names, values,
                                         [("le", _fmt_value(le))])
                        line = f"{name}_bucket{bl} {cum}"
                        ex = ex_by_le.get(le)
                        if ex is not None:
                            # OpenMetrics exemplar trailer: the last trace id
                            # that landed in this bucket, linking the scrape
                            # to /debug/traces/<id>
                            tid, v, ts = ex
                            line += (f' # {{trace_id="{_escape_label(tid)}"}}'
                                     f" {_fmt_value(v)} {ts:.3f}")
                        lines.append(line)
                    lines.append(
                        f"{name}_sum{ls} {_fmt_value(snap['sum'])}")
                    lines.append(f"{name}_count{ls} {snap['count']}")
                else:
                    lines.append(f"{name}{ls} {_fmt_value(child.value())}")
        for name, (help, kind, label_names, fn) in collectors:
            lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            try:
                samples = dict(fn())     # last write wins on duplicate labels
            except Exception:            # a broken collector must not kill
                continue                 # the whole scrape
            for values, v in sorted(samples.items()):
                ls = _labels_str(label_names, tuple(str(x) for x in values))
                lines.append(f"{name}{ls} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def snapshot(self, buckets: bool = False) -> Dict[str, Any]:
        """JSON-able merged view of every family + collector.

        ``buckets=True`` additionally carries each histogram child's
        cumulative ``(le, count)`` ladder — what the observability history
        store samples so quantile-over-time queries can difference bucket
        counts between two points in time."""
        out: Dict[str, Any] = {}
        with self._lock:
            families = list(self._families.items())
            collectors = list(self._collectors.items())
        for name, fam in families:
            entry: Dict[str, Any] = {"kind": fam.kind, "samples": {}}
            for values, child in fam.children():
                key = ",".join(values) if values else ""
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    sample = {"sum": snap["sum"], "count": snap["count"]}
                    if buckets:
                        sample["buckets"] = snap["buckets"]
                    entry["samples"][key] = sample
                else:
                    entry["samples"][key] = child.value()
            out[name] = entry
        for name, (_h, kind, _l, fn) in collectors:
            try:
                samples = {",".join(str(x) for x in values): v
                           for values, v in fn()}
            except Exception:
                continue
            out[name] = {"kind": kind, "samples": samples}
        return out

    def write_jsonl(self, path: str) -> None:
        """Append one timestamped snapshot line (machine-readable export)."""
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")

    def reset(self) -> None:
        """Zero every value but keep the families registered — module-level
        metric handles stay valid across tests."""
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            for _values, child in fam.children():
                if isinstance(child, Gauge):
                    child.set(0.0)
                else:
                    child._shards.reset()


# ---------------------------------------------------------------------------
# Prometheus text-format parser (scrape validation in tests and the bench)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(-?[0-9.eE+-]+|[+-]Inf|NaN)$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
# OpenMetrics exemplar trailer: `# {label="v",...} value [timestamp]`
_EXEMPLAR_RE = re.compile(
    r"^\{(?P<labels>.*)\}\s+(?P<value>-?[0-9.eE+-]+|[+-]Inf|NaN)"
    r"(?:\s+(?P<ts>[0-9.eE+-]+))?$")


def _unescape_label(s: str) -> str:
    """Inverse of the renderer's ``_escape_label`` (``\\\\``, ``\\"``,
    ``\\n``), so label values round-trip through render→parse."""
    return re.sub(r"\\(.)", lambda m: "\n" if m.group(1) == "n"
                  else m.group(1), s)


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse Prometheus text format into ``{family: {"type": ...,
    "samples": [(name, labels_dict, value), ...]}}``. OpenMetrics exemplar
    trailers (``... # {trace_id="x"} 0.42 ts``) are parsed into an
    ``"exemplars"`` list of ``(sample_name, labels_dict, exemplar_dict)``
    per family. Raises :class:`TelemetryError` on a malformed line — the
    bench uses this as its validity assertion."""
    out: Dict[str, Dict[str, Any]] = {}

    def family_of(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[:-len(suffix)] if sample_name.endswith(suffix) \
                else None
            if base and base in out and out[base]["type"] == "histogram":
                return base
        return sample_name

    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                ptype = parts[3] if len(parts) > 3 else "untyped"
                if ptype not in ("counter", "gauge", "histogram", "summary",
                                 "untyped"):
                    raise TelemetryError(f"line {lineno}: bad TYPE {line!r}")
                out.setdefault(parts[2], {"type": ptype, "samples": []})
            continue
        m = _SAMPLE_RE.match(line)
        exemplar = None
        if not m and " # {" in line:
            # exemplar trailer — split at the LAST marker so a (pathological)
            # label value containing the marker still parses as a sample
            sample_part, _sep, ex_part = line.rpartition(" # {")
            em = _EXEMPLAR_RE.match("{" + ex_part)
            if em is not None:
                m = _SAMPLE_RE.match(sample_part)
                if m is not None:
                    ex_labels = {lm.group(1): _unescape_label(lm.group(2))
                                 for lm in _LABEL_PAIR_RE.finditer(
                                     em.group("labels"))}
                    exemplar = {
                        "labels": ex_labels,
                        "value": float(em.group("value")
                                       .replace("Inf", "inf")),
                        "ts": (float(em.group("ts"))
                               if em.group("ts") else None)}
        if not m:
            raise TelemetryError(f"line {lineno}: malformed sample {line!r}")
        name, labels_raw, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labels_raw:
            body = labels_raw[1:-1].rstrip(",")
            consumed = 0
            for lm in _LABEL_PAIR_RE.finditer(body):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
                consumed = lm.end()
            leftover = body[consumed:].strip(", ")
            if leftover:
                raise TelemetryError(
                    f"line {lineno}: malformed labels {labels_raw!r}")
        v = float(value.replace("Inf", "inf"))
        fam = family_of(name)
        out.setdefault(fam, {"type": "untyped", "samples": []})
        out[fam]["samples"].append((name, labels, v))
        if exemplar is not None:
            out[fam].setdefault("exemplars", []).append(
                (name, labels, exemplar))
    return out


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------

class TraceContext:
    """Identifies a position in a trace: ``(trace_id, span_id)``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_wire(self) -> Dict[str, str]:
        return {"t": self.trace_id, "s": self.span_id}

    @staticmethod
    def from_wire(obj: Any) -> Optional["TraceContext"]:
        """Tolerant decode: anything that isn't a well-formed context dict —
        including ``None`` from an old peer — is simply no context."""
        if (isinstance(obj, dict) and isinstance(obj.get("t"), str)
                and isinstance(obj.get("s"), str) and obj["t"] and obj["s"]):
            return TraceContext(obj["t"], obj["s"])
        return None

    def __repr__(self):
        return f"TraceContext({self.trace_id[:8]}…/{self.span_id[:8]}…)"


class SpanRecord:
    """One finished span (immutable snapshot kept by the recorder)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_wall",
                 "duration_s", "status", "tags")

    def __init__(self, name, trace_id, span_id, parent_id, start_wall,
                 duration_s, status, tags):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_wall = start_wall
        self.duration_s = duration_s
        self.status = status
        self.tags = tags

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_wall": self.start_wall,
                "duration_s": self.duration_s, "status": self.status,
                "tags": self.tags}

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, trace={self.trace_id[:8]}…, "
                f"{self.duration_s * 1e3:.2f}ms, {self.status})")


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


_current_span: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("zoo_current_span", default=None)


class _SpanRecorder:
    """Bounded in-memory buffer of finished spans, evicted by WHOLE TRACE.

    A flat deque would evict the oldest SPANS regardless of trace
    membership, so a long-lived trace would lose its parent and root spans
    and render as orphans in the exporter — fatal once tail sampling makes
    "keep this trace whole" load-bearing. Spans are bucketed per trace
    (insertion order = trace age) and eviction drops the oldest whole trace
    at a time.

    Tail retention: traces with an errored span, and the traces holding the
    ``keep_slowest`` longest spans seen so far, are evicted LAST (they are
    exactly what an operator wants whole after an incident). Memory stays
    bounded regardless — when only protected traces remain over budget, the
    oldest protected trace goes too.
    """

    def __init__(self, maxlen: int = 8192, keep_slowest: int = 16,
                 max_pinned: int = 64):
        import collections

        self._lock = threading.Lock()
        self._maxlen = maxlen
        self._keep_slowest = keep_slowest
        self._max_pinned = max_pinned
        self._traces: "collections.OrderedDict[str, List[SpanRecord]]" = \
            collections.OrderedDict()
        self._count = 0
        self._errored: Dict[str, None] = {}       # insertion-ordered set
        self._slow: Dict[str, float] = {}         # trace_id -> max duration
        # explicitly pinned traces (decision events pin theirs so an audit
        # entry's trace survives high-traffic churn); bounded FIFO
        self._pinned: Dict[str, None] = {}

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            bucket = self._traces.get(rec.trace_id)
            if bucket is None:
                bucket = self._traces[rec.trace_id] = []
            bucket.append(rec)
            self._count += 1
            if rec.status != "ok":
                self._errored[rec.trace_id] = None
            cur = self._slow.get(rec.trace_id)
            if cur is None or rec.duration_s > cur:
                self._slow[rec.trace_id] = rec.duration_s
                if len(self._slow) > self._keep_slowest:
                    fastest = min(self._slow, key=self._slow.get)
                    del self._slow[fastest]
            self._evict_locked()

    def pin(self, trace_id: str) -> None:
        """Retain ``trace_id`` through eviction (decision-event traces).
        Bounded: past ``max_pinned`` pins the oldest pin is released."""
        with self._lock:
            self._pinned[trace_id] = None
            while len(self._pinned) > self._max_pinned:
                self._pinned.pop(next(iter(self._pinned)))

    def _evict_locked(self) -> None:
        while self._count > self._maxlen and self._traces:
            victim = None
            for tid in self._traces:            # oldest unprotected first
                if tid not in self._errored and tid not in self._slow \
                        and tid not in self._pinned:
                    victim = tid
                    break
            if victim is None:                  # all protected: oldest goes
                victim = next(iter(self._traces))
            dropped = self._traces.pop(victim)
            self._count -= len(dropped)
            self._errored.pop(victim, None)
            self._slow.pop(victim, None)
            self._pinned.pop(victim, None)

    def spans(self, trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[SpanRecord]:
        with self._lock:
            if trace_id is not None:
                out = list(self._traces.get(trace_id, ()))
            else:
                out = [s for bucket in self._traces.values() for s in bucket]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def trace_ids(self) -> List[str]:
        """Known trace ids, oldest first."""
        with self._lock:
            return list(self._traces)

    def protected_ids(self) -> Dict[str, str]:
        """``{trace_id: reason}`` for tail-retained traces (``error`` wins
        over ``pinned`` wins over ``slow``)."""
        with self._lock:
            out = {tid: "slow" for tid in self._slow if tid in self._traces}
            out.update({tid: "pinned" for tid in self._pinned
                        if tid in self._traces})
            out.update({tid: "error" for tid in self._errored
                        if tid in self._traces})
            return out

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._errored.clear()
            self._slow.clear()
            self._pinned.clear()
            self._count = 0


class Span:
    """An in-flight span; use via :func:`span` as a context manager."""

    def __init__(self, name: str, remote: Any = None,
                 tags: Optional[Dict[str, Any]] = None):
        self.name = name
        self.tags: Dict[str, Any] = dict(tags or {})
        self._remote = TraceContext.from_wire(remote) \
            if not isinstance(remote, TraceContext) else remote
        self.trace_id = ""
        self.span_id = _new_id(8)
        self.parent_id: Optional[str] = None
        self.status = "ok"
        self._token = None
        self._annot = None
        self._t0 = 0.0
        self._wall = 0.0

    # -- context -------------------------------------------------------------
    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def wire_context(self) -> Dict[str, str]:
        return self.context.to_wire()

    def set_tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "Span":
        if self._remote is not None:
            self.trace_id = self._remote.trace_id
            self.parent_id = self._remote.span_id
        else:
            parent = _current_span.get()
            if parent is not None:
                self.trace_id = parent.trace_id
                self.parent_id = parent.span_id
            else:
                self.trace_id = _new_id(16)
        self._token = _current_span.set(self)
        # profiler integration: only when torch is ALREADY imported — a
        # process that only scrapes must not pull in the runtime for a label
        torch_mod = sys.modules.get("torch")
        if torch_mod is not None:
            try:
                self._annot = torch_mod.profiler.record_function(self.name)
                self._annot.__enter__()
            except Exception:
                self._annot = None
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = time.perf_counter() - self._t0
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        _current_span.reset(self._token)
        if exc is not None:
            self.status = "error"
            self.tags.setdefault("error", repr(exc))
        _finish(self.name, self.trace_id, self.span_id, self.parent_id,
                self._wall, dt, self.status, self.tags)
        return False


_RECORDER = _SpanRecorder()
_DEFAULT = MetricRegistry()
_SPAN_HIST = _DEFAULT.histogram(
    "zoo_span_duration_seconds",
    "Duration of telemetry spans (request hops, annotated regions)",
    labels=("span",))
_SPAN_ERRORS = _DEFAULT.counter(
    "zoo_span_errors_total", "Spans that finished with an error status",
    labels=("span",))


def _finish(name, trace_id, span_id, parent_id, wall, duration_s, status,
            tags) -> SpanRecord:
    # the span's trace id rides the histogram bucket as an OpenMetrics
    # exemplar, linking a latency bucket on the scrape to a concrete
    # exported trace (/debug/traces/<id>)
    _SPAN_HIST.labels(span=name).observe(duration_s, exemplar=trace_id)
    if status != "ok":
        _SPAN_ERRORS.labels(span=name).inc()
    rec = SpanRecord(name, trace_id, span_id, parent_id, wall,
                     duration_s, status, dict(tags))
    _RECORDER.record(rec)
    return rec


# ---------------------------------------------------------------------------
# module-level convenience API (the default registry/recorder)
# ---------------------------------------------------------------------------

def default_registry() -> MetricRegistry:
    return _DEFAULT


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> MetricFamily:
    return _DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> MetricFamily:
    return _DEFAULT.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> MetricFamily:
    return _DEFAULT.histogram(name, help, labels, buckets)


def collector(name: str, help: str, fn: Callable,
              labels: Sequence[str] = (), kind: str = "gauge") -> None:
    _DEFAULT.collector(name, help, fn, labels, kind)


def render_prometheus(openmetrics: bool = False) -> str:
    return _DEFAULT.render_prometheus(openmetrics=openmetrics)


def snapshot(buckets: bool = False) -> Dict[str, Any]:
    return _DEFAULT.snapshot(buckets=buckets)


def write_jsonl(path: str) -> None:
    _DEFAULT.write_jsonl(path)


def span(name: str, remote: Any = None, **tags) -> Span:
    """``with span("serving.http.predict", uri=uri):`` — child of the ambient
    span (or of ``remote``, a wire-context dict/:class:`TraceContext` from a
    peer); root of a fresh trace when neither exists."""
    return Span(name, remote=remote, tags=tags)


def record_span(name: str, start_s: float, end_s: float, remote: Any = None,
                status: str = "ok", **tags) -> SpanRecord:
    """Record a span from explicit ``time.perf_counter()`` stamps — for hops
    whose start and end live on different threads (queue waits), where a
    context-manager span can't straddle the hand-off."""
    ctx = remote if isinstance(remote, TraceContext) \
        else TraceContext.from_wire(remote)
    trace_id = ctx.trace_id if ctx else _new_id(16)
    parent_id = ctx.span_id if ctx else None
    dur = max(0.0, end_s - start_s)
    return _finish(name, trace_id, _new_id(8), parent_id,
                   time.time() - dur, dur, status, tags)


def spans(trace_id: Optional[str] = None,
          name: Optional[str] = None) -> List[SpanRecord]:
    """Finished spans from the bounded in-process recorder."""
    return _RECORDER.spans(trace_id=trace_id, name=name)


def trace_ids() -> List[str]:
    """Trace ids held by the in-process recorder, oldest first."""
    return _RECORDER.trace_ids()


def protected_trace_ids() -> Dict[str, str]:
    """Tail-retained traces: ``{trace_id: "error"|"pinned"|"slow"}`` — the
    traces the recorder refuses to evict before ordinary ones."""
    return _RECORDER.protected_ids()


def pin_trace(trace_id: str) -> None:
    """Retain one trace through recorder eviction (bounded FIFO of pins) —
    decision events pin theirs so the audit stream's trace links outlive
    high-traffic span churn."""
    _RECORDER.pin(trace_id)


def current_span() -> Optional[Span]:
    return _current_span.get()


def current_wire_context() -> Optional[Dict[str, str]]:
    """The ambient span's wire context (``None`` outside any span) — what the
    serving data plane stamps into frame headers."""
    sp = _current_span.get()
    return sp.wire_context() if sp is not None else None


def reset_telemetry() -> None:
    """Test helper: zero all default-registry values and drop recorded
    spans. Registered families/collectors stay (module handles remain
    valid)."""
    _DEFAULT.reset()
    _RECORDER.clear()
