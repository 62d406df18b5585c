"""The ``/debug`` ops surface — stdlib-only HTML + JSON views (port of
``analytics_zoo_tpu/observability/debug.py``, which needs no JAX: a copy).

Served by the HTTP frontend (``serving/http_frontend.py`` routes every
``/debug*`` path here). Pure functions over the observability plane: no
framework, no static assets — the dashboard is one self-contained HTML page
with inline-SVG sparklines rendered from the metrics history store.

Routes (all GET):

    /debug               HTML dashboard: SLO table, sparklines, recent
                         decision events, tail-sampled trace index
    /debug/slo           SLO engine status as JSON (cli slo-status)
    /debug/events        recent decision events as JSON (?n=, ?kind=)
    /debug/rowcache      host hot-row cache stats (per-tier hit rates,
                         pinned rows, host/device bytes) as JSON
    /debug/traces        tail-sampled trace index as JSON
    /debug/traces/<id>   one trace as Chrome/Perfetto trace-event JSON
                         (Content-Disposition: attachment — drop the file
                         onto ui.perfetto.dev)
    /debug/flight        complete flight-recorder dump as JSON
                         (Content-Disposition: attachment — feed it to
                         `cli postmortem` or the replay harness)
"""

from __future__ import annotations

import html
import json
import time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, quote, urlsplit

from ..common import telemetry as _tm
from . import events as _ev
from . import traces as _traces

__all__ = ["DebugSurface"]

_JSON = "application/json"
_HTML = "text/html; charset=utf-8"


def _trace_link(trace_id: str, label_chars: int = 12) -> str:
    """Safe trace anchor: trace ids arrive over the WIRE (any client can
    put any string in a trace context), so both the href and the label are
    escaped — never interpolated raw into the dashboard."""
    href = quote(f"/debug/traces/{trace_id}", safe="/")
    return (f'<a href="{html.escape(href)}">'
            f"{html.escape(trace_id[:label_chars])}…</a>")


def _spark(points: List[Tuple[float, float]], width: int = 220,
           height: int = 36) -> str:
    """One inline-SVG sparkline for ``[(ts, value)]`` (empty-safe)."""
    if len(points) < 2:
        return (f'<svg width="{width}" height="{height}">'
                f'<text x="4" y="{height - 8}" class="dim">no data</text>'
                f"</svg>")
    ts = [p[0] for p in points]
    vs = [p[1] for p in points]
    t0, t1 = min(ts), max(ts)
    v0, v1 = min(vs), max(vs)
    tspan = (t1 - t0) or 1.0
    vspan = (v1 - v0) or 1.0
    pts = " ".join(
        f"{(t - t0) / tspan * (width - 4) + 2:.1f},"
        f"{height - 4 - (v - v0) / vspan * (height - 8):.1f}"
        for t, v in points)
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline fill="none" stroke="currentColor" stroke-width="1.5"'
            f' points="{pts}"/>'
            f'<text x="{width - 2}" y="10" text-anchor="end" class="dim">'
            f"{vs[-1]:.3g}</text></svg>")


class DebugSurface:
    """Route handler for ``/debug*``; tolerates an absent plane (history /
    SLO engine) — events and traces are process-global and always served."""

    def __init__(self, plane: Optional[Any] = None,
                 extra_status: Optional[Any] = None):
        self.plane = plane
        # optional () -> dict merged into the dashboard header (the frontend
        # passes its readiness/engine stats callback)
        self._extra_status = extra_status

    @property
    def history(self):
        return getattr(self.plane, "history", None)

    @property
    def slo(self):
        return getattr(self.plane, "slo", None)

    # -- dispatch --------------------------------------------------------------

    def handle(self, path: str) -> Tuple[int, str, bytes, Dict[str, str]]:
        """``(status, content_type, body, extra_headers)`` for one request."""
        parts = urlsplit(path)
        query = {k: v[-1] for k, v in parse_qs(parts.query).items()}
        route = parts.path.rstrip("/") or "/debug"
        try:
            if route == "/debug":
                return 200, _HTML, self._dashboard().encode("utf-8"), {}
            if route == "/debug/slo":
                return self._json(self._slo_payload())
            if route == "/debug/events":
                return self._json(self._events_payload(query))
            if route == "/debug/rowcache":
                from ..serving import rowcache as _rc
                return self._json({"caches": _rc.cache_stats()})
            if route == "/debug/traces":
                return self._json({"traces":
                                   _traces.interesting_traces(
                                       int(query.get("n", "20")))})
            if route == "/debug/flight":
                from . import recorder as _flight
                rec = _flight.get()
                if rec is None:
                    return self._json(
                        {"error": "flight recorder not installed "
                                  "(the serving stack installs it; see "
                                  "docs/observability.md)"}, code=503)
                snap = rec.snapshot(trigger="debug")
                code, ctype, body, _hdr = self._json(snap)
                stamp = int(snap["created"])
                return code, ctype, body, {
                    "Content-Disposition":
                        f'attachment; filename="flight-{stamp}.json"'}
            if route.startswith("/debug/traces/"):
                tid = route[len("/debug/traces/"):]
                trace = _traces.export_trace(tid)
                if trace is None:
                    return self._json({"error": f"unknown trace {tid!r}"},
                                      code=404)
                code, ctype, body, _hdr = self._json(trace)
                return code, ctype, body, {
                    "Content-Disposition":
                        f'attachment; filename="trace-{tid[:16]}.json"'}
            return self._json({"error": f"no debug route {route!r}"},
                              code=404)
        except Exception as e:      # an ops surface must never 500 opaquely
            return self._json({"error": repr(e)}, code=500)

    @staticmethod
    def _json(obj: Any, code: int = 200
              ) -> Tuple[int, str, bytes, Dict[str, str]]:
        return code, _JSON, json.dumps(obj, indent=1).encode("utf-8"), {}

    # -- payloads --------------------------------------------------------------

    def _slo_payload(self) -> Dict[str, Any]:
        if self.slo is None:
            return {"enabled": False, "objectives": [], "firing": 0}
        return {"enabled": True, **self.slo.status()}

    def _events_payload(self, query: Dict[str, str]) -> Dict[str, Any]:
        evs = _ev.events(kind=query.get("kind") or None,
                         min_severity=query.get("severity") or None,
                         limit=int(query.get("n", "100")))
        return {"count": len(evs),
                "total_emitted": _ev.default_log().count(),
                "events": [e.to_dict() for e in evs]}

    # -- dashboard -------------------------------------------------------------

    _SPARK_SERIES = (
        # (title, metric, key, field, as_rate)
        ("http req/s", "zoo_http_requests_total", None, None, True),
        ("sheds/s", "zoo_http_shed_total", None, None, True),
        ("queue depth", "zoo_fleet_queue_depth", None, None, False),
        ("eligible replicas", "zoo_fleet_eligible_replicas", None, None,
         False),
        ("prefix hits/s", "zoo_gen_prefix_hits_total", None, None, True),
        ("prefix tokens saved/s", "zoo_gen_prefix_tokens_saved_total", None,
         None, True),
    )

    def _spark_points(self, metric: str, as_rate: bool,
                      window_s: float = 300.0
                      ) -> List[Tuple[float, float]]:
        hist = self.history
        if hist is None:
            return []
        pts: Dict[float, float] = {}
        for key in hist.keys(metric):
            for ts, v in hist.series(metric, key, window_s):
                pts[ts] = pts.get(ts, 0.0) + v
        series = sorted(pts.items())
        if not as_rate or len(series) < 2:
            return series
        out = []
        for (t0, v0), (t1, v1) in zip(series, series[1:]):
            dt = t1 - t0
            if dt > 0:
                d = v1 - v0
                out.append((t1, max(0.0, d) / dt))
        return out

    def _dashboard(self) -> str:
        now = time.time()
        rows: List[str] = []
        rows.append("<!doctype html><html><head><title>zoo /debug</title>"
                    "<style>body{font:13px/1.5 system-ui,sans-serif;margin:"
                    "24px;max-width:1000px}h1{font-size:18px}h2{font-size:"
                    "15px;margin-top:24px}table{border-collapse:collapse;"
                    "width:100%}th,td{text-align:left;padding:3px 10px 3px 0;"
                    "border-bottom:1px solid #ddd;font-variant-numeric:"
                    "tabular-nums}.dim{fill:#888;color:#888;font-size:11px}"
                    ".firing{color:#b00;font-weight:600}.ok{color:#080}"
                    ".spark{display:inline-block;margin:0 18px 8px 0;"
                    "vertical-align:top}</style></head><body>")
        rows.append("<h1>analytics_zoo_tpu_torch /debug</h1>")
        rows.append(f'<p class="dim">rendered {time.strftime("%H:%M:%S")} · '
                    f'<a href="/debug/slo">slo</a> · '
                    f'<a href="/debug/events">events</a> · '
                    f'<a href="/debug/traces">traces</a> · '
                    f'<a href="/debug/flight">flight</a> · '
                    f'<a href="/metrics">metrics</a></p>')

        # SLO table
        slo = self._slo_payload()
        rows.append("<h2>SLO objectives</h2>")
        if not slo.get("objectives"):
            rows.append('<p class="dim">no objectives configured '
                        "(ServingConfig YAML <code>slo:</code> section)</p>")
        else:
            rows.append("<table><tr><th>objective</th><th>type</th>"
                        "<th>state</th><th>burn fast</th><th>burn slow</th>"
                        "<th>budget left</th><th>fired</th></tr>")
            for o in slo["objectives"]:
                cls = "firing" if o["state"] == "firing" else "ok"
                rows.append(
                    f"<tr><td>{html.escape(o['name'])}</td>"
                    f"<td>{html.escape(o['type'])}</td>"
                    f'<td class="{cls}">{o["state"]}</td>'
                    f"<td>{o['burn_fast']}</td><td>{o['burn_slow']}</td>"
                    f"<td>{o['budget_remaining']}</td>"
                    f"<td>{o['fired_count']}</td></tr>")
            rows.append("</table>")

        # sparklines
        rows.append("<h2>last 5 minutes</h2>")
        if self.history is None:
            rows.append('<p class="dim">history store not attached '
                        "(stack starts it; standalone frontends may not)"
                        "</p>")
        else:
            for title, metric, _k, _f, as_rate in self._SPARK_SERIES:
                pts = self._spark_points(metric, as_rate)
                rows.append(f'<span class="spark">{html.escape(title)}'
                            f"<br>{_spark(pts)}</span>")

        # shared-prefix KV cache (live registry counters; the families only
        # exist once serving.generation is imported — absent families mean
        # no generation engine in this process, so the section is omitted)
        snap = _tm.default_registry().snapshot()

        def _total(name: str) -> Optional[float]:
            fam = snap.get(name)
            if not isinstance(fam, dict):
                return None
            return sum(float(v) for v in fam.get("samples", {}).values())

        hits = _total("zoo_gen_prefix_hits_total")
        misses = _total("zoo_gen_prefix_misses_total")
        if hits is not None and misses is not None:
            rows.append("<h2>generation prefix cache</h2>")
            total = hits + misses
            rate = (f"<b>{hits / total:.1%}</b>" if total
                    else '<span class="dim">no prefills yet</span>')
            saved = _total("zoo_gen_prefix_tokens_saved_total") or 0.0
            evicted = _total("zoo_gen_prefix_evicted_pages_total") or 0.0
            reclaimable = _total("zoo_gen_prefix_reclaimable_pages") or 0.0
            rows.append(
                f"<p>hit rate {rate} ({hits:.0f} hits / {misses:.0f} "
                f"misses) · {saved:.0f} prompt tokens not recomputed · "
                f"{evicted:.0f} pages evicted · {reclaimable:.0f} held "
                f"pages reclaimable</p>")

        # decision events
        evs = _ev.events(limit=20)
        rows.append("<h2>recent decision events</h2>")
        if not evs:
            rows.append('<p class="dim">none yet</p>')
        else:
            rows.append("<table><tr><th>age</th><th>kind</th><th>sev</th>"
                        "<th>fields</th><th>trace</th></tr>")
            for e in reversed(evs):
                fields = html.escape(json.dumps(e.fields, sort_keys=True))
                trace = _trace_link(e.trace_id, 8) if e.trace_id else "—"
                rows.append(f"<tr><td>{now - e.ts:.1f}s</td>"
                            f"<td>{html.escape(e.kind)}</td>"
                            f"<td>{e.severity}</td><td>{fields}</td>"
                            f"<td>{trace}</td></tr>")
            rows.append("</table>")

        # traces
        rows.append("<h2>tail-sampled traces</h2>")
        traces = _traces.interesting_traces(10)
        if not traces:
            rows.append('<p class="dim">no recorded traces</p>')
        else:
            rows.append("<table><tr><th>trace</th><th>root</th>"
                        "<th>spans</th><th>slowest span</th><th>why kept"
                        "</th></tr>")
            for t in traces:
                rows.append(
                    f"<tr><td>{_trace_link(t['trace_id'])}</td>"
                    f"<td>{html.escape(t['root'])}</td>"
                    f"<td>{t['spans']}</td><td>{t['duration_ms']}ms</td>"
                    f"<td>{'error' if t['errored'] else t['retention']}"
                    f"</td></tr>")
            rows.append("</table>")
        rows.append("</body></html>")
        return "".join(rows)
