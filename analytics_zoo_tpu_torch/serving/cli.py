"""cluster-serving lifecycle CLI (port of ``analytics_zoo_tpu/serving/cli.py``,
which needs no JAX: the same verbs over the same broker keys, so either
package's CLI reads either package's fleet).

Parity: ``scripts/cluster-serving/cluster-serving-start|stop|restart`` in the
reference manage the Redis + Flink serving service. Here the managed process is
the queue broker (with optional append-only persistence, see broker.py); a
restart with the same ``--aof`` file recovers every acknowledged request and
re-delivers in-flight ones.

    python -m analytics_zoo_tpu_torch.serving.cli start   --port 6380 --aof /var/zoo/serving.aof
    python -m analytics_zoo_tpu_torch.serving.cli stop    --port 6380
    python -m analytics_zoo_tpu_torch.serving.cli restart --port 6380 --aof /var/zoo/serving.aof
    python -m analytics_zoo_tpu_torch.serving.cli status  --port 6380
    python -m analytics_zoo_tpu_torch.serving.cli info    --port 6380

Fleet operations (a stack running with ``replicas > 1``, serving/fleet.py):
the commands ride broker control hashes, so they work from any host that can
reach the broker — the supervising stack process picks them up.

    python -m ... cli fleet-status     --port 6380            # roster + hb
    python -m ... cli hosts            --port 6380            # host agents
    python -m ... cli drain --replica r0 --port 6380          # graceful drain
    python -m ... cli rolling-restart  --port 6380            # zero-downtime

Observability verbs (docs/observability.md): ``events`` tails the structured
decision-event stream off the broker (autoscale/failover/rollout/breaker/
shed/chaos/slo, one JSON object per line); ``slo-status`` and ``trace`` hit
the frontend's ``/debug`` ops surface over HTTP.

    python -m ... cli events     --port 6380 [--kind autoscale] [--count 50]
    python -m ... cli slo-status --http 127.0.0.1:8080
    python -m ... cli trace      --http 127.0.0.1:8080 --trace <id> --out t.json
    python -m ... cli dump       --http 127.0.0.1:8080 --out flight.json
    python -m ... cli postmortem flight.json

``dump`` pulls the flight recorder's black-box artifact off a LIVE stack
(``/debug/flight``); ``postmortem`` pretty-prints any flight dump offline —
including one a crashed process left behind (signal/atexit hook) or one a
chaos kill auto-cut — as a timeline of decision events with SLO verdicts,
chaos firings, and the trace each decision pins.

``info`` prints the broker's data-plane gauges (wire protocol version,
per-stream depths, bytes on wire by frame kind, shm attachment) as JSON —
the operator-side view of the binary zero-copy data plane. Since the unified
telemetry layer it also carries ``aof_replayed_records`` (per-op counts of
log records replayed at the last startup), ``shm_negotiations`` (ok vs.
fallback ring attachments), and per-verb ``commands`` totals — the broker-side
slice of the shared metric registry (docs/observability.md).
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys

from ..common.resilience import ResilienceError, RetryPolicy
from .broker import recv_msg, send_msg


def _call(host: str, port: int, *req, timeout: float = 5.0):
    with socket.create_connection((host, port), timeout=timeout) as s:
        send_msg(s, list(req))
        return recv_msg(s)


def _alive(host: str, port: int) -> bool:
    try:
        return _call(host, port, "PING", timeout=2.0) == "PONG"
    except (OSError, ConnectionError, ValueError):
        return False


class _NotYet(Exception):
    """Condition not met yet (retried under a RetryPolicy deadline)."""


def _await_condition(check, wait_s: float) -> bool:
    """Poll ``check`` (raises _NotYet until satisfied) under the shared
    retry machinery: fixed 0.1s cadence, overall deadline ``wait_s``."""
    policy = RetryPolicy(max_attempts=None, base_delay_s=0.1, multiplier=1.0,
                         jitter=0.0, deadline_s=wait_s, retryable=(_NotYet,))
    try:
        policy.call(check)
        return True
    except ResilienceError:
        return False


def do_start(args) -> int:
    if _alive(args.host, args.port):
        print(f"broker already running on {args.host}:{args.port}")
        return 0
    cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.broker",
           "--host", args.host, "--port", str(args.port)]
    if args.aof:
        cmd += ["--aof", args.aof]
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            start_new_session=True)

    def up():
        if proc.poll() is not None:
            raise RuntimeError(f"broker exited rc={proc.returncode}")
        if not _alive(args.host, args.port):
            raise _NotYet()

    try:
        if _await_condition(up, args.wait):
            print(f"broker started on {args.host}:{args.port} (pid {proc.pid})"
                  + (f", persisting to {args.aof}" if args.aof else ""))
            return 0
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    print("broker did not come up in time", file=sys.stderr)
    return 1


def do_stop(args) -> int:
    if not _alive(args.host, args.port):
        print(f"no broker on {args.host}:{args.port}")
        return 0
    try:
        _call(args.host, args.port, "SHUTDOWN")
    except (OSError, ConnectionError):
        pass

    def down():
        if _alive(args.host, args.port):
            raise _NotYet()

    if _await_condition(down, args.wait):
        print("broker stopped")
        return 0
    print("broker still answering after SHUTDOWN", file=sys.stderr)
    return 1


def do_restart(args) -> int:
    rc = do_stop(args)
    if rc != 0:
        return rc
    return do_start(args)


def do_status(args) -> int:
    up = _alive(args.host, args.port)
    print(f"broker on {args.host}:{args.port}: {'UP' if up else 'DOWN'}")
    return 0 if up else 3


def do_info(args) -> int:
    try:
        info = _call(args.host, args.port, "INFO")
    except (OSError, ConnectionError, ValueError) as e:
        print(f"broker on {args.host}:{args.port} unreachable: {e}",
              file=sys.stderr)
        return 3
    # hot-swap operator view: per-replica model versions + rollout phase
    # (present only when a fleet/rollout has registered on this broker)
    try:
        from .engine import FLEET_HB_PREFIX
        from .fleet import MEMBERS_KEY
        from .hotswap import ROLLOUT_KEY

        members = _call(args.host, args.port, "HGET", MEMBERS_KEY, 0)
        if isinstance(members, dict):
            versions = {}
            for rid in members.get("replicas", ()):
                hb = _call(args.host, args.port, "HGET",
                           FLEET_HB_PREFIX + rid, 0)
                if isinstance(hb, dict):
                    versions[rid] = {
                        "model_version": hb.get("model_version"),
                        "state": hb.get("state"),
                        "swap_state": hb.get("swap_state")}
            info["fleet_model_versions"] = versions
        rollout = _call(args.host, args.port, "HGET", ROLLOUT_KEY, 0)
        if isinstance(rollout, dict):
            info["rollout"] = {k: rollout.get(k) for k in
                               ("phase", "current", "target", "canary")}
    except (OSError, ConnectionError, ValueError):
        pass
    # generation operator view: the engine's source loop republishes its
    # stats hash ~1/s (GEN_STATS_PREFIX); present only when a generation
    # engine consumes from this broker
    try:
        from .generation import GEN_STATS_PREFIX

        gen = _call(args.host, args.port, "HGET",
                    GEN_STATS_PREFIX + "generation", 0)
        if isinstance(gen, dict):
            entry = {k: gen.get(k) for k in
                     ("served_streams", "active_slots", "backlog",
                      "model_version", "ts")}
            prefix = gen.get("prefix")
            if isinstance(prefix, dict):
                # shared-prefix KV cache headline: fraction of prefills
                # served (partly) from published prefix pages, plus the
                # compute + device memory those hits represent
                entry["prefix_cache"] = {k: prefix.get(k) for k in
                                         ("hit_rate", "hits", "misses",
                                          "tokens_saved", "held_pages",
                                          "budget_pages", "entries")}
            info["generation"] = entry
    except (OSError, ConnectionError, ValueError):
        pass
    print(json.dumps(info, indent=1, sort_keys=True))
    return 0


def do_fleet_status(args) -> int:
    """Roster + per-replica heartbeat view of a fleet-mode stack, including
    each replica's active model version and the rollout-controller phase —
    a stuck canary rollout is visible at a glance (one replica on the target
    version, phase != idle)."""
    from .engine import FLEET_HB_PREFIX
    from .fleet import MEMBERS_KEY
    from .hotswap import MODEL_CURRENT_KEY, ROLLOUT_KEY

    try:
        members = _call(args.host, args.port, "HGET", MEMBERS_KEY, 0)
    except (OSError, ConnectionError, ValueError) as e:
        print(f"broker on {args.host}:{args.port} unreachable: {e}",
              file=sys.stderr)
        return 3
    if not isinstance(members, dict):
        print("no fleet registered on this broker", file=sys.stderr)
        return 4
    import time

    out = {"spawn": members.get("spawn"), "replicas": {}}
    now = time.time()
    for rid in members.get("replicas", ()):
        hb = _call(args.host, args.port, "HGET", FLEET_HB_PREFIX + rid, 0)
        if isinstance(hb, dict):
            entry = {
                "state": hb.get("state"),
                "served": hb.get("served"),
                "inflight": hb.get("inflight"),
                "model_version": hb.get("model_version"),
                "swap_state": hb.get("swap_state"),
                "hb_age_s": round(now - float(hb.get("ts", 0)), 3)}
            if hb.get("swap_error"):
                entry["swap_error"] = hb["swap_error"]
            out["replicas"][rid] = entry
        else:
            out["replicas"][rid] = {"state": "no-heartbeat"}
    rollout = _call(args.host, args.port, "HGET", ROLLOUT_KEY, 0)
    if isinstance(rollout, dict):
        out["rollout"] = {k: rollout.get(k) for k in
                          ("phase", "current", "target", "canary")}
    current = _call(args.host, args.port, "HGET", MODEL_CURRENT_KEY, 0)
    if isinstance(current, dict):
        out["model_current"] = {k: current.get(k)
                                for k in ("version", "step", "path")}
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def do_hosts(args) -> int:
    """Host-tier view of a cross-host fleet: each registered host agent's
    heartbeat age, reported replicas, capacity, and last echoed clock
    sample — the raw evidence behind `zoo_fleet_host_clock_skew_seconds`
    and whole-host failover decisions."""
    from .fleet import MEMBERS_KEY
    from .hostagent import HOST_HB_PREFIX

    try:
        members = _call(args.host, args.port, "HGET", MEMBERS_KEY, 0)
    except (OSError, ConnectionError, ValueError) as e:
        print(f"broker on {args.host}:{args.port} unreachable: {e}",
              file=sys.stderr)
        return 3
    if not isinstance(members, dict) or not members.get("hosts"):
        print("no cross-host fleet registered on this broker",
              file=sys.stderr)
        return 4
    import time

    out = {"hosts": {}}
    now = time.time()
    for hid in members.get("hosts", ()):
        hb = _call(args.host, args.port, "HGET", HOST_HB_PREFIX + hid, 0)
        if isinstance(hb, dict):
            out["hosts"][hid] = {
                "state": hb.get("state"),
                "identity": hb.get("identity"),
                "capacity": hb.get("capacity"),
                "replicas": hb.get("replicas"),
                "pid": hb.get("pid"),
                "hb_age_s": round(now - float(hb.get("ts", 0)), 3)}
        else:
            out["hosts"][hid] = {"state": "no-heartbeat"}
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def do_drain(args) -> int:
    """Graceful drain of one replica: it stops claiming new requests,
    finishes + acks in-flight work, and reports state ``drained``."""
    from .engine import FLEET_CTL_PREFIX, FLEET_HB_PREFIX

    if not args.replica:
        print("drain needs --replica <id>", file=sys.stderr)
        return 2
    try:
        _call(args.host, args.port, "HSET", FLEET_CTL_PREFIX + args.replica,
              {"state": "drain"})
    except (OSError, ConnectionError, ValueError) as e:
        print(f"broker unreachable: {e}", file=sys.stderr)
        return 3

    def drained():
        hb = _call(args.host, args.port, "HGET",
                   FLEET_HB_PREFIX + args.replica, 0)
        if not (isinstance(hb, dict) and hb.get("state") == "drained"):
            raise _NotYet()

    if _await_condition(drained, args.wait):
        print(f"replica {args.replica} drained")
        return 0
    print(f"replica {args.replica} not drained after {args.wait}s "
          f"(still finishing in-flight work?)", file=sys.stderr)
    return 1


def do_events(args) -> int:
    """Print the stack's structured decision events (autoscale, failover,
    rollout, breaker, shed, chaos, slo transitions) from the broker's
    ``events`` stream — the cross-process view of ``/debug/events``. One
    JSON object per line, oldest first."""
    from ..observability.events import EVENT_STREAM

    cursor, rows = 0, []
    limit = max(1, int(args.count))
    try:
        while True:
            cursor, entries = _call(args.host, args.port, "XREAD",
                                    EVENT_STREAM, cursor, 256, 0)
            if not entries:
                break
            for _id, rec in entries:
                if args.kind and not str(rec.get("kind", "")) \
                        .startswith(args.kind):
                    continue
                rows.append(rec)
    except (OSError, ConnectionError, ValueError) as e:
        print(f"broker on {args.host}:{args.port} unreachable: {e}",
              file=sys.stderr)
        return 3
    for rec in rows[-limit:]:
        print(json.dumps(rec, sort_keys=True))
    if not rows:
        print("no decision events on this broker (stack not running with "
              "the observability plane, or nothing has happened yet)",
              file=sys.stderr)
    return 0


def _http_get(http: str, path: str, timeout: float = 5.0):
    import urllib.request

    url = f"http://{http}{path}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def do_slo_status(args) -> int:
    """Print the SLO engine's status (objectives, burn rates, alert states)
    from the frontend's ``/debug/slo``."""
    try:
        payload = _http_get(args.http, "/debug/slo")
    except Exception as e:
        print(f"frontend on {args.http} unreachable: {e}", file=sys.stderr)
        return 3
    print(json.dumps(payload, indent=1, sort_keys=True))
    if not payload.get("enabled"):
        return 4
    return 1 if payload.get("firing") else 0


def do_rowcache(args) -> int:
    """Print host hot-row cache stats (per-tier hit rates, pinned rows,
    host/device bytes) from the frontend's ``/debug/rowcache``."""
    try:
        payload = _http_get(args.http, "/debug/rowcache")
    except Exception as e:
        print(f"frontend on {args.http} unreachable: {e}", file=sys.stderr)
        return 3
    print(json.dumps(payload, indent=1, sort_keys=True))
    return 0 if payload.get("caches") else 4


def do_trace(args) -> int:
    """Fetch one trace as Chrome/Perfetto trace-event JSON from the
    frontend's ``/debug/traces/<id>`` (load the file at ui.perfetto.dev)."""
    if not args.trace:
        print("trace needs --trace <trace_id> (see /debug/events or "
              "`cli events` for ids)", file=sys.stderr)
        return 2
    try:
        payload = _http_get(args.http, f"/debug/traces/{args.trace}")
    except Exception as e:
        print(f"frontend on {args.http} unreachable or unknown trace: {e}",
              file=sys.stderr)
        return 3
    text = json.dumps(payload, indent=1)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {len(payload.get('traceEvents', []))} span(s) to "
              f"{args.out}")
    else:
        print(text)
    return 0


def do_dump(args) -> int:
    """Pull a complete flight-recorder dump from the frontend's
    ``/debug/flight`` and write it to disk — the black-box artifact for a
    live stack, on operator request."""
    import time

    try:
        payload = _http_get(args.http, "/debug/flight", timeout=15.0)
    except Exception as e:
        print(f"frontend on {args.http} unreachable or no flight recorder "
              f"installed: {e}", file=sys.stderr)
        return 3
    if payload.get("schema") != "zoo-flight-v1":
        print(f"unexpected flight payload: {payload.get('error', payload)}",
              file=sys.stderr)
        return 1
    out = args.out or f"flight-{int(time.time())}.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote flight dump to {out} ({payload.get('records_held', 0)} "
          f"control records, {len(payload.get('events') or [])} events, "
          f"trigger={payload.get('trigger')})")
    return 0


def do_postmortem(args) -> int:
    """Pretty-print a flight dump offline: header, SLO verdicts, chaos
    firings, decision-record summary, and a merged timeline of the decision
    events with the trace each one pins (marked when the dump carries the
    full trace export)."""
    if not args.target:
        print("postmortem needs a dump file: cli postmortem <dump.json>",
              file=sys.stderr)
        return 2
    try:
        with open(args.target, encoding="utf-8") as f:
            dump = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot load {args.target}: {e}", file=sys.stderr)
        return 1
    if not isinstance(dump, dict) or dump.get("schema") != "zoo-flight-v1":
        print(f"{args.target} is not a zoo-flight-v1 dump", file=sys.stderr)
        return 1
    import time

    created = float(dump.get("created", 0.0))
    print(f"flight dump {args.target}")
    print(f"  schema   {dump['schema']}   trigger {dump.get('trigger')}")
    print(f"  cut      {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(created))}"
          f"   host {dump.get('host')}   pid {dump.get('pid')}")
    print(f"  records  {dump.get('records_held', 0)} held / "
          f"{dump.get('records_total', 0)} total "
          f"({dump.get('records_dropped', 0)} overwritten)")
    slo = dump.get("slo")
    if isinstance(slo, dict) and slo.get("objectives"):
        print("SLO verdicts:")
        for o in slo["objectives"]:
            print(f"  {o.get('name'):<28} {o.get('state'):<9} "
                  f"burn fast {o.get('burn_fast')} / slow "
                  f"{o.get('burn_slow')}  fired {o.get('fired_count')}x")
    chaos = dump.get("chaos") or []
    if chaos:
        print("chaos firings:")
        for c in chaos:
            print(f"  {c.get('site')}[{c.get('tag')}] x{c.get('fired')}")
    sites = {}
    for r in dump.get("records") or []:
        d = r.get("decision") or {}
        key = (r.get("site"), d.get("action"))
        sites[key] = sites.get(key, 0) + 1
    if sites:
        print("decision records:")
        for (site, action), n in sorted(sites.items(),
                                        key=lambda kv: str(kv[0])):
            print(f"  {site:<24} {str(action):<10} x{n}")
    events = dump.get("events") or []
    traces = dump.get("traces") or {}
    if events:
        t0 = float(events[0].get("ts", created))
        print(f"timeline ({len(events)} events):")
        for e in events:
            tid = e.get("trace_id")
            pin = ""
            if tid:
                pin = (f"  [trace {tid[:12]}"
                       + (", exported]" if tid in traces else "]"))
            fields = {k: v for k, v in (e.get("fields") or {}).items()}
            print(f"  +{float(e.get('ts', t0)) - t0:8.3f}s "
                  f"{e.get('severity', 'info'):<8} {e.get('kind'):<22} "
                  f"{json.dumps(fields, sort_keys=True, default=str)}{pin}")
    print(f"exported traces: {len(traces)}")
    return 0


def do_rolling_restart(args) -> int:
    """Ask the fleet supervisor for a rolling restart: each replica is
    drained, restarted and readmitted in turn — N-1 replicas keep serving
    at every instant (zero downtime)."""
    import uuid

    from .fleet import ROLLING_KEY

    try:
        _call(args.host, args.port, "HSET", ROLLING_KEY,
              {"nonce": uuid.uuid4().hex})
    except (OSError, ConnectionError, ValueError) as e:
        print(f"broker unreachable: {e}", file=sys.stderr)
        return 3
    print("rolling restart requested (watch `cli fleet-status`)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cluster-serving lifecycle (start/stop/restart/status) "
                    "+ fleet operations (fleet-status/drain/rolling-restart)")
    ap.add_argument("action",
                    choices=["start", "stop", "restart", "status", "info",
                             "fleet-status", "hosts", "drain",
                             "rolling-restart", "events", "slo-status",
                             "rowcache", "trace", "dump", "postmortem"])
    ap.add_argument("target", nargs="?", default=None,
                    help="`postmortem`: path to a flight dump JSON "
                         "(from `cli dump`, /debug/flight, or a crash)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6380)
    ap.add_argument("--aof", default=None,
                    help="append-only persistence file (start/restart)")
    ap.add_argument("--replica", default=None,
                    help="replica id for `drain` (see fleet-status)")
    ap.add_argument("--wait", type=float, default=10.0,
                    help="seconds to wait for start/stop/drain to take effect")
    ap.add_argument("--http", default="127.0.0.1:8080",
                    help="frontend host:port for `slo-status`/`trace` "
                         "(the /debug ops surface)")
    ap.add_argument("--count", type=int, default=100,
                    help="`events`: print at most the newest N events")
    ap.add_argument("--kind", default=None,
                    help="`events`: only kinds with this prefix (e.g. "
                         "autoscale, fleet, rollout, slo, chaos)")
    ap.add_argument("--trace", default=None,
                    help="`trace`: the trace id to export (from "
                         "/debug/events or `cli events`)")
    ap.add_argument("--out", default=None,
                    help="`trace`: write the Perfetto-loadable JSON here "
                         "instead of stdout; `dump`: the flight dump path "
                         "(default flight-<ts>.json)")
    args = ap.parse_args(argv)
    return {"start": do_start, "stop": do_stop, "restart": do_restart,
            "status": do_status, "info": do_info,
            "fleet-status": do_fleet_status, "hosts": do_hosts,
            "drain": do_drain,
            "rolling-restart": do_rolling_restart, "events": do_events,
            "slo-status": do_slo_status, "rowcache": do_rowcache,
            "trace": do_trace,
            "dump": do_dump,
            "postmortem": do_postmortem}[args.action](args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
