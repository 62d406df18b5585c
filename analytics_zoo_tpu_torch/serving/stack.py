"""One-command serving stack: broker + streaming engine + HTTP frontend, run
in the FOREGROUND — the container/systemd entrypoint the reference covers with
``docker/cluster-serving`` (Redis + Flink job + FrontEnd jar in one image).
Port of ``analytics_zoo_tpu/serving/stack.py``: the engines serve on
``--device`` (default ``cuda``; without a card they fail, they never drop to
the CPU unless ``--device cpu`` is given).

    python -m analytics_zoo_tpu_torch.serving.stack --model /models/my_zoo_bundle
    python -m analytics_zoo_tpu_torch.serving.stack --model B --int8 --replicas 2
    python -m analytics_zoo_tpu_torch.serving.stack --demo   # built-in demo MLP

HTTP on ``--http-port`` (default 8080): POST /predict {"instances": [...]},
GET /metrics. The broker persists to ``--aof`` when given, so a container
restart on the same volume redelivers in-flight requests.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from ..common import telemetry as _tm
from ..common.resilience import HealthRegistry
from ..observability import ObservabilityPlane
from ..observability import events as _events
from ..observability import recorder as _recorder
from .broker import start_broker
from .config import ServingConfig
from .engine import ClusterServing
from .fleet import FleetSupervisor
from .http_frontend import FrontEndApp

_JSONL_BYTES = _tm.gauge(
    "zoo_metrics_jsonl_bytes",
    "Size of the --metrics-jsonl snapshot file after the last append "
    "(drops to ~0 at each size-triggered rotation)")


def write_metrics_snapshot(path: str, max_bytes: int) -> int:
    """Append one telemetry snapshot line to ``path`` with size-based
    rotation: past ``max_bytes`` the file moves to ``<path>.1`` (replacing
    the previous rotation) and a fresh file starts — a long-lived stack can
    never fill the disk with its own metrics. Returns the post-append size.
    """
    _tm.write_jsonl(path)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if max_bytes > 0 and size > max_bytes:
        try:
            os.replace(path, path + ".1")
            size = 0
        except OSError:
            logging.exception("metrics jsonl rotation failed")
    _JSONL_BYTES.set(size)
    return size


def shutdown_stack(app, backend, broker, drain_s: float = 5.0) -> None:
    """Ordered stack shutdown (the SIGTERM path).

    Order matters and is NOT construction order: (1) the frontend stops
    ACCEPTING (readyz flips 503, new requests shed) but keeps running so
    already-admitted requests can still fetch their results; (2) the routing
    tier + engines drain — every claimed request finishes, is written to the
    broker, and acked; (3) admitted HTTP requests have collected their
    responses (wait_idle); (4) the broker stops; (5) the frontend exits.
    Stopping in construction order (broker first, or frontend hard-stop
    first) strands accepted requests mid-flight — the regression test in
    tests/test_fleet.py drives a request THROUGH this shutdown."""
    app.stop_accepting()
    backend.stop(drain_s)        # FleetSupervisor.stop or ClusterServing.stop
    app.wait_idle(timeout_s=drain_s)
    broker.shutdown()
    app.stop()


def _demo_model(device=None):
    """Tiny MLP so the stack can be driven before a real bundle exists: the
    JAX stack's architecture and recipe (one epoch of Adam on seeded data),
    on ``device`` (CUDA when ``None``). Its weights are the port's own
    training; ``bridge.state_dict_from_jax`` loads the JAX demo model's tree
    into it where both must answer alike."""
    import numpy as np

    from ..nn import layers as L
    from ..nn.topology import Sequential

    model = Sequential([L.Dense(64, activation="relu", input_shape=(16,)),
                        L.Dense(4, activation="softmax")], device=device)
    model.compile(optimizer="adam", loss="categorical_crossentropy")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 16)).astype("float32")
    y = np.eye(4, dtype="float32")[rng.integers(0, 4, 128)]
    model.fit(x, y, batch_size=32, nb_epoch=1)
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="foreground serving stack")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=8080)
    ap.add_argument("--broker-port", type=int, default=6380)
    ap.add_argument("--aof", default=None)
    ap.add_argument("--model", default=None, help="zoo model bundle path")
    ap.add_argument("--config", default=None, help="ServingConfig yaml")
    ap.add_argument("--replicas", type=int, default=None,
                    help="engine replicas behind the fleet router (default: "
                         "config `fleet: replicas`, else 1 = classic single "
                         "engine). >1 enables health-routed dispatch, "
                         "failover requeue, and rolling `cli drain`/restart")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable queue-driven autoscaling (fleet mode even "
                         "at 1 replica): the supervisor spawns replicas on "
                         "sustained zoo_fleet_queue_depth pressure up to "
                         "--max-replicas and drains them back down to "
                         "--min-replicas when idle, zero-loss (YAML "
                         "`autoscale:` section sets the thresholds)")
    ap.add_argument("--min-replicas", type=int, default=None)
    ap.add_argument("--max-replicas", type=int, default=None)
    ap.add_argument("--hosts", type=int, default=None,
                    help="cross-host fleet: place replicas on N host-agent "
                         "failure domains (local stand-in subprocesses here; "
                         "run `python -m analytics_zoo_tpu_torch.serving."
                         "hostagent`"
                         " per real machine instead). Whole-host death "
                         "evicts+respawns every replica in one decision; "
                         "cross-host connections never use shm")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--no-hot-swap", action="store_true",
                    help="ignore the trainer's model_updates publish stream "
                         "(default: fleet stacks run the canary "
                         "RolloutController; single engines swap in place "
                         "on every published checkpoint)")
    ap.add_argument("--demo", action="store_true",
                    help="serve a built-in demo model (no bundle needed)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines serve (default: the card; "
                         "without one the stack fails)")
    ap.add_argument("--no-shm", action="store_true",
                    help="disable the same-host shared-memory ring (tensor "
                         "buffers then ride the socket as binary frames)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append a JSONL snapshot of the telemetry registry "
                         "to this file every --metrics-interval seconds and "
                         "at shutdown (the file-based twin of GET /metrics)")
    ap.add_argument("--metrics-interval", type=float, default=60.0)
    ap.add_argument("--metrics-jsonl-max-mb", type=float, default=64.0,
                    help="rotate the --metrics-jsonl file to <path>.1 once "
                         "it grows past this many MiB (0 = never rotate); "
                         "current size is the zoo_metrics_jsonl_bytes gauge")
    ap.add_argument("--events-jsonl", default=None,
                    help="append every structured decision event "
                         "(autoscale, failover, rollout, breaker, shed, "
                         "chaos, slo) to this JSONL file; events also ride "
                         "the broker `events` stream for `cli events`")
    ap.add_argument("--flight-dir", default=None,
                    help="directory for flight-recorder dumps (default "
                         "$ZOO_FLIGHT_DIR or the system temp dir); the "
                         "recorder is always on — dumps are cut on "
                         "SIGTERM/atexit, fast-burn SLO pages, chaos "
                         "kills, `cli dump`, and GET /debug/flight")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.no_shm:
        import os

        os.environ["ZOO_SERVING_SHM"] = "0"

    cfg = (ServingConfig.from_yaml(args.config) if args.config
           else ServingConfig())
    cfg.queue_host, cfg.queue_port = "127.0.0.1", args.broker_port
    if args.model:
        cfg.model_path = args.model
    if args.int8:
        cfg.int8 = True
    if not cfg.model_path and not args.demo:
        ap.error("pass --model <bundle>, --config with model/path, or --demo")

    if args.replicas is not None:
        cfg.replicas = args.replicas
    if args.autoscale:
        cfg.autoscale = True
    if args.min_replicas is not None:
        cfg.min_replicas = args.min_replicas
    if args.max_replicas is not None:
        cfg.max_replicas = args.max_replicas
    if args.hosts is not None:
        cfg.fleet_hosts = args.hosts
    if args.no_hot_swap:
        cfg.hot_swap = False

    broker = start_broker("127.0.0.1", args.broker_port, aof_path=args.aof)
    # observability plane: 1s metrics history behind /debug, SLO engine when
    # the YAML declared objectives; decision events mirror onto the broker's
    # `events` stream so `cli events` works from any host that reaches it
    plane = ObservabilityPlane.from_config(cfg).start()
    _events.attach_broker("127.0.0.1", args.broker_port)
    if args.events_jsonl:
        _events.attach_jsonl(args.events_jsonl)
    # one registry spans the stack: engine stage/worker heartbeats feed the
    # frontend's /healthz, so an orchestrator probes the whole pipeline
    registry = HealthRegistry(default_timeout_s=cfg.heartbeat_timeout_s)
    ready_fn = None
    if cfg.replicas > 1 or cfg.autoscale or cfg.fleet_hosts > 0:
        # fleet mode: router + N supervised replicas; /readyz reflects the
        # eligible-replica count, `cli drain`/`rolling-restart` work.
        # Autoscaling implies fleet mode even at 1 replica — the supervisor
        # owns the spawn/drain lifecycle the autoscaler drives; fleet_hosts
        # shifts placement onto host-agent failure domains
        demo_module = (_demo_model(args.device)
                       if args.demo and not cfg.model_path else None)
        if cfg.fleet_spawn == "process" and demo_module is not None:
            ap.error("--demo needs thread-mode replicas (fleet: spawn)")
        if cfg.fleet_hosts > 0 and demo_module is not None:
            # host-agent subprocesses rebuild the demo model themselves
            demo_module = None
        # the supervisor keeps its OWN registry: a dead replica is a
        # READINESS event (supervisor evicts + respawns; /readyz reflects
        # it) — it must not flip /healthz and get the whole stack restarted
        serving = FleetSupervisor(
            cfg,
            model_factory=((lambda: demo_module) if demo_module is not None
                           else None),
            demo=bool(args.demo and not cfg.model_path),
            config_path=args.config, device=args.device)
        serving.start()
        ready_fn = serving.readiness
    else:
        serving = ClusterServing(
            _demo_model(args.device) if args.demo and not cfg.model_path
            else None, config=cfg, registry=registry, device=args.device)
        serving.start()
    # engine_stats feeds the frontend's /metrics recompile-count gauges;
    # the plane backs its /debug ops surface
    app = FrontEndApp(cfg, host=args.host, port=args.http_port,
                      registry=registry, engine_stats=serving.stats,
                      ready_fn=ready_fn, plane=plane)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    # black box: always-on flight recorder. Installed AFTER the stop
    # handlers so its chained SIGTERM handler dumps FIRST, then triggers
    # the graceful shutdown above; atexit covers plain exits
    _recorder.install(dump_dir=args.flight_dir, plane=plane,
                      signals=(signal.SIGTERM,))
    threading.Thread(target=app.serve, daemon=True,
                     name="zoo-http-frontend").start()
    if args.metrics_jsonl:
        max_bytes = int(args.metrics_jsonl_max_mb * (1 << 20))

        def _dump_loop():
            while not stop.wait(max(1.0, args.metrics_interval)):
                try:
                    write_metrics_snapshot(args.metrics_jsonl, max_bytes)
                except OSError:
                    logging.exception("metrics snapshot failed")

        threading.Thread(target=_dump_loop, daemon=True,
                         name="zoo-metrics-jsonl").start()
    logging.info("serving stack up: http=%s:%d broker=127.0.0.1:%d "
                 "replicas=%d%s", args.host, args.http_port, args.broker_port,
                 cfg.replicas, f" aof={args.aof}" if args.aof else "")
    stop.wait()
    logging.info("shutting down")
    if args.metrics_jsonl:
        try:
            write_metrics_snapshot(
                args.metrics_jsonl,
                int(args.metrics_jsonl_max_mb * (1 << 20)))
        except OSError:
            pass
    # ordered: stop accepting -> drain router+engines -> broker -> frontend
    # (construction-order stops strand accepted requests; see shutdown_stack)
    plane.stop()
    shutdown_stack(app, serving, broker)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
