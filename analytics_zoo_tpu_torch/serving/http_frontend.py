"""HTTP frontend — REST gateway in front of the serving queue (port of
``analytics_zoo_tpu/serving/http_frontend.py``, which needs no JAX: the same
routes, shedding and breaker; ``/metrics`` renders the port's registry).

Parity: the reference's ``serving/http/FrontEndApp.scala`` — an
akka-http app exposing ``PUT/POST predict``: serialise the request onto the
Redis stream, await the result hash, respond; plus liveness + metrics routes.
Here: stdlib ``ThreadingHTTPServer`` (one thread per in-flight request replaces
the actor round-trip).

Two serving modes:
* queue-backed (default): requests ride the broker stream and are batched by
  the ClusterServing engine's XREADGROUP window;
* direct (``model=`` given): requests from concurrent connections coalesce in
  an in-process :class:`MicroBatcher` into single batched predict calls —
  the FrontEndApp.scala actor-batching capability without a broker hop. A
  ``torch.nn.Module`` given as ``model`` is served through an
  ``InferenceModel`` on ``device`` (CUDA unless the caller names another; it
  raises without CUDA, as every entry point of the port does).

Routes:
    GET  /                 -> liveness ("welcome to analytics zoo web serving")
    GET  /healthz          -> LIVENESS: health registry status (503 when a
                              component is dead). An orchestrator restarts on
                              this.
    GET  /readyz           -> READINESS: 503 + Retry-After while the stack
                              cannot take NEW traffic — draining, circuit
                              breaker open, or zero eligible fleet replicas —
                              even though the process is perfectly alive. An
                              orchestrator (or L4 balancer) routes on this.
    POST /predict          -> {"instances":[{name: tensor-as-nested-list, ...}]}
    GET  /metrics          -> the shared telemetry registry as Prometheus text
                              format (docs/observability.md)
    GET  /metrics.json     -> legacy JSON stats view (timing + batching +
                              engine + wire dicts)

Resilience: requests beyond ``max_inflight`` are shed with HTTP 503 +
``Retry-After`` (bounded work queue — under overload the frontend answers
instantly instead of letting every client time out); repeated broker-path
failures open a :class:`CircuitBreaker` so a dead broker fails fast instead of
tying one thread per doomed request for the full timeout.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.locks import traced_lock
from ..common.resilience import (CircuitBreaker, CircuitOpenError,
                                 HealthRegistry, ResilienceError)
from ..inference.summary import timing, timing_stats
from ..observability import events as _ev
from ..observability.debug import DebugSurface
from . import qos as _qos
from . import slo_metrics as _slo_metrics
from .client import InputQueue, OutputQueue
from .config import ServingConfig
from .wire import wire_stats

_HTTP_REQS = _tm.counter("zoo_http_requests_total",
                         "HTTP /predict requests by final status code",
                         labels=("code",))
_HTTP_SHED = _tm.counter("zoo_http_shed_total",
                         "Requests shed with 503, by overload class "
                         "(admission = bounded-queue full, breaker = "
                         "circuit open, deadline = provably unmeetable, "
                         "backend = downstream tier shed it)",
                         labels=("reason",))
# per-class SLO evidence, registered once in serving/slo_metrics.py
_REQ_LAT = _slo_metrics.REQUEST_LATENCY
_REQ_OUTCOMES = _slo_metrics.REQUEST_OUTCOMES

# HTTP header twins of the payload/wire QoS fields (serving/qos.py):
# X-Zoo-Priority: critical|normal|bulk; X-Zoo-Deadline-Ms: relative latency
# budget in milliseconds (converted to an absolute deadline at receipt)
PRIORITY_HEADER = "X-Zoo-Priority"
DEADLINE_HEADER = "X-Zoo-Deadline-Ms"


class _Handler(BaseHTTPRequestHandler):
    # keep-alive: one client thread ↔ one server thread for its whole session
    # instead of a TCP connect + thread spawn per request
    protocol_version = "HTTP/1.1"
    # Nagle + the client's delayed ACK turns each small header/body write pair
    # into a ~40ms stall; serving responses are small and latency-bound
    disable_nagle_algorithm = True

    def log_message(self, *args):  # quiet
        pass

    def _respond(self, code: int, obj,
                 model_version: Optional[str] = None) -> None:
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if model_version:
            # the HTTP twin of the wire header's "v" field
            self.send_header("X-Zoo-Model-Version", model_version)
        self.end_headers()
        self.wfile.write(data)

    def _respond_shed(self, retry_after_s: float, reason: str,
                      shed_reason: str = "admission") -> None:
        """503 + computed Retry-After. The header is integer seconds
        (RFC 9110, rounded UP so clients never retry early); the JSON body
        carries the precise float and the overload class."""
        retry_after_s = max(_qos.MIN_RETRY_AFTER_S, float(retry_after_s))
        data = json.dumps({"error": reason,
                           "retry_after_s": round(retry_after_s, 4),
                           "shed_reason": shed_reason}).encode("utf-8")
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Retry-After",
                         str(max(1, int(-(-retry_after_s // 1)))))
        self.end_headers()
        self.wfile.write(data)

    def _request_qos(self):
        """(priority, absolute deadline) from the request headers — absent
        headers (old clients) behave exactly as before."""
        pri = self.headers.get(PRIORITY_HEADER)
        dl_ms = self.headers.get(DEADLINE_HEADER)
        deadline = None
        if dl_ms is not None:
            try:
                deadline = _qos.deadline_from_ms(float(dl_ms))
            except (TypeError, ValueError):
                deadline = None
        return (_qos.normalize_priority(pri) if pri is not None else None,
                deadline)

    def do_GET(self):
        app: "FrontEndApp" = self.server.app  # type: ignore[attr-defined]
        if self.path == "/metrics":
            # ONE scrape shows the whole system: every subsystem (wire,
            # batching, engine compiles, breakers, heartbeats, spans,
            # training) reports through the shared registry. Content
            # negotiation: exemplar trailers are OpenMetrics-only syntax,
            # so they are emitted only to scrapers that Accept it — a
            # stock 0.0.4 Prometheus scraper gets a clean exposition
            accept = self.headers.get("Accept", "")
            om = "application/openmetrics-text" in accept
            body = _tm.render_prometheus(openmetrics=om)
            if om:
                body += "# EOF\n"
                ctype = ("application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8")
            else:
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            text = body.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
        elif self.path == "/metrics.json":
            # legacy JSON stats view (pre-registry consumers, quick curl)
            stats = dict(timing_stats())
            if app._batcher is not None:
                # micro-batcher efficiency: mean/max batch, batches_run,
                # live queue depth, pad overhead, distinct batch shapes
                stats["batching"] = app._batcher.stats()
            engine = app.engine_stats()
            if engine:
                # recompile-count gauges: `compiles` flat under traffic means
                # every dispatch was a compiled-cache dict lookup
                stats["engine"] = engine
            stats["wire"] = wire_stats()    # bytes-on-wire / frame-kind gauges
            stats["shed_requests"] = app.shed_requests
            self._respond(200, stats)
        elif self.path.startswith("/debug"):
            # the ops surface (observability/debug.py): HTML dashboard,
            # /debug/slo, /debug/events, /debug/traces/<id>
            code, ctype, body, extra = app.debug.handle(self.path)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/healthz":
            if app.registry is None:
                self._respond(200, {"status": "ok", "components": {}})
                return
            status = app.registry.status()
            self._respond(200 if status["status"] == "ok" else 503, status)
        elif self.path == "/readyz":
            ready, detail = app.readiness()
            if ready:
                self._respond(200, {"status": "ready", **detail})
            else:
                # Retry-After so rolling restarts look like backpressure,
                # not an outage, to well-behaved clients
                data = json.dumps({"status": "unready",
                                   **detail}).encode("utf-8")
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(data)
        else:
            self._respond(200, {"message":
                                "welcome to analytics zoo web serving"})

    def do_POST(self):
        if self.path == "/generate":
            self._do_generate()
            return
        if self.path not in ("/predict", "/models/predict"):
            self._respond(404, {"error": f"no route {self.path}"})
            return
        app: "FrontEndApp" = self.server.app  # type: ignore[attr-defined]
        priority, deadline = self._request_qos()
        admitted, retry_after, reason = app._admit(priority, deadline)
        if not admitted:
            # bounded queue full / provably unmeetable deadline: shed with
            # an HONEST Retry-After (queue depth × measured service time)
            # instead of queueing work that will only time out
            app.shed_requests += 1
            app._note_shed(priority, reason)
            _HTTP_REQS.labels(code="503").inc()
            self._respond_shed(retry_after,
                               "server overloaded, request shed",
                               shed_reason=reason)
            return
        code = "500"
        t_start = time.monotonic()
        n_served = 0
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            instances = body.get("instances")
            if not isinstance(instances, list) or not instances:
                raise ValueError('body must contain non-empty "instances"')
            # root span of the request's trace: in queue mode the enqueue /
            # query hops (and through them broker + engine) nest under it
            with timing("http.predict"), \
                    _tm.span("serving.http.predict", n=len(instances)):
                preds, versions = app.predict_instances(
                    instances, timeout_s=app.timeout_s,
                    priority=priority, deadline=deadline)
            n_served = len(instances)
            code = "200"
            if app._batcher is not None:
                # direct mode has no engine to account the per-class SLO
                # evidence; queue mode counts at the engine (no double count)
                pri = _qos.normalize_priority(
                    priority if priority is not None
                    else app.default_priority)
                per_rec = (time.monotonic() - t_start) / n_served
                for _ in range(n_served):
                    _REQ_LAT.labels(priority=pri).observe(per_rec)
                    _REQ_OUTCOMES.labels(priority=pri,
                                         outcome="served").inc()
            body = {"predictions": preds}
            # hot-swap attribution: which model version(s) served this
            # request — a string normally, a list mid-swap (mixed versions
            # ACROSS instances are legal; within one tensor they are not)
            if versions:
                body["model_version"] = (versions[0] if len(versions) == 1
                                         else versions)
            self._respond(200, body,
                          model_version=",".join(versions) or None)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            code = "400"
            self._respond(400, {"error": str(e)})
        except _qos.ShedError as e:
            # a downstream tier (router, micro-batcher, engine) shed this
            # request; relay ITS computed Retry-After to the client. The
            # queue-mode tiers already counted the per-class outcome; the
            # in-process micro-batcher has no counter of its own, so direct
            # mode attributes it here
            code = "503"
            app.shed_requests += 1
            app._note_shed(priority, e.reason,
                           decided=app._batcher is not None)
            self._respond_shed(e.retry_after_s, str(e),
                               shed_reason=e.reason)
        except CircuitOpenError as e:
            code = "503"
            app._note_shed(priority, "breaker")
            self._respond_shed(e.retry_after_s, str(e),
                               shed_reason="breaker")
        except TimeoutError as e:
            code = "504"
            self._respond(504, {"error": str(e)})
        except ResilienceError as e:   # broker unreachable after retries
            code = "503"
            app._note_shed(priority, "breaker")
            self._respond_shed(app.retry_after_s(), str(e),
                               shed_reason="breaker")
        except Exception as e:  # pragma: no cover
            self._respond(500, {"error": str(e)})
        finally:
            if n_served:
                # measured per-record service time: the evidence behind the
                # admission tier's shed decisions and computed Retry-After
                app.service_ema.observe(
                    (time.monotonic() - t_start) / n_served)
            _HTTP_REQS.labels(code=code).inc()
            app._release()


    # -- streaming generation -------------------------------------------------

    def _write_chunk(self, data: bytes) -> None:
        """One HTTP/1.1 chunked-transfer chunk (hand-rolled: the stdlib
        handler has no chunked writer)."""
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii") + data
                         + b"\r\n")

    def _abort_stream(self, error: str) -> None:
        """Mid-stream failure after the 200/chunked headers are gone: emit an
        error final frame and terminate the chunked body cleanly so the
        client's reader ends instead of hanging."""
        try:
            self._write_chunk(json.dumps(
                {"tokens": [], "final": True, "outcome": "error",
                 "error": error}).encode("utf-8") + b"\n")
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass

    def _do_generate(self):
        """POST /generate: ``{"prompt": [ids...], "max_new_tokens": N,
        "temperature": t, "seed": s, "eos_id": e, "stream": true}``.

        ``stream: true`` (default) answers with ``Transfer-Encoding:
        chunked`` — one JSON line per token-delta frame plus a final-marker
        line, flushed as the decode loop emits, so the client sees tokens at
        inter-token latency instead of request latency. ``stream: false``
        accumulates and answers one JSON object (old one-shot shape)."""
        app: "FrontEndApp" = self.server.app  # type: ignore[attr-defined]
        priority, deadline = self._request_qos()
        admitted, retry_after, reason = app._admit(priority, deadline)
        if not admitted:
            app.shed_requests += 1
            app._note_shed(priority, reason)
            _HTTP_REQS.labels(code="503").inc()
            self._respond_shed(retry_after,
                               "server overloaded, request shed",
                               shed_reason=reason)
            return
        code = "500"
        headers_sent = False
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body.get("prompt")
            if not isinstance(prompt, list) or not prompt:
                raise ValueError('body must contain a non-empty "prompt" '
                                 'token-id list')
            stream = bool(body.get("stream", True))
            kw = dict(max_new_tokens=int(body.get("max_new_tokens", 32)),
                      temperature=float(body.get("temperature", 0.0)),
                      seed=int(body.get("seed", 0)),
                      eos_id=(int(body["eos_id"])
                              if body.get("eos_id") is not None else None))
            with _tm.span("serving.http.generate", n=len(prompt)):
                frames = app.generate_frames(prompt, timeout_s=app.timeout_s,
                                             priority=priority,
                                             deadline=deadline, **kw)
                if not stream:
                    tokens, meta = [], {}
                    for toks, final, m in frames:
                        tokens.extend(toks)
                        if final:
                            meta = m
                    if meta.get("outcome") == "shed":
                        raise _qos.ShedError(
                            meta.get("error", "generation request shed"),
                            retry_after_s=float(
                                meta.get("retry_after_s", 1.0)),
                            reason="deadline")
                    if meta.get("error"):
                        raise RuntimeError(meta["error"])
                    code = "200"
                    app._note_gen_outcome(priority,
                                          meta.get("outcome", "ok"))
                    self._respond(200, {"tokens": tokens,
                                        "outcome": meta.get("outcome", "ok"),
                                        "n_tokens": len(tokens)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                headers_sent = True
                final_outcome = "ok"
                for toks, final, meta in frames:
                    line = {"tokens": list(toks), "final": bool(final)}
                    if final:
                        final_outcome = meta.get("outcome", "ok")
                        line.update({k: meta[k] for k in
                                     ("outcome", "error", "n_tokens",
                                      "retry_after_s")
                                     if k in meta})
                    self._write_chunk(json.dumps(line).encode("utf-8")
                                      + b"\n")
                    self.wfile.flush()
                # a shed that rode the stream as a terminal frame (not an
                # exception) still counts as this class's SLO outcome —
                # noted BEFORE the terminal chunk so a client that reads
                # the stream to completion observes the outcome on the
                # very next scrape
                app._note_gen_outcome(priority, final_outcome)
                self.wfile.write(b"0\r\n\r\n")
                code = "200"
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            # a late validation error (e.g. prompt over gen_max_seq_len,
            # raised by submit() at the generator's FIRST iteration) lands
            # after the 200/chunked headers — a second status line would
            # corrupt the open chunked body
            code = "400"
            if headers_sent:
                self._abort_stream(str(e))
            else:
                self._respond(400, {"error": str(e)})
        except _qos.ShedError as e:
            code = "503"
            app.shed_requests += 1
            # the generation tiers count only zoo_gen_shed_total — the
            # per-class SLO outcome is attributed HERE (the frontend is the
            # generation path's one per-class accountant)
            app._note_shed(priority, e.reason)
            if headers_sent:
                self._abort_stream(str(e))
            else:
                self._respond_shed(e.retry_after_s, str(e),
                                   shed_reason=e.reason)
        except TimeoutError as e:
            code = "504"
            if headers_sent:
                self._abort_stream(str(e))
            else:
                self._respond(504, {"error": str(e)})
        except Exception as e:
            if headers_sent:
                self._abort_stream(str(e))
            else:
                self._respond(500, {"error": str(e)})
        finally:
            _HTTP_REQS.labels(code=code).inc()
            app._release()


class _Server(ThreadingHTTPServer):
    # default listen backlog (5) drops/resets connections under concurrent
    # clients — the whole point of the micro-batching mode
    request_queue_size = 128
    daemon_threads = True


class FrontEndApp:
    """REST gateway. ``serve()`` blocks; ``start()`` runs on a daemon thread."""

    def __init__(self, config: Optional[ServingConfig] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 30.0, model=None,
                 max_batch: int = 32, max_delay_ms: float = 2.0,
                 max_inflight: Optional[int] = None,
                 registry: Optional[HealthRegistry] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 engine_stats=None, generator=None, ready_fn=None,
                 plane=None, device=None):
        self.config = config or ServingConfig()
        if isinstance(model, torch.nn.Module):
            from ..inference.inference_model import InferenceModel

            model = InferenceModel(
                supported_concurrent_num=self.config.concurrent_num,
                max_batch_size=max_batch, device=device).load(model)
        self.timeout_s = timeout_s
        self.registry = registry             # backs /healthz (None => always ok)
        # observability plane (history + SLO engine, observability/__init__)
        # behind the /debug ops surface; None still serves events + traces
        # (process-global), just without sparklines/SLO
        self.plane = plane
        self.debug = DebugSurface(plane)
        # backs /readyz: () -> (ready, detail) — e.g. FleetSupervisor.
        # readiness (>= 1 eligible replica). None => backend always ready
        self._ready_fn = ready_fn
        # ordered shutdown: stop_accepting() flips this; new requests shed
        # 503 while already-admitted ones finish (wait_idle)
        self._draining = False
        self._inflight = 0
        # zoo-lock: guards(_inflight)
        self._inflight_lock = traced_lock("FrontEndApp._inflight_lock")
        self._model = model
        # queue-backed stacks pass the ClusterServing job's ``stats`` here so
        # /metrics carries the engine's compile-cache gauges too
        self._engine_stats = engine_stats
        # load shedding: at most max_inflight concurrently admitted /predict
        # requests; excess answers 503 + Retry-After immediately
        self.max_inflight = (max_inflight if max_inflight is not None
                             else self.config.http_max_inflight)
        self._admission = threading.Semaphore(self.max_inflight)
        self.shed_requests = 0
        # overload QoS: measured per-record service time feeds the computed
        # Retry-After and the deadline-admission proof; bulk traffic admits
        # only up to a fraction of the inflight budget so critical requests
        # always find headroom under sustained overload
        self.service_ema = _qos.ServiceTimeEMA()
        self.default_priority = _qos.normalize_priority(
            getattr(self.config, "default_priority", None))
        frac = float(getattr(self.config, "bulk_inflight_fraction", 0.5))
        self._bulk_max = max(1, int(self.max_inflight * min(1.0, frac)))
        # broker-path breaker: consecutive failures (timeouts, dead broker)
        # open it and /predict fails fast until a half-open probe succeeds
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=self.config.breaker_failure_threshold,
            reset_timeout_s=self.config.breaker_reset_timeout_s,
            name="serving-frontend")
        self._server = _Server((host, port), _Handler)
        self._server.app = self  # type: ignore[attr-defined]
        self._batcher = None
        self._input = None
        if model is not None:
            # direct mode: micro-batch across concurrent request threads
            from .batching import MicroBatcher

            predict = model.predict if hasattr(model, "predict") else model
            self._batcher = MicroBatcher(predict, max_batch=max_batch,
                                         max_delay_ms=max_delay_ms)
        else:
            self._input = InputQueue(self.config.queue_host,
                                     self.config.queue_port)
        # ThreadingHTTPServer spawns a fresh thread per request, so cache broker
        # connections in a pool rather than thread-locals (which would never hit)
        self._oq_pool: "queue.LifoQueue[OutputQueue]" = queue.LifoQueue()
        # streaming generation: an in-process ContinuousBatcher (direct mode)
        # or — when absent — the broker-backed GenerationClient path
        self._generator = generator
        self._gc_pool: "queue.LifoQueue" = queue.LifoQueue()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def engine_stats(self) -> dict:
        """Compile-cache gauges from whichever engine this frontend fronts:
        a direct-mode model with ``compile_stats`` or an attached queue-mode
        engine callback."""
        if self._engine_stats is not None:
            try:
                return dict(self._engine_stats())
            except Exception:
                return {}
        if hasattr(self._model, "compile_stats"):
            return self._model.compile_stats()
        return {}

    # -- load shedding / readiness -------------------------------------------
    def retry_after_s(self) -> float:
        """Honest backoff hint: the current admitted backlog's drain
        estimate — what the fixed ``Retry-After: 1`` used to fake.
        ``service_ema`` is whole-request WALL time and admitted requests
        run concurrently (up to ``max_inflight``), so the estimate divides
        by that concurrency — multiplying depth by wall time would double-
        count the parallelism and inflate the hint."""
        with self._inflight_lock:
            inflight = self._inflight
        return _qos.retry_after_s(inflight, self.service_ema.value(),
                                  self.max_inflight)

    def _admit(self, priority: Optional[str] = None,
               deadline: Optional[float] = None) -> tuple:
        """Admission decision: ``(admitted, retry_after_s, reason)``.

        Sheds BEFORE any work is done when (a) draining, (b) the request's
        deadline provably cannot be met (estimated wait = inflight ×
        measured service time already overruns it), (c) a bulk-class
        request would push past the bulk watermark (critical/normal keep
        the remaining headroom), or (d) the inflight budget is exhausted."""
        priority = (priority if priority is not None
                    else self.default_priority)
        if self._draining:
            return False, self.retry_after_s(), "admission"
        ema = self.service_ema.value()
        with self._inflight_lock:
            inflight = self._inflight
        # service_ema is whole-request WALL time (it already contains the
        # downstream batcher/broker queueing) and admitted requests run
        # CONCURRENTLY — the wait estimate must divide by that concurrency,
        # or steady parallel traffic would look like a serial backlog and
        # shed requests that would comfortably meet their deadline
        est = _qos.estimated_wait_s(inflight, ema, self.max_inflight)
        if _qos.cannot_meet(deadline, est, ema):
            chaos_point("overload.shed", tag="frontend")
            return False, _qos.retry_after_s(inflight, ema,
                                             self.max_inflight), "deadline"
        if (_qos.priority_rank(priority) == _qos.PRIORITY_RANK["bulk"]
                and inflight >= self._bulk_max):
            chaos_point("overload.shed", tag="frontend")
            return False, _qos.retry_after_s(inflight, ema,
                                             self.max_inflight), "admission"
        if not self._admission.acquire(blocking=False):
            return False, _qos.retry_after_s(inflight, ema,
                                             self.max_inflight), "admission"
        with self._inflight_lock:
            self._inflight += 1
        return True, 0.0, ""

    def _release(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
        self._admission.release()

    def _note_shed(self, priority: Optional[str], reason: str,
                   decided: bool = True) -> None:
        """Shed accounting: the HTTP-class counter always moves; the
        per-class SLO outcome + decision event only when THIS tier decided
        the shed (a relayed downstream shed was already counted there)."""
        _HTTP_SHED.labels(reason=reason).inc()
        if decided:
            pri = _qos.normalize_priority(
                priority if priority is not None else self.default_priority)
            _REQ_OUTCOMES.labels(priority=pri, outcome="shed").inc()
            _ev.emit("shed.frontend", severity="warning", throttle_s=1.0,
                     reason=reason, priority=pri)

    def _note_gen_outcome(self, priority: Optional[str],
                          outcome: str) -> None:
        """Per-class SLO outcome for one generation STREAM. The generation
        tiers count only zoo_gen_* families, so the frontend is the one
        per-class accountant here — no double count in either serving mode.
        ``shed`` covers both transports of a batcher shed: the raised
        ShedError (one-shot) and the terminal shed frame (streaming)."""
        pri = _qos.normalize_priority(
            priority if priority is not None else self.default_priority)
        if outcome == "shed":
            _REQ_OUTCOMES.labels(priority=pri, outcome="shed").inc()
            _ev.emit("shed.frontend", severity="warning", throttle_s=1.0,
                     reason="deadline", priority=pri, path="generate")
        elif outcome == "ok":
            _REQ_OUTCOMES.labels(priority=pri, outcome="served").inc()

    def readiness(self) -> tuple:
        """(ready, detail) for /readyz: NOT ready while draining, while the
        broker-path breaker is open (no backend will answer), or while the
        attached readiness source (fleet) reports zero eligible replicas.
        Liveness (/healthz) is deliberately independent: a draining stack is
        alive-but-unready, and must not be restarted by its orchestrator."""
        detail: dict = {}
        if self._draining:
            return False, {"reason": "draining"}
        if self.breaker.state == CircuitBreaker.OPEN:
            return False, {"reason": "circuit open",
                           "retry_after_s": self.breaker.retry_after_s()}
        if self._ready_fn is not None:
            try:
                ready, detail = self._ready_fn()
            except Exception as e:
                return False, {"reason": f"readiness probe failed: {e}"}
            if not ready:
                return False, {"reason": "no eligible replica", **detail}
        return True, detail

    def stop_accepting(self) -> None:
        """First step of ordered shutdown: /readyz flips 503 and new
        /predict//generate requests shed immediately; in-flight requests
        keep running (pair with :meth:`wait_idle`)."""
        self._draining = True

    def wait_idle(self, timeout_s: float = 10.0) -> bool:
        """Block until every admitted request released (True) or timeout."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._inflight_lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.02)
        with self._inflight_lock:
            return self._inflight == 0

    @contextlib.contextmanager
    def _output(self):
        try:
            oq = self._oq_pool.get_nowait()
        except queue.Empty:
            oq = OutputQueue(self.config.queue_host, self.config.queue_port)
        try:
            yield oq
        except (OSError, ConnectionError):
            oq.close()  # broken connection: don't return it to the pool
            raise
        else:
            self._oq_pool.put(oq)

    def predict_instances(self, instances, timeout_s: float = 30.0,
                          priority: Optional[str] = None,
                          deadline: Optional[float] = None):
        """Returns ``(predictions, versions)`` where ``versions`` is the
        deduped (order-preserving) list of serving model versions that
        produced them — normally one entry; two legitimately appear when a
        hot-swap lands between instances of one request. ``priority`` /
        ``deadline`` ride to the micro-batcher (direct mode) or the queue
        payload (broker mode) so every downstream tier orders and sheds on
        them."""
        parsed = []
        for inst in instances:
            if not isinstance(inst, dict) or not inst:
                raise ValueError("each instance must be a non-empty object")
            parsed.append({k: np.asarray(v) for k, v in inst.items()})
        if self._batcher is not None:
            # submit every instance first so one request's records share a batch
            slots = [self._batcher.submit_async(t, priority=priority,
                                                deadline=deadline)
                     for t in parsed]
            out = []
            for slot in slots:
                val = self._batcher.wait(slot, timeout_s=timeout_s)
                out.append(val.tolist() if isinstance(val, np.ndarray)
                           else [np.asarray(v).tolist() for v in val])
            ver = getattr(self._model, "version", None) or "initial"
            return out, [ver]
        # queue mode: the whole broker round trip rides the circuit breaker —
        # when the broker/engine is down, requests fail fast (503 upstream)
        # instead of each burning a thread for the full timeout
        if not self.breaker.allow():
            raise CircuitOpenError(self.breaker.name,
                                   self.breaker.retry_after_s())
        versions: list = []
        try:
            uris = [self._input.enqueue(None, priority=priority,
                                        deadline=deadline, **tensors)
                    for tensors in parsed]
            out = []
            with self._output() as oq:
                for uri in uris:
                    val = oq.query(uri, timeout_s=timeout_s)
                    out.append(val.tolist() if isinstance(val, np.ndarray)
                               else val)
                    v = oq.last_model_version
                    if v and v not in versions:
                        versions.append(v)
        except (TimeoutError, ConnectionError, OSError, ResilienceError):
            self.breaker.record_failure()
            raise
        except BaseException:
            # application-level error (e.g. a serving-error result raised by
            # oq.query): the broker round trip itself WORKED. Must still be
            # recorded as breaker success — allow() consumed a half-open probe
            # slot, and leaving it unpaired would wedge the breaker half-open
            # (probes exhausted, no outcome) refusing all traffic forever
            self.breaker.record_success()
            raise
        self.breaker.record_success()
        return out, versions

    @contextlib.contextmanager
    def _gen_client(self):
        from .generation import GenerationClient

        try:
            gc = self._gc_pool.get_nowait()
        except queue.Empty:
            gc = GenerationClient(self.config.queue_host,
                                  self.config.queue_port)
        try:
            yield gc
        except BaseException:
            # anything but a clean finish — TimeoutError, GeneratorExit
            # (client disconnected mid-stream), connection errors — must
            # close the socket, not strand it unreferenced
            gc.close()
            raise
        else:
            self._gc_pool.put(gc)

    def generate_frames(self, prompt, timeout_s: float = 30.0,
                        priority: Optional[str] = None,
                        deadline: Optional[float] = None, **kw):
        """Yield ``(tokens, final, meta)`` frames for one generation request
        — in-process when a generator (ContinuousBatcher) was attached,
        otherwise through the broker's generation engine. An abandoned
        consumer (client disconnect mid-stream, timeout) CANCELS the
        underlying request — otherwise the decode loop would keep burning a
        slot + KV pages to max_new_tokens for output nobody reads."""
        if priority is not None or deadline is not None:
            kw.update(priority=priority, deadline=deadline)
        if self._generator is not None:
            handle = self._generator.submit(prompt, **kw)
            try:
                yield from handle.frames(timeout_s=timeout_s)
            finally:
                handle.cancel()   # no-op once the stream finished
            return
        with self._gen_client() as gc:
            uri = gc.submit(prompt, **kw)
            n = 0
            finished = False
            try:
                try:
                    for chunk in gc.stream(uri, timeout_s=timeout_s):
                        n += len(chunk)
                        yield chunk.tolist(), False, {}
                except _qos.ShedError as e:
                    finished = True      # terminal shed frame consumed
                    yield [], True, {"outcome": "shed", "error": str(e),
                                     "retry_after_s": e.retry_after_s}
                    return
                except RuntimeError as e:
                    finished = True      # terminal frame consumed (error)
                    yield [], True, {"outcome": "error", "error": str(e)}
                    return
                finished = True
                yield [], True, {"outcome": "ok", "n_tokens": n}
            finally:
                if not finished:
                    try:
                        gc.cancel(uri)
                    except Exception:
                        pass

    def start(self) -> "FrontEndApp":
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="serving-http").start()
        return self

    def serve(self):  # pragma: no cover
        self._server.serve_forever()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()   # release the listening socket fd
        if self._input is not None:
            self._input.close()
        if self._batcher is not None:
            self._batcher.close()
        while True:   # pooled generation clients (the generator itself is
            try:      # caller-owned and NOT closed here)
                self._gc_pool.get_nowait().close()
            except queue.Empty:
                break
