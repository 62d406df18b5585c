"""Serving client — ``InputQueue`` / ``OutputQueue`` (port of
``analytics_zoo_tpu/serving/client.py``, which needs no JAX).

Parity: the reference's ``pyzoo/zoo/serving/client.py`` —
``InputQueue.enqueue(uri, **data)`` (ndarray → arrow → base64 → Redis XADD)
and ``OutputQueue.query(uri)`` / ``dequeue()``. Same API over the port's
broker, or the JAX package's: the wire is the same.

``InputQueue.enqueue`` takes numpy arrays and ``torch`` tensors. A CPU
tensor frames its own storage; a CUDA tensor is copied to the host here,
explicitly, before the frame is built (the wire refuses device tensors).
``OutputQueue.query`` returns numpy, as in the JAX package (bf16 as ``V2``
bytes, see ``wire.py``).
"""

from __future__ import annotations

import socket
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.locks import traced_lock
from ..common.resilience import RetryPolicy
from .qos import (ShedError, deadline_from_ms, normalize_deadline,
                  normalize_priority, shed_error_from_payload)
from .shm import (MIN_SHM_BUFFER_BYTES, ShmChannel, host_identity,
                  shm_enabled)
from .wire import (WireError, received_model_version, recv_msg, send_msg,
                   set_wire_qos, tensor_to_numpy)
from .schema import (DEADLINE_KEY, PRIORITY_KEY, TRACE_KEY, decode_payload,
                     payload_model_version)

INPUT_STREAM = "serving_stream"
RESULT_PREFIX = "result:"

_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")


def _array_bytes(obj) -> int:
    """Total ndarray payload bytes in a request (shm-negotiation trigger)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_array_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_array_bytes(v) for v in obj)
    return 0


def _host_array(v) -> Any:
    """One enqueued value as the frame carries it: a tensor's host storage
    (a CUDA tensor copied to the host first, explicitly and blocking), an
    ndarray as it is; strings and bytes pass."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            v = v.detach().to("cpu")
        return tensor_to_numpy(v)
    return v if isinstance(v, (str, bytes)) else np.asarray(v)


def default_conn_policy() -> RetryPolicy:
    """Reconnect-with-backoff policy for broker connections: a broker bounce
    (cluster-serving-restart) is survived transparently; a genuinely dead
    broker surfaces as RetryExhaustedError within a few seconds."""
    return RetryPolicy(max_attempts=6, base_delay_s=0.05, max_delay_s=1.0,
                       attempt_timeout_s=5.0,
                       retryable=(ConnectionError, OSError))


class _Conn:
    """One broker connection; a lock serialises request/response pairs.

    With ``policy=None`` (the default) this is a bare eager connection whose
    failures propagate — protocol-level tests and probes want that. With a
    :class:`RetryPolicy`, the socket connects lazily and every ``call``
    transparently reconnects-with-backoff on connection failures; ``abort``
    (e.g. an engine's stop flag) ends the retry loop early. ``tag`` names the
    connection at the ``conn.call`` chaos site so fault schedules can target
    one role (engine source vs. client input) deterministically.
    """

    def __init__(self, host: str, port: int, timeout: Optional[float] = None,
                 policy: Optional[RetryPolicy] = None,
                 abort: Optional[Callable[[], bool]] = None,
                 tag: Optional[str] = None, shm_mode: str = "lazy"):
        self.host, self.port = host, port
        self.policy = policy
        self.abort = abort
        self.tag = tag
        # same-host zero-copy ring: "eager" negotiates right after connect
        # (bulk-receiving roles — the engine source/sink), "lazy" only once a
        # request actually carries a large tensor, "off" never
        self.shm_mode = shm_mode if shm_enabled() else "off"
        self._shm: Optional[ShmChannel] = None
        self._shm_failed = False
        self.timeout = (timeout if timeout is not None
                        else policy.attempt_timeout_s if policy else None)
        self.lock = traced_lock("_Conn.lock")
        self.sock: Optional[socket.socket] = None
        if policy is None:  # eager single-attempt connect (legacy semantics)
            self._connect()

    def _connect(self):
        # the conn lock EXISTS to serialize one request/response round trip
        # per connection: blocking I/O under it is its purpose, and call()
        # holders hold no other lock (see the concurrency-lint catalog)
        # zoo-lint: disable=lock-hold-hazard — serialized-I/O-by-design
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
        # small request/reply frames are latency-bound: without NODELAY the
        # kernel holds the second small write of a frame for the peer's
        # delayed ACK (~40ms per broker round trip)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        if self.policy is not None:
            # policy-managed conns: the connect timeout guards unreachable
            # hosts, but replies to blocking ops (XREADGROUP block_ms, HGET
            # timeouts) can legitimately take longer than any connect would,
            # so reads stay blocking and failures come from the peer closing.
            # Policy-less conns keep the legacy semantics: the caller's
            # timeout bounds EVERY socket op, recv included (a probe against
            # a wedged half-up broker must fail fast, not hang)
            self.sock.settimeout(None)
        if self.shm_mode == "eager":
            self._negotiate_shm()

    def _negotiate_shm(self):
        """Offer the broker a shared-memory ring (SHMOPEN). Any failure —
        remote host, segment creation denied, old broker — marks this
        connection socket-only until the next reconnect."""
        if self._shm is not None or self._shm_failed or self.shm_mode == "off":
            return
        if self.host not in _LOOPBACK_HOSTS:
            self._shm_failed = True
            return
        try:
            ch = ShmChannel.create()
        except Exception:
            self._shm_failed = True
            return
        try:
            # SHMOPEN negotiation is part of the serialized round trip the
            # conn lock exists for (see _connect); the host-identity token
            # lets the broker refuse a peer that resolves to loopback but
            # lives in another kernel/ipc namespace (port-forwarded or
            # containerized "localhost")
            # zoo-lint: disable=lock-hold-hazard — serialized-I/O-by-design
            send_msg(self.sock, ["SHMOPEN", ch.name, ch.size,
                                 host_identity()])
            # zoo-lint: disable=lock-hold-hazard — serialized-I/O-by-design
            if recv_msg(self.sock) == "OK":
                self._shm = ch
                return
        except (ConnectionError, OSError):
            ch.close()
            raise          # connection-level failure: let the retry layer act
        except Exception:
            pass
        ch.close()
        self._shm_failed = True

    def _drop(self):
        if self._shm is not None:
            self._shm.close()
            self._shm = None
        # a fresh connection may renegotiate. close() calls this without the
        # conn lock ON PURPOSE (unblocking a call() stuck in recv), so the
        # flag write is tolerably racy — worst case one extra negotiation
        # zoo-lint: disable=lock-guarded-by — lock-free close() by design
        self._shm_failed = False
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _attempt(self, req: List[Any]) -> Any:
        try:
            chaos_point("conn.call", tag=self.tag)
            if self.sock is None:
                self._connect()
            if (self._shm is None and not self._shm_failed
                    and self.shm_mode == "lazy"
                    and _array_bytes(req) >= MIN_SHM_BUFFER_BYTES):
                self._negotiate_shm()
            # THE serialized round trip the conn lock exists for; holders
            # hold no other lock
            # zoo-lint: disable=lock-hold-hazard — serialized-I/O-by-design
            send_msg(self.sock, req, shm=self._shm)
            # zoo-lint: disable=lock-hold-hazard — serialized-I/O-by-design
            return recv_msg(self.sock, shm=self._shm)
        except (ConnectionError, OSError):
            self._drop()  # next attempt reconnects from scratch
            raise
        except WireError:
            # protocol-level corruption: the socket may hold half a frame and
            # can never resync — reusing it would misparse every later reply
            self._drop()
            raise

    def call(self, *req) -> Any:
        with self.lock:
            if self.policy is None:
                return self._attempt(list(req))
            return self.policy.call(self._attempt, list(req),
                                    abort=self.abort)

    def close(self):
        # deliberately lock-free: closing from another thread must be able to
        # unblock a call() stuck in recv (it raises and is NOT retried once
        # the owner aborts/closes)
        self._drop()


class InputQueue:
    """Producer side: enqueue named tensors for the serving job.

    Connections reconnect-with-backoff under ``policy`` (at-least-once: an
    XADD retried across a reconnect may duplicate the record; the serving
    result hash is keyed by uri, so duplicates cost compute, not correctness).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6380,
                 stream: str = INPUT_STREAM,
                 policy: Optional[RetryPolicy] = None):
        self.stream = stream
        self._conn = _Conn(host, port, policy=policy or default_conn_policy(),
                           tag="client.input")

    def enqueue(self, uri: Optional[str] = None,
                priority: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                deadline: Optional[float] = None, **data) -> str:
        """Enqueue one record. ``data``: name → ndarray or tensor (or
        scalars/str).
        Returns the record uri (auto-generated when not given).

        Overload QoS: ``priority`` is one of ``critical``/``normal``/
        ``bulk`` (default normal), ``deadline_ms`` a relative latency budget
        from now (``deadline`` takes an absolute epoch-seconds value
        instead). Both ride the payload (durable — surviving the broker
        stream, AOF replay, and failover requeue) AND the binary frame
        header; every serving tier sheds the record instead of serving it
        once the deadline provably cannot be met.

        Tensors ride the binary zero-copy frame protocol raw — no npy/base64/
        JSON encode step; large batches transfer through the same-host shm
        ring when the broker negotiated one."""
        if not data:
            raise ValueError("enqueue needs at least one named tensor")
        uri = uri or uuid.uuid4().hex
        dl = normalize_deadline(deadline)
        if dl is None:
            dl = deadline_from_ms(deadline_ms)
        # the send span parents the whole request's trace: its context rides
        # BOTH the binary frame header (ambient, via send_msg) and the payload
        # (durable — it survives the broker stream/AOF to the engine hops)
        with _tm.span("serving.client.send", uri=uri) as sp:
            payload = {"uri": uri, TRACE_KEY: sp.wire_context(), "data":
                       {k: _host_array(v) for k, v in data.items()}}
            if priority is not None:
                payload[PRIORITY_KEY] = normalize_priority(priority)
            if dl is not None:
                payload[DEADLINE_KEY] = dl
            set_wire_qos(payload.get(PRIORITY_KEY), dl)
            try:
                self._conn.call("XADD", self.stream, payload)
            finally:
                set_wire_qos(None, None)
        return uri

    def __len__(self) -> int:
        return int(self._conn.call("LEN", self.stream))

    def close(self):
        self._conn.close()


class OutputQueue:
    """Consumer side: fetch results by uri or drain everything available."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6380,
                 policy: Optional[RetryPolicy] = None):
        self._conn = _Conn(host, port, policy=policy or default_conn_policy(),
                           tag="client.output")
        self._known: List[str] = []
        # serving model version of the LAST result query() returned (payload
        # field, falling back to the reply frame's "v" header) — None for
        # results from pre-hot-swap engines
        self.last_model_version: Optional[str] = None

    def register(self, uri: str) -> None:
        self._known.append(uri)

    def query(self, uri: str, timeout_s: float = 30.0) -> Any:
        """Blocking fetch of one result (client.py:277 parity)."""
        with _tm.span("serving.client.query", uri=uri):
            resp = self._conn.call("HGET", RESULT_PREFIX + uri,
                                   int(timeout_s * 1000))
            if resp is None:
                raise TimeoutError(f"no result for {uri!r} within {timeout_s}s")
            self.last_model_version = (payload_model_version(resp)
                                       or received_model_version())
            self._conn.call("HDEL", RESULT_PREFIX + uri)
        decoded = decode_payload(resp)
        shed = shed_error_from_payload(decoded, uri)
        if shed is not None:
            # an overloaded tier answered instead of serving: surface the
            # computed Retry-After so the caller (and any RetryPolicy around
            # this call) backs off proportionally to real drain time
            raise shed
        if "error" in decoded:
            raise RuntimeError(f"serving error for {uri!r}: {decoded['error']}")
        return decoded["value"]

    def dequeue(self) -> Dict[str, Any]:
        """Fetch all registered results that are READY — a non-blocking scan
        like the reference's key scan (client.py:293). Errored records come
        back as ``{"error": ...}`` dicts (and leave the registry) instead of
        aborting the whole drain."""
        out: Dict[str, Any] = {}
        for uri in list(self._known):
            try:
                out[uri] = self.query(uri, timeout_s=0)
                self._known.remove(uri)
            except TimeoutError:
                continue  # not ready yet; stays registered
            except RuntimeError as e:
                out[uri] = {"error": str(e)}
                self._known.remove(uri)
        return out

    def close(self):
        self._conn.close()
