"""Payload encoding helpers for queue transport and persistence (port of
``analytics_zoo_tpu/serving/schema.py``, which needs no JAX: a copy, but
for dtype names, which go through the port's wire so bf16 keeps its name).

Parity: the reference's ``pyzoo/zoo/serving/client.py`` — the reference
serialises ndarrays/images to Arrow record batches then base64 for Redis.

The serving HOT PATH no longer goes through this module: tensors ride the
binary zero-copy frame protocol (wire.py) as raw buffers. What remains here:

* the legacy base64-JSON ndarray codec (``encode_payload``/``decode_payload``)
  — still accepted from old/JSON-only clients, and ``decode_payload`` passes
  already-decoded ndarrays (binary-frame payloads) straight through, so one
  decode call serves both wire generations;
* the append-only-file bridge (``json_default``/``json_revive``): the broker's
  AOF is line-JSON for greppability and torn-write tolerance, so ndarray
  payloads from binary frames are tagged ``{"__zoond__": <npy b64>}`` on the
  way to disk and revived to real ndarrays on replay — binary-frame requests
  survive a broker crash bit-exactly.
"""

from __future__ import annotations

import base64
import io
from typing import Any, Dict, Optional

import numpy as np

# Trace-context field carried INSIDE request/result payload dicts (the JSON
# control-plane twin of the binary frame header's "c" field): a plain
# ``{"t": trace_id, "s": span_id}`` dict, JSON- and AOF-serializable, ignored
# by peers that predate it — interop never depends on its presence.
TRACE_KEY = "trace"

# Serving-model-version field carried inside RESULT payload dicts (the
# durable twin of the binary frame header's "v" field): the version id of
# the hot-swappable model that produced the result (serving/hotswap.py),
# stamped by the engine sink, surviving the broker hash + AOF replay to the
# client. Absent from pre-hot-swap engines — consumers must tolerate that.
MODEL_VERSION_KEY = "model_version"

# Overload QoS fields carried inside REQUEST payload dicts (the durable
# twins of the binary frame header's "p"/"dl" fields — serving/qos.py):
# ``priority`` is one of critical/normal/bulk, ``deadline`` an absolute
# wall-clock epoch-seconds float. Both survive the broker stream, AOF
# replay, and XTRANSFER failover requeues — a requeued request keeps its
# ORIGINAL deadline (and is shed, not served, if it expired in flight).
# Old clients omit them; every consumer tolerates absence.
PRIORITY_KEY = "priority"
DEADLINE_KEY = "deadline"


def payload_priority(payload: Any) -> str:
    """Tolerant read of a request payload's priority class (``normal``
    when absent/malformed — old-client records stay first-class)."""
    from .qos import normalize_priority

    if isinstance(payload, dict):
        return normalize_priority(payload.get(PRIORITY_KEY))
    return normalize_priority(None)


def payload_deadline(payload: Any) -> Optional[float]:
    """Tolerant read of a request payload's absolute deadline (epoch
    seconds; ``None`` when absent/malformed)."""
    from .qos import normalize_deadline

    if isinstance(payload, dict):
        return normalize_deadline(payload.get(DEADLINE_KEY))
    return None


def payload_model_version(payload: Any) -> Optional[str]:
    """Tolerant read of a result payload's serving model version."""
    if isinstance(payload, dict):
        v = payload.get(MODEL_VERSION_KEY)
        if isinstance(v, str) and v:
            return v
    return None


def payload_trace(payload: Any) -> Optional[Dict[str, str]]:
    """Tolerant read of a payload dict's trace context (``None`` when absent
    or malformed — e.g. a record enqueued by an old client). Validation is
    delegated to ``TraceContext.from_wire`` so the payload field and the
    frame-header field accept exactly the same shapes."""
    if isinstance(payload, dict):
        from ..common.telemetry import TraceContext

        ctx = payload.get(TRACE_KEY)
        if TraceContext.from_wire(ctx) is not None:
            return ctx
    return None


def encode_ndarray(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_ndarray(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s.encode("ascii"))),
                   allow_pickle=False)


def encode_payload(data: Dict[str, Any]) -> Dict[str, Any]:
    """ndarrays → tagged base64; scalars/strings pass through. Legacy wire
    format — the binary frame path (wire.py) sends raw arrays instead."""
    out: Dict[str, Any] = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": encode_ndarray(v)}
        elif isinstance(v, (list, tuple)) and v and \
                all(isinstance(x, np.ndarray) for x in v):
            out[k] = {"__ndarray_list__": [encode_ndarray(x) for x in v]}
        else:
            out[k] = v
    return out


def decode_payload(data: Dict[str, Any]) -> Dict[str, Any]:
    """Decode a payload dict from EITHER wire generation: legacy tagged-base64
    values are decoded; raw ndarrays (binary frames) pass through untouched."""
    out: Dict[str, Any] = {}
    for k, v in data.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = decode_ndarray(v["__ndarray__"])
        elif isinstance(v, dict) and "__ndarray_list__" in v:
            out[k] = [decode_ndarray(x) for x in v["__ndarray_list__"]]
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# AOF bridge: ndarray-bearing payloads <-> line-JSON mutation records
# ---------------------------------------------------------------------------

_AOF_TAG = "__zoond__"


def json_default(o: Any):
    """``json.dumps(..., default=json_default)`` hook: tag raw ndarrays (from
    binary frames) so they survive the broker's line-JSON append-only log.
    Dtype rides by NAME (not npy) so bf16 (2-byte voids in the port) replays
    bit-exact under its own name, readable by either package."""
    from .wire import _dtype_name

    if isinstance(o, (np.ndarray, np.generic)):
        arr = np.asarray(o)                 # keeps 0-d shape
        if isinstance(arr, np.ndarray) and not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        return {_AOF_TAG: [_dtype_name(arr.dtype), list(arr.shape),
                           base64.b64encode(arr.tobytes()).decode("ascii")]}
    raise TypeError(f"Object of type {type(o).__name__} is not JSON "
                    f"serializable")


def json_revive(obj: Any) -> Any:
    """Inverse of :func:`json_default`, applied recursively to a replayed AOF
    record. Legacy ``__ndarray__``-tagged dicts are left alone — they are the
    payload a JSON-generation consumer expects to see."""
    if isinstance(obj, dict):
        if len(obj) == 1 and _AOF_TAG in obj:
            from .wire import _dtype_from_name

            name, shape, b64 = obj[_AOF_TAG]
            raw = bytearray(base64.b64decode(b64.encode("ascii")))
            return np.frombuffer(raw, dtype=_dtype_from_name(name)).reshape(
                tuple(shape))
        return {k: json_revive(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_revive(v) for v in obj]
    return obj
