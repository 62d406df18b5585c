"""Binary zero-copy wire protocol for the serving data plane (port of
``analytics_zoo_tpu/serving/wire.py``; the frame format, byte for byte).

    outer frame   := u32be total_len | body            (shared with legacy JSON)
    JSON body     := utf-8 JSON (first byte is never 0x00)   [control plane]
    binary body   := MAGIC b"\\x00ZB" | version u8 | flags u8
                     | header_len u32be | header | buffer bytes...

The header is a msgpack map (encoder/decoder below — standard msgpack format
codes, no external dependency) ``{"t": tree, "b": [desc, ...]}`` where
``tree`` is the payload with every array leaf replaced by ``{"__nd__": i}``
and ``desc[i] = {"d": dtype-name, "s": shape, "n": nbytes[, "o": shm-offset]}``.
Buffers without ``"o"`` follow the header on the socket as raw contiguous
bytes, written with ``sendall(memoryview)`` and read with ``recv_into``
straight into a preallocated ``np.empty``. Buffers with ``"o"`` live in a
same-host shared-memory ring (shm.py) and never cross the socket. Optional
header fields carry the sender's trace context (``"c"``), the serving model
version (``"v"``) and the overload-QoS pair (``"p"``, ``"dl"``), per thread.

Version negotiation is sniff-based: every receiver accepts both body kinds
(0x00 first byte: binary), and a sender only emits a binary frame when the
payload holds arrays, so a JSON-only peer interoperates on the control plane.

Dtypes ride by name. bfloat16 is named and decoded here, without
``ml_dtypes``: on the wire it is the name ``"bfloat16"`` and the raw 16-bit
patterns, as the JAX package sends it; on receipt it is a numpy array of
dtype ``V2`` holding those bytes (as ``engine/checkpoint.py`` holds bf16
leaves), and a ``V2`` array is sent as ``"bfloat16"`` again. View one as a
tensor with ``torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)``. A
sender may also give ``torch`` tensors as array leaves: CPU tensors frame
their own storage (bf16 included); a CUDA tensor is refused with
:class:`WireError`, so a copy from the card is always the caller's explicit
``.cpu()`` (``InputQueue.enqueue`` makes it), never a hidden one here.
Not carried: the fp8 dtypes, which only ``ml_dtypes`` names (a frame holding
one is refused with :class:`WireError`).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import telemetry as _tm

MAGIC = b"\x00ZB"
VERSION = 1
_HDR = struct.Struct(">I")
_PRE = struct.Struct(">3sBBI")          # magic, version, flags, header_len
MAX_MSG = 512 * 1024 * 1024
# frames whose inline tensor bytes fit under this are coalesced into one
# sendall (one TCP segment): see the Nagle/delayed-ACK note in send_msg
SMALL_FRAME_COALESCE_BYTES = 16 * 1024

FLAG_SHM = 0x01                          # at least one buffer rides the ring


class WireError(ValueError):
    """Malformed or unsupported frame."""


# ---------------------------------------------------------------------------
# byte accounting — shared-registry counters (one scrape shows the whole
# system); wire_stats() keeps the historical dict shape for /metrics.json,
# broker INFO, and the bench
# ---------------------------------------------------------------------------

_WIRE_BYTES = _tm.counter("zoo_wire_bytes_total",
                          "Bytes moved by the serving wire protocol",
                          labels=("direction",))
_WIRE_FRAMES = _tm.counter("zoo_wire_frames_total",
                           "Frames sent+received by body kind",
                           labels=("kind",))
_WIRE_SHM = _tm.counter("zoo_wire_shm_bytes_total",
                        "Tensor bytes that rode a same-host shm ring "
                        "instead of the socket")

_ACCOUNT = {
    "bytes_sent": _WIRE_BYTES.labels(direction="sent"),
    "bytes_received": _WIRE_BYTES.labels(direction="received"),
    "frames_binary": _WIRE_FRAMES.labels(kind="binary"),
    "frames_json": _WIRE_FRAMES.labels(kind="json"),
    "shm_bytes": _WIRE_SHM.labels(),
}


def _account(**kw) -> None:
    for k, v in kw.items():
        _ACCOUNT[k].inc(v)


def wire_stats() -> Dict[str, int]:
    """Process-wide data-plane counters (monotonic since import)."""
    return {k: int(c.value()) for k, c in _ACCOUNT.items()}


# ---------------------------------------------------------------------------
# trace-context propagation: binary frames carry the ambient span's context in
# an optional header field "c" (old decoders ignore unknown header keys; old
# senders simply omit it — both directions tolerate absence). recv_msg stashes
# the last received context per thread; connection handlers read it right
# after recv to parent their server-side spans.
# ---------------------------------------------------------------------------

_TLS = threading.local()


def received_trace_context() -> Optional[Dict[str, str]]:
    """Wire trace context (``{"t": trace_id, "s": span_id}``) carried by the
    last frame ``recv_msg`` returned on THIS thread, or ``None``."""
    return getattr(_TLS, "ctx", None)


# ---------------------------------------------------------------------------
# serving-model-version propagation: binary frames carry an optional header
# field "v" — the model version of the serving engine that produced the
# payload. Set ambiently per thread (the engine's sink thread tags its result
# writes; the broker tags result-fetch replies from the stored payload), read
# after recv like the trace context. Old peers ignore/omit it.
# ---------------------------------------------------------------------------

def set_wire_model_version(version: Optional[str]) -> None:
    """Tag binary frames SENT from this thread with a serving model version
    (header field "v"); ``None`` clears the tag."""
    _TLS.send_version = version


def received_model_version() -> Optional[str]:
    """Model version carried by the last frame ``recv_msg`` returned on
    THIS thread, or ``None`` (JSON frame, old sender, untagged)."""
    return getattr(_TLS, "recv_version", None)


# ---------------------------------------------------------------------------
# overload-QoS propagation: binary frames carry optional header fields "p"
# (priority class: critical/normal/bulk) and "dl" (absolute wall-clock
# deadline, epoch seconds) — the wire twins of the payload's
# priority/deadline fields (schema.py). Same compat pattern as the PR-3
# trace field and PR-10 version field: old decoders ignore unknown header
# keys, old senders omit them, both directions tolerate absence. Set
# ambiently per thread around a send; read after recv.
# ---------------------------------------------------------------------------

def set_wire_qos(priority: Optional[str] = None,
                 deadline: Optional[float] = None) -> None:
    """Tag binary frames SENT from this thread with an overload-QoS pair
    (header fields "p"/"dl"); ``(None, None)`` clears the tag."""
    _TLS.send_priority = priority
    _TLS.send_deadline = deadline


def received_qos() -> Tuple[Optional[str], Optional[float]]:
    """``(priority, deadline)`` carried by the last frame ``recv_msg``
    returned on THIS thread — ``(None, None)`` for JSON frames, old
    senders, or untagged frames."""
    return (getattr(_TLS, "recv_priority", None),
            getattr(_TLS, "recv_deadline", None))


# ---------------------------------------------------------------------------
# msgpack subset (nil/bool/int/float64/str/bin/array/map — standard format
# codes, interoperable with any msgpack reader)
# ---------------------------------------------------------------------------

def pack(obj: Any) -> bytearray:
    out = bytearray()
    _pack_into(out, obj)
    return out


def _pack_into(out: bytearray, o: Any) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        if 0 <= o <= 0x7F:
            out.append(o)
        elif -32 <= o < 0:
            out.append(0x100 + o)
        elif 0 <= o <= 0xFFFFFFFF:
            out.append(0xCE)
            out += struct.pack(">I", o)
        elif 0 <= o:
            out.append(0xCF)
            out += struct.pack(">Q", o)
        elif o >= -(1 << 31):
            out.append(0xD2)
            out += struct.pack(">i", o)
        else:
            out.append(0xD3)
            out += struct.pack(">q", o)
    elif isinstance(o, float):
        out.append(0xCB)
        out += struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        n = len(b)
        if n <= 0xFF:
            out += bytes((0xC4, n))
        elif n <= 0xFFFF:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(o, (list, tuple)):
        n = len(o)
        if n <= 15:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out.append(0xDC)
            out += struct.pack(">H", n)
        else:
            out.append(0xDD)
            out += struct.pack(">I", n)
        for v in o:
            _pack_into(out, v)
    elif isinstance(o, dict):
        n = len(o)
        if n <= 15:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out.append(0xDE)
            out += struct.pack(">H", n)
        else:
            out.append(0xDF)
            out += struct.pack(">I", n)
        for k, v in o.items():
            _pack_into(out, k)
            _pack_into(out, v)
    elif isinstance(o, (np.integer,)):
        _pack_into(out, int(o))
    elif isinstance(o, (np.floating,)):
        _pack_into(out, float(o))
    else:
        raise WireError(f"cannot pack {type(o).__name__} into a wire header")


def unpack(buf) -> Any:
    obj, off = _unpack_from(memoryview(buf), 0)
    return obj


def _unpack_from(mv: memoryview, off: int) -> Tuple[Any, int]:
    c = mv[off]
    off += 1
    if c <= 0x7F:
        return c, off
    if c >= 0xE0:
        return c - 0x100, off
    if 0x80 <= c <= 0x8F:
        return _unpack_map(mv, off, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return _unpack_array(mv, off, c & 0x0F)
    if 0xA0 <= c <= 0xBF:
        n = c & 0x1F
        return str(mv[off:off + n], "utf-8"), off + n
    if c == 0xC0:
        return None, off
    if c == 0xC2:
        return False, off
    if c == 0xC3:
        return True, off
    if c == 0xC4:
        n = mv[off]
        return bytes(mv[off + 1:off + 1 + n]), off + 1 + n
    if c == 0xC5:
        (n,) = struct.unpack_from(">H", mv, off)
        return bytes(mv[off + 2:off + 2 + n]), off + 2 + n
    if c == 0xC6:
        (n,) = struct.unpack_from(">I", mv, off)
        return bytes(mv[off + 4:off + 4 + n]), off + 4 + n
    if c == 0xCB:
        (v,) = struct.unpack_from(">d", mv, off)
        return v, off + 8
    if c == 0xCC:
        return mv[off], off + 1
    if c == 0xCD:
        (v,) = struct.unpack_from(">H", mv, off)
        return v, off + 2
    if c == 0xCE:
        (v,) = struct.unpack_from(">I", mv, off)
        return v, off + 4
    if c == 0xCF:
        (v,) = struct.unpack_from(">Q", mv, off)
        return v, off + 8
    if c == 0xD0:
        (v,) = struct.unpack_from(">b", mv, off)
        return v, off + 1
    if c == 0xD1:
        (v,) = struct.unpack_from(">h", mv, off)
        return v, off + 2
    if c == 0xD2:
        (v,) = struct.unpack_from(">i", mv, off)
        return v, off + 4
    if c == 0xD3:
        (v,) = struct.unpack_from(">q", mv, off)
        return v, off + 8
    if c == 0xD9:
        n = mv[off]
        return str(mv[off + 1:off + 1 + n], "utf-8"), off + 1 + n
    if c == 0xDA:
        (n,) = struct.unpack_from(">H", mv, off)
        return str(mv[off + 2:off + 2 + n], "utf-8"), off + 2 + n
    if c == 0xDB:
        (n,) = struct.unpack_from(">I", mv, off)
        return str(mv[off + 4:off + 4 + n], "utf-8"), off + 4 + n
    if c == 0xDC:
        (n,) = struct.unpack_from(">H", mv, off)
        return _unpack_array(mv, off + 2, n)
    if c == 0xDD:
        (n,) = struct.unpack_from(">I", mv, off)
        return _unpack_array(mv, off + 4, n)
    if c == 0xDE:
        (n,) = struct.unpack_from(">H", mv, off)
        return _unpack_map(mv, off + 2, n)
    if c == 0xDF:
        (n,) = struct.unpack_from(">I", mv, off)
        return _unpack_map(mv, off + 4, n)
    raise WireError(f"unsupported msgpack code 0x{c:02x}")


def _unpack_array(mv, off, n):
    out = []
    for _ in range(n):
        v, off = _unpack_from(mv, off)
        out.append(v)
    return out, off


def _unpack_map(mv, off, n):
    out = {}
    for _ in range(n):
        k, off = _unpack_from(mv, off)
        v, off = _unpack_from(mv, off)
        out[k] = v
    return out, off


# ---------------------------------------------------------------------------
# dtype naming (little-endian assumed; bf16 as 2-byte voids, no ml_dtypes)
# ---------------------------------------------------------------------------

#: how a bfloat16 buffer is held on receipt: its raw bits as 2-byte voids
BF16_VOID = np.dtype("V2")


def _dtype_name(dt: np.dtype) -> str:
    # a V2 array is bf16's bits (what _dtype_from_name hands out); an
    # ml_dtypes bfloat16 array, where a caller has one, is named so already
    return "bfloat16" if dt == BF16_VOID else dt.name


def _dtype_from_name(name: str) -> np.dtype:
    if name == "bfloat16":
        return BF16_VOID
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    # numpy's own dtypes only: a name that resolves only because some other
    # library (ml_dtypes) registered it would decode differently on a host
    # without that library
    if dt is None or dt.type.__module__.split(".")[0] != "numpy":
        raise WireError(f"unknown wire dtype {name!r}")
    return dt


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's storage as a numpy array the wire frames as is (bf16
    as ``V2`` bytes). A CUDA tensor raises: copy it to the host first."""
    if t.device.type != "cpu":
        raise WireError(f"a {t.device} tensor cannot ride the wire: copy it "
                        f"to the host explicitly (.cpu()) first")
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_VOID)
    return t.numpy()


# ---------------------------------------------------------------------------
# tree <-> (skeleton, buffers)
# ---------------------------------------------------------------------------

_ND_KEY = "__nd__"


def _extract(obj: Any, bufs: List[np.ndarray]) -> Any:
    """Replace ndarray leaves by ``{"__nd__": i}`` placeholders, collecting
    the arrays (made contiguous, zero further copies) into ``bufs``."""
    if isinstance(obj, torch.Tensor):
        obj = tensor_to_numpy(obj)
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise WireError("object arrays cannot ride the wire")
        # the wire is native/little-endian and dtype.name drops byte order,
        # so a big-endian array (e.g. loaded from a network-order file) must
        # be swapped to native before its raw bytes are framed
        if obj.dtype.byteorder == ">":
            obj = obj.astype(obj.dtype.newbyteorder("="))
        # NOT ascontiguousarray: that implies ndmin=1 and would silently
        # promote 0-d arrays to shape (1,)
        bufs.append(obj if obj.flags["C_CONTIGUOUS"]
                    else np.ascontiguousarray(obj))
        return {_ND_KEY: len(bufs) - 1}
    if isinstance(obj, dict):
        return {k: _extract(v, bufs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_extract(v, bufs) for v in obj]
    if isinstance(obj, np.generic):        # numpy scalars ride as 0-d arrays
        bufs.append(np.asarray(obj))
        return {_ND_KEY: len(bufs) - 1}
    return obj


def _rebuild(obj: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if len(obj) == 1 and _ND_KEY in obj:
            return arrays[obj[_ND_KEY]]
        return {k: _rebuild(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_rebuild(v, arrays) for v in obj]
    return obj


def _has_arrays(obj: Any) -> bool:
    if isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        return True
    if isinstance(obj, dict):
        return any(_has_arrays(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_arrays(v) for v in obj)
    return False


def _as_bytes_view(arr: np.ndarray) -> memoryview:
    """Flat uint8 memoryview over a C-contiguous array's storage — works for
    void and custom dtypes whose buffer format ``cast("B")`` rejects. Pure
    view: no copy."""
    if arr.nbytes == 0:
        return memoryview(b"")
    return memoryview(arr.reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# socket primitives — recv_into on preallocated memoryviews throughout
# ---------------------------------------------------------------------------

def recv_exact_into(sock: socket.socket, mv: memoryview) -> None:
    """Fill ``mv`` completely from the socket — no per-chunk ``bytes``
    concatenation; the kernel writes straight into the caller's buffer."""
    got, n = 0, len(mv)
    while got < n:
        r = sock.recv_into(mv[got:])
        if r == 0:
            raise ConnectionError("peer closed")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    recv_exact_into(sock, memoryview(buf))
    return buf


def send_msg(sock: socket.socket, obj: Any, shm=None) -> None:
    """Send one frame. Payloads without arrays go as JSON (legacy/control
    interop); payloads with arrays go as a binary frame whose buffers are
    ``sendall``'d as raw memoryviews (or placed in the shm ring)."""
    if not _has_arrays(obj):
        data = json.dumps(obj).encode("utf-8")
        sock.sendall(_HDR.pack(len(data)) + data)
        _account(bytes_sent=4 + len(data), frames_json=1)
        return

    bufs: List[np.ndarray] = []
    tree = _extract(obj, bufs)
    descs: List[Dict[str, Any]] = []
    inline: List[memoryview] = []
    flags = 0
    if shm is not None:
        shm.begin_message()
    for arr in bufs:
        d: Dict[str, Any] = {"d": _dtype_name(arr.dtype),
                             "s": list(arr.shape), "n": arr.nbytes}
        mv = _as_bytes_view(arr)
        off = shm.try_write(mv) if (shm is not None and arr.nbytes) else None
        if off is not None:
            d["o"] = off
            flags |= FLAG_SHM
            _account(shm_bytes=arr.nbytes)
        elif arr.nbytes:
            inline.append(mv)
        descs.append(d)
    meta: Dict[str, Any] = {"t": tree, "b": descs}
    ctx = _tm.current_wire_context()
    if ctx is not None:
        meta["c"] = ctx
    ver = getattr(_TLS, "send_version", None)
    if ver is not None:
        meta["v"] = str(ver)
    pri = getattr(_TLS, "send_priority", None)
    if pri is not None:
        meta["p"] = str(pri)
    dl = getattr(_TLS, "send_deadline", None)
    if dl is not None:
        meta["dl"] = float(dl)
    header = pack(meta)
    inline_bytes = sum(len(m) for m in inline)
    total = _PRE.size + len(header) + inline_bytes
    if total > MAX_MSG:
        raise WireError(f"frame of {total} bytes exceeds limit")
    # preamble + header ride one small buffer; each tensor is sent as its own
    # memoryview — zero intermediate concatenation of array bytes
    head = bytearray(_HDR.size + _PRE.size + len(header))
    _HDR.pack_into(head, 0, total)
    _PRE.pack_into(head, _HDR.size, MAGIC, VERSION, flags, len(header))
    head[_HDR.size + _PRE.size:] = header
    if inline and inline_bytes <= SMALL_FRAME_COALESCE_BYTES:
        # small frames (fleet heartbeats, per-record serving requests) go as
        # ONE segment: a head+buffer write pair of tiny segments interacts
        # with Nagle + the peer's delayed ACK into a ~40ms stall per message
        # — the copy is cheaper than any network behavior it avoids
        sock.sendall(bytes(head) + b"".join(inline))
    else:
        sock.sendall(head)
        for mv in inline:
            sock.sendall(mv)
    _account(bytes_sent=len(head) + inline_bytes, frames_binary=1)


def recv_msg(sock: socket.socket, shm=None) -> Any:
    """Receive one frame (JSON or binary, sniffed by the first body byte)."""
    hdr = bytearray(_HDR.size)
    recv_exact_into(sock, memoryview(hdr))
    (n,) = _HDR.unpack(hdr)
    if n > MAX_MSG:
        raise WireError(f"message of {n} bytes exceeds limit")
    if n == 0:
        raise WireError("empty frame")
    first = bytearray(1)
    recv_exact_into(sock, memoryview(first))
    if first[0] != MAGIC[0]:
        body = bytearray(n)
        body[0] = first[0]
        if n > 1:
            recv_exact_into(sock, memoryview(body)[1:])
        _account(bytes_received=4 + n, frames_json=1)
        _TLS.ctx = None       # JSON control frames carry context in-payload
        _TLS.recv_version = None
        _TLS.recv_priority = None
        _TLS.recv_deadline = None
        return json.loads(bytes(body))
    pre = bytearray(_PRE.size)
    pre[0] = first[0]
    recv_exact_into(sock, memoryview(pre)[1:])
    magic, version, flags, header_len = _PRE.unpack(pre)
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if version > VERSION:
        raise WireError(f"unsupported wire version {version}")
    if _PRE.size + header_len > n:
        # bound the header read by the outer frame BEFORE allocating — a
        # corrupt length must fail fast, not block on bytes that never come
        raise WireError(f"header of {header_len} bytes exceeds frame of {n}")
    header = bytearray(header_len)
    recv_exact_into(sock, memoryview(header))
    meta = unpack(header)
    # optional trace context ("c") / model version ("v"): absent from old
    # senders — tolerated
    ctx = meta.get("c")
    _TLS.ctx = ctx if _tm.TraceContext.from_wire(ctx) is not None else None
    ver = meta.get("v")
    _TLS.recv_version = str(ver) if isinstance(ver, str) and ver else None
    # optional overload-QoS pair ("p"/"dl"): absent from old senders
    pri = meta.get("p")
    _TLS.recv_priority = pri if isinstance(pri, str) and pri else None
    dl = meta.get("dl")
    _TLS.recv_deadline = (float(dl)
                          if isinstance(dl, (int, float))
                          and not isinstance(dl, bool) and dl > 0 else None)
    expect = _PRE.size + header_len + sum(
        d["n"] for d in meta["b"] if "o" not in d)
    if expect != n:
        # a desynced stream must fail loudly, not misread the next frame
        raise WireError(f"frame length mismatch: outer {n}, content {expect}")
    arrays: List[np.ndarray] = []
    for d in meta["b"]:
        dt = _dtype_from_name(d["d"])
        shape = tuple(d["s"])
        want_nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize \
            if shape else dt.itemsize
        if want_nbytes != d["n"]:
            # 'n' framed the stream; a shape that disagrees would desync the
            # read (or drive np.empty into an absurd allocation) — reject
            raise WireError(f"buffer descriptor mismatch: shape {shape} "
                            f"({want_nbytes} bytes) vs n={d['n']}")
        arr = np.empty(shape, dtype=dt)
        if d["n"]:
            if "o" in d:
                if shm is None:
                    raise WireError("frame references a shm ring that is "
                                    "not attached on this connection")
                src = shm.read(d["o"], d["n"])
                _as_bytes_view(arr)[:] = src
            else:
                # zero-copy receive: the kernel fills the result array
                recv_exact_into(sock, _as_bytes_view(arr))
        arrays.append(arr)
    inline_bytes = sum(d["n"] for d in meta["b"] if "o" not in d)
    _account(bytes_received=4 + _PRE.size + header_len + inline_bytes,
             frames_binary=1)
    return _rebuild(meta["t"], arrays)
