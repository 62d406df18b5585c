"""Minimal ONNX protobuf wire-format codec (reader + writer): the port's
copy of the JAX package's ``importers/onnx_proto.py``, which is pure
Python; the port's other codecs (``tf_proto``, ``caffe``,
``data/tfrecord``) take their wire helpers from here.

No ``onnx`` package is needed, and the capability needed is narrow:
decode ModelProto→GraphProto→{NodeProto, TensorProto, ValueInfoProto} for the
op subset the loader executes. Protobuf wire format is simple (tag = field<<3 |
wiretype; varint / 64-bit / length-delimited / 32-bit), so this module decodes
exactly the fields the loader consumes and encodes the same subset for tests.

Field numbers follow onnx.proto3 (onnx upstream, stable since opset 1):
  ModelProto:   graph=7, opset_import=8
  GraphProto:   node=1, name=2, initializer=5, input=11, output=12
  NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20
  TensorProto:  dims=1, data_type=2, float_data=4, int32_data=5, int64_data=7,
                name=8, raw_data=9, double_data=10
  ValueInfoProto: name=1, type=2 ; TypeProto.tensor_type=1 ;
  TensorTypeProto: elem_type=1, shape=2 ; TensorShapeProto.dim=1 ;
  Dimension: dim_value=1, dim_param=2
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType values
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_BOOL, DT_DOUBLE = \
    1, 2, 3, 6, 7, 9, 11
_DTYPE_NP = {DT_FLOAT: np.float32, DT_UINT8: np.uint8, DT_INT8: np.int8,
             DT_INT32: np.int32, DT_INT64: np.int64, DT_BOOL: np.bool_,
             DT_DOUBLE: np.float64}
_NP_DTYPE = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int64): DT_INT64,
             np.dtype(np.int32): DT_INT32, np.dtype(np.float64): DT_DOUBLE,
             np.dtype(np.bool_): DT_BOOL}

# attribute types
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_FLOATS, AT_INTS, AT_STRINGS = \
    1, 2, 3, 4, 6, 7, 8


# ------------------------------------------------------------------ wire level

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _s64(v: int) -> int:
    """Re-sign a varint decoded as unsigned 64-bit."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) — value is int for varint/fixed,
    bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            v, pos = _read_varint(buf, pos)
            yield fnum, wtype, v
        elif wtype == 1:
            yield fnum, wtype, struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            yield fnum, wtype, buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            yield fnum, wtype, struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _write_varint((fnum << 3) | wtype) + payload


def _ld(fnum: int, payload: bytes) -> bytes:
    return _field(fnum, 2, _write_varint(len(payload)) + payload)


def _vi(fnum: int, v: int) -> bytes:
    return _field(fnum, 0, _write_varint(v))


# ------------------------------------------------------------------- schema


@dataclass
class Tensor:
    name: str = ""
    dims: Tuple[int, ...] = ()
    data: Optional[np.ndarray] = None

    @classmethod
    def decode(cls, buf: bytes) -> "Tensor":
        dims: List[int] = []
        dtype = DT_FLOAT
        raw = None
        floats: List[float] = []
        ints: List[int] = []
        name = ""
        for fnum, wtype, v in _iter_fields(buf):
            if fnum == 1:
                if wtype == 0:
                    dims.append(v)
                else:  # packed
                    p = 0
                    while p < len(v):
                        d, p = _read_varint(v, p)
                        dims.append(d)
            elif fnum == 2:
                dtype = v
            elif fnum == 4:
                if wtype == 2:  # packed floats
                    floats.extend(struct.unpack(f"<{len(v)//4}f", v))
                else:
                    floats.append(struct.unpack("<f", struct.pack("<i", v))[0])
            elif fnum in (5, 7):
                if wtype == 2:
                    p = 0
                    while p < len(v):
                        d, p = _read_varint(v, p)
                        ints.append(_s64(d))
                else:
                    ints.append(v)
            elif fnum == 8:
                name = v.decode()
            elif fnum == 9:
                raw = v
            elif fnum == 10 and wtype == 2:
                floats.extend(struct.unpack(f"<{len(v)//8}d", v))
        np_dtype = _DTYPE_NP.get(dtype, np.float32)
        shape = tuple(dims)
        if raw is not None:
            arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy()
        elif floats:
            arr = np.asarray(floats, dtype=np_dtype).reshape(shape)
        elif ints:
            arr = np.asarray(ints, dtype=np_dtype).reshape(shape)
        else:
            arr = np.zeros(shape, dtype=np_dtype)
        return cls(name=name, dims=shape, data=arr)

    def encode(self) -> bytes:
        arr = np.ascontiguousarray(self.data)
        dt = _NP_DTYPE.get(arr.dtype)
        if dt is None:
            arr = arr.astype(np.float32)
            dt = DT_FLOAT
        out = b"".join(_vi(1, d) for d in arr.shape)
        out += _vi(2, dt)
        out += _ld(8, self.name.encode())
        out += _ld(9, arr.tobytes())
        return out


@dataclass
class Attribute:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[Tensor] = None
    floats: Tuple[float, ...] = ()
    ints: Tuple[int, ...] = ()

    @property
    def value(self):
        for v in (self.f, self.i, self.s, self.t):
            if v is not None:
                return v
        if self.floats:
            return self.floats
        if self.ints:
            return self.ints
        return None

    @classmethod
    def decode(cls, buf: bytes) -> "Attribute":
        a = cls()
        floats: List[float] = []
        ints: List[int] = []
        for fnum, wtype, v in _iter_fields(buf):
            if fnum == 1:
                a.name = v.decode()
            elif fnum == 2:
                a.f = struct.unpack("<f", struct.pack("<i", v))[0] \
                    if wtype == 5 else float(v)
            elif fnum == 3:
                a.i = _s64(v)
            elif fnum == 4:
                a.s = v
            elif fnum == 5:
                a.t = Tensor.decode(v)
            elif fnum == 7:
                if wtype == 2:
                    floats.extend(struct.unpack(f"<{len(v)//4}f", v))
                else:
                    floats.append(struct.unpack("<f", struct.pack("<i", v))[0])
            elif fnum == 8:
                if wtype == 2:
                    p = 0
                    while p < len(v):
                        d, p = _read_varint(v, p)
                        ints.append(_s64(d))
                else:
                    ints.append(_s64(v))
        a.floats = tuple(floats)
        a.ints = tuple(ints)
        return a

    def encode(self) -> bytes:
        out = _ld(1, self.name.encode())
        if self.f is not None:
            out += _field(2, 5, struct.pack("<f", self.f)) + _vi(20, AT_FLOAT)
        elif self.i is not None:
            out += _vi(3, self.i) + _vi(20, AT_INT)
        elif self.s is not None:
            out += _ld(4, self.s) + _vi(20, AT_STRING)
        elif self.t is not None:
            out += _ld(5, self.t.encode()) + _vi(20, AT_TENSOR)
        elif self.floats:
            out += b"".join(_field(7, 5, struct.pack("<f", f))
                            for f in self.floats) + _vi(20, AT_FLOATS)
        elif self.ints:
            out += b"".join(_vi(8, i) for i in self.ints) + _vi(20, AT_INTS)
        return out


@dataclass
class Node:
    op_type: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value

    @classmethod
    def decode(cls, buf: bytes) -> "Node":
        n = cls(op_type="")
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                n.inputs.append(v.decode())
            elif fnum == 2:
                n.outputs.append(v.decode())
            elif fnum == 3:
                n.name = v.decode()
            elif fnum == 4:
                n.op_type = v.decode()
            elif fnum == 5:
                a = Attribute.decode(v)
                n.attrs[a.name] = a
        return n

    def encode(self) -> bytes:
        out = b"".join(_ld(1, s.encode()) for s in self.inputs)
        out += b"".join(_ld(2, s.encode()) for s in self.outputs)
        out += _ld(3, self.name.encode())
        out += _ld(4, self.op_type.encode())
        out += b"".join(_ld(5, a.encode()) for a in self.attrs.values())
        return out


@dataclass
class ValueInfo:
    name: str
    shape: Tuple[Optional[int], ...] = ()

    @classmethod
    def decode(cls, buf: bytes) -> "ValueInfo":
        name = ""
        shape: List[Optional[int]] = []
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                name = v.decode()
            elif fnum == 2:  # TypeProto
                for f2, _w2, v2 in _iter_fields(v):
                    if f2 == 1:  # tensor_type
                        for f3, _w3, v3 in _iter_fields(v2):
                            if f3 == 2:  # shape
                                for f4, _w4, v4 in _iter_fields(v3):
                                    if f4 == 1:  # dim
                                        dim_val: Optional[int] = None
                                        for f5, _w5, v5 in _iter_fields(v4):
                                            if f5 == 1:
                                                dim_val = v5
                                        shape.append(dim_val)
        return cls(name=name, shape=tuple(shape))

    def encode(self) -> bytes:
        dims = b"".join(_ld(1, _vi(1, d) if d is not None else _ld(2, b"N"))
                        for d in self.shape)
        tensor_type = _vi(1, DT_FLOAT) + _ld(2, dims)
        return _ld(1, self.name.encode()) + _ld(2, _ld(1, tensor_type))


@dataclass
class Graph:
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)
    name: str = "graph"

    @classmethod
    def decode(cls, buf: bytes) -> "Graph":
        g = cls()
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                g.nodes.append(Node.decode(v))
            elif fnum == 2:
                g.name = v.decode()
            elif fnum == 5:
                t = Tensor.decode(v)
                g.initializers[t.name] = t.data
            elif fnum == 11:
                g.inputs.append(ValueInfo.decode(v))
            elif fnum == 12:
                g.outputs.append(ValueInfo.decode(v))
        return g

    def encode(self) -> bytes:
        out = b"".join(_ld(1, n.encode()) for n in self.nodes)
        out += _ld(2, self.name.encode())
        out += b"".join(_ld(5, Tensor(name=k, data=v).encode())
                        for k, v in self.initializers.items())
        out += b"".join(_ld(11, vi.encode()) for vi in self.inputs)
        out += b"".join(_ld(12, vi.encode()) for vi in self.outputs)
        return out


def decode_model(buf: bytes) -> Graph:
    """ModelProto bytes → Graph (field 7)."""
    for fnum, _wt, v in _iter_fields(buf):
        if fnum == 7:
            return Graph.decode(v)
    raise ValueError("no GraphProto found — not an ONNX ModelProto?")


def encode_model(graph: Graph, opset: int = 13) -> bytes:
    """Graph → ModelProto bytes (ir_version=8, one opset import)."""
    opset_import = _vi(2, opset)  # OperatorSetIdProto.version=2
    return (_vi(1, 8)                      # ir_version
            + _ld(7, graph.encode())
            + _ld(8, opset_import))
