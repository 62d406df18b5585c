"""Minimal TensorFlow artifact codecs — no ``tensorflow`` dependency (port
of ``analytics_zoo_tpu/importers/tf_proto.py``, without ``ml_dtypes``:
``DT_BFLOAT16`` tensors decode from their 16-bit words widened to float32,
exactly, and ``DT_HALF`` ones as numpy's float16).

Decodes the three on-disk formats the TFNet capability needs
(reference ``zoo/.../pipeline/api/net/TFNet.scala:56`` loads frozen GraphDefs;
``TFNetForInference.scala`` additionally reads SavedModels):

* **GraphDef** (``tensorflow/core/framework/graph.proto``): node=1 repeated
  NodeDef{name=1, op=2, input=3, device=4, attr=5 map<string, AttrValue>};
  AttrValue{list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8};
  TensorProto{dtype=1, tensor_shape=2, tensor_content=4, float_val=5,
  double_val=6, int_val=7, string_val=8, int64_val=10, bool_val=11};
  TensorShapeProto{dim=2{size=1}, unknown_rank=3}.
* **SavedModel** (``saved_model.proto``): meta_graphs=2 MetaGraphDef{
  graph_def=2, signature_def=5 map<string, SignatureDef{inputs=1, outputs=2
  map<string, TensorInfo{name=1}>}>}.
* **Checkpoint bundle** (``variables/variables.{index,data-*}``): the index is
  a leveldb-format immutable table (prefix-compressed blocks + 48-byte footer,
  magic 0xdb4775248b80fb57) whose values are BundleEntryProto{dtype=1, shape=2,
  shard_id=3, offset=4, size=5}; tensor bytes live at [offset, offset+size) in
  the data shard. TF writes the index uncompressed (tensor_bundle.cc sets
  kNoCompression), which is the only mode decoded here.

Encoders for the same subset exist so tests can synthesize artifacts without
tensorflow (mirroring ``onnx_proto.py``'s round-trip strategy). CRCs are
written as zero and never verified — artifacts written here are test fixtures,
not files TF itself must re-read.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .onnx_proto import (_field, _iter_fields, _ld, _read_varint, _s64,
                         _vi, _write_varint)

# TF DataType enum (tensorflow/core/framework/types.proto)
TF_FLOAT, TF_DOUBLE, TF_INT32, TF_UINT8, TF_INT16, TF_INT8 = 1, 2, 3, 4, 5, 6
TF_STRING, TF_INT64, TF_BOOL = 7, 9, 10
TF_BFLOAT16, TF_HALF = 14, 19
_TF_NP = {TF_FLOAT: np.float32, TF_DOUBLE: np.float64, TF_INT32: np.int32,
          TF_UINT8: np.uint8, TF_INT16: np.int16, TF_INT8: np.int8,
          TF_INT64: np.int64, TF_BOOL: np.bool_, TF_HALF: np.float16,
          TF_BFLOAT16: np.float32}
_NP_TF = {np.dtype(np.float32): TF_FLOAT, np.dtype(np.float64): TF_DOUBLE,
          np.dtype(np.int32): TF_INT32, np.dtype(np.int64): TF_INT64,
          np.dtype(np.bool_): TF_BOOL, np.dtype(np.uint8): TF_UINT8}


def _from_buffer(raw: bytes, dtype: int) -> np.ndarray:
    """Tensor bytes of TF ``dtype`` as a flat numpy array: bfloat16 words
    widened to float32 (the upper half of an f32, so exactly)."""
    if dtype == TF_BFLOAT16:
        words = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32)
        return (words << 16).view(np.float32)
    return np.frombuffer(raw, dtype=_TF_NP.get(dtype, np.float32))


# ----------------------------------------------------------------- tensor/shape

def _decode_shape(buf: bytes) -> Tuple[Optional[Tuple[int, ...]], bool]:
    """TensorShapeProto → (dims or None, unknown_rank)."""
    dims: List[int] = []
    unknown = False
    for fnum, _wt, v in _iter_fields(buf):
        if fnum == 2:
            size = 0
            for f2, _w2, v2 in _iter_fields(v):
                if f2 == 1:
                    size = _s64(v2)
            dims.append(size)
        elif fnum == 3:
            unknown = bool(v)
    return (None if unknown else tuple(dims)), unknown


def _encode_shape(dims: Tuple[int, ...]) -> bytes:
    return b"".join(_ld(2, _vi(1, d)) for d in dims)


def decode_tf_tensor(buf: bytes) -> np.ndarray:
    """TF TensorProto → numpy array."""
    dtype = TF_FLOAT
    shape: Tuple[int, ...] = ()
    content = None
    vals: List = []
    for fnum, wtype, v in _iter_fields(buf):
        if fnum == 1:
            dtype = v
        elif fnum == 2:
            shape = _decode_shape(v)[0] or ()
        elif fnum == 4:
            content = v
        elif fnum == 5:  # float_val
            if wtype == 2:
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                vals.append(struct.unpack("<f", struct.pack("<i", v))[0])
        elif fnum == 6:  # double_val
            if wtype == 2:
                vals.extend(struct.unpack(f"<{len(v) // 8}d", v))
            else:
                vals.append(struct.unpack("<d", struct.pack("<q", v))[0])
        elif fnum in (7, 10, 11):  # int_val / int64_val / bool_val
            if wtype == 2:
                p = 0
                while p < len(v):
                    d, p = _read_varint(v, p)
                    vals.append(_s64(d))
            else:
                vals.append(_s64(v))
    np_dtype = _TF_NP.get(dtype, np.float32)
    if content is not None:
        return _from_buffer(content, dtype).reshape(shape).copy()
    arr = np.asarray(vals, dtype=np_dtype)
    if shape:
        n = int(np.prod(shape))
        if arr.size == 1 and n > 1:       # splat: one value fills the shape
            arr = np.full(shape, arr.reshape(-1)[0], dtype=np_dtype)
        else:
            arr = arr.reshape(shape)
    elif arr.size == 1:
        arr = arr.reshape(())
    return arr


def encode_tf_tensor(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = _NP_TF.get(arr.dtype)
    if dt is None:
        arr = arr.astype(np.float32)
        dt = TF_FLOAT
    return (_vi(1, dt) + _ld(2, _encode_shape(arr.shape))
            + _ld(4, arr.tobytes()))


# -------------------------------------------------------------------- AttrValue

@dataclass
class AttrValue:
    s: Optional[bytes] = None
    i: Optional[int] = None
    f: Optional[float] = None
    b: Optional[bool] = None
    type: Optional[int] = None
    shape: Optional[Tuple[int, ...]] = None
    tensor: Optional[np.ndarray] = None
    list_i: Tuple[int, ...] = ()
    list_s: Tuple[bytes, ...] = ()

    @property
    def value(self):
        for v in (self.s, self.i, self.f, self.b, self.type, self.tensor):
            if v is not None:
                return v
        if self.shape is not None:
            return self.shape
        if self.list_i:
            return self.list_i
        if self.list_s:
            return self.list_s
        return None

    @classmethod
    def decode(cls, buf: bytes) -> "AttrValue":
        a = cls()
        for fnum, wtype, v in _iter_fields(buf):
            if fnum == 1:  # ListValue
                ints: List[int] = []
                ss: List[bytes] = []
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 2:
                        ss.append(v2)
                    elif f2 == 3:
                        if w2 == 2:
                            p = 0
                            while p < len(v2):
                                d, p = _read_varint(v2, p)
                                ints.append(_s64(d))
                        else:
                            ints.append(_s64(v2))
                a.list_i = tuple(ints)
                a.list_s = tuple(ss)
            elif fnum == 2:
                a.s = v
            elif fnum == 3:
                a.i = _s64(v)
            elif fnum == 4:
                a.f = (struct.unpack("<f", struct.pack("<i", v))[0]
                       if wtype == 5 else float(v))
            elif fnum == 5:
                a.b = bool(v)
            elif fnum == 6:
                a.type = v
            elif fnum == 7:
                a.shape = _decode_shape(v)[0]
            elif fnum == 8:
                a.tensor = decode_tf_tensor(v)
        return a

    def encode(self) -> bytes:
        if self.s is not None:
            return _ld(2, self.s)
        if self.b is not None:          # before i: bools are also ints in py
            return _vi(5, int(self.b))
        if self.i is not None:
            return _vi(3, self.i)
        if self.f is not None:
            return _field(4, 5, struct.pack("<f", self.f))
        if self.type is not None:
            return _vi(6, self.type)
        if self.tensor is not None:
            return _ld(8, encode_tf_tensor(self.tensor))
        if self.shape is not None:
            return _ld(7, _encode_shape(self.shape))
        if self.list_i:
            return _ld(1, b"".join(_vi(3, i) for i in self.list_i))
        if self.list_s:
            return _ld(1, b"".join(_ld(2, s) for s in self.list_s))
        return b""


# ---------------------------------------------------------------------- NodeDef

@dataclass
class TFNode:
    name: str = ""
    op: str = ""
    inputs: List[str] = field(default_factory=list)
    attrs: Dict[str, AttrValue] = field(default_factory=dict)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value

    @classmethod
    def decode(cls, buf: bytes) -> "TFNode":
        n = cls()
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                n.name = v.decode()
            elif fnum == 2:
                n.op = v.decode()
            elif fnum == 3:
                n.inputs.append(v.decode())
            elif fnum == 5:  # map entry {key=1, value=2}
                key, val = "", AttrValue()
                for f2, _w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        key = v2.decode()
                    elif f2 == 2:
                        val = AttrValue.decode(v2)
                n.attrs[key] = val
        return n

    def encode(self) -> bytes:
        out = _ld(1, self.name.encode()) + _ld(2, self.op.encode())
        out += b"".join(_ld(3, s.encode()) for s in self.inputs)
        for k, a in self.attrs.items():
            out += _ld(5, _ld(1, k.encode()) + _ld(2, a.encode()))
        return out


@dataclass
class TFGraph:
    nodes: List[TFNode] = field(default_factory=list)

    @classmethod
    def decode(cls, buf: bytes) -> "TFGraph":
        g = cls()
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                g.nodes.append(TFNode.decode(v))
        return g

    def encode(self) -> bytes:
        return b"".join(_ld(1, n.encode()) for n in self.nodes)


# ------------------------------------------------------------------- SavedModel

@dataclass
class SignatureDef:
    inputs: Dict[str, str] = field(default_factory=dict)    # arg name → tensor
    outputs: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def _decode_tensor_info_map(buf: bytes) -> Dict[str, str]:
        out = {}
        key, tname = "", ""
        for f2, _w2, v2 in _iter_fields(buf):
            if f2 == 1:
                key = v2.decode()
            elif f2 == 2:
                for f3, _w3, v3 in _iter_fields(v2):
                    if f3 == 1:
                        tname = v3.decode()
        out[key] = tname
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "SignatureDef":
        s = cls()
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                s.inputs.update(cls._decode_tensor_info_map(v))
            elif fnum == 2:
                s.outputs.update(cls._decode_tensor_info_map(v))
        return s

    def encode(self) -> bytes:
        out = b""
        for k, t in self.inputs.items():
            out += _ld(1, _ld(1, k.encode()) + _ld(2, _ld(1, t.encode())))
        for k, t in self.outputs.items():
            out += _ld(2, _ld(1, k.encode()) + _ld(2, _ld(1, t.encode())))
        return out


@dataclass
class SavedModel:
    graph: TFGraph = field(default_factory=TFGraph)
    signatures: Dict[str, SignatureDef] = field(default_factory=dict)

    @classmethod
    def decode(cls, buf: bytes) -> "SavedModel":
        sm = cls()
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 2:  # MetaGraphDef (first one wins, like TF's default tag)
                for f2, _w2, v2 in _iter_fields(v):
                    if f2 == 2:
                        sm.graph = TFGraph.decode(v2)
                    elif f2 == 5:  # signature_def map entry
                        key, sig = "", SignatureDef()
                        for f3, _w3, v3 in _iter_fields(v2):
                            if f3 == 1:
                                key = v3.decode()
                            elif f3 == 2:
                                sig = SignatureDef.decode(v3)
                        sm.signatures[key] = sig
                if sm.graph.nodes:
                    break
        return sm

    def encode(self) -> bytes:
        sigs = b""
        for k, s in self.signatures.items():
            sigs += _ld(5, _ld(1, k.encode()) + _ld(2, s.encode()))
        meta = _ld(2, self.graph.encode()) + sigs
        return _vi(1, 1) + _ld(2, meta)


# ----------------------------------------------------- checkpoint bundle reader

_TABLE_MAGIC = 0xDB4775248B80FB57


def _decode_block(block: bytes) -> List[Tuple[bytes, bytes]]:
    """leveldb table block → [(key, value)] via prefix-compressed entries."""
    if len(block) < 4:
        return []
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * n_restarts
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        entries.append((key, block[pos:pos + value_len]))
        pos += value_len
    return entries


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Read block at handle; trailer = 1-byte compression type + 4-byte crc.
    Only uncompressed (type 0) is supported — what TF writes for bundles."""
    ctype = data[offset + size]
    if ctype != 0:
        raise NotImplementedError(
            f"compressed checkpoint index block (type {ctype}) unsupported")
    return data[offset:offset + size]


def _decode_handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    off, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return off, size, pos


@dataclass
class BundleEntry:
    dtype: int = TF_FLOAT
    shape: Tuple[int, ...] = ()
    shard_id: int = 0
    offset: int = 0
    size: int = 0

    @classmethod
    def decode(cls, buf: bytes) -> "BundleEntry":
        e = cls()
        for fnum, _wt, v in _iter_fields(buf):
            if fnum == 1:
                e.dtype = v
            elif fnum == 2:
                e.shape = _decode_shape(v)[0] or ()
            elif fnum == 3:
                e.shard_id = v
            elif fnum == 4:
                e.offset = v
            elif fnum == 5:
                e.size = v
        return e

    def encode(self) -> bytes:
        return (_vi(1, self.dtype) + _ld(2, _encode_shape(self.shape))
                + _vi(3, self.shard_id) + _vi(4, self.offset)
                + _vi(5, self.size))


def read_checkpoint_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """``prefix`` like ``<dir>/variables/variables`` → {tensor_key: array}.

    Replaces the tensorflow-dependent ``tf.train.load_checkpoint`` path: parses
    the leveldb-table index (footer → index block → data blocks) and slices
    tensors out of the data shards by BundleEntry offset/size.
    """
    with open(prefix + ".index", "rb") as f:
        idx = f.read()
    footer = idx[-48:]
    if struct.unpack("<Q", footer[-8:])[0] != _TABLE_MAGIC:
        raise ValueError(f"{prefix}.index: bad table magic — not a TF "
                         "checkpoint index")
    # footer = metaindex handle + index handle + padding + magic
    _mo, _ms, pos = _decode_handle(footer, 0)
    io_, is_, _ = _decode_handle(footer, pos)
    index_block = _decode_block(_read_block(idx, io_, is_))

    shards: Dict[int, np.memmap] = {}

    def shard(sid: int, num_shards: int) -> np.memmap:
        if sid not in shards:
            path = f"{prefix}.data-{sid:05d}-of-{num_shards:05d}"
            shards[sid] = np.memmap(path, dtype=np.uint8, mode="r")
        return shards[sid]

    out: Dict[str, np.ndarray] = {}
    num_shards = 1
    for _ikey, handle in index_block:
        off, size, _ = _decode_handle(handle)
        for key, value in _decode_block(_read_block(idx, off, size)):
            if key == b"":
                # BundleHeaderProto{num_shards=1}
                for fnum, _wt, v in _iter_fields(value):
                    if fnum == 1:
                        num_shards = v
                continue
            entry = BundleEntry.decode(value)
            if b"/" in key and key.endswith(b"_slice_info"):
                continue
            np_dtype = _TF_NP.get(entry.dtype)
            if np_dtype is None:       # strings/resources: not donor material
                continue
            raw = shard(entry.shard_id, num_shards)[
                entry.offset:entry.offset + entry.size]
            out[key.decode()] = _from_buffer(
                bytes(raw), entry.dtype).reshape(entry.shape).copy()
    return out


# ---------------------------------------------------- bundle writer (for tests)

def _encode_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """Single-restart-interval block: every entry is a restart point."""
    out = bytearray()
    restarts = []
    for key, value in entries:
        restarts.append(len(out))
        out += _write_varint(0) + _write_varint(len(key)) \
            + _write_varint(len(value)) + key + value
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def write_checkpoint_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a 1-shard TF-format bundle readable by :func:`read_checkpoint_bundle`
    (and structurally by TF, modulo the zeroed CRCs)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    data = bytearray()
    entries: List[Tuple[bytes, bytes]] = []
    header = _vi(1, 1) + _ld(3, _vi(1, 1))  # num_shards=1, version{producer=1}
    entries.append((b"", header))
    for key in sorted(tensors):
        arr = np.ascontiguousarray(tensors[key])
        dt = _NP_TF.get(arr.dtype)
        if dt is None:
            arr = arr.astype(np.float32)
            dt = TF_FLOAT
        e = BundleEntry(dtype=dt, shape=arr.shape, shard_id=0,
                        offset=len(data), size=arr.nbytes)
        data += arr.tobytes()
        entries.append((key.encode(), e.encode()))
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(bytes(data))

    data_block = _encode_block(entries)
    idx = bytearray()
    idx += data_block + b"\x00" + b"\x00\x00\x00\x00"   # type + crc(0)
    data_handle = _write_varint(0) + _write_varint(len(data_block))
    # index block: one entry pointing at the data block (key >= last data key)
    index_block = _encode_block([(b"\xff", data_handle)])
    index_off = len(idx)
    idx += index_block + b"\x00" + b"\x00\x00\x00\x00"
    meta_block = _encode_block([])
    meta_off = len(idx)
    idx += meta_block + b"\x00" + b"\x00\x00\x00\x00"
    footer = (_write_varint(meta_off) + _write_varint(len(meta_block))
              + _write_varint(index_off) + _write_varint(len(index_block)))
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    idx += footer
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(idx))
