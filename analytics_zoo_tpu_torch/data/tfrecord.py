"""TFRecord files and the tf.Example codec, without tensorflow (port of
``analytics_zoo_tpu/data/tfrecord.py``, which needs no JAX).

Records are decoded on the host by this codec and land in a
:class:`~.featureset.FeatureSet` (``FeatureSet.from_tfrecord``) that feeds
the card like any other tier; the bytes written and read are the JAX
package's, both ways.

Wire formats:
* TFRecord framing: <len u64le><masked_crc32c(len) u32le><data><masked_crc32c
  (data) u32le> per record — the codec ``common/summary.py`` writes
  TensorBoard event files with.
* tf.Example (``tensorflow/core/example/example.proto``):
  Example{features=1 Features{feature=1 map<string, Feature>}};
  Feature{bytes_list=1{value=1}, float_list=2{value=1 packed},
  int64_list=3{value=1 packed}}.
"""

from __future__ import annotations

import struct
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Union)

import numpy as np

from ..common.summary import _masked_crc
from ..importers.onnx_proto import (_iter_fields, _ld, _read_varint, _s64,
                                    _vi)

# ----------------------------------------------------------------- record IO


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate raw record payloads of one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (hcrc,) = struct.unpack("<I", header[8:12])
                if _masked_crc(header[:8]) != hcrc:
                    raise ValueError(f"{path}: corrupt record length CRC")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"{path}: truncated record")
            if verify_crc:
                (dcrc,) = struct.unpack("<I", footer)
                if _masked_crc(data) != dcrc:
                    raise ValueError(f"{path}: corrupt record data CRC")
            yield data


def write_records(path: str, records: Iterable[bytes]) -> int:
    """Write raw payloads in TFRecord framing (readable by TF). Returns count."""
    n = 0
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


# ---------------------------------------------------------------- tf.Example


def decode_example(buf: bytes) -> Dict[str, np.ndarray]:
    """tf.Example bytes → {name: 1-D array} (bytes features → object array)."""
    out: Dict[str, np.ndarray] = {}
    for fnum, _wt, v in _iter_fields(buf):
        if fnum != 1:                      # Features
            continue
        for f2, _w2, v2 in _iter_fields(v):
            if f2 != 1:                    # map<string, Feature> entry
                continue
            name, feat = "", None
            for f3, _w3, v3 in _iter_fields(v2):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feat = v3
            if feat is None:
                continue
            out[name] = _decode_feature(feat)
    return out


def _decode_feature(buf: bytes) -> np.ndarray:
    for fnum, _wt, v in _iter_fields(buf):
        if fnum == 1:                      # BytesList
            vals = [v2 for f2, _w2, v2 in _iter_fields(v) if f2 == 1]
            return np.asarray(vals, dtype=object)
        if fnum == 2:                      # FloatList (packed or not)
            floats: List[float] = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:
                    if w2 == 2:
                        floats.extend(
                            struct.unpack(f"<{len(v2) // 4}f", v2))
                    else:
                        floats.append(
                            struct.unpack("<f", struct.pack("<i", v2))[0])
            return np.asarray(floats, dtype=np.float32)
        if fnum == 3:                      # Int64List
            ints: List[int] = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:
                    if w2 == 2:
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            ints.append(_s64(d))
                    else:
                        ints.append(_s64(v2))
            return np.asarray(ints, dtype=np.int64)
    return np.asarray([], dtype=np.float32)


def encode_example(features: Dict[str, Union[np.ndarray, Sequence]]) -> bytes:
    """{name: array/list} → tf.Example bytes (float32→float_list,
    int→int64_list, bytes/str→bytes_list)."""
    entries = b""
    for name, value in features.items():
        if isinstance(value, (bytes, str)):
            value = [value]
        arr = (value if isinstance(value, (list, tuple))
               else np.asarray(value).reshape(-1))
        if len(arr) and isinstance(arr[0], (bytes, str)):
            vals = b"".join(_ld(1, v.encode() if isinstance(v, str) else v)
                            for v in arr)
            feat = _ld(1, vals)
        elif np.asarray(arr).dtype.kind in "iub":
            vals = b"".join(_vi(1, int(v) & ((1 << 64) - 1)) for v in arr)
            feat = _ld(3, vals)
        else:
            packed = struct.pack(f"<{len(arr)}f",
                                 *[float(v) for v in arr])
            feat = _ld(2, _ld(1, packed))
        entries += _ld(1, _ld(1, name.encode()) + _ld(2, feat))
    return _ld(1, entries)


# ------------------------------------------------------------------ dataset


def read_tfrecord_examples(paths: Union[str, Sequence[str]],
                           max_records: Optional[int] = None,
                           verify_crc: bool = False
                           ) -> Dict[str, np.ndarray]:
    """Read tf.Example TFRecord file(s) → {feature: stacked array}.

    Fixed-length features stack to (N, ...); ragged features raise with a
    clear message (pad upstream or read record-wise via ``read_records``).
    """
    if isinstance(paths, str):
        paths = [paths]
    rows: List[Dict[str, np.ndarray]] = []
    for p in paths:
        for rec in read_records(p, verify_crc=verify_crc):
            rows.append(decode_example(rec))
            if max_records is not None and len(rows) >= max_records:
                break
        if max_records is not None and len(rows) >= max_records:
            break
    if not rows:
        raise ValueError(f"no records in {paths}")
    names = set()
    for r in rows:
        names.update(r)                   # schema = union over ALL records
    out: Dict[str, np.ndarray] = {}
    for name in sorted(names):
        vals = []
        for i, r in enumerate(rows):
            if name not in r:
                raise ValueError(
                    f"feature {name!r} missing from record {i} — optional "
                    "features need a default; iterate read_records/"
                    "decode_example to handle them record-wise")
            vals.append(r[name])
        lens = {len(v) for v in vals}
        if len(lens) != 1:
            raise ValueError(
                f"feature {name!r} is ragged (lengths {sorted(lens)[:5]}...) "
                "— pad upstream or iterate read_records/decode_example")
        # width-1 features keep their axis: (N, 1); FeatureSet.from_tfrecord
        # squeezes LABEL columns only (same contract as from_dataframe)
        out[name] = np.stack(vals)
    return out
