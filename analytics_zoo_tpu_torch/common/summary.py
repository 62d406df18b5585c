"""TensorBoard event files and a JSON-lines stream (port of
``common/summary.py``).

A copy of the JAX package's module, which needs no JAX: a TFRecord writer
with hand-rolled protobuf encoding of ``tensorflow.Event`` scalar
messages (masked CRC32-C framing), its reader, and the
``TrainSummary``/``ValidationSummary`` pair the Estimator feeds. For the
same ``(step, wall_time, scalars)`` both packages write the same bytes.

Not ported: the ``zoo_summary_scalar`` gauge and the
``zoo_summary_events_total`` counter that mirror every scalar into
``common/telemetry.py`` (the training counters, ROADMAP Queue 1, item 8's
next slice).
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

# ----------------------------------------------------------------------------- crc32c
# TFRecord framing uses masked CRC32-C (Castagnoli). Table-driven implementation.

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------------- proto encoding
# Minimal protobuf wire-format encoders for tensorflow.Event / Summary.


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # tensorboard.Summary.Value: tag=1 (string), simple_value=2 (float)
    body = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return body


def _event_scalar(step: int, wall_time: float, scalars: Dict[str, float]) -> bytes:
    # tensorflow.Event: wall_time=1 double, step=2 int64, summary=5 message
    summary = b"".join(_f_bytes(1, _summary_value(t, v)) for t, v in scalars.items())
    return _f_double(1, wall_time) + _f_int(2, step) + _f_bytes(5, summary)


def _event_file_version(wall_time: float) -> bytes:
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


class EventWriter:
    """Append-only TensorBoard event-file writer (tfevents TFRecord framing).

    Parity: zoo/.../tensorboard/EventWriter.scala + RecordWriter.scala.
    """

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}{filename_suffix}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event_file_version(time.time()))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        self._write_record(_event_scalar(step, wall_time or time.time(), scalars))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """Read back (step, tag, value) triples from an event file.

    Parity: the reference reads TB scalars back for ``getTrainSummary``
    (Topology.scala:223-239, tensorboard/FileReader.scala).
    """
    out: List[Tuple[int, str, float]] = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            f.read(4)
            data = f.read(length)
            f.read(4)
            step, scalars = _decode_event(data)
            for tag, v in scalars:
                out.append((step, tag, v))
    return out


def _decode_event(data: bytes) -> Tuple[int, List[Tuple[str, float]]]:
    i = 0
    step = 0
    scalars: List[Tuple[str, float]] = []

    def rd_varint(j):
        n = 0
        shift = 0
        while True:
            b = data[j]
            n |= (b & 0x7F) << shift
            j += 1
            if not b & 0x80:
                return n, j
            shift += 7

    while i < len(data):
        tag_key, i = rd_varint(i)
        field, wire = tag_key >> 3, tag_key & 7
        if wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 0:
            v, i = rd_varint(i)
            if field == 2:
                step = v
        elif wire == 2:
            ln, i = rd_varint(i)
            payload = data[i:i + ln]
            i += ln
            if field == 5:  # summary
                scalars.extend(_decode_summary(payload))
    return step, scalars


def _decode_summary(data: bytes) -> List[Tuple[str, float]]:
    out = []
    i = 0
    while i < len(data):
        key = data[i]
        i += 1
        if key >> 3 == 1 and (key & 7) == 2:  # value submessage
            ln = data[i]
            i += 1
            sub = data[i:i + ln]
            i += ln
            tag_name = ""
            val = 0.0
            j = 0
            while j < len(sub):
                k = sub[j]
                j += 1
                if k >> 3 == 1 and (k & 7) == 2:
                    l2 = sub[j]
                    j += 1
                    tag_name = sub[j:j + l2].decode()
                    j += l2
                elif k >> 3 == 2 and (k & 7) == 5:
                    (val,) = struct.unpack("<f", sub[j:j + 4])
                    j += 4
                else:
                    break
            out.append((tag_name, val))
        else:
            break
    return out


# ---------------------------------------------------------------------- summaries


class Summary:
    """Base for Train/Validation summaries (Topology.scala:196-239 parity)."""

    def __init__(self, log_dir: str, app_name: str, kind: str):
        self.app_name = app_name
        self.kind = kind
        self.log_dir = os.path.join(log_dir, app_name, kind)
        self.writer = EventWriter(self.log_dir)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        clean = {k: float(v) for k, v in scalars.items()}
        self.writer.add_scalars(step, clean)
        self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **clean}) + "\n")
        self.flush()

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        return [(s, v) for s, t, v in read_scalars(self.writer.path) if t == tag]

    def flush(self):
        self.writer.flush()
        self._jsonl.flush()

    def close(self):
        self.writer.close()
        self._jsonl.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


__all__ = ["EventWriter", "Summary", "TrainSummary", "ValidationSummary",
           "crc32c", "read_scalars"]
