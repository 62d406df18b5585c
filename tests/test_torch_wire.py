"""The port's binary wire against the JAX package's, on the CPU.

``send_msg`` in both packages gives byte-identical frames for every dtype
the serving path carries (bf16 from ``ml_dtypes`` on the JAX side, from a
torch tensor or the port's ``V2`` bytes on the port's), for nested maps and
lists, strings, bytes, and the trace, QoS and model-version header fields;
each package decodes the other's frames to the same values and bits. The
port decodes bf16 where ``ml_dtypes`` cannot be imported, and a >= 64 KB
tensor rides the same-host shm ring both ways.
"""

import json
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import wire as jwire
from analytics_zoo_tpu_torch.serving import wire as twire

ROOT = Path(__file__).resolve().parent.parent
CTX = {"t": "ab" * 16, "s": "cd" * 8}


class _Capture:
    """A socket that keeps what ``send_msg`` writes."""

    def __init__(self):
        self.buf = bytearray()

    def sendall(self, b):
        self.buf += bytes(b)


class _Feed:
    """A socket that ``recv_msg`` reads a captured frame from."""

    def __init__(self, data: bytes):
        self.mv = memoryview(bytes(data))
        self.off = 0

    def recv_into(self, mv):
        n = min(len(mv), len(self.mv) - self.off)
        mv[:n] = self.mv[self.off:self.off + n]
        self.off += n
        return n


def _frame(wire, obj, *, ctx=None, version=None, qos=(None, None)):
    cap = _Capture()
    wire.set_wire_model_version(version)
    wire.set_wire_qos(*qos)
    try:
        wire.send_msg(cap, obj)
    finally:
        wire.set_wire_model_version(None)
        wire.set_wire_qos(None, None)
    return bytes(cap.buf)


@pytest.fixture
def fixed_ctx(monkeypatch):
    """Both packages' ambient trace context pinned to one value, so their
    frames can be compared byte for byte."""
    from analytics_zoo_tpu.common import telemetry as jtm
    from analytics_zoo_tpu_torch.common import telemetry as ttm

    for tm in (jtm, ttm):
        monkeypatch.setattr(tm, "current_wire_context", lambda: dict(CTX))


def _arrays(rng):
    """Each dtype the wire carries, as (JAX-side array, port-side leaf)."""
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf = rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16)
    bits = bf.view(np.int16)
    tbf = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    cases = {
        "f32": (f32, f32),
        "f32_tensor": (f32, torch.from_numpy(f32)),
        "f16": (rng.normal(size=(7,)).astype(np.float16),) * 2,
        "int8": (rng.integers(-128, 128, (2, 3, 4)).astype(np.int8),) * 2,
        "int32": (rng.integers(-2**31, 2**31, (9,)).astype(np.int32),) * 2,
        "int64": (rng.integers(-2**62, 2**62, (2, 2)).astype(np.int64),) * 2,
        "bool": (rng.integers(0, 2, (5,)).astype(bool),) * 2,
        "bf16": (bf, tbf),
        "bf16_void": (bf, bits.view(np.dtype("V2"))),
        "scalar": (np.float32(1.5), np.float32(1.5)),
        "empty": (np.zeros((0, 3), np.float32),) * 2,
    }
    return cases


@pytest.mark.parametrize("case", ["f32", "f32_tensor", "f16", "int8", "int32",
                                  "int64", "bool", "bf16", "bf16_void",
                                  "scalar", "empty"])
def test_frames_are_byte_identical_per_dtype(case, fixed_ctx):
    j, t = _arrays(np.random.default_rng(0))[case]
    jf = _frame(jwire, {"x": j})
    tf = _frame(twire, {"x": t})
    assert jf == tf


def _nested(rng, side):
    a = _arrays(rng)
    k = 0 if side == "jax" else 1
    return {"uri": "u-1", "data": {"img": a["f32"][k],
                                   "ids": [a["int32"][k], a["int64"][k]],
                                   "emb": a["bf16"][k]},
            "meta": {"n": 3, "neg": -7, "big": 2**40, "f": 0.25,
                     "s": "x" * 40, "b": b"\x00\x01raw", "none": None,
                     "flag": True, "list": [1, "two", [3.0, None]]},
            "mask": a["bool"][k]}


def test_nested_payloads_and_contexts_are_byte_identical(fixed_ctx):
    kw = dict(version="v7", qos=("critical", 1.7e9 + 0.5))
    jf = _frame(jwire, _nested(np.random.default_rng(1), "jax"), **kw)
    tf = _frame(twire, _nested(np.random.default_rng(1), "torch"), **kw)
    assert jf == tf
    # a JSON control frame (no arrays) too
    assert _frame(jwire, ["XREADGROUP", "s", "g", 8, 5]) == \
        _frame(twire, ["XREADGROUP", "s", "g", 8, 5])
    # the msgpack header codec alone
    hdr = {"a": [1, -1, -33, 2**33, -2**40, 1.5, "é", b"\xff" * 300],
           "b": {str(i): i for i in range(20)}}
    assert bytes(jwire.pack(hdr)) == bytes(twire.pack(hdr))
    assert twire.unpack(jwire.pack(hdr)) == jwire.unpack(twire.pack(hdr))


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def test_each_package_decodes_the_others_frames(fixed_ctx):
    kw = dict(version="v7", qos=("bulk", 1.7e9))
    jf = _frame(jwire, _nested(np.random.default_rng(2), "jax"), **kw)
    tf = _frame(twire, _nested(np.random.default_rng(2), "torch"), **kw)
    by_port = twire.recv_msg(_Feed(jf))
    assert twire.received_model_version() == "v7"
    assert twire.received_qos() == ("bulk", 1.7e9)
    assert twire.received_trace_context() == CTX
    by_jax = jwire.recv_msg(_Feed(tf))
    assert jwire.received_model_version() == "v7"
    assert jwire.received_trace_context() == CTX
    _same(by_port, by_jax)
    # bf16 arrives in the port as 2-byte voids holding JAX's bits, and in
    # JAX as ml_dtypes bfloat16 holding the port's
    emb = by_port["data"]["emb"]
    assert emb.dtype == np.dtype("V2")
    want = _nested(np.random.default_rng(2), "jax")["data"]["emb"]
    np.testing.assert_array_equal(emb.view(np.int16), want.view(np.int16))
    assert by_jax["data"]["emb"].dtype == ml_dtypes.bfloat16
    t = torch.from_numpy(emb.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))
    # and the port re-sends what it received byte for byte
    assert _frame(twire, by_port, **kw) == tf


def test_a_device_tensor_is_refused_by_the_wire():
    """Only host storage rides: a tensor elsewhere (a "meta" one stands in
    for the card here) must be copied to the host by the caller."""
    t = torch.zeros(2)
    meta = torch.zeros(2, device="meta")
    with pytest.raises(twire.WireError, match="explicitly"):
        twire.send_msg(_Capture(), {"x": meta})
    assert _frame(twire, {"x": t})   # a CPU tensor rides


def test_port_decodes_bf16_without_ml_dtypes(tmp_path, fixed_ctx):
    bf = np.arange(-6, 6, dtype=np.float32).reshape(3, 4).astype(
        ml_dtypes.bfloat16)
    frame = _frame(jwire, {"w": bf, "n": 1})
    path = tmp_path / "frame.bin"
    path.write_bytes(frame)
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import json, numpy as np, torch\n"
        "from analytics_zoo_tpu_torch.serving import wire\n"
        "class F:\n"
        "    def __init__(s, b): s.b, s.o = memoryview(b), 0\n"
        "    def recv_into(s, mv):\n"
        "        n = min(len(mv), len(s.b) - s.o)\n"
        "        mv[:n] = s.b[s.o:s.o + n]; s.o += n; return n\n"
        f"got = wire.recv_msg(F(open({str(path)!r}, 'rb').read()))\n"
        "w = got['w']\n"
        "t = torch.from_numpy(w.view(np.int16)).view(torch.bfloat16)\n"
        "print(json.dumps({'dtype': str(w.dtype), 'shape': list(w.shape),\n"
        "                  'bits': w.view(np.int16).ravel().tolist(),\n"
        "                  'values': t.float().ravel().tolist(),\n"
        "                  'ml_dtypes': 'ml_dtypes' in sys.modules and\n"
        "                  sys.modules['ml_dtypes'] is not None}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["dtype"] == "|V2" and res["shape"] == [3, 4]
    assert res["bits"] == bf.view(np.int16).ravel().tolist()
    assert res["values"] == list(map(float, range(-6, 6)))
    assert res["ml_dtypes"] is False


def test_unknown_dtype_names_are_refused():
    with pytest.raises(twire.WireError, match="unknown wire dtype"):
        twire._dtype_from_name("float8_e4m3fn")
    assert twire._dtype_from_name("bfloat16") == np.dtype("V2")
    assert twire._dtype_name(np.dtype("V2")) == "bfloat16"
    assert twire._dtype_name(np.dtype(ml_dtypes.bfloat16)) == "bfloat16"


@pytest.fixture(scope="module")
def port_broker():
    from analytics_zoo_tpu_torch.serving.broker import start_broker

    b = start_broker()
    yield b
    b.shutdown()
    b.server_close()


def test_a_large_tensor_rides_the_shm_ring_both_ways(port_broker):
    from analytics_zoo_tpu_torch.serving.client import _Conn

    big = np.random.default_rng(3).normal(size=(128, 160)).astype(
        np.float32)   # 80 KB
    assert big.nbytes >= 64 * 1024
    before = twire.wire_stats()["shm_bytes"]
    c = _Conn("127.0.0.1", port_broker.port, timeout=10.0)
    try:
        c.call("HSET", "wire:big", {"x": big})
        assert c._shm is not None                 # negotiated on demand
        sent = twire.wire_stats()["shm_bytes"]
        assert sent - before >= big.nbytes        # client -> broker
        got = c.call("HGET", "wire:big", 0)
        np.testing.assert_array_equal(got["x"], big)
        assert twire.wire_stats()["shm_bytes"] - sent >= big.nbytes  # back
        # a bf16 tensor of the same size, from torch
        t = torch.from_numpy(big).to(torch.bfloat16)
        c.call("HSET", "wire:bf", {"x": t})
        back = c.call("HGET", "wire:bf", 0)["x"]
        assert back.dtype == np.dtype("V2")
        assert torch.equal(torch.from_numpy(back.view(np.int16))
                           .view(torch.bfloat16), t)
    finally:
        c.close()
