"""The port's stream broker against the JAX package's, on the CPU.

One seeded command script (XADD, XGROUPCREATE, XREADGROUP, XACK, the idle
reclaim, XTRANSFER, XREAD, XLAST, HSET/HSETNX/HGET/HDEL, trimming) gives
equal replies from both stores; the append-only file either one writes is
the other's byte for byte, and replays in the other to the same state,
compaction included. Each package's queue clients work against the other's
broker over the socket (the shm ring too), and ``python -m
analytics_zoo_tpu_torch.serving.broker`` starts a broker.
"""

import select
import shutil
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import wire as twire

ROOT = Path(__file__).resolve().parent.parent


class _Clock:
    """``time`` for a store under test: ``monotonic`` moves only when the
    script says so, so the idle reclaim is deterministic."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now


def _norm(x):
    """A reply or state in a package-neutral form (arrays by dtype name,
    shape and bytes; bf16 named so in both packages)."""
    if isinstance(x, np.ndarray) or isinstance(x, np.generic):
        a = np.asarray(x)
        return ("nd", twire._dtype_name(a.dtype), a.shape, a.tobytes())
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _payload(rng, k, side):
    p = {"v": int(k), "uri": f"u{k}"}
    if k % 3 == 0:
        p["x"] = rng.normal(size=(2, 3)).astype(np.float32)
    if k % 5 == 0:
        bf = rng.normal(size=(4,)).astype(ml_dtypes.bfloat16)
        p["w"] = bf if side == "jax" else bf.view(np.int16).view(
            np.dtype("V2"))
    return p


def _script(seed=0, n=70):
    """A seeded op list over the store's verbs."""
    rng = np.random.default_rng(seed)
    ops = [("xgroupcreate", "s", "g", "0"), ("xgroupcreate", "s", "h", "$")]
    # a side stream past maxlen: trimming shifts its group cursor
    ops += [("xgroupcreate", "t", "g", "0")] + [("xadd", "t", 100 + k)
                                                for k in range(20)]
    ops += [("xreadgroup", "t", "g", 5, 0)]
    for k in range(n):
        r = rng.random()
        if r < 0.35:
            ops.append(("xadd", "s", k))
        elif r < 0.5:
            ops.append(("xreadgroup", "s", ["g", "h"][k % 2],
                        int(rng.integers(1, 4)), 0))
        elif r < 0.6:
            ops.append(("xack", "s", "g"))      # acks the oldest pending
        elif r < 0.65:
            ops.append(("tick", 120.0))         # past the reclaim idle time
        elif r < 0.75:
            ops.append(("hset", f"k{k % 4}", k))
        elif r < 0.8:
            ops.append(("hsetnx", f"k{k % 6}", k))
        elif r < 0.85:
            ops.append(("hget", f"k{k % 4}"))
        elif r < 0.88:
            ops.append(("hdel", f"k{k % 4}"))
        elif r < 0.92:
            ops.append(("xread", "s", int(rng.integers(0, 6)), 3))
        elif r < 0.95:
            ops.append(("xlast", "s"))
        else:
            ops.append(("slen", "s"))
    ops += [("xtransfer", "s", "g", "s2"), ("xread", "s2", 0, 50),
            ("xlast", "s2"), ("slen", "s2")]
    return ops


def _run(store, clock, ops, side, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for op in ops:
        kind = op[0]
        if kind == "tick":
            clock.now += op[1]
            r = None
        elif kind == "xadd":
            r = store.xadd(op[1], _payload(rng, op[2], side))
        elif kind == "xgroupcreate":
            r = store.xgroupcreate(op[1], op[2], op[3])
        elif kind == "xreadgroup":
            r = store.xreadgroup(op[1], op[2], op[3], op[4])
        elif kind == "xack":
            pend = sorted(store.pending[(op[1], op[2])],
                          key=lambda i: int(i.split("-")[0]))
            r = store.xack(op[1], op[2], pend[:1])
        elif kind == "hset":
            r = store.hset(op[1], _payload(rng, op[2], side))
        elif kind == "hsetnx":
            r = store.hsetnx(op[1], _payload(rng, op[2], side))
        elif kind == "hget":
            r = store.hget(op[1], 0)
        elif kind == "hdel":
            r = store.hdel(op[1])
        elif kind == "xread":
            r = store.xread(op[1], op[2], op[3], 0)
        elif kind == "xlast":
            r = store.xlast(op[1])
        elif kind == "xtransfer":
            r = store.xtransfer(op[1], op[2], op[3])
        else:
            r = store.slen(op[1])
        out.append(_norm(r))
    return out


def _state(store):
    return _norm({
        "streams": {k: [list(e) for e in v]
                    for k, v in store.streams.items() if v},
        "cursors": {f"{s}|{g}": c for (s, g), c in store.cursors.items()},
        "trimmed": {k: v for k, v in store.trimmed.items() if v},
        "hashes": dict(store.hashes),
        "pending": {f"{s}|{g}": sorted(e) for (s, g), e
                    in store.pending.items() if e},
        "redeliver": {f"{s}|{g}": [i for i, _ in e] for (s, g), e
                      in store.redeliver.items() if e},
        "seq": store._seq})


def _store(mod, monkeypatch, clock, **kw):
    monkeypatch.setattr(mod, "time", clock)
    return mod._Store(reclaim_idle_ms=60_000, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_seeded_script_gets_equal_replies(seed, monkeypatch):
    ops = _script(seed)
    got = {}
    for side, mod in (("jax", jbroker), ("torch", tbroker)):
        clock = _Clock()
        store = _store(mod, monkeypatch, clock, maxlen=12)
        got[side] = (_run(store, clock, ops, side), _state(store))
    assert got["jax"] == got["torch"]
    replies = got["jax"][0]
    assert any(r for r in replies if isinstance(r, list))    # reads served
    assert got["jax"][1]["trimmed"]                           # trimming hit


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_aof_replays_across_packages_with_compaction(writer, tmp_path,
                                                     monkeypatch):
    ops = _script(3, n=90)
    aof = {}
    for side, mod in (("jax", jbroker), ("torch", tbroker)):
        clock = _Clock()
        path = str(tmp_path / f"{side}.aof")
        store = _store(mod, monkeypatch, clock, maxlen=12, aof_path=path,
                       aof_rewrite_min_bytes=4096)
        _run(store, clock, ops, side)
        assert store.compactions >= 1          # a compaction mid-script
        aof[side] = (path, _state(store))
    # the same mutations make the same file in both packages
    assert open(aof["jax"][0], "rb").read() == \
        open(aof["torch"][0], "rb").read()
    src, live = aof[writer]
    replays = {}
    for side, mod in (("jax", jbroker), ("torch", tbroker)):
        copy = str(tmp_path / f"replay-{writer}-by-{side}.aof")
        shutil.copy(src, copy)
        replays[side] = _state(_store(mod, monkeypatch, _Clock(), maxlen=12,
                                      aof_path=copy))
    assert replays["jax"] == replays["torch"]
    st = replays["torch"]
    # redelivery is scheduled from what was pending at the "crash"
    assert {k: sorted(v) for k, v in st["redeliver"].items()} == \
        live["pending"]
    # the compacted log carries live state, not the trim offsets (in both
    # packages: a replayed stream restarts its absolute xread index at 0)
    for key in ("redeliver", "trimmed"):
        st.pop(key)
        live.pop(key)
    assert st == live


@pytest.fixture(scope="module")
def brokers():
    jb = jbroker.start_broker()
    tb = tbroker.start_broker()
    yield {"jax": jb, "torch": tb}
    for b in (jb, tb):
        b.shutdown()
        b.server_close()


@pytest.mark.parametrize("client_side,broker_side", [("jax", "torch"),
                                                     ("torch", "jax")])
def test_queue_clients_work_against_the_other_broker(client_side,
                                                     broker_side, brokers):
    cmod = jclient if client_side == "jax" else tclient
    port = brokers[broker_side].port
    rng = np.random.default_rng(4)
    small = rng.normal(size=(3, 4)).astype(np.float32)
    big = rng.normal(size=(128, 160)).astype(np.float32)    # 80 KB: shm
    stream = f"in-{client_side}-{broker_side}"
    iq = cmod.InputQueue(port=port, stream=stream)
    oq = cmod.OutputQueue(port=port)
    # the engine side speaks the broker's own package
    eng = (jclient if broker_side == "jax" else tclient)._Conn(
        "127.0.0.1", port, timeout=10.0)
    try:
        eng.call("XGROUPCREATE", stream, "g", "0")
        u1 = iq.enqueue(None, priority="critical", x=small)
        u2 = iq.enqueue(None, x=big)
        assert iq._conn._shm is not None        # ring negotiated across
        entries = eng.call("XREADGROUP", stream, "g", 8, 1000)
        assert [p["uri"] for _, p in entries] == [u1, u2]
        assert entries[0][1]["priority"] == "critical"
        np.testing.assert_array_equal(entries[0][1]["data"]["x"], small)
        np.testing.assert_array_equal(entries[1][1]["data"]["x"], big)
        eng.call("HSET", "result:" + u1, {"value": small * 2,
                                          "model_version": "v3"})
        eng.call("HSET", "result:" + u2, {"value": big + 1})
        eng.call("XACK", stream, "g", [i for i, _ in entries])
        np.testing.assert_array_equal(oq.query(u1, timeout_s=10), small * 2)
        assert oq.last_model_version == "v3"
        np.testing.assert_array_equal(oq.query(u2, timeout_s=10), big + 1)
        with pytest.raises(TimeoutError):
            oq.query(u1, timeout_s=0)           # consumed: HDEL'd
    finally:
        for c in (iq, oq, eng):
            c.close()


def test_port_input_queue_takes_tensors(brokers):
    port = brokers["torch"].port
    iq = tclient.InputQueue(port=port, stream="in-tensors")
    eng = tclient._Conn("127.0.0.1", port, timeout=10.0)
    try:
        eng.call("XGROUPCREATE", "in-tensors", "g", "0")
        t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        iq.enqueue("t1", x=t, w=t.to(torch.bfloat16), n=np.int32(5))
        (_, p), = eng.call("XREADGROUP", "in-tensors", "g", 8, 1000)
        np.testing.assert_array_equal(p["data"]["x"], t.numpy())
        w = p["data"]["w"]
        assert w.dtype == np.dtype("V2")
        assert torch.equal(torch.from_numpy(w.view(np.int16)).view(
            torch.bfloat16), t.to(torch.bfloat16))
        assert int(p["data"]["n"]) == 5
    finally:
        iq.close()
        eng.close()


def test_broker_starts_as_a_module():
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.broker",
         "--host", "127.0.0.1", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "broker printed nothing within 60 s"
        line = proc.stdout.readline()
        assert "queue broker listening on 127.0.0.1:" in line, line
        port = int(line.rsplit(":", 1)[1])
        c = tclient._Conn("127.0.0.1", port, timeout=10.0)
        assert c.call("PING") == "PONG"
        assert c.call("INFO")["wire_version"] == twire.VERSION
        assert c.call("SHUTDOWN") == "OK"
        c.close()
        assert proc.wait(timeout=30) is not None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
