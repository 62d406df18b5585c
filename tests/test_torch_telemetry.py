"""The PyTorch port's telemetry, events, flight recorder, chaos counts,
locks and resilience primitives against the JAX package's, on the CPU.

The two packages' registries are separate module objects: a process that
loads both holds two, and the same family names never clash. The same
counter, gauge, histogram and collector operations on fresh registries of
each render Prometheus text that ``parse_prometheus`` reads back equal, and
each package's parser accepts the other's text. Events, recorder records
and dumps, chaos counts, the lock witness and the health registry
behave as the JAX package's on the same inputs.
"""

import json
import pickle
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu.common import chaos as jchaos
from analytics_zoo_tpu.common import locks as jlocks
from analytics_zoo_tpu.common import resilience as jres
from analytics_zoo_tpu.common import telemetry as jtm
from analytics_zoo_tpu.observability import events as jev
from analytics_zoo_tpu.observability import recorder as jrec
from analytics_zoo_tpu.observability import traces as jtr
from analytics_zoo_tpu_torch.common import chaos as tchaos
from analytics_zoo_tpu_torch.common import locks as tlocks
from analytics_zoo_tpu_torch.common import resilience as tres
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.observability import events as tev
from analytics_zoo_tpu_torch.observability import recorder as trec
from analytics_zoo_tpu_torch.observability import traces as ttr

BOTH = pytest.mark.parametrize("tm", [ttm, jtm], ids=["torch", "jax"])


def _ops(tm, seed: int):
    """The same seeded operations on a fresh registry of ``tm``."""
    rng = np.random.default_rng(seed)
    reg = tm.MetricRegistry()
    c = reg.counter("zoo_test_requests_total", "requests", labels=("outcome",))
    g = reg.gauge("zoo_test_depth", "depth")
    h = reg.histogram("zoo_test_latency_seconds", "latency",
                      labels=("priority",), buckets=(.01, .1, 1.0))
    u = reg.counter("zoo_test_steps_total", "steps")
    for _ in range(200):
        c.labels(outcome=str(rng.choice(["ok", "shed", "cancelled"]))).inc(
            float(rng.integers(1, 4)))
        h.labels(priority=str(rng.choice(["critical", "bulk"]))).observe(
            float(rng.exponential(0.2)))
        u.inc()
    g.set(float(rng.integers(0, 100)))
    g.add(2.5)
    reg.collector("zoo_test_slots", "slots", lambda: [(("a",), 3.0),
                                                      (("b",), 1.5)],
                  labels=("gen",))
    reg.collector("zoo_test_broken", "a collector that raises",
                  lambda: 1 / 0)
    return reg


@pytest.mark.parametrize("seed", range(5))
def test_same_operations_render_the_same_text(seed):
    t, j = _ops(ttm, seed), _ops(jtm, seed)
    tt, jt = t.render_prometheus(), j.render_prometheus()
    assert tt == jt
    assert ttm.parse_prometheus(tt) == jtm.parse_prometheus(jt)
    # each parser reads the other package's text
    assert ttm.parse_prometheus(jt) == jtm.parse_prometheus(tt)
    assert t.snapshot(buckets=True) == j.snapshot(buckets=True)


def test_two_registries_in_one_process_do_not_clash():
    """The module-level families of both packages exist side by side; the
    port's zoo_gen_* counters move only the port's registry."""
    import analytics_zoo_tpu.serving.generation  # noqa: F401
    import analytics_zoo_tpu_torch.serving.generation as tgen

    assert ttm.default_registry() is not jtm.default_registry()
    ttm.reset_telemetry()
    jtm.reset_telemetry()
    tgen._GEN_SHED.labels(reason="deadline").inc(3)
    tfam = ttm.parse_prometheus(ttm.render_prometheus())
    jfam = jtm.parse_prometheus(jtm.render_prometheus())
    # a child an earlier test made renders at 0 after the reset
    assert [(lab, v) for _, lab, v in tfam["zoo_gen_shed_total"]["samples"]
            if v] == [({"reason": "deadline"}, 3.0)]
    assert not any(v for _, _, v in jfam["zoo_gen_shed_total"]["samples"])
    # the families the JAX batcher registers, the port registers too
    gen = {f for f in jfam if f.startswith("zoo_gen_")}
    assert gen and gen <= set(tfam)
    ttm.reset_telemetry()


@BOTH
def test_registration_errors(tm):
    reg = tm.MetricRegistry()
    reg.counter("zoo_x_total", labels=("a",))
    with pytest.raises(tm.TelemetryError):
        reg.gauge("zoo_x_total")
    with pytest.raises(tm.TelemetryError):
        reg.counter("zoo_x_total", labels=("b",))
    with pytest.raises(tm.TelemetryError):
        reg.counter("0bad")
    with pytest.raises(tm.TelemetryError):
        reg.counter("zoo_y_total").inc(-1)
    reg.histogram("zoo_h", buckets=(1, 2))
    with pytest.raises(tm.TelemetryError):
        reg.histogram("zoo_h", buckets=(1, 3))
    with pytest.raises(tm.TelemetryError):
        tm.parse_prometheus("zoo_x_total{a=\"1\" 3\n")


def test_counters_from_many_threads_merge():
    for tm in (ttm, jtm):
        reg = tm.MetricRegistry()
        c = reg.counter("zoo_threads_total")
        ts = [threading.Thread(target=lambda: [c.inc() for _ in range(500)])
              for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert c.value() == 4000


def test_spans_and_chrome_export_match_in_shape():
    out = []
    for tm, tr in ((ttm, ttr), (jtm, jtr)):
        tm.reset_telemetry()
        with tm.span("serving.gen.prefill", uri="u1") as root:
            with tm.span("serving.gen.prefill.chunk", n_done=0):
                pass
        remote = tm.span("child", remote=root.wire_context())
        with remote:
            pass
        spans = tm.spans(trace_id=root.trace_id)
        assert {s.name for s in spans} == {"serving.gen.prefill",
                                           "serving.gen.prefill.chunk",
                                           "child"}
        trace = tr.export_trace(root.trace_id)
        out.append(sorted((e["name"], e["ph"], sorted(e["args"]))
                          for e in trace["traceEvents"]))
        assert tr.trace_summaries()[0]["spans"] == 3
    assert out[0] == out[1]
    with pytest.raises(RuntimeError):
        with ttm.span("failing"):
            raise RuntimeError("x")
    assert ttm.spans(name="failing")[0].status == "error"


def test_events_ring_filters_throttle_and_jsonl(tmp_path):
    got = []
    for ev in (tev, jev):
        ev.reset_events()
        path = tmp_path / f"{ev.__name__.split('.')[0]}.jsonl"
        ev.attach_jsonl(str(path))
        ev.emit("gen.prefix.invalidated", severity="info", reason="hot_swap",
                pages=4)
        for i in range(5):
            ev.emit("shed", severity="warning", throttle_s=60.0,
                    reason="deadline", i=i)
        ev.emit("chaos.injected", severity="warning", site="s")
        with pytest.raises(ValueError):
            ev.emit("x", severity="fatal")
        assert ev.default_log().flush(5.0)
        deadline = time.monotonic() + 5.0
        while len(path.read_text().splitlines()) < 3 \
                and time.monotonic() < deadline:
            time.sleep(0.01)     # the drain thread writes after its get()
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        got.append(([(e.kind, e.severity, e.fields) for e in ev.events()],
                    [e.kind for e in ev.events(kind="gen")],
                    [e.kind for e in ev.events(min_severity="warning")],
                    [(r["kind"], r["fields"]) for r in rows]))
        ev.reset_events()
    assert got[0] == got[1]
    assert got[0][1] == ["gen.prefix.invalidated"]


def test_flight_recorder_records_and_dump(tmp_path):
    """Records, site filters, the ring's bound, and a dump's schema and
    sections: the same in both packages (timestamps aside)."""
    dumps = []
    for rec_mod, ev, chaos in ((trec, tev, tchaos), (jrec, jev, jchaos)):
        ev.reset_events()
        rec = rec_mod.install(dump_dir=str(tmp_path / rec_mod.__name__),
                              capacity=4)
        assert rec_mod.get() is rec
        for i in range(6):
            rec_mod.record("admission.generation", {"now": float(i)},
                           {"action": "shed" if i % 2 else "admit"})
        rec_mod.record("gen.prefill.budget", {"chunk_tokens": 16}, None)
        assert rec.occupancy() == (4, 7)
        assert [r["inputs"]["now"] for r in
                rec.records("admission")] == [3.0, 4.0, 5.0]
        sched = chaos.ChaosSchedule(seed=1).delay("serving.generate", at=None,
                                                  seconds=0.0)
        with sched:
            for _ in range(3):
                chaos.chaos_point("serving.generate")
        path = rec.dump(trigger="manual")
        with open(path) as f:
            snap = json.load(f)
        rec_mod.uninstall()
        assert rec_mod.get() is None
        dumps.append(snap)
        ev.reset_events()
    t, j = dumps
    assert t["schema"] == j["schema"] == "zoo-flight-v1"
    assert set(t) == set(j)
    for key in ("records_held", "records_total", "records_dropped",
                "trigger"):
        assert t[key] == j[key]
    strip = lambda rs: [(r["site"], r["inputs"], r["decision"], r["seq"])
                        for r in rs]
    assert strip(t["records"]) == strip(j["records"])
    assert [(e["kind"], e["fields"]) for e in t["events"]] == \
        [(e["kind"], e["fields"]) for e in j["events"]]


def test_chaos_counts_events_pickling_and_sites():
    out = []
    for chaos, ev in ((tchaos, tev), (jchaos, jev)):
        ev.reset_events()
        sched = chaos.ChaosSchedule(seed=3).fail("serving.generate", at=2,
                                                 exc=RuntimeError)
        with sched:
            chaos.chaos_point("serving.generate")
            with pytest.raises(RuntimeError):
                chaos.chaos_point("serving.generate")
            chaos.chaos_point("prefill.chunk", tag=1)
            assert chaos.get_chaos() is sched
        assert chaos.get_chaos() is None
        clone = pickle.loads(pickle.dumps(sched))
        assert clone.counts() == [] and clone.seed == 3
        out.append((sched.counts(),
                    [(e.kind, e.fields) for e in ev.events()]))
        ev.reset_events()
        assert chaos.register_chaos_site("test.site") == "test.site"
        assert "test.site" in chaos.KNOWN_SITES
        chaos.KNOWN_SITES.discard("test.site")
    assert out[0] == out[1]
    assert out[0][0] == [{"site": "prefill.chunk", "tag": 1, "fired": 1},
                         {"site": "serving.generate", "tag": None,
                          "fired": 2}]
    for site in ("serving.generate", "overload.shed", "prefix.publish",
                 "prefill.chunk"):
        assert site in tchaos.KNOWN_SITES


def test_traced_locks_record_the_same_witness(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_TPU_TRACE_LOCKS", "1")
    got = []
    for locks in (tlocks, jlocks):
        locks.reset_witness()
        a, b = locks.traced_lock("A._lock"), locks.traced_rlock("B._lock")
        assert isinstance(a, locks.TracedLock)
        with a:
            with b:
                with b:
                    pass
        cond = threading.Condition(locks.traced_lock("C._lock"))
        with cond:
            cond.wait(timeout=0.001)
        path = tmp_path / f"{locks.__name__}.jsonl"
        locks.dump_witness(str(path))
        edges, holds = locks.load_witness(str(path))
        got.append((edges, sorted(holds)))
        locks.reset_witness()
    # the reentrant acquire of B under A records the edge again
    assert got[0] == got[1] == ({("A._lock", "B._lock"): 2},
                                ["A._lock", "B._lock", "C._lock"])
    monkeypatch.delenv("ZOO_TPU_TRACE_LOCKS")
    assert not isinstance(tlocks.traced_lock("x"), tlocks.TracedLock)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_health_registry_matches():
    out = []
    for res in (tres, jres):
        clk = _Clock()
        reg = res.HealthRegistry(default_timeout_s=1.0, clock=clk, name="r")
        seen = []
        reg.add_transition_listener(lambda n, alive: seen.append((n, alive)))
        hb = reg.register("loop", timeout_s=2.0)
        reg.beat("sink", step=1)
        clk.t = 1.5
        hb.beat()
        trans = [reg.check_transitions()]
        clk.t = 3.0
        trans.append(reg.check_transitions())
        reg.beat("sink")
        trans.append(reg.check_transitions())
        status = reg.status()
        hb.stop()
        out.append((trans, seen, status, reg.components(), reg.dead(),
                    reg.beats("sink"), reg.healthy()))
    assert out[0] == out[1]


def test_circuit_breaker_matches():
    """The same outcomes on the same clock walk both packages' breakers
    through the same states, retry-after hints, opens (counted in
    ``zoo_breaker_opens_total`` and the ``zoo_breaker_state`` collector)
    and ``breaker.open`` events."""
    out = []
    for res, tm, ev in ((tres, ttm, tev), (jres, jtm, jev)):
        tm.reset_telemetry()
        ev.reset_events()
        clk = _Clock()
        b = res.CircuitBreaker(failure_threshold=2, window=4,
                               reset_timeout_s=1.0, name="t-breaker",
                               clock=clk)
        trace = []

        def step(what):
            if what == "ok":
                b.record_success()
            elif what == "fail":
                b.record_failure()
            elif what == "allow":
                trace.append(b.allow())
            elif what == "trip":
                b.trip()
            elif what == "reset":
                b.reset()
            else:
                clk.t += what
            trace.append((b.state, round(b.retry_after_s(), 6)))

        for what in ["ok", "fail", "allow", "fail", "allow", 0.5, "allow",
                     0.6, "allow", "allow", "fail", 1.0, "allow", "ok",
                     "trip", "allow", "reset", "allow"]:
            step(what)
        with pytest.raises(res.CircuitOpenError):
            b.trip()
            b.call(lambda: None)
        text = tm.render_prometheus()
        fams = tm.parse_prometheus(text)
        opens = [v for _n, l, v in fams["zoo_breaker_opens_total"]["samples"]
                 if l.get("name") == "t-breaker"]
        states = [v for _n, l, v in fams["zoo_breaker_state"]["samples"]
                  if l.get("name") == "t-breaker"]
        kinds = [(e.kind, e.fields["cause"]) for e in ev.events("breaker.open")]
        out.append((trace, opens, states, kinds))
        tm.reset_telemetry()
        ev.reset_events()
    assert out[0] == out[1]
    trace, opens, states, kinds = out[0]
    assert opens == [4.0] and states == [2.0]
    assert kinds == [("breaker.open", "failures")] * 2 + \
        [("breaker.open", "tripped")] * 2


def test_retry_policy_counts_attempts_in_telemetry():
    ttm.reset_telemetry()
    pol = tres.RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0,
                           sleep=lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "ok"

    assert pol.call(flaky) == "ok"
    fam = ttm.parse_prometheus(ttm.render_prometheus())
    assert fam["zoo_retry_attempts_total"]["samples"][0][2] == 2.0
    ttm.reset_telemetry()
