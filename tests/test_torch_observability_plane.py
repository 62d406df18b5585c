"""The observability plane of the port (metrics history, the SLO engine,
decision replay, ``ObservabilityPlane`` and ``/debug/slo``) against the JAX
package's, on the CPU.

The same registry samples go to both packages' ``MetricsHistory`` and
``SLOEngine`` under a virtual clock: windows, rates, quantiles, burn rates
and the alert transitions agree exactly. A flight recording cut by either
package's recorder replays through the other's ``verify_incumbent`` with
identical decisions, and a candidate policy diverges on the same records in
both. The YAML ``slo:`` section parses to equal fields, and the generation
engine arms the SLO-derived prefill budget from the ITL objective.
"""

import json

import numpy as np
import pytest

from analytics_zoo_tpu.common import telemetry as jtm
from analytics_zoo_tpu.observability import (MetricsHistory as JaxHistory,
                                             ObservabilityPlane as JaxPlane,
                                             SLOEngine as JaxSLOEngine,
                                             events as jev,
                                             parse_objectives as jparse)
from analytics_zoo_tpu.observability import recorder as jrec
from analytics_zoo_tpu.observability import replay as jrp
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import qos as jqos
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.observability import (DebugSurface,
                                                   MetricsHistory,
                                                   ObservabilityPlane,
                                                   SLOEngine, parse_objectives)
from analytics_zoo_tpu_torch.observability import events as tev
from analytics_zoo_tpu_torch.observability import recorder as trec
from analytics_zoo_tpu_torch.observability import replay as trp
from analytics_zoo_tpu_torch.serving import ServingConfig
from analytics_zoo_tpu_torch.serving import qos as tqos

SIDES = {
    "torch": dict(tm=ttm, ev=tev, History=MetricsHistory, SLO=SLOEngine,
                  parse=parse_objectives, rec=trec, rp=trp, qos=tqos),
    "jax": dict(tm=jtm, ev=jev, History=JaxHistory, SLO=JaxSLOEngine,
                parse=jparse, rec=jrec, rp=jrp, qos=jqos),
}


@pytest.fixture(autouse=True)
def _fresh():
    for s in SIDES.values():
        s["ev"].reset_events()
        s["rec"].uninstall()
    yield
    for s in SIDES.values():
        s["ev"].reset_events()
        s["rec"].uninstall()


# ---------------------------------------------------------------- history

def _hist_run(side, seed):
    """One scripted sampling run: a counter and a labelled histogram fed
    seeded increments, sampled once a virtual second."""
    s = SIDES[side]
    rng = np.random.default_rng(seed)
    incs = rng.integers(0, 20, size=40).tolist()
    obs = rng.choice([0.004, 0.02, 0.3, 2.0], size=(40, 6)).tolist()
    reg = s["tm"].MetricRegistry()
    c = reg.counter("zoo_t_hist_total", "t")
    h = reg.histogram("zoo_t_q_seconds", "t", labels=("k",),
                      buckets=(0.01, 0.1, 1.0))
    hist = s["History"](registry=reg, resolutions=((1.0, 12), (5.0, 10)))
    t0 = 1000.0
    out = []
    for i in range(40):
        c.inc(incs[i])
        for v in obs[i]:
            h.labels(k="a").observe(v)
        hist.sample(now=t0 + i)
        if i % 5 == 4:
            now = t0 + i
            out.append((
                hist.rate("zoo_t_hist_total", "", 8, now=now),
                hist.delta("zoo_t_hist_total", "", 8, now=now),
                hist.series("zoo_t_hist_total", "", 40, now=now),
                hist.quantile_over_time("zoo_t_q_seconds", "a", 0.5, 4.5,
                                        now=now),
                hist.quantile_over_time("zoo_t_q_seconds", "a", 0.99, 4.5,
                                        now=now),
                hist.fraction_le("zoo_t_q_seconds", "a", 0.1, 6.0, now=now)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_history_windows_match_jax(seed):
    assert _hist_run("torch", seed) == _hist_run("jax", seed)


# ------------------------------------------------------------- SLO engine

OBJECTIVES = [
    {"name": "bulk-avail", "type": "availability", "priority": "bulk",
     "target": 0.9},
    {"name": "crit-lat", "type": "latency", "priority": "critical",
     "threshold_ms": 100, "target": 0.95},
]


def _slo_run(side, seed):
    s = SIDES[side]
    rng = np.random.default_rng(seed)
    reg = s["tm"].MetricRegistry()
    out = reg.counter("zoo_request_outcomes_total", "t",
                      labels=("priority", "outcome"))
    lat = reg.histogram("zoo_request_latency_seconds", "t",
                        labels=("priority",))
    hist = s["History"](registry=reg, resolutions=((1.0, 60),))
    eng = s["SLO"](hist, s["parse"](OBJECTIVES), fast_window_s=3.0,
                   slow_window_s=9.0, burn_factor=3.0)
    # healthy, overloaded, healthy again: seeded shed fractions and latency
    shed_frac = [0.0] * 6 + list(rng.uniform(0.4, 0.8, 8)) + [0.0] * 10
    slow_frac = [0.0] * 8 + list(rng.uniform(0.3, 0.9, 6)) + [0.0] * 10
    t0 = 3000.0
    trace = []
    for i, (sf, lf) in enumerate(zip(shed_frac, slow_frac)):
        n_shed = int(round(10 * sf))
        out.labels(priority="bulk", outcome="served").inc(10 - n_shed)
        if n_shed:
            out.labels(priority="bulk", outcome="shed").inc(n_shed)
        n_slow = int(round(20 * lf))
        for _ in range(20 - n_slow):
            lat.labels(priority="critical").observe(0.01)
        for _ in range(n_slow):
            lat.labels(priority="critical").observe(0.5)
        hist.sample(now=t0 + i)
        moved = eng.evaluate(now=t0 + i)
        trace.append((moved, [(st["name"], st["state"], st["burn_fast"],
                               st["burn_slow"], st["budget_remaining"])
                              for st in eng.objective_states()]))
    transitions = [(t["objective"], t["to"])
                   for t in eng.status()["transitions"]]
    events = [(e.kind, e.fields["objective"])
              for e in s["ev"].events() if e.kind.startswith("slo.")]
    return trace, transitions, events


@pytest.mark.parametrize("seed", [0, 3])
def test_slo_burn_rates_and_alert_transitions_match_jax(seed):
    got, want = _slo_run("torch", seed), _slo_run("jax", seed)
    assert got == want
    trace, transitions, events = got
    # the run really fires and resolves both objectives
    assert {("bulk-avail", "firing"), ("bulk-avail", "resolved"),
            ("crit-lat", "firing"), ("crit-lat", "resolved")} \
        <= set(transitions)
    assert ("slo.firing", "bulk-avail") in events


def test_slo_collectors_land_on_the_ports_scrape():
    hist = MetricsHistory(resolutions=((1.0, 10),))
    engine = SLOEngine(hist, parse_objectives(OBJECTIVES[1:]),
                       fast_window_s=3.0, slow_window_s=9.0)
    assert engine.state_of("crit-lat") == "ok"
    fams = ttm.parse_prometheus(ttm.render_prometheus())
    burn = {(l["objective"], l["window"]) for _n, l, _v
            in fams["zoo_slo_burn_rate"]["samples"]}
    assert {("crit-lat", "fast"), ("crit-lat", "slow")} <= burn


@pytest.mark.parametrize("bad", [
    [{"name": "x", "type": "bogus"}],
    [{"name": "x", "type": "latency", "target": 1.5}],
    [{"name": "x", "type": "error_ratio", "target": 0.9},
     {"name": "x", "type": "error_ratio", "target": 0.9}],
])
def test_parse_objectives_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as t:
        parse_objectives(bad)
    with pytest.raises(ValueError) as j:
        jparse(bad)
    assert str(t.value) == str(j.value)


SLO_YAML = """
slo:
  fast_window_s: 30
  slow_window_s: 300
  burn_factor: 6
  objectives:
    - {name: crit, type: latency, priority: critical,
       threshold_ms: 250, target: 0.999}
    - {name: gen-itl, type: latency, threshold_ms: 40, target: 0.99}
    - {name: avail, type: availability, priority: bulk, target: 0.9}
"""


def test_yaml_slo_section_parses_as_jax_parses(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(SLO_YAML)
    t, j = ServingConfig.from_yaml(str(p)), JaxServingConfig.from_yaml(str(p))
    for f in ("slo_objectives", "slo_fast_window_s", "slo_slow_window_s",
              "slo_burn_factor"):
        assert getattr(t, f) == getattr(j, f), f
    plane, jplane = ObservabilityPlane.from_config(t), \
        JaxPlane.from_config(j)
    assert [o.as_dict() for o in plane.slo.objectives] == \
        [o.as_dict() for o in jplane.slo.objectives]
    assert [(r.step, r.buf.maxlen) for r in plane.history._rings] == \
        [(r.step, r.buf.maxlen) for r in jplane.history._rings]
    # a typo'd objective and inverted windows fail at config time
    bad = tmp_path / "bad.yaml"
    bad.write_text("slo:\n  fast_window_s: 600\n  slow_window_s: 60\n"
                   "  objectives:\n    - {name: x, type: error_ratio, "
                   "target: 0.99}\n")
    with pytest.raises(ValueError):
        ServingConfig.from_yaml(str(bad))


def test_debug_slo_lists_the_objectives(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(SLO_YAML)
    plane = ObservabilityPlane.from_config(ServingConfig.from_yaml(str(p)))
    code, ctype, body, _ = DebugSurface(plane).handle("/debug/slo")
    assert code == 200 and ctype.startswith("application/json")
    status = json.loads(body)
    assert status["enabled"] is True
    assert [o["name"] for o in status["objectives"]] == \
        ["crit", "gen-itl", "avail"]
    code, _, html, _ = DebugSurface(plane).handle("/debug")
    assert code == 200 and b"gen-itl" in html


def test_itl_objective_arms_the_prefill_budget(tmp_path):
    from analytics_zoo_tpu.serving import generation as jgen
    from analytics_zoo_tpu_torch.serving import generation as tgen

    p = tmp_path / "cfg.yaml"
    p.write_text(SLO_YAML)
    t, j = ServingConfig.from_yaml(str(p)), JaxServingConfig.from_yaml(str(p))
    assert tgen._itl_objective_target_s(t) == \
        jgen._itl_objective_target_s(j) == pytest.approx(0.04)
    assert tgen._itl_objective_target_s(ServingConfig()) is None


# ---------------------------------------------------------------- replay

def _admission_inputs(now, deadline, est, priority="bulk"):
    return {"now": now, "deadline": deadline, "est_wait_s": est,
            "service_ema_s": 0.05, "skew_tolerance_s": 0.0, "depth": 3,
            "concurrency": 2, "priority": priority}


def _recording(side, seed):
    """A flight recording cut the way the live taps record: each pure
    decision function's own verdict on seeded inputs, with the autoscale
    state threaded across ticks."""
    s = SIDES[side]
    rng = np.random.default_rng(seed)
    rec = s["rec"].FlightRecorder(capacity=256)
    mono = 0.0
    for _ in range(12):
        deadline = None if rng.random() < 0.2 else \
            float(1000.0 + rng.uniform(-0.5, 2.0))
        inputs = _admission_inputs(1000.0, deadline,
                                   float(rng.uniform(0.0, 0.8)),
                                   str(rng.choice(["bulk", "normal",
                                                   "critical"])))
        rec.record("admission.router", inputs,
                   s["qos"].admission_decision(inputs))
        mono += 1.0
        with rec._lock:
            rec._ring[-1]["mono"] = mono
    state = {"pressure_since": None, "idle_since": None, "last_event_t": 0.0}
    knobs = {"up_depth": 4, "sustain_s": 1.0, "idle_s": 5.0,
             "cooldown_s": 0.5, "min_replicas": 1, "max_replicas": 4,
             "routed_delta": 0, "shed_delta": 0}
    t, n = 1.0, 1
    for _ in range(14):
        t += float(rng.uniform(0.3, 2.5))
        owed = None if rng.random() < 0.1 else int(rng.integers(0, 12))
        obs = {"now": t, "n": n, "eligible": n, "owed": owed, **knobs}
        before = dict(state)
        decision = s["qos"].autoscale_decision(obs, state)
        if decision["action"] == "up":
            n += 1
        elif decision["action"] == "down":
            n -= 1
        rec.record("autoscale.tick", {**obs, "state": before}, decision)
        with rec._lock:
            rec._ring[-1]["mono"] = 100.0 + t
    rec.record("fleet.host_check",
               {"now": 200.0, "host": "h0", "hb_age_s": 2.0,
                "replicas": ["r0"]},
               {"action": "failover", "replicas": ["r0"]})
    return rec.records()


@pytest.mark.parametrize("seed", [0, 1])
def test_recordings_replay_across_packages_with_identical_decisions(seed):
    jrecs, trecs = _recording("jax", seed), _recording("torch", seed)
    assert [r["decision"] for r in jrecs] == [r["decision"] for r in trecs]
    for recs in (jrecs, trecs):
        # a JAX recording through the port's verifier, and the reverse
        tv, jv = trp.verify_incumbent(recs), jrp.verify_incumbent(recs)
        assert tv["exact"] and jv["exact"], (tv["divergences"],
                                             jv["divergences"])
        assert tv["decisions"] == jv["decisions"] == len(recs)
        trun = trp.replay(recs, trp.IncumbentPolicy())
        jrun = jrp.replay(recs, jrp.IncumbentPolicy())
        assert trun.signature() == jrun.signature()
        assert trun.counts() == jrun.counts()
        cand_t = trp.replay(recs, trp.WatermarkAdmissionPolicy(0.25))
        cand_j = jrp.replay(recs, jrp.WatermarkAdmissionPolicy(0.25))
        assert cand_t.signature() == cand_j.signature()
        assert [d["seq"] for d in trp.diff_runs(trun, cand_t)] == \
            [d["seq"] for d in jrp.diff_runs(jrun, cand_j)]
        assert trp.score_admission(cand_t) == jrp.score_admission(cand_j)


def test_a_tampered_recording_fails_in_both_verifiers():
    recs = _recording("jax", 2)
    recs[0]["decision"] = dict(recs[0]["decision"], action="bogus")
    tv, jv = trp.verify_incumbent(recs), jrp.verify_incumbent(recs)
    assert not tv["exact"] and not jv["exact"]
    assert [d["seq"] for d in tv["divergences"]] == \
        [d["seq"] for d in jv["divergences"]]


def test_a_jax_dump_file_loads_in_the_port(tmp_path):
    rec = jrec.FlightRecorder(capacity=8, dump_dir=str(tmp_path))
    rec.record("admission.router", _admission_inputs(1000.0, None, 0.1),
               {"action": "admit"})
    path = rec.dump(trigger="manual")
    assert trp.load_records(path) == jrp.load_records(path)
    with pytest.raises(ValueError, match="schema"):
        trp.load_records({"schema": "zoo-flight-v99", "records": []})
