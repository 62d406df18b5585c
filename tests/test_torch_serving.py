"""The port's ClusterServing, MicroBatcher and HTTP frontend against the
JAX package's, on the CPU.

Both engines serve the same small float model (the JAX model's weights
loaded into the port's through the bridge) over their own brokers; the
same seeded records come back within 1e-5 of each other, every uri answered
exactly once. ``top_n``, the bad-record error, the malformed record, a
chaos-killed infer worker and draining behave as ``tests/test_serving.py``
has them for JAX. ``MicroBatcher`` orders, sheds and buckets a seeded
arrival schedule as JAX's does. The frontend answers ``/predict`` in queue
and direct mode, ``/metrics`` (parsed by the port's ``parse_prometheus``),
``/healthz``, ``/readyz``, ``/debug``, and a fast 503 once its breaker
opened against a dead broker. The config's graph-check fields build as the
reference's, and ``graph_checks="warn"`` logs each warm-up finding once.
"""

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import batching as jbatching
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule
from analytics_zoo_tpu_torch.common.resilience import (CircuitBreaker,
                                                       HealthRegistry)
from analytics_zoo_tpu_torch.common.telemetry import parse_prometheus
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential
from analytics_zoo_tpu_torch.serving import (ClusterServing, FrontEndApp,
                                             InputQueue, OutputQueue,
                                             ServingConfig, start_broker)
from analytics_zoo_tpu_torch.serving import batching as tbatching
from analytics_zoo_tpu_torch.serving.client import _Conn

pytestmark = pytest.mark.serving


def _pair(seed=0):
    jm = JaxSequential([JL.Dense(16, activation="relu", input_shape=(8,)),
                        JL.Dense(4, activation="softmax")])
    tm = Sequential([TL.Dense(16, activation="relu", input_shape=(8,)),
                     TL.Dense(4, activation="softmax")], device="cpu")
    params, state = jm.build(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    return jm, tm, params, state


@pytest.fixture(scope="module")
def models():
    jm, tm, params, state = _pair()
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        device="cpu").load(tm, params, state)
    jim = JaxInferenceModel(supported_concurrent_num=2,
                            max_batch_size=8).load(jm, params, state)
    x = np.random.default_rng(0).normal(size=(24, 8)).astype(np.float32)
    return im, jim, x, (params, state)


@pytest.fixture(scope="module")
def brokers():
    tb, jb = start_broker(), jax_start_broker()
    yield tb, jb
    for b in (tb, jb):
        b.shutdown()
        b.server_close()


def _serve(job, iq, oq, xs, **kw):
    uris = [iq.enqueue(None, input=x, **kw) for x in xs]
    return uris, [oq.query(u, timeout_s=30) for u in uris]


def test_cluster_serving_matches_jax(models, brokers):
    im, jim, x, _ = models
    tb, jb = brokers
    got = {}
    for side, b, Job, Cfg, IQ, OQ, model in (
            ("torch", tb, ClusterServing, ServingConfig, InputQueue,
             OutputQueue, im),
            ("jax", jb, JaxClusterServing, JaxServingConfig, JaxInputQueue,
             JaxOutputQueue, jim)):
        cfg = Cfg(batch_size=8, concurrent_num=2, queue_port=b.port)
        job = Job(model, cfg, group="e2e").start()
        iq, oq = IQ(port=b.port), OQ(port=b.port)
        try:
            uris, outs = _serve(job, iq, oq, x[:20])
            assert oq.last_model_version == "initial"
            # answered once: the result hash is consumed by the query
            with pytest.raises(TimeoutError):
                oq.query(uris[0], timeout_s=0)
        finally:
            iq.close()
            oq.close()
            job.stop()
        stats = job.stats()
        assert stats["served"] == 20 and stats["errors"] == 0
        # every entry acked: nothing pending or unread for the group
        c = _Conn("127.0.0.1", b.port, timeout=10.0)
        assert c.call("LEN", "serving_stream", "e2e") == 0
        c.close()
        got[side] = np.stack(outs)
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5,
                               atol=1e-5)
    # against the port's own direct predict (float matmuls on the CPU may
    # round differently at another batch size)
    np.testing.assert_allclose(got["torch"], im.predict(x[:20]), rtol=1e-6,
                               atol=1e-6)
    assert job.stats()["model_version"] == "initial"


def test_cluster_serving_takes_a_module_and_a_device(models, brokers):
    _, _, x, (params, state) = models
    tb, _ = brokers
    tm = _pair()[1]
    tm.load_state_dict(state_dict_from_jax(params, state))
    cfg = ServingConfig(batch_size=4, queue_port=tb.port, top_n=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterServing(tm, cfg)          # no card and no device: raises
    job = ClusterServing(tm, cfg, group="topn", device="cpu").start()
    assert job.model.device == torch.device("cpu")
    iq, oq = InputQueue(port=tb.port), OutputQueue(port=tb.port)
    try:
        uri = iq.enqueue(None, input=torch.from_numpy(x[0]))
        res = oq.query(uri, timeout_s=30)
    finally:
        iq.close()
        oq.close()
        job.stop()
    assert res.shape == (2, 2)           # (index, value) pairs
    probs = models[1].predict(x[:1])[0]
    assert int(res[0, 0]) == int(np.argmax(probs))
    order = np.argsort(-probs)[:2]
    np.testing.assert_allclose(res[:, 1], probs[order], rtol=1e-5, atol=1e-6)


def test_bad_and_malformed_records_answer_errors(models, brokers):
    im, jim, x, _ = models
    tb, _ = brokers
    cfg = ServingConfig(batch_size=4, queue_port=tb.port)
    job = ClusterServing(im, cfg, group="errs").start()
    iq, oq = InputQueue(port=tb.port), OutputQueue(port=tb.port)
    try:
        bad = iq.enqueue(None, input=np.zeros((3,), np.float32))
        with pytest.raises(RuntimeError, match="serving error"):
            oq.query(bad, timeout_s=30)
        raw = _Conn("127.0.0.1", tb.port, timeout=10.0)
        raw.call("XADD", "serving_stream",
                 {"uri": "bad1", "data": {"input": {"__ndarray__": "!!"}}})
        raw.close()
        good = [iq.enqueue(None, input=x[i]) for i in range(3)]
        with pytest.raises(RuntimeError, match="malformed payload"):
            oq.query("bad1", timeout_s=30)
        for i, u in enumerate(good):
            np.testing.assert_allclose(oq.query(u, timeout_s=30),
                                       jim.predict(x[i:i + 1])[0],
                                       rtol=1e-5, atol=1e-5)
    finally:
        iq.close()
        oq.close()
        job.stop()
    assert job.errors == 2 and job.served == 5


def test_chaos_killed_infer_worker_is_respawned_without_loss(models,
                                                              brokers):
    im, jim, x, _ = models
    tb, _ = brokers
    sched = ChaosSchedule(seed=7).kill("serving.infer", at=2, tag=0)
    with sched:
        cfg = ServingConfig(batch_size=4, queue_port=tb.port,
                            infer_workers=2)
        job = ClusterServing(im, cfg, group="chaos").start()
        iq, oq = InputQueue(port=tb.port), OutputQueue(port=tb.port)
        try:
            _, outs = _serve(job, iq, oq, x[:20])
        finally:
            iq.close()
            oq.close()
            job.stop()
    np.testing.assert_allclose(np.stack(outs), jim.predict(x[:20]),
                               rtol=1e-5, atol=1e-5)
    assert job.workers_respawned >= 1
    assert sched.occurrences("serving.infer", tag=0) >= 2
    assert job.stats()["served"] == 20


def test_drain_finishes_in_flight_work(models, brokers):
    im, _, x, _ = models
    tb, _ = brokers
    job = ClusterServing(im, ServingConfig(batch_size=4, queue_port=tb.port),
                         group="drain").start()
    iq, oq = InputQueue(port=tb.port), OutputQueue(port=tb.port)
    try:
        assert job.state() == "up"
        _serve(job, iq, oq, x[:4])
        job.drain()
        assert job.state() in ("draining", "drained")
        job.stop()
        assert job.drained() and job.state() == "drained"
    finally:
        iq.close()
        oq.close()
        job.stop()


# ------------------------------------------------------------ MicroBatcher

class _Clock:
    def __init__(self):
        self.now = 1.7e9

    def time(self):
        return self.now

    def monotonic(self):
        return self.now


def _arrivals(seed):
    """A seeded arrival schedule: (priority, deadline offset or None, rows,
    width)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(23):
        pri = ["critical", "normal", "bulk", None][int(rng.integers(0, 4))]
        dl = [None, 0.001, 0.05, 5.0][int(rng.integers(0, 4))]
        width = [3, 3, 5][int(rng.integers(0, 3))]
        out.append((pri, dl, width))
    return out


def _drive(mod, monkeypatch, seed):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    calls = []

    def predict(b):
        calls.append(b.shape)
        return b * 2.0

    mb = mod.MicroBatcher(predict, max_batch=8, max_delay_ms=0.0)
    mb._stop.set()                # drive the waves by hand, in order
    mb._thread.join(timeout=5)
    mb.service_ema.observe(0.01)
    slots = []
    for k, (pri, dl, width) in enumerate(_arrivals(seed)):
        x = np.full((width,), float(k), np.float32)
        slots.append(mb.submit_async(
            {"x": x}, priority=pri,
            deadline=None if dl is None else clock.now + dl))
    waves = []
    while mb._fill_backlog():
        mb._order_and_shed()
        wave = mb._backlog[:mb.max_batch]
        del mb._backlog[:len(wave)]
        waves.append([s.seq for s in wave])
        groups = {}
        for s in wave:
            groups.setdefault(mb._signature(s.tensors), []).append(s)
        for g in groups.values():
            mb._run_group(g)
        if not mb._backlog and mb._q.empty():
            break
    outcome = []
    for s in slots:
        if isinstance(s.error, Exception):
            outcome.append((type(s.error).__name__,
                            round(getattr(s.error, "retry_after_s", 0), 9)))
        else:
            outcome.append(s.result.tolist())
    stats = mb.stats()
    stats.pop("service_ema_s")
    return waves, calls, outcome, stats, [mb._bucket(n) for n in range(1, 9)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_microbatcher_orders_sheds_and_buckets_as_jax(seed, monkeypatch):
    got = _drive(tbatching, monkeypatch, seed)
    want = _drive(jbatching, monkeypatch, seed)
    assert got == want
    waves, calls, outcome, stats, _ = got
    assert any(o[0] == "ShedError" for o in outcome if isinstance(o, tuple))
    assert stats["padded_rows"] > 0 and len(waves) >= 2


# ---------------------------------------------------------------- frontend

def _post(port, path, body, headers=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(port, path, timeout=10):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_frontend_queue_and_direct_modes(models, brokers):
    im, jim, x, (params, state) = models
    tb, _ = brokers
    want = jim.predict(x[:4])
    cfg = ServingConfig(batch_size=8, queue_port=tb.port)
    registry = HealthRegistry(default_timeout_s=60)
    job = ClusterServing(im, cfg, group="http", registry=registry).start()
    app = FrontEndApp(cfg, port=0, registry=registry,
                      engine_stats=job.stats).start()
    tm = _pair()[1]
    tm.load_state_dict(state_dict_from_jax(params, state))
    direct = FrontEndApp(cfg, port=0, model=tm, device="cpu",
                         max_batch=8, max_delay_ms=20.0).start()
    try:
        body = {"instances": [{"input": x[i].tolist()} for i in range(4)]}
        for front in (app, direct):
            code, hdr, out = _post(front.port, "/predict", body)
            assert code == 200, out
            np.testing.assert_allclose(np.asarray(out["predictions"]), want,
                                       rtol=1e-5, atol=1e-5)
            assert out["model_version"] == "initial"
        # direct mode: concurrent batch-1 requests share predict calls
        results, errors = [None] * 8, []

        def one(i):
            try:
                results[i] = _post(direct.port, "/predict", {
                    "instances": [{"input": x[i].tolist()}]})[2]
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        # wait for the event asserted below, every request answered: all
        # threads ended (each client call is bounded by its own timeout)
        deadline = time.monotonic() + 120
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not [t for t in threads if t.is_alive()], "requests unanswered"
        assert not errors, errors
        assert all("predictions" in r for r in results), results
        np.testing.assert_allclose(
            np.asarray([r["predictions"][0] for r in results]),
            jim.predict(x[:8]), rtol=1e-5, atol=1e-5)
        assert direct._batcher.stats()["records"] == 12, \
            direct._batcher.stats()
        # metrics: Prometheus text the port's parser accepts
        code, _, text = _get(app.port, "/metrics")
        fams = parse_prometheus(text.decode())
        for fam in ("zoo_http_requests_total", "zoo_broker_commands_total",
                    "zoo_infer_compiles_total", "zoo_wire_bytes_total",
                    "zoo_serving_records_total", "zoo_breaker_state"):
            assert fam in fams, fam
        assert any(l.get("span") == "serving.http.predict" for _n, l, _v
                   in fams["zoo_span_duration_seconds"]["samples"])
        code, _, raw = _get(app.port, "/metrics.json")
        stats = json.loads(raw)
        assert stats["engine"]["graph_checks"] == "warn"
        assert "wire" in stats and "http.predict" in stats
        assert _get(app.port, "/healthz")[0] == 200
        code, _, raw = _get(app.port, "/readyz")
        assert code == 200 and json.loads(raw)["status"] == "ready"
        code, hdr, raw = _get(app.port, "/debug")
        assert code == 200 and b"/debug" in raw
        assert json.loads(_get(app.port, "/debug/rowcache")[2]) == \
            {"caches": {}}
        assert json.loads(_get(app.port, "/debug/slo")[2])["enabled"] is \
            False
        assert "events" in json.loads(_get(app.port, "/debug/events")[2])
    finally:
        direct.stop()
        app.stop()
        job.stop()


def test_frontend_breaker_fast_fails_against_a_dead_broker():
    with socket.socket() as s:      # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    cfg = ServingConfig(queue_port=dead)
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=30.0,
                             name="test-frontend")
    app = FrontEndApp(cfg, port=0, breaker=breaker).start()
    try:
        body = {"instances": [{"input": [0.0] * 8}]}
        code, hdr, out = _post(app.port, "/predict", body)
        assert code == 503 and out["shed_reason"] == "breaker"
        assert breaker.state == CircuitBreaker.OPEN
        code, hdr, out = _post(app.port, "/predict", body, timeout=5)
        assert code == 503 and out["shed_reason"] == "breaker"
        assert int(hdr["Retry-After"]) >= 1
        code, _, raw = _get(app.port, "/readyz")
        assert code == 503 and json.loads(raw)["reason"] == "circuit open"
        fams = parse_prometheus(_get(app.port, "/metrics")[2].decode())
        opens = [v for _n, l, v in fams["zoo_breaker_opens_total"]["samples"]
                 if l.get("name") == "test-frontend"]
        assert opens == [1.0]
    finally:
        app.stop()


# ----------------------------------------------------------------- config

@pytest.mark.parametrize("kw", [dict(graph_checks="raise"),
                                dict(hbm_budget_mb=512.0),
                                dict(replicas=2), dict(fleet_hosts=1),
                                dict(autoscale=True),
                                dict(slo_objectives=({"name": "p99"},))])
def test_unported_config_fields_raise(kw):
    """Every one of these fields is ported (the graph-lint fields since
    the analysis tier) and gives the reference's values."""
    jcfg = JaxServingConfig(**kw)     # the reference accepts each
    cfg = ServingConfig(**kw)
    assert {f: getattr(cfg, f) for f in kw} == \
        {f: getattr(jcfg, f) for f in kw}


def test_yaml_layout_and_the_slo_section(tmp_path):
    p = tmp_path / "config.yaml"
    p.write_text("model:\n  path: /models/ncf\nparams:\n  batchSize: 64\n"
                 "  coreNum: 8\nredis:\n  host: 1.2.3.4\n  port: 9999\n"
                 "postprocessing:\n  topN: 5\ngeneration:\n  slots: 4\n")
    for Cfg in (ServingConfig, JaxServingConfig):
        cfg = Cfg.from_yaml(str(p))
        assert (cfg.model_path, cfg.batch_size, cfg.concurrent_num,
                cfg.queue_host, cfg.queue_port, cfg.top_n, cfg.gen_slots) \
            == ("/models/ncf", 64, 8, "1.2.3.4", 9999, 5, 4)
    p.write_text("slo:\n  objectives:\n    - {name: p99, type: latency, "
                 "target: 0.99, threshold_ms: 50}\n")
    assert ServingConfig.from_yaml(str(p)).slo_objectives == \
        JaxServingConfig.from_yaml(str(p)).slo_objectives == \
        ({"name": "p99", "type": "latency", "target": 0.99,
          "threshold_ms": 50},)


def test_graph_checks_warn_logs_once(models, brokers, caplog):
    """At warm-up, ``graph_checks="warn"`` runs the dispatch checks: a
    clean model logs nothing; a 1-byte ``hbm_budget_mb`` logs its one
    ``hbm-budget`` finding once and serves; "off" runs nothing."""
    im, _, _, _ = models
    tb, _ = brokers
    runs = {}
    for group, kw in (("warn", {}), ("tight", dict(hbm_budget_mb=1e-6)),
                      ("off", dict(graph_checks="off"))):
        job = ClusterServing(im, ServingConfig(queue_port=tb.port,
                                               warmup_shape=(8,), **kw),
                             group=group)
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             logger="analytics_zoo_tpu_torch.inference"):
            job.start()
            job.stop()
        runs[group] = ([r.getMessage() for r in caplog.records
                        if "graph-lint" in r.getMessage()], job.stats())
    assert runs["warn"][0] == [] and runs["off"][0] == []
    assert runs["warn"][1]["graph_checks"] == "warn"
    warned, stats = runs["tight"]
    assert len(warned) == 1 and "hbm-budget" in warned[0]
    assert stats["graph_findings"] == 1 and runs["off"][1][
        "graph_findings"] == 0
