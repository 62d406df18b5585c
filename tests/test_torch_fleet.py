"""The port's replica fleet against the JAX package's, on the CPU.

* ``ReplicaRouter``: the same roster, depths, hosts and canary weights give
  the same dispatch order under ``round_robin`` and the same choices under
  ``least_pending`` in both packages.
* A thread fleet of the stack's demo model, the JAX demo model's trained
  weights carried across, answers a seeded burst within 1e-5 of the JAX
  fleet; ``kill_replica`` mid-burst loses nothing (every uri answered once,
  ``requeued > 0``, two eligible replicas again), and after a rolling
  restart the new incarnations answer the same.
* Two routed ``GenerationEngine`` replicas behind a ``ReplicaRouter`` stream
  the JAX routed fleet's greedy tokens, with the ITL objective arming the
  SLO-derived prefill budget.
* A process fleet (``--device cpu``) serves an int8 ResNet-18 bundle bit
  for bit the direct predicts, before and after a replica's restart, and
  every spawned command names the port's package.
"""

import json
import sys
import time

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import FleetSupervisor as JaxFleet
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ReplicaRouter as JaxRouter
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu.serving import stack as jstack
from analytics_zoo_tpu.serving.generation import GEN_STREAM as JAX_GEN_STREAM
from analytics_zoo_tpu.serving.generation import \
    GenerationClient as JaxGenerationClient
from analytics_zoo_tpu.serving.generation import \
    GenerationEngine as JaxGenerationEngine
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential
from analytics_zoo_tpu_torch.serving import (FleetSupervisor, InputQueue,
                                             OutputQueue, ReplicaRouter,
                                             ServingConfig, start_broker)
from analytics_zoo_tpu_torch.serving.generation import (GEN_STREAM,
                                                        GenerationClient,
                                                        GenerationEngine)

pytestmark = [pytest.mark.serving, pytest.mark.fleet]

FAST = dict(batch_size=4, batch_timeout_ms=2, fleet_heartbeat_s=0.1,
            fleet_failover_timeout_s=2.0, fleet_spawn_grace_s=10.0,
            breaker_reset_timeout_s=0.3)


def _wait(cond, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ----------------------------------------------------------------- routers

def _router_run(Router, Cfg, policy, seed):
    rng = np.random.default_rng(seed)
    ids = tuple(f"r{i}" for i in range(5))
    router = Router(Cfg(), ids, policy=policy)
    for rid in ids:
        router.set_replica_host(rid, f"h{int(rng.integers(0, 3))}")
        router._slots[rid].depth = int(rng.integers(0, 6))
    router.set_traffic_fraction("r3", 0.25)
    picks = []
    for step in range(40):
        if step == 12:
            router.evict("r1")
        if step == 20:
            router.set_liveness("r4", False)
        if step == 28:
            router.set_liveness("r4", True)
            for rid in ids:
                router._slots[rid].depth = int(rng.integers(0, 6))
        rid = router._pick()
        picks.append(rid)
        if rid is not None:
            router._note_dispatched(rid)
    return picks, router.depths(), sorted(router.eligible_ids())


@pytest.mark.parametrize("policy", ["round_robin", "least_pending"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routers_pick_the_same_replicas(policy, seed):
    got = _router_run(ReplicaRouter, ServingConfig, policy, seed)
    want = _router_run(JaxRouter, JaxServingConfig, policy, seed)
    assert got == want
    assert len(set(got[0])) >= 3


# ------------------------------------------------------------ thread fleet

@pytest.fixture(scope="module")
def demo_weights():
    """The JAX stack's demo model, trained; its params and state as numpy."""
    from analytics_zoo_tpu.common import init_zoo_context, reset_zoo_context

    reset_zoo_context()
    init_zoo_context()
    try:
        jm = jstack._demo_model()
    finally:
        reset_zoo_context()
    ts = jm.estimator.train_state
    np_tree = jax.tree_util.tree_map(np.asarray, (ts["params"],
                                                  ts["model_state"]))
    return jm, np_tree[0], np_tree[1]


def _port_demo(params, state):
    """The port's demo architecture with the JAX demo model's weights."""
    seq = Sequential([TL.Dense(64, activation="relu", input_shape=(16,)),
                      TL.Dense(4, activation="softmax")], device="cpu")
    return InferenceModel(device="cpu").load(seq, params, state)


def _burst(side, port, x, kill=None):
    IQ, OQ = ((InputQueue, OutputQueue) if side == "torch"
              else (JaxInputQueue, JaxOutputQueue))
    iq, oq = IQ(port=port), OQ(port=port)
    try:
        uris = []
        for i in range(len(x)):
            uris.append(iq.enqueue(None, input=x[i]))
            if kill is not None and i == len(x) // 3:
                kill()
        out = [oq.query(u, timeout_s=30) for u in uris]
    finally:
        iq.close()
        oq.close()
    assert all(o is not None for o in out)
    return uris, np.stack([np.asarray(o) for o in out])


def _fleet(side, broker, factory):
    if side == "torch":
        cfg = ServingConfig(queue_port=broker.port, replicas=2, **FAST)
        return FleetSupervisor(cfg, model_factory=factory, device="cpu")
    cfg = JaxServingConfig(queue_port=broker.port, replicas=2, **FAST)
    return JaxFleet(cfg, model_factory=factory)


def test_thread_fleets_answer_alike_and_survive_a_kill(demo_weights):
    jm, params, state = demo_weights
    x = np.random.default_rng(7).normal(size=(48, 16)).astype(np.float32)
    got = {}
    for side in ("jax", "torch"):
        broker = (start_broker if side == "torch" else jax_start_broker)()
        factory = ((lambda: _port_demo(params, state)) if side == "torch"
                   else (lambda: jm))
        fleet = _fleet(side, broker, factory).start()
        try:
            assert fleet.wait_eligible(2, timeout_s=30)
            _, calm = _burst(side, broker.port, x[:16])
            uris, killed = _burst(side, broker.port, x[16:],
                                  kill=lambda: fleet.kill_replica("r0"))
            assert len(set(uris)) == len(uris)
            _wait(lambda: fleet.requeued > 0 or fleet.respawns > 0,
                  what="the kill's requeue")
            assert fleet.wait_eligible(2, timeout_s=30)
            got[side] = np.concatenate([calm, killed])
            stats = fleet.stats()
            assert stats["respawns"] >= 1
        finally:
            fleet.stop(drain_s=1.0)
            broker.shutdown()
            broker.server_close()
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5,
                               atol=1e-5)
    want = _port_demo(params, state).predict(x)
    np.testing.assert_allclose(got["torch"].reshape(want.shape), want,
                               rtol=1e-6, atol=1e-7)


def test_kill_mid_burst_requeues_and_answers_every_uri_once(demo_weights):
    _, params, state = demo_weights
    broker = start_broker()
    fleet = _fleet("torch", broker, lambda: _port_demo(params, state))
    fleet.start()
    try:
        assert fleet.wait_eligible(2, timeout_s=30)
        x = np.random.default_rng(8).normal(size=(64, 16)).astype(
            np.float32)
        # both replicas hold claimed work when r1 dies
        uris, out = _burst("torch", broker.port, x,
                           kill=lambda: fleet.kill_replica("r1"))
        assert fleet.requeued > 0
        assert fleet.wait_eligible(2, timeout_s=30)
        np.testing.assert_allclose(
            out.reshape(64, 4), _port_demo(params, state).predict(x),
            rtol=1e-6, atol=1e-7)
        # dedup-on-uri: exactly one result hash per uri
        from analytics_zoo_tpu_torch.serving.client import (RESULT_PREFIX,
                                                            _Conn)
        c = _Conn("127.0.0.1", broker.port, timeout=10.0)
        try:
            assert all(c.call("EXISTS", RESULT_PREFIX + u) for u in uris)
        finally:
            c.close()
        # a rolling restart: each replica a new incarnation, answering alike
        old = {r: h.engine for r, h in fleet._handles.items()}
        assert fleet.rolling_restart(timeout_s=60)
        assert all(fleet._handles[r].engine is not old[r]
                   and fleet._hb_seen.get(r) for r in old)
        _, again = _burst("torch", broker.port, x[:16])
        np.testing.assert_allclose(
            again.reshape(16, 4), _port_demo(params, state).predict(x[:16]),
            rtol=1e-6, atol=1e-7)
    finally:
        fleet.stop(drain_s=1.0)
        broker.shutdown()
        broker.server_close()


# -------------------------------------------------------- routed generation

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 64, 32, 2, 2, 64
GEN = dict(gen_slots=2, gen_page_size=4, gen_max_seq_len=32)
ITL = ({"name": "gen-itl", "type": "latency", "threshold_ms": 40,
        "target": 0.99},)


def _gen_fleet(side, np_params, jm, jparams, broker):
    if side == "torch":
        cfg = ServingConfig(queue_port=broker.port, slo_objectives=ITL, **GEN)
        engines = [GenerationEngine(
            TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                          n_head=HEADS, seq_len=SEQ, device="cpu"),
            np_params, cfg, group=f"genfleet-{rid}",
            stream="fleet:gen:" + rid, device="cpu").start()
            for rid in ("g0", "g1")]
        router = ReplicaRouter(cfg, ("g0", "g1"), stream=GEN_STREAM,
                               prefix="fleet:gen:", group="gen-router",
                               policy="round_robin", name="genfleet")
        client = GenerationClient(port=broker.port)
    else:
        cfg = JaxServingConfig(queue_port=broker.port, slo_objectives=ITL,
                               graph_checks="off", **GEN)
        engines = [JaxGenerationEngine(jm, jparams, config=cfg,
                                       group=f"genfleet-{rid}",
                                       stream="fleet:gen:" + rid).start()
                   for rid in ("g0", "g1")]
        router = JaxRouter(cfg, ("g0", "g1"), stream=JAX_GEN_STREAM,
                           prefix="fleet:gen:", group="gen-router",
                           policy="round_robin", name="genfleet")
        client = JaxGenerationClient(port=broker.port)
    return engines, router.start(), client


def test_routed_generation_streams_match_jax():
    jm = JaxLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
               n_head=HEADS, seq_len=SEQ)
    jparams, _ = jm.build(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, VOCAB, int(rng.integers(3, 10))).tolist()
               for _ in range(4)]
    got = {}
    for side in ("jax", "torch"):
        broker = (start_broker if side == "torch" else jax_start_broker)()
        engines, router, client = _gen_fleet(side, np_params, jm, jparams,
                                             broker)
        try:
            got[side] = [list(client.generate(p, max_new_tokens=6, seed=s,
                                              timeout_s=60))
                         for s, p in enumerate(prompts)]
            reps = router.stats()["replicas"]
            assert reps["g0"]["dispatched"] == reps["g1"]["dispatched"] == 2
            if side == "torch":
                for e in engines:
                    assert e.stats()["itl_target_s"] == pytest.approx(0.04)
        finally:
            client.close()
            router.stop()
            for e in engines:
                e.stop()
            broker.shutdown()
            broker.server_close()
    assert got["torch"] == got["jax"]
    assert all(len(t) == 6 for t in got["torch"])


# ----------------------------------------------------------- process fleet

def test_process_fleet_on_cpu_serves_and_restarts_a_replica(tmp_path,
                                                              capsys):
    """Two replica processes (``--device cpu``) load an int8 ResNet-18
    bundle that ``ImageClassifier.save_model`` wrote, through
    ``InferenceModel.load_zoo``, with the YAML config the supervisor hands
    them; their answers are bit for bit the direct int8 predicts, before
    and after r1's restart as a new process; ``cli fleet-status`` reads
    the roster."""
    from analytics_zoo_tpu_torch.models.image.backbones import resnet18
    from analytics_zoo_tpu_torch.serving import cli as tcli
    from analytics_zoo_tpu_torch.models.image.classification import \
        ImageClassifier

    bundle = str(tmp_path / "resnet")
    ImageClassifier("resnet-18", (32, 32, 3), 10, device="cpu",
                    model=resnet18((32, 32, 3), 10, device="cpu",
                                   seed=0)).save_model(bundle)
    yaml = tmp_path / "serving.yaml"
    yaml.write_text(
        f"model:\n  path: {bundle}\n  int8: true\n"
        "params:\n  batchSize: 4\n  coreNum: 2\nbatch_timeout_ms: 2\n"
        "fleet:\n  replicas: 2\n  spawn: process\n  heartbeat_s: 0.1\n"
        "  failover_timeout_s: 3.0\n  spawn_grace_s: 60\n"
        "hot_swap: false\n")
    broker = start_broker()
    cfg = ServingConfig.from_yaml(str(yaml))
    cfg.queue_port = broker.port
    fleet = FleetSupervisor(cfg, config_path=str(yaml), device="cpu")
    fleet.start()
    try:
        for rid, h in fleet._handles.items():
            assert h.proc.args[:3] == [sys.executable, "-m",
                                       "analytics_zoo_tpu_torch.serving.fleet"]
            i = h.proc.args.index("--device")
            assert h.proc.args[i + 1] == "cpu"
            assert h.proc.args[h.proc.args.index("--model") + 1] == bundle
        _wait(lambda: all(fleet._hb_seen.get(r) for r in ("r0", "r1")),
              timeout_s=90, what="both replicas' first heartbeat")
        x = np.random.default_rng(9).normal(size=(12, 32, 32, 3)).astype(
            np.float32)
        direct = InferenceModel(max_batch_size=4, device="cpu").load_zoo(
            bundle).quantize_int8()
        want = np.concatenate([direct.predict(x[i:i + 3])
                               for i in range(0, 12, 3)])
        _, out = _burst("torch", broker.port, x)
        np.testing.assert_array_equal(out.reshape(want.shape), want)
        capsys.readouterr()
        assert tcli.main(["fleet-status", "--port", str(broker.port)]) == 0
        roster = json.loads(capsys.readouterr().out)
        assert roster["spawn"] == "process"
        assert set(roster["replicas"]) == {"r0", "r1"}
        old = fleet._handles["r1"].proc.pid
        assert fleet.restart_replica("r1", timeout_s=180)
        # r1 is a new process that has heartbeat
        assert fleet._handles["r1"].proc.pid != old
        assert fleet._hb_seen.get("r1")
        _, again = _burst("torch", broker.port, x)
        np.testing.assert_array_equal(again.reshape(want.shape), want)
    finally:
        fleet.stop(drain_s=2.0)
        broker.shutdown()
        broker.server_close()
    for h in fleet._handles.values():
        assert h.proc is None or h.proc.poll() is not None
