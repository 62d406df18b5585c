"""The port's ``RolloutController`` against the JAX package's, on the CPU.

Both packages run a two-replica thread fleet over their own broker, serving
a small Dense model with the same JAX weights, and get the same scripted
publishes through ``ModelPublisher``: the weights × 1.01 (the canary swaps,
validates and the rollout promotes fleet-wide), then NaN weights (the canary
refuses them, the rollout rolls back, and ``model_rejections`` holds one
record), then the weights × 0.99 (a good publish after a poisoned one still
deploys). The outcomes, the rejection reasons and the versions every replica
ends on agree with JAX's; every answer served meanwhile carries a version
and equals that version's direct predict within 1e-5.
"""

import threading
import time

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.engine import checkpoint as jckpt
from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu.serving import FleetSupervisor as JaxFleet
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import ModelPublisher as JaxPublisher
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential
from analytics_zoo_tpu_torch.serving import (FleetSupervisor, InputQueue,
                                             ModelPublisher, OutputQueue,
                                             ServingConfig, start_broker)
from analytics_zoo_tpu_torch.serving.hotswap import ROLLOUT_KEY

pytestmark = [pytest.mark.serving, pytest.mark.hotswap]

FLEET = dict(batch_size=4, batch_timeout_ms=2, replicas=2,
             fleet_heartbeat_s=0.1, fleet_failover_timeout_s=3.0,
             fleet_spawn_grace_s=10.0, breaker_reset_timeout_s=0.3,
             warmup_shape=(4,), rollout_window_s=0.3, rollout_min_requests=3,
             rollout_canary_fraction=0.5, swap_timeout_s=10.0)

SIDE = {
    "torch": dict(start_broker=start_broker, Cfg=ServingConfig,
                  Fleet=FleetSupervisor, IQ=InputQueue, OQ=OutputQueue,
                  Pub=ModelPublisher),
    "jax": dict(start_broker=jax_start_broker, Cfg=JaxServingConfig,
                Fleet=JaxFleet, IQ=JaxInputQueue, OQ=JaxOutputQueue,
                Pub=JaxPublisher),
}


@pytest.fixture(scope="module")
def weights():
    jm = JaxSequential([JL.Dense(8, activation="relu", input_shape=(4,)),
                        JL.Dense(2)])
    params, state = jm.build(jax.random.PRNGKey(3))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return jm, to_np(params), to_np(state)


def _scaled(params, f):
    return jax.tree_util.tree_map(
        lambda a: (a * np.float32(f)).astype(a.dtype), params)


def _poisoned(params):
    p = jax.tree_util.tree_map(np.copy, params)
    p[sorted(p)[0]]["kernel"][0, 0] = np.nan
    return p


def _factory(side, jm, params, state):
    if side == "torch":
        def make():
            seq = Sequential([TL.Dense(8, activation="relu",
                                       input_shape=(4,)), TL.Dense(2)],
                             device="cpu")
            return InferenceModel(max_batch_size=8, device="cpu").load(
                seq, params, state)
        return make
    return lambda: JaxInferenceModel(max_batch_size=8).load(jm, params,
                                                            state)


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class _Load:
    """One closed-loop client recording (input index, answer, version)."""

    def __init__(self, side, port, x):
        self.iq, self.oq = SIDE[side]["IQ"](port=port), \
            SIDE[side]["OQ"](port=port)
        self.x, self.results = x, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        i = 0
        while not self.stop.is_set():
            k = i % len(self.x)
            u = self.iq.enqueue(None, input=self.x[k])
            y = self.oq.query(u, timeout_s=30)
            self.results.append((k, np.asarray(y), self.oq.last_model_version))
            i += 1

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        self.iq.close()
        self.oq.close()


def _run(side, tmp_path, weights):
    jm, params, state = weights
    p = SIDE[side]
    broker = p["start_broker"]()
    fleet = p["Fleet"](p["Cfg"](queue_port=broker.port, **FLEET),
                       model_factory=_factory(side, jm, params, state),
                       **({"device": "cpu"} if side == "torch" else {}))
    fleet.start()
    pub = p["Pub"](port=broker.port)
    x = np.random.default_rng(4).normal(size=(8, 4)).astype(np.float32)
    steps = []
    try:
        assert fleet.wait_eligible(2, timeout_s=30)
        with _Load(side, broker.port, x) as load:
            for it, tree in ((1, _scaled(params, 1.01)),
                             (2, _poisoned(params)),
                             (3, _scaled(params, 0.99))):
                path = jckpt.save_checkpoint(str(tmp_path / side), tree,
                                             iteration=it, epoch=0)
                rec = pub.publish(path)
                assert _wait(lambda: any(v == rec["version"] for v, _ in
                                         fleet.rollout.outcomes)), \
                    fleet.rollout.state()
                assert _wait(lambda: fleet.rollout.state()["phase"]
                             == "idle")
                converged = _wait(lambda: len(set(
                    fleet.model_versions().values())) == 1)
                steps.append((rec["version"], converged,
                              sorted(set(fleet.model_versions().values())),
                              fleet.rollout.state()["current"]))
                n = len(load.results)
                assert _wait(lambda: len(load.results) >= n + 4)
        rejections = [(r["version"], r["outcome"], r["reason"])
                      for r in pub.check_rejections()]
        ready, detail = fleet.readiness()
        rollout = pub._conn.call("HGET", ROLLOUT_KEY, 0) \
            if side == "torch" else None
        return dict(outcomes=list(fleet.rollout.outcomes), steps=steps,
                    rejections=rejections, ready=ready,
                    phase=detail["rollout"]["phase"], rollout=rollout,
                    results=load.results, x=x)
    finally:
        pub.close()
        fleet.stop(drain_s=1.0)
        broker.shutdown()
        broker.server_close()


def test_rollout_promotes_and_rolls_back_as_jax_does(tmp_path, weights):
    got = {side: _run(side, tmp_path, weights) for side in ("jax", "torch")}
    t, j = got["torch"], got["jax"]
    assert t["outcomes"] == j["outcomes"]
    v1, v2, v3 = (s[0] for s in t["steps"])
    assert t["outcomes"] == [(v1, "promoted"), (v2, "rolled_back"),
                             (v3, "promoted")]
    assert t["steps"] == j["steps"]
    assert [s[2] for s in t["steps"]] == [[v1], [v1], [v3]]
    assert len(t["rejections"]) == len(j["rejections"]) == 1
    (tv, to, tr), (jv, jo, jr) = t["rejections"][0], j["rejections"][0]
    assert (tv, to) == (jv, jo) == (v2, "rolled_back")
    assert tr.split(":")[0] == jr.split(":")[0]
    assert "nan" in tr
    assert t["ready"] and t["phase"] == "idle"
    assert t["rollout"]["phase"] == "idle" and t["rollout"]["current"] == v3
    # every answer carries the version that computed it
    _, params, state = weights
    direct = {}
    for version, tree in (("initial", params), (v1, _scaled(params, 1.01)),
                          (v3, _scaled(params, 0.99))):
        direct[version] = _factory("torch", None, tree, state)().predict(
            t["x"])
    assert len(t["results"]) >= 12
    for k, y, version in t["results"]:
        assert version in direct, version
        np.testing.assert_allclose(y.reshape(-1), direct[version][k],
                                   rtol=1e-5, atol=1e-5)
    assert {v for _, _, v in t["results"]} >= {v1, v3}
