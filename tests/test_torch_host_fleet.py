"""Host failure domains, whole-host failover and the autoscaler of the
port's fleet against the JAX package's, on the CPU.

Replicas serve a stub model whose answer is each row's sum (so every answer
is attributable to exactly one request). Both packages place four replicas
on two hosts the same way, and a whole-host kill mid-burst makes the same
single decision: one ``fleet.host_failed`` event naming the host, every
replica it carried respawned on the survivor, every uri answered once. Host
agents run in process, and once as ``python -m
analytics_zoo_tpu_torch.serving.hostagent --device cpu`` subprocesses. The
queue-driven autoscaler grows a one-replica fleet under a burst and drains
it back when idle, with zero loss.
"""

import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.observability import events as jev
from analytics_zoo_tpu.serving import FleetSupervisor as JaxFleet
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.observability import events as tev
from analytics_zoo_tpu_torch.serving import (FleetSupervisor, InputQueue,
                                             OutputQueue, ServingConfig,
                                             start_broker)

pytestmark = [pytest.mark.serving, pytest.mark.fleet]


class _Stub(InferenceModel):
    """Per-row sums after a fixed service time (released GIL)."""

    def __init__(self, service_s=0.0):
        super().__init__(device="cpu")
        self._service = service_s

    def predict(self, inputs, batch_first=True):
        if self._service:
            time.sleep(self._service)
        x = np.asarray(inputs)
        return x.sum(axis=tuple(range(1, x.ndim)), keepdims=True)


class _JaxStub(JaxInferenceModel):
    def __init__(self, service_s=0.0):
        super().__init__()
        self._service = service_s

    def predict(self, inputs, batch_first=True):
        if self._service:
            time.sleep(self._service)
        x = np.asarray(inputs)
        return x.sum(axis=tuple(range(1, x.ndim)), keepdims=True)


SIDE = {
    "torch": dict(start_broker=start_broker, Cfg=ServingConfig,
                  Fleet=FleetSupervisor, IQ=InputQueue, OQ=OutputQueue,
                  Stub=_Stub, ev=tev, kw={"device": "cpu"}),
    "jax": dict(start_broker=jax_start_broker, Cfg=JaxServingConfig,
                Fleet=JaxFleet, IQ=JaxInputQueue, OQ=JaxOutputQueue,
                Stub=_JaxStub, ev=jev, kw={}),
}

BASE = dict(batch_size=4, batch_timeout_ms=2, fleet_heartbeat_s=0.1,
            fleet_failover_timeout_s=2.0, fleet_spawn_grace_s=10.0,
            breaker_reset_timeout_s=0.3)


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _submit(side, port, n, start=0):
    iq = SIDE[side]["IQ"](port=port)
    try:
        return [(iq.enqueue(None, input=np.full((4,), float(i), np.float32)),
                 4.0 * i) for i in range(start, start + n)]
    finally:
        iq.close()


def _check_exactly_once(side, port, subs, timeout_s=60.0):
    oq = SIDE[side]["OQ"](port=port)
    try:
        for uri, want in subs:
            got = oq.query(uri, timeout_s=timeout_s)
            assert abs(float(np.asarray(got).ravel()[0]) - want) < 1e-4
    finally:
        oq.close()


def _host_run(side):
    p = SIDE[side]
    p["ev"].reset_events()
    broker = p["start_broker"]()
    cfg = p["Cfg"](queue_port=broker.port, replicas=4, fleet_hosts=2,
                   **BASE)
    fleet = p["Fleet"](cfg, model_factory=lambda: p["Stub"](0.02), **p["kw"])
    try:
        fleet.start()
        assert fleet.wait_eligible(4, timeout_s=30)
        placed = {h: sorted(s["replicas"])
                  for h, s in fleet.stats()["hosts"].items()}
        subs = _submit(side, broker.port, 24)
        fleet.kill_host("h0")
        subs += _submit(side, broker.port, 24, start=24)
        _check_exactly_once(side, broker.port, subs)
        assert _wait(lambda: fleet.host_failovers == 1)
        events = [e.fields for e in p["ev"].events(kind="fleet.host_failed")]
        assert fleet.wait_eligible(4, timeout_s=30)
        _check_exactly_once(side, broker.port,
                            _submit(side, broker.port, 8, start=100))
        after = {h: sorted(s["replicas"])
                 for h, s in fleet.stats()["hosts"].items()}
        # capacity is a hard per-host ceiling
        full = fleet._place_host()
        return dict(placed=placed, events=events, after=after,
                    place_next=full)
    finally:
        fleet.stop(drain_s=1.0)
        broker.shutdown()
        broker.server_close()
        p["ev"].reset_events()


def test_placement_and_whole_host_failover_decide_as_jax_does():
    got, want = _host_run("torch"), _host_run("jax")
    assert got["placed"] == want["placed"]
    assert sorted(len(r) for r in got["placed"].values()) == [2, 2]
    assert len(got["events"]) == len(want["events"]) == 1
    t, j = got["events"][0], want["events"][0]
    assert t["host"] == j["host"] == "h0"
    assert sorted(t["replicas"]) == sorted(j["replicas"]) \
        == got["placed"]["h0"]
    assert t["respawned"] == j["respawned"]
    assert set(t["respawned"].values()) == {"h1"}
    assert got["after"]["h1"] == want["after"]["h1"]
    assert got["place_next"] == want["place_next"]


def test_host_agents_as_subprocesses_on_cpu():
    tev.reset_events()
    broker = start_broker()
    cfg = ServingConfig(queue_port=broker.port, replicas=2, fleet_hosts=2,
                        batch_size=4, batch_timeout_ms=2,
                        fleet_heartbeat_s=0.1, fleet_failover_timeout_s=2.0,
                        fleet_spawn_grace_s=60.0, hot_swap=False)
    fleet = FleetSupervisor(cfg, demo=True, device="cpu")
    try:
        fleet.start()
        for slot in fleet._hosts.values():
            args = slot.proc.args
            assert args[1:3] == ["-m",
                                 "analytics_zoo_tpu_torch.serving.hostagent"]
            assert args[args.index("--device") + 1] == "cpu"
        assert _wait(lambda: all(fleet._hb_seen.get(r)
                                 for r in ("r0", "r1")), timeout_s=60)
        x = np.random.default_rng(2).normal(size=(24, 16)).astype(np.float32)
        iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
        try:
            uris = [iq.enqueue(None, input=x[i]) for i in range(12)]
            victim = next(h for h, s in fleet._hosts.items() if s.replicas)
            fleet.kill_host(victim)
            uris += [iq.enqueue(None, input=x[i]) for i in range(12, 24)]
            out = [oq.query(u, timeout_s=60) for u in uris]
        finally:
            iq.close()
            oq.close()
        from analytics_zoo_tpu_torch.serving.stack import _demo_model

        want = InferenceModel(device="cpu").load(_demo_model("cpu")).predict(x)
        np.testing.assert_allclose(np.stack(out).reshape(want.shape), want,
                                   rtol=1e-6, atol=1e-7)
        assert _wait(lambda: fleet.host_failovers == 1)
        # the dead agent's last heartbeat must not resurrect the host: no
        # second failover once it would have aged out and expired again
        # (twice the failover timeout)
        assert not _wait(lambda: fleet.host_failovers > 1, timeout_s=5.0)
        failed = tev.events(kind="fleet.host_failed")
        assert [e.fields["host"] for e in failed] == [victim]
    finally:
        fleet.stop(drain_s=2.0)
        broker.shutdown()
        broker.server_close()
        tev.reset_events()
    for slot in fleet._hosts.values():
        assert slot.proc is None or slot.proc.poll() is not None


def test_autoscale_up_under_a_burst_and_down_when_idle():
    broker = start_broker()
    cfg = ServingConfig(queue_port=broker.port, replicas=1, autoscale=True,
                        min_replicas=1, max_replicas=3,
                        autoscale_up_depth=2.0, autoscale_sustain_s=0.2,
                        autoscale_idle_s=0.6, autoscale_cooldown_s=0.1,
                        **BASE)
    fleet = FleetSupervisor(cfg, model_factory=lambda: _Stub(0.04),
                            device="cpu")
    try:
        fleet.start()
        assert fleet.wait_eligible(1, timeout_s=15)
        subs, lock = [], threading.Lock()

        def submit(k):
            got = _submit("torch", broker.port, 40, start=40 * k)
            with lock:
                subs.extend(got)

        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        _check_exactly_once("torch", broker.port, subs)
        assert len(subs) == 120
        assert [e for e in fleet.scale_events if e[0] == "up"], \
            fleet.scale_events
        assert _wait(lambda: len(fleet._handles) == 1, timeout_s=30), \
            fleet.scale_events
        assert [e for e in fleet.scale_events if e[0] == "down"]
        _check_exactly_once("torch", broker.port,
                            _submit("torch", broker.port, 4, start=500))
    finally:
        fleet.stop(drain_s=2.0)
        broker.shutdown()
        broker.server_close()
