"""The port's serving stack and CLI, and their interplay with the JAX
package's, on the CPU.

* ``python -m analytics_zoo_tpu_torch.serving.stack --demo --device cpu
  --replicas 2`` boots a fleet stack: ``/readyz`` answers 200, ``/predict``
  answers the port's demo model, ``cli info``/``fleet-status``/``events``
  answer against its broker, and SIGTERM still answers an in-flight request
  and exits 0 (the ordered shutdown).
* Either package's ``cli fleet-status`` reads the other's fleet, and either's
  ``cli drain --replica`` drains a replica of the other's fleet.
* The YAML ``fleet:``/``autoscale:``/``rollout:`` sections parse to the JAX
  package's fields, and the fleet fields no longer raise.
"""

import json
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.serving import FleetSupervisor as JaxFleet
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import cli as jcli
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.serving import (FleetSupervisor, ServingConfig,
                                             start_broker)
from analytics_zoo_tpu_torch.serving import cli as tcli
from analytics_zoo_tpu_torch.serving.stack import _demo_model

pytestmark = pytest.mark.serving

ROOT = Path(__file__).resolve().parent.parent

FAST = dict(batch_size=4, batch_timeout_ms=2, fleet_heartbeat_s=0.1,
            fleet_failover_timeout_s=2.0, fleet_spawn_grace_s=10.0,
            breaker_reset_timeout_s=0.3, hot_swap=False)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class _Stub(InferenceModel):
    def __init__(self):
        super().__init__(device="cpu")

    def predict(self, inputs, batch_first=True):
        x = np.asarray(inputs)
        return x.sum(axis=tuple(range(1, x.ndim)), keepdims=True)


class _JaxStub(JaxInferenceModel):
    def predict(self, inputs, batch_first=True):
        x = np.asarray(inputs)
        return x.sum(axis=tuple(range(1, x.ndim)), keepdims=True)


# ----------------------------------------------------- cross-package CLI

@pytest.mark.parametrize("fleet_side", ["jax", "torch"])
def test_each_cli_reads_and_drains_the_other_packages_fleet(fleet_side,
                                                           capsys):
    if fleet_side == "jax":
        broker = jax_start_broker()
        fleet = JaxFleet(JaxServingConfig(queue_port=broker.port,
                                          replicas=2, **FAST),
                         model_factory=_JaxStub)
        reader = tcli
    else:
        broker = start_broker()
        fleet = FleetSupervisor(ServingConfig(queue_port=broker.port,
                                              replicas=2, **FAST),
                                model_factory=_Stub, device="cpu")
        reader = jcli
    fleet.start()
    try:
        assert fleet.wait_eligible(2, timeout_s=30)
        assert _wait(lambda: all(fleet._hb_seen.get(r)
                                 for r in ("r0", "r1")))
        port = ["--port", str(broker.port)]
        outs = {}
        for name, cli in (("torch", tcli), ("jax", jcli)):
            capsys.readouterr()
            assert cli.main(["fleet-status"] + port) == 0
            outs[name] = json.loads(capsys.readouterr().out)
        assert set(outs["torch"]["replicas"]) == \
            set(outs["jax"]["replicas"]) == {"r0", "r1"}
        assert outs["torch"]["spawn"] == outs["jax"]["spawn"] == "thread"
        assert {r["state"] for r in outs["torch"]["replicas"].values()} \
            == {"up"}
        # the other package's CLI drains one replica of this fleet
        assert reader.main(["drain", "--replica", "r1"] + port) == 0
        assert fleet.wait_state("r1", "drained", timeout_s=20)
        capsys.readouterr()
        assert reader.main(["fleet-status"] + port) == 0
        status = json.loads(capsys.readouterr().out)
        assert status["replicas"]["r1"]["state"] == "drained"
        assert reader.main(["info"] + port) == 0
        info = json.loads(capsys.readouterr().out)
        assert "streams" in info or "wire" in info
    finally:
        fleet.stop(drain_s=1.0)
        broker.shutdown()
        broker.server_close()


# --------------------------------------------------------------- the stack

def _fleet_status(port) -> str:
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["fleet-status", "--port", str(port)]) == 0
    return out.getvalue()


def test_stack_serves_a_fleet_and_shuts_down_in_order():
    http_port, broker_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.stack",
         "--demo", "--device", "cpu", "--replicas", "2",
         "--http-port", str(http_port), "--broker-port", str(broker_port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{http_port}"
    log = []
    reader = threading.Thread(target=lambda: log.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        def ready():
            if proc.poll() is not None:
                raise AssertionError("".join(log))
            try:
                return urllib.request.urlopen(url + "/readyz",
                                              timeout=2).status == 200
            except OSError:
                return False

        assert _wait(ready, timeout_s=120), "".join(log)
        x = np.random.default_rng(5).normal(size=(6, 16)).astype(np.float32)
        body = json.dumps({"instances": [{"x": r.tolist()} for r in x]})
        resp = json.loads(urllib.request.urlopen(urllib.request.Request(
            url + "/predict", body.encode(),
            {"Content-Type": "application/json"}), timeout=60).read())
        got = np.asarray(resp["predictions"], np.float32)
        want = InferenceModel(device="cpu").load(_demo_model("cpu")).predict(
            x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        for verb in (["info"], ["fleet-status"], ["events", "--count", "5"]):
            assert tcli.main(verb + ["--port", str(broker_port)]) == 0, verb
        roster = json.loads(_fleet_status(broker_port))
        assert roster["spawn"] == "thread"
        assert set(roster["replicas"]) == {"r0", "r1"}
        # SIGTERM with a request in flight: it is still answered
        inflight = {}

        def request():
            one = json.dumps({"instances": [{"x": x[0].tolist()}]})
            r = urllib.request.urlopen(urllib.request.Request(
                url + "/predict", one.encode(),
                {"Content-Type": "application/json"}), timeout=60)
            inflight["resp"] = json.loads(r.read())

        t = threading.Thread(target=request)
        t.start()
        time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=60)
        assert proc.wait(timeout=60) == 0, "".join(log)
        if "resp" in inflight:
            np.testing.assert_allclose(inflight["resp"]["predictions"][0],
                                       want[0], rtol=1e-5, atol=1e-6)
        else:
            raise AssertionError("the in-flight request got no answer")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ----------------------------------------------------------------- config

FLEET_YAML = """
fleet:
  replicas: 3
  policy: round_robin
  spawn: process
  heartbeat_s: 0.2
  failover_timeout_s: 1.5
  spawn_grace_s: 45
  hosts: 2
  host_capacity: 5
autoscale:
  enabled: true
  min_replicas: 2
  max_replicas: 6
  up_depth: 12
  sustain_s: 3.5
  idle_s: 9
  cooldown_s: 4.5
rollout:
  canary_fraction: 0.5
  window_s: 1.5
  min_requests: 4
"""


def test_yaml_fleet_autoscale_and_rollout_sections_parse_as_jax(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(FLEET_YAML)
    t, j = ServingConfig.from_yaml(str(p)), JaxServingConfig.from_yaml(str(p))
    import dataclasses

    names = [f.name for f in dataclasses.fields(ServingConfig)]
    assert names == [f.name for f in dataclasses.fields(JaxServingConfig)]
    for f in names:
        assert getattr(t, f) == getattr(j, f), f
    assert (t.replicas, t.fleet_spawn, t.fleet_hosts, t.autoscale,
            t.max_replicas) == (3, "process", 2, True, 6)
    bad = tmp_path / "bad.yaml"
    bad.write_text("fleet:\n  spawn: fork\n")
    for Cfg in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError):
            Cfg.from_yaml(str(bad))


# -------------------------------------------- slo-status, dump, postmortem

def test_slo_status_dump_and_postmortem_verbs(tmp_path, capsys):
    """``cli slo-status`` and ``cli dump`` against a frontend with the
    observability plane, then ``cli postmortem`` of the dump: the port's
    CLI and the JAX package's print the same timeline for it."""
    from analytics_zoo_tpu_torch.observability import ObservabilityPlane
    from analytics_zoo_tpu_torch.observability import events as tev
    from analytics_zoo_tpu_torch.observability import recorder as trec
    from analytics_zoo_tpu_torch.serving import FrontEndApp, qos

    cfg = ServingConfig(slo_objectives=(
        {"name": "avail", "type": "availability", "priority": "bulk",
         "target": 0.9},), slo_fast_window_s=2.0, slo_slow_window_s=8.0)
    plane = ObservabilityPlane.from_config(cfg)
    app = FrontEndApp(cfg, port=0, plane=plane).start()
    http = ["--http", f"127.0.0.1:{app.port}"]
    try:
        assert tcli.main(["slo-status"] + http) == 0
        status = json.loads(capsys.readouterr().out)
        assert [o["name"] for o in status["objectives"]] == ["avail"]
        rec = trec.install(dump_dir=str(tmp_path), plane=plane)
        inputs = {"now": 1000.0, "deadline": 1000.1, "est_wait_s": 0.5,
                  "service_ema_s": 0.05, "skew_tolerance_s": 0.0,
                  "depth": 3, "concurrency": 2, "priority": "bulk"}
        rec.record("admission.router", inputs,
                   qos.admission_decision(inputs))
        tev.emit("shed.router", severity="warning", reason="deadline",
                 priority="bulk")
        dest = str(tmp_path / "pulled.json")
        assert tcli.main(["dump"] + http + ["--out", dest]) == 0
        capsys.readouterr()
    finally:
        trec.uninstall()
        tev.reset_events()
        app.stop()
    outs = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        assert cli.main(["postmortem", dest]) == 0
        outs[name] = capsys.readouterr().out
    assert "admission.router" in outs["torch"]
    assert "shed.router" in outs["torch"]
    assert outs["torch"] == outs["jax"]
    assert tcli.main(["dump", "--http", "127.0.0.1:9", "--out",
                      str(tmp_path / "no.json")]) == 3
