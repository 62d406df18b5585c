"""The runtime context, its configuration and the profiling helpers of the
PyTorch port, on the CPU, against the JAX package where it has the same
function.

Held: ``MeshConfig.sizes`` equal to JAX's over device counts and layouts
(errors too); ``apply_env_overrides`` reading the same ``ZOO_TPU_*``
variables to the same values as JAX's; the JAX fields and defaults of
``MeshConfig``, ``PrecisionConfig`` and ``RuntimeConfig``;
``init_zoo_context`` on the CPU (devices, mesh, process 0 of 1, the
precision policy engaged and restored by ``reset_zoo_context``), raising
without CUDA and without a platform, and its mesh reaching the
Estimator's multi-GPU raise; a CUDA context holding the process's own
card, and an Estimator with no context training alone on its device
(no context made); ``xprof_trace`` writing a Chrome trace,
``annotate`` landing in ``zoo_span_duration_seconds{span=...}`` and
``profile_steps`` returning the median of its traced steps.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu_torch.common import config as tconfig
from analytics_zoo_tpu_torch.common import profiling, telemetry
from analytics_zoo_tpu_torch.common.context import (Mesh, build_mesh,
                                                    get_zoo_context,
                                                    init_zoo_context,
                                                    reset_zoo_context)
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import module as tmod


@pytest.fixture
def fresh_context():
    reset_zoo_context()
    yield
    reset_zoo_context()


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("layout", [{}, {"tp": 2}, {"fsdp": 2, "tp": 2},
                                    {"dp": 2, "sp": 2}, {"pp": 4},
                                    {"dp": 3}, {"ep": 2, "dp": 0}])
def test_mesh_sizes_match_jax(n, layout):
    want = got = None
    try:
        want = jconfig.MeshConfig(**layout).sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError, match="devices|match"):
            tconfig.MeshConfig(**layout).sizes(n)
        assert "divisible" in str(e) or "match" in str(e)
        return
    got = tconfig.MeshConfig(**layout).sizes(n)
    assert got == want
    assert tconfig.MeshConfig().axis_names == jconfig.MeshConfig().axis_names


def test_runtime_config_fields_are_jax_s():
    for name in ("MeshConfig", "PrecisionConfig", "RuntimeConfig"):
        jf = {f.name: (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
              for f in dataclasses.fields(getattr(jconfig, name))}
        tf = {f.name: (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
              for f in dataclasses.fields(getattr(tconfig, name))}
        assert set(tf) == set(jf), name
        for k in jf:
            a, b = tf[k], jf[k]
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (name, k)


def test_env_overrides_match_jax(monkeypatch):
    env = {"ZOO_TPU_MESH_TP": "2", "ZOO_TPU_MESH_DP": "0",
           "ZOO_TPU_PRECISION_COMPUTE_DTYPE": "bfloat16",
           "ZOO_TPU_PLATFORM": "cpu", "ZOO_TPU_NUM_PROCESSES": "3",
           "ZOO_TPU_SEED": "17", "ZOO_TPU_COORDINATOR_ADDRESS":
           "127.0.0.1:7001", "ZOO_TPU_BATCH_SIZE": "64",
           "ZOO_TPU_SHUFFLE": "false", "ZOO_TPU_GRADIENT_CLIP_NORM": "1.5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = tconfig.config_to_dict(tconfig.apply_env_overrides(
        tconfig.RuntimeConfig()))
    want = jconfig.config_to_dict(jconfig.apply_env_overrides(
        jconfig.RuntimeConfig()))
    assert got == want
    assert got["mesh"]["tp"] == 2 and got["precision"]["compute_dtype"] == \
        "bfloat16" and got["coordinator_address"] == "127.0.0.1:7001"
    tt = tconfig.apply_env_overrides(tconfig.TrainConfig())
    jt = jconfig.apply_env_overrides(jconfig.TrainConfig())
    assert tconfig.config_to_dict(tt) == jconfig.config_to_dict(jt)
    assert tt.batch_size == 64 and tt.shuffle is False


def test_cpu_context(fresh_context):
    ctx = init_zoo_context(platform="cpu", num_virtual_devices=4,
                           mesh=tconfig.MeshConfig(tp=2),
                           precision=tconfig.PrecisionConfig(
                               compute_dtype="bfloat16"))
    assert ctx.num_devices == 4 and ctx.local_devices[0].type == "cpu"
    assert (ctx.process_index, ctx.process_count) == (0, 1)
    assert isinstance(ctx.mesh, Mesh)
    assert ctx.mesh.shape == dict(zip(ctx.mesh.axis_names,
                                      jconfig.MeshConfig(tp=2).sizes(4)))
    assert ctx.mesh.devices.shape == (2, 1, 2, 1, 1, 1)
    assert tmod.compute_dtype() == torch.bfloat16
    assert get_zoo_context() is ctx
    with ctx as entered:
        assert entered is ctx
    # a mesh of more than one device outside a torch.distributed job
    with pytest.raises(ValueError, match="needs a torch.distributed job"):
        Estimator(torch.nn.Linear(2, 2), optimizer="sgd", device="cpu")
    reset_zoo_context()
    assert tmod.compute_dtype() == torch.float32
    with pytest.raises(RuntimeError, match="init_zoo_context"):
        get_zoo_context(auto_init=False)
    # with no context the Estimator makes none and trains alone
    est = Estimator(torch.nn.Linear(2, 2), optimizer="sgd", device="cpu")
    assert est.mesh is None
    with pytest.raises(RuntimeError, match="init_zoo_context"):
        get_zoo_context(auto_init=False)
    ctx = init_zoo_context(platform="cpu")
    assert ctx.num_devices == 1 and set(ctx.mesh.shape.values()) == {1}
    assert build_mesh(tconfig.MeshConfig(), ctx.devices).size == 1
    assert Estimator(torch.nn.Linear(2, 2), optimizer="sgd",
                     device="cpu").mesh is ctx.mesh


def test_a_host_with_two_cards_still_trains_on_one(fresh_context,
                                                   monkeypatch):
    """Two visible cards: a CUDA context holds the process's current card
    only, and an Estimator with no context neither makes one nor lays a
    mesh over every device (here the two virtual CPU devices the
    environment asks for): it trains on its own."""
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    ctx = init_zoo_context(platform="cuda")
    assert ctx.local_devices == [torch.device("cuda", 1)]
    assert (ctx.num_devices, ctx.mesh.size) == (1, 1)
    reset_zoo_context()
    monkeypatch.setenv("ZOO_TPU_NUM_VIRTUAL_DEVICES", "2")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = x.sum(1, keepdims=True).astype(np.float32)
    model = Sequential([TL.Dense(1, input_shape=(4,))], device="cpu")
    est = Estimator(model, optimizer="sgd", loss="mse", device="cpu",
                    config=tconfig.TrainConfig(log_every_n_steps=1))
    assert est.mesh is None
    est.fit((x, y), batch_size=8, epochs=2)
    losses = [h["loss"] for h in est.history]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    with pytest.raises(RuntimeError, match="init_zoo_context"):
        get_zoo_context(auto_init=False)


def test_context_needs_cuda_or_a_platform(fresh_context):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default platform is the card")
    with pytest.raises(RuntimeError, match="platform='cpu'"):
        init_zoo_context()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_zoo_context()
    with pytest.raises(ValueError, match="platform"):
        init_zoo_context(platform="tpu")


def test_xprof_trace_and_annotate(tmp_path):
    lin = torch.nn.Linear(8, 8)
    hist = telemetry.default_registry()._families[
        "zoo_span_duration_seconds"]
    before = hist.labels(span="p18.region").snapshot()["count"]
    with profiling.xprof_trace(str(tmp_path)):
        with profiling.annotate("p18.region"):
            lin(torch.ones(4, 8)).sum().backward()
    assert hist.labels(span="p18.region").snapshot()["count"] == before + 1
    with open(tmp_path / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "p18.region" in names
    assert any(n and "addmm" in n for n in names)


def test_profile_steps_returns_the_median_of_the_traced_steps(tmp_path):
    calls = []

    def step(i):
        calls.append(i)
        return torch.full((2,), float(i))

    ms = profiling.profile_steps(step, [(i,) for i in range(6)],
                                 str(tmp_path), warmup=2, steps=3)
    assert calls == [0, 1, 2, 3, 4]
    assert ms >= 0 and os.path.isfile(tmp_path / profiling.TRACE_FILE)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step_0", "step_1", "step_2"} <= names and "step_3" not in names
    x = np.arange(4.0)
    assert profiling.profile_steps(lambda: x, [()] * 1, str(tmp_path),
                                   warmup=0, steps=1) >= 0
