"""Retry-from-checkpoint, the SIGTERM final save and the chaos sites of
the port's ``Estimator.fit``, against the JAX package's, on the CPU.

The cases of ``tests/test_fault_injection.py`` run on the port: a step
that fails twice at iteration 7 with checkpoints every 3 iterations rolls
back to iteration 6 and re-runs its epoch (iteration 14 and epoch 3 at
the end), here beside the JAX Estimator on the same weights and data,
the two runs' steps within 1e-5; an exhausted budget raises the original
error; a SIGTERM'd training process saves a final checkpoint and exits
143, and a resume reaches the uninterrupted run's weights bit for bit.
``RetryPolicy``'s seeded backoff equals the JAX package's, and
``chaos_point("estimator.step")`` fires in both epoch runners.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common import resilience as jres
from analytics_zoo_tpu.data.featureset import FeatureSet as JFeatureSet
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import params_to_numpy, state_dict_from_jax
from analytics_zoo_tpu_torch.common import resilience as tres
from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.engine import checkpoint as tck
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _data(n=256, d=3):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype("float32")
    return x, x.sum(axis=1, keepdims=True).astype("float32")


def _port_mlp(tree=None, d=3, seed=0):
    m = Sequential([TL.Dense(4, activation="relu", input_shape=(d,)),
                    TL.Dense(1)], device="cpu", seed=seed)
    if tree is not None:
        m.load_state_dict(state_dict_from_jax(tree))
    return m


def test_retry_rolls_back_and_replays_the_epoch_as_jax_does(tmp_path):
    """tests/test_fault_injection.py::test_in_process_retry_from_checkpoint
    on both packages: 4 iterations an epoch; epoch 2 fails at iteration 7,
    rolls back to checkpoint 6, fails again, rolls back, then runs 6 -> 10;
    epoch 3 runs 10 -> 14. Every step each package ran, in order, within
    1e-5, and the final weights too."""
    jm = JSequential([JL.Dense(4, activation="relu", input_shape=(3,)),
                      JL.Dense(1)])
    params, _ = jm.build(jax.random.PRNGKey(0), (3,))
    tree = jax.tree_util.tree_map(np.asarray, params)
    x, y = _data()
    cfg = dict(checkpoint_every_n_iters=3, retry_times=3, log_every_n_steps=1)

    jest = JEstimator(jm, optimizer="adam", loss="mse", mesh=_mesh(),
                      config=jconfig.TrainConfig(
                          checkpoint_dir=str(tmp_path / "j"), **cfg))
    jest.initial_weights = (params, {})
    real, jfails, jlosses = jest._make_train_step(), {"left": 2}, []

    def jflaky(state, batch):
        if int(state["step"]) == 7 and jfails["left"] > 0:
            jfails["left"] -= 1
            raise RuntimeError("injected failure")
        state, (loss, gnorm) = real(state, batch)
        jlosses.append(float(loss))
        return state, (loss, gnorm)

    jest._train_step = jflaky
    jest.fit(JFeatureSet.from_numpy(x, y), batch_size=64, epochs=3)

    est = Estimator(_port_mlp(tree), optimizer="adam", loss="mse",
                    config=TrainConfig(checkpoint_dir=str(tmp_path / "t"),
                                       **cfg))
    step, fails, losses = est._step, {"left": 2}, []

    def flaky(batch):
        if est.train_state["step"] == 7 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("injected failure")
        loss, gnorm = step(batch)
        losses.append(float(loss))
        return loss, gnorm

    est._step = flaky
    est.fit(FeatureSet.from_numpy(x, y), batch_size=64, epochs=3)
    assert jfails["left"] == fails["left"] == 0
    assert est.trainer_state.iteration == 14 == jest.trainer_state.iteration
    assert est.trainer_state.epoch == 3 == jest.trainer_state.epoch
    # 7 steps before the first failure, the replay's first step (6 -> 7)
    # before the second, then 4 + 4 after the rollback to 6
    assert len(losses) == len(jlosses) == 16
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    got = params_to_numpy(est.model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jest.train_state["params"]):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=1e-5)


def test_retry_exhaustion_raises_the_original_error(tmp_path):
    x, y = np.zeros((64, 3), np.float32), np.zeros((64, 1), np.float32)
    est = Estimator(_port_mlp(), optimizer="adam", loss="mse",
                    config=TrainConfig(checkpoint_dir=str(tmp_path),
                                       checkpoint_every_n_iters=1,
                                       retry_times=2))
    step = est._step

    def always_fails(batch):
        if est.train_state["step"] >= 2:
            raise RuntimeError("permanent failure")
        return step(batch)

    est._step = always_fails
    with pytest.raises(RuntimeError, match="permanent failure"):
        est.fit((x, y), batch_size=32, epochs=3)
    # without a checkpoint directory nothing is retried
    est = Estimator(_port_mlp(), optimizer="adam", loss="mse",
                    config=TrainConfig(retry_times=5))
    est._step = lambda batch: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        est.fit((x, y), batch_size=32, epochs=1)


@pytest.mark.parametrize("cached", [False, True], ids=["stream", "cached"])
def test_a_chaos_fault_at_the_step_site_rolls_back(tmp_path, cached):
    """``chaos_point("estimator.step")`` fires once a step (once a block
    on the cached path); a fault there rolls back to the last checkpoint
    and the run ends where an unfaulted one does, on the same weights."""
    x, y = _data(128)
    cfg = dict(checkpoint_every_n_iters=2, cache_on_device=cached,
               scan_block_steps=2, shuffle=False)
    clean = Estimator(_port_mlp(seed=1), optimizer="adam", loss="mse",
                      config=TrainConfig(**cfg))
    clean.fit((x, y), batch_size=32, epochs=2)
    est = Estimator(_port_mlp(seed=1), optimizer="adam", loss="mse",
                    config=TrainConfig(checkpoint_dir=str(tmp_path), **cfg))
    # stream: the 5th step is epoch 2's first; cached: the 3rd block is
    with ChaosSchedule().fail("estimator.step", at=3 if cached else 5,
                              exc=RuntimeError) as sched:
        est.fit((x, y), batch_size=32, epochs=2)
    assert sched.occurrences("estimator.step") == (5 if cached else 9)
    assert est.trainer_state.iteration == 8
    for (n, a), (_, b) in zip(clean.model.state_dict().items(),
                              est.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_retry_policy_delays_equal_jax():
    for seed in (0, 3, 11):
        kw = dict(max_attempts=6, base_delay_s=0.1, max_delay_s=1.0,
                  jitter=0.1, seed=seed)
        assert list(tres.RetryPolicy(**kw).delays()) == \
            list(jres.RetryPolicy(**kw).delays())
        tj, tt = (m.RetryPolicy(**kw).tracker() for m in (jres, tres))
        for _ in range(5):
            assert tt.record_failure(RuntimeError("x")) == \
                tj.record_failure(RuntimeError("x"))
        with pytest.raises(tres.RetryExhaustedError):
            tt.record_failure(RuntimeError("x"))
    clock = iter([0.0, 5.0])
    tr = tres.RetryPolicy(base_delay_s=1.0, deadline_s=3.0,
                          clock=lambda: next(clock)).tracker()
    with pytest.raises(tres.DeadlineExceededError):
        tr.record_failure(RuntimeError("late"))


SIGTERM_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, {repo!r})

    from analytics_zoo_tpu_torch.common.chaos import (ChaosSchedule,
                                                      install_chaos)
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as L
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    # slow every step so the SIGTERM lands mid-training
    install_chaos(ChaosSchedule().delay("estimator.step", at=None,
                                        seconds=0.05))
    model = Sequential([L.Dense(8, activation="relu", input_shape=(4,)),
                        L.Dense(1)], device="cpu", seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype("float32")
    y = x.sum(axis=1, keepdims=True).astype("float32")
    est = Estimator(model, optimizer="adam", loss="mse",
                    config=TrainConfig(checkpoint_dir=sys.argv[1]))
    est.fit((x, y), batch_size=64, epochs=100000)
    print("FINISHED", flush=True)   # never reached
""")


def test_sigterm_saves_a_final_checkpoint_exits_143_and_resumes(tmp_path):
    """One step an epoch, so every checkpoint is at an epoch's end and the
    resumed run follows the uninterrupted one exactly."""
    script = tmp_path / "worker.py"
    script.write_text(SIGTERM_WORKER.format(repo=REPO))
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.Popen([sys.executable, str(script), ckpt],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while tck.latest_checkpoint(ckpt) is None:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline, "no checkpoint within 120 s"
            time.sleep(0.05)
        first = tck.read_manifest(tck.latest_checkpoint(ckpt))["iteration"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143, err.decode()[-2000:]
    assert b"FINISHED" not in out
    final = tck.verify_checkpoint(tck.latest_checkpoint(ckpt))
    assert final["iteration"] >= first and final["epoch"] == \
        final["iteration"]
    x = np.random.default_rng(0).standard_normal((64, 4)).astype("float32")
    y = x.sum(axis=1, keepdims=True).astype("float32")
    epochs = final["iteration"] + 3

    def model():
        return Sequential([TL.Dense(8, activation="relu", input_shape=(4,)),
                           TL.Dense(1)], device="cpu", seed=0)

    resumed = Estimator(model(), optimizer="adam", loss="mse",
                        config=TrainConfig(checkpoint_dir=ckpt))
    resumed.fit((x, y), batch_size=64, epochs=epochs)
    straight = Estimator(model(), optimizer="adam", loss="mse")
    straight.fit((x, y), batch_size=64, epochs=epochs)
    assert resumed.trainer_state.iteration == epochs
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_fit_restores_the_previous_sigterm_handler(tmp_path):
    def mine(*_):
        pass

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        x, y = _data(64)
        Estimator(_port_mlp(), optimizer="sgd", loss="mse", config=TrainConfig(
            checkpoint_dir=str(tmp_path))).fit((x, y), batch_size=32)
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, prev)
