"""The port's orca (``TaskPool``, the orca ``Estimator``, ``PPOTrainer``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_task_pool.py``, the orca cases of
``tests/test_orca_cluster.py``, the two TaskPool cases of
``tests/test_fault_injection.py`` and ``tests/test_rl.py`` (the knobs'
update-sharding case of ``tests/test_update_sharding.py`` is in
``tests/test_torch_update_sharding.py``, in that module's rank pool).

Held: tasks, closures, errors, actor ordering, a dead worker failing its
futures, respawn under a chaos kill, the chaos drill with serving, and that
a task sees no card (``CUDA_VISIBLE_DEVICES == ""``, no JAX loaded); the
async parameter-server loop of ``examples/rl_parameter_server.py`` on the
pool gives the serial loop's weights exactly; ``XShards.parallel_apply``
gives the serial apply; the orca Estimator's fit, evaluate and predict
over numpy, dicts, XShards of DataFrames and the host-sharded path are
the JAX Estimator's within 1e-5 from the same weights (save/load both
ways; the sticky knobs raise after training and leave the config as it
was); PPO's rollouts are JAX's exactly and one round's update is JAX's
within 1e-5.

This module's functions and classes are sent to the workers by value, so
the workers never import it (nor JAX).
"""

import concurrent.futures as cf
import importlib.util
import os
import signal
import sys
import time

import cloudpickle
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data.xshards import XShards as JXShards
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu.orca import CatchEnv as JCatchEnv
from analytics_zoo_tpu.orca import Estimator as JEstimator
from analytics_zoo_tpu.orca import PPOTrainer as JPPOTrainer
from analytics_zoo_tpu.orca import rl as jrl
from analytics_zoo_tpu.orca.learn import estimator as jorca_est
from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule
from analytics_zoo_tpu_torch.data.xshards import XShards
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential
from analytics_zoo_tpu_torch.orca import (CatchEnv, Estimator, PPOTrainer,
                                          TaskPool, pool_rank, pool_world)
from analytics_zoo_tpu_torch.orca import rl as trl
from analytics_zoo_tpu_torch.orca.learn import estimator as orca_est

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def pool():
    with TaskPool(2) as p:
        yield p


def _square(x):
    return x * x


class Counter:
    def __init__(self, start=0):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n

    def value(self):
        return self.n


def _worker_view():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "analytics_zoo_tpu")))


# ------------------------------------------------------------------ TaskPool
def test_submit_and_map(pool):
    futs = [pool.submit(_square, i) for i in range(8)]
    assert [f.result(timeout=60) for f in futs] == [i * i for i in range(8)]
    assert pool.map(_square, [3, 4, 5]) == [9, 16, 25]


def test_closures_and_arrays(pool):
    bias = np.arange(4.0)
    f = pool.submit(lambda x: x + bias, np.ones(4))
    np.testing.assert_allclose(f.result(timeout=60), bias + 1)


def test_task_error_propagates(pool):
    f = pool.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        f.result(timeout=60)
    assert pool.submit(_square, 6).result(timeout=60) == 36


def test_actor_state_and_ordering(pool):
    c = pool.actor(Counter, start=10)
    futs = [c.add(1) for _ in range(20)]
    assert [f.result(timeout=60) for f in futs] == list(range(11, 31))
    assert c.value().result(timeout=60) == 30
    c.terminate()


def test_two_actors_isolated(pool):
    a = pool.actor(Counter, worker=0)
    b = pool.actor(Counter, worker=1)
    a.add(5)
    assert b.value().result(timeout=60) == 0
    assert a.value().result(timeout=60) == 5


def test_pool_rank_world_defaults():
    assert pool_rank() == 0 and pool_world() == 1


def test_tasks_run_without_the_card(pool):
    """Every worker hides the card before anything can initialise CUDA,
    and none loads JAX or the JAX package; a port entry point in a task
    with no device given raises, as on a host with no card."""
    for visible, mods in pool.map(lambda _: _worker_view(), range(4)):
        assert visible == "" and mods == []

    def build():
        from analytics_zoo_tpu_torch.nn import layers as L
        from analytics_zoo_tpu_torch.nn.topology import Sequential as S

        return S([L.Dense(2, input_shape=(3,))])

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pool.submit(build).result(timeout=60)


def _ps_example():
    spec = importlib.util.spec_from_file_location(
        "rl_ps", os.path.join(ROOT, "examples", "rl_parameter_server.py"))
    rl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rl)
    return rl


def test_parameter_server_loop(pool):
    """The async-PS round trip of ``examples/rl_parameter_server.py``
    (rollout tasks push gradients to a PS actor), driven inline: the
    weights after 3 rounds are the serial loop's exactly."""
    rl = _ps_example()
    ps = pool.actor(rl.ParameterServer, lr=1.0)
    serial = rl.ParameterServer(lr=1.0)
    for it in range(3):
        w = ps.get_weights().result(timeout=120)
        np.testing.assert_array_equal(w, serial.get_weights())
        grad, mean_r = pool.submit(rl.rollout_batch, w, it, 4).result(
            timeout=120)
        want_grad, want_r = rl.rollout_batch(serial.get_weights(), it, 4)
        np.testing.assert_array_equal(grad, want_grad)
        assert mean_r == want_r and -1.0 <= mean_r <= 1.0
        assert ps.apply_gradients(grad).result(timeout=120) == \
            serial.apply_gradients(want_grad)
    got = ps.call("get_weights").result(timeout=120)
    assert got.any()
    np.testing.assert_array_equal(got, serial.get_weights())
    ps.terminate()


def test_parallel_apply_matches_serial(pool):
    shards = XShards.partition({"a": np.arange(24, dtype="float32")},
                               num_partitions=3)
    lazy = shards.transform_shard(lambda p: {"a": p["a"] * 3}, lazy=True)
    par = lazy.parallel_apply(lambda p: {"a": p["a"] + 1}, pool=pool)
    np.testing.assert_allclose(par.collect_tree()["a"],
                               np.arange(24) * 3 + 1)
    # a pool of its own (spawned and shut down inside) gives the same
    again = lazy.parallel_apply(lambda p: {"a": p["a"] + 1}, num_workers=2)
    np.testing.assert_array_equal(again.collect_tree()["a"],
                                  par.collect_tree()["a"])
    jpar = JXShards.partition({"a": np.arange(24, dtype="float32")},
                              num_partitions=3).transform_shard(
        lambda p: {"a": p["a"] * 3 + 1})
    np.testing.assert_array_equal(par.collect_tree()["a"],
                                  jpar.collect_tree()["a"])


def test_worker_death_fails_futures_instead_of_hanging():
    with TaskPool(1) as p:
        assert p.submit(_square, 3).result(timeout=60) == 9
        victim = p._procs[0].pid
        fut = p.submit(time.sleep, 30)
        os.kill(victim, signal.SIGKILL)
        with pytest.raises(RuntimeError, match="died"):
            fut.result(timeout=30)
        with pytest.raises(RuntimeError, match="died"):
            p.submit(_square, 1)


def test_dead_worker_resubmission_and_actor_respawn():
    """A scheduled hard kill (exit 137) of worker 1 at its 2nd task: every
    future still resolves, and the actor homed there is re-instantiated
    with its ``on_respawn`` state pushed back."""
    sched = ChaosSchedule(seed=11).kill("task_pool.worker", at=2, tag=1,
                                        exit_code=137)
    restored = []

    def push_state_back(handle):
        restored.append(True)
        handle.add(5)

    with sched:
        pool = TaskPool(2, respawn=True, heartbeat_interval_s=0.1)
    with pool:
        c = pool.actor(Counter, worker=1, on_respawn=push_state_back)
        assert c.add(5).result(timeout=60) == 5
        futs = [pool.submit(_square, i) for i in range(8)]
        assert [f.result(timeout=120) for f in futs] == \
            [i * i for i in range(8)]
        assert pool.workers_respawned >= 1
        assert restored, "on_respawn callback never ran"
        assert c.value().result(timeout=60) == 5


def test_chaos_drill_end_to_end_zero_loss():
    """One seeded schedule kills a serving infer worker, drops a broker
    connection under the engine's source and hard-kills a TaskPool
    worker: every request and every task is answered."""
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 OutputQueue, ServingConfig,
                                                 start_broker)

    model = Sequential([TL.Dense(16, activation="relu", input_shape=(8,)),
                        TL.Dense(4, activation="softmax")], device="cpu")
    x = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    with torch.no_grad():
        want = model.apply(torch.from_numpy(x)).numpy()
    sched = (ChaosSchedule(seed=7)
             .kill("serving.infer", at=2, tag=0)
             .fail("conn.call", at=5, exc=ConnectionError,
                   tag="engine.source")
             .kill("task_pool.worker", at=2, tag=0, exit_code=137))
    broker = start_broker()
    with sched:
        cfg = ServingConfig(batch_size=4, queue_port=broker.port,
                            infer_workers=2)
        job = ClusterServing(model, cfg, group="chaos-drill",
                             device="cpu").start()
        pool = TaskPool(2, respawn=True, heartbeat_interval_s=0.1)
        try:
            iq = InputQueue(port=broker.port)
            oq = OutputQueue(port=broker.port)
            futs = [pool.submit(_square, i) for i in range(8)]
            uris = [iq.enqueue(None, input=x[i]) for i in range(20)]
            for i, uri in enumerate(uris):
                np.testing.assert_allclose(oq.query(uri, timeout_s=60),
                                           want[i], rtol=1e-4, atol=1e-5)
            assert [f.result(timeout=120) for f in futs] == \
                [i * i for i in range(8)]
            assert job.workers_respawned >= 1
            assert pool.workers_respawned >= 1
            assert sched.occurrences("conn.call", tag="engine.source") >= 5
            iq.close()
            oq.close()
        finally:
            pool.shutdown()
            job.stop()
    broker.shutdown()


# -------------------------------------------------------- orca Estimator
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp_pair(in_dim=3, out_dim=1, seed=0):
    jm = JSequential()
    jm.add(JL.InputLayer((in_dim,)))
    jm.add(JL.Dense(8, activation="relu"))
    jm.add(JL.Dense(out_dim))
    tm = Sequential(device="cpu")
    tm.add(TL.InputLayer((in_dim,)))
    tm.add(TL.Dense(8, activation="relu"))
    tm.add(TL.Dense(out_dim))
    params, state = jm.build(jax.random.PRNGKey(seed))
    params, state = _np(params), _np(state)
    tm.load_state_dict(params_from_jax(params))
    return jm, tm, params, state


def _orca_pair(in_dim=3, out_dim=1, **kw):
    """The JAX and the port orca Estimators over the same weights."""
    jm, tm, params, state = _mlp_pair(in_dim, out_dim)
    jest = JEstimator.from_keras(jm, **kw)
    jest._ensure_compiled()
    jm.estimator.initial_weights = (params, state)
    return jest, Estimator.from_keras(tm, **kw), jm, tm


def _same_params(jm, tm):
    jp = _np(jm.estimator.train_state["params"])
    tp = params_to_numpy(tm)
    for slot, leaves in jp.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(tp[slot][leaf], v, rtol=0, atol=TOL,
                                       err_msg=f"{slot}.{leaf}")


def _fit_counts():
    fam = ttm.snapshot().get("zoo_orca_fit_total", {})
    return dict(fam.get("samples", {}))


def test_orca_estimator_numpy_and_dict_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 3)).astype("float32")
    y = x.sum(axis=1, keepdims=True)
    jest, est, jm, tm = _orca_pair(loss="mse", optimizer="adam")
    before = _fit_counts()
    for e in (jest, est):
        e.fit({"x": x, "y": y}, epochs=3, batch_size=16)
    after = _fit_counts()
    key = next(k for k in after if "dict" in k)
    assert after[key] == before.get(key, 0) + 1
    _same_params(jm, tm)
    jev, tev = jest.evaluate((x, y), metrics=["mse"]), \
        est.evaluate((x, y), metrics=["mse"])
    np.testing.assert_allclose(list(tev.values()), list(jev.values()),
                               rtol=0, atol=TOL)
    pred = est.predict(x)
    assert pred.shape == (64, 1)
    np.testing.assert_allclose(pred, jest.predict(x), rtol=0, atol=TOL)
    stats = est.train_stats()
    assert stats and all(k.startswith(("zoo_train_", "zoo_data_"))
                         or k == "zoo_summary_scalar" for k in stats)


def test_orca_estimator_xshards_dataframe_matches_jax():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"f1": rng.standard_normal(80),
                       "f2": rng.standard_normal(80)})
    df["y"] = df["f1"] - df["f2"]
    jest, est, jm, tm = _orca_pair(2, loss="mse")
    outs = []
    for e, xs in ((jest, JXShards), (est, XShards)):
        shards = xs.partition(df, num_partitions=4)
        e.fit(shards, epochs=2, batch_size=16, feature_cols=["f1", "f2"],
              label_cols=["y"])
        outs.append(e.predict(shards, feature_cols=["f1", "f2"]))
    _same_params(jm, tm)
    jout, out = outs
    assert isinstance(out, XShards) and out.num_partitions() == 4
    assert sum(len(p) for p in out.collect()) == 80
    for a, b in zip(out.collect(), jout.collect()):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # a DataFrame as it is: the same arrays as the JAX marshalling
    tx, ty = orca_est._marshal(df, ["f1", "f2"], ["y"])
    jx, jy = jorca_est._marshal(df, ["f1", "f2"], ["y"])
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError, match="feature_cols"):
        orca_est._marshal(df)


def test_orca_estimator_save_load_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 3)).astype("float32")
    y = x[:, :1]
    jest, est, jm, tm = _orca_pair(loss="mse")
    jest.fit((x, y), epochs=1)
    est.fit((x, y), epochs=1)
    pred = est.predict(x)
    p, jp = str(tmp_path / "m"), str(tmp_path / "jm")
    est.save(p)
    jest.save(jp)
    for path, want in ((p, pred), (jp, jest.predict(x))):
        est2 = Estimator.from_keras(_mlp_pair(seed=3)[1], loss="mse")
        est2.fit((x, y), epochs=0)
        est2.load(path)
        np.testing.assert_allclose(est2.predict(x), want, rtol=0, atol=TOL)
    assert est.get_model() is tm


def test_orca_host_sharded_featureset_lockstep_matches_jax():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": np.arange(40.0), "b": np.arange(40.0) * 2,
                       "label": (np.arange(40) % 2).astype("float64")})
    for r in range(2):
        fs = orca_est.host_sharded_featureset(
            XShards.partition(df, num_partitions=8), ["a", "b"], ["label"],
            process_index=r, process_count=2)
        jfs = jorca_est.host_sharded_featureset(
            JXShards.partition(df, num_partitions=8), ["a", "b"], ["label"],
            process_index=r, process_count=2)
        assert fs.num_batches(10) == jfs.num_batches(10) == 4
        for b, jb in zip(fs.batches(10, epoch=0, shuffle=True),
                         jfs.batches(10, epoch=0, shuffle=True)):
            assert b[0].shape == (5, 2) and b[1].shape == (5, 1)
            np.testing.assert_array_equal(b[0], jb[0])
            np.testing.assert_array_equal(b[1], jb[1])


def test_orca_host_sharding_guards_empty_and_unbalanced():
    small = XShards.partition(np.arange(8.0), num_partitions=2)
    with pytest.raises(ValueError, match="no data"):
        orca_est.host_sharded_featureset(small, process_index=0,
                                         process_count=4)
    uneven = XShards([np.arange(10.0), np.arange(10.0, 14.0)])
    fss = [orca_est.host_sharded_featureset(uneven, process_index=r,
                                            process_count=2)
           for r in range(2)]
    assert fss[0].num_batches(4) == fss[1].num_batches(4)
    n0 = sum(b.shape[0] for (b,) in fss[0].batches(4))
    n1 = sum(b.shape[0] for (b,) in fss[1].batches(4))
    assert n0 == n1


def test_orca_fit_with_host_sharding_single_process_matches_jax():
    """host_sharding=True in one process is the whole dataset."""
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(64, 6)).astype("float32"),
            "y": rng.normal(size=(64, 1)).astype("float32")}
    jest, est, jm, tm = _orca_pair(6, loss="mse", optimizer="adam")
    for e, xs in ((jest, JXShards), (est, XShards)):
        shards = xs.partition(data, num_partitions=4).transform_shard(
            lambda p: (p["x"], p["y"]))
        e.fit(shards, epochs=2, batch_size=16, host_sharding=True)
    assert np.isfinite(tm.estimator.trainer_state.last_loss)
    np.testing.assert_allclose(tm.estimator.trainer_state.last_loss,
                               float(jm.estimator.trainer_state.last_loss),
                               rtol=0, atol=TOL)
    _same_params(jm, tm)


def test_orca_sticky_knobs_raise_after_training_and_leave_the_config():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    jest, est, jm, tm = _orca_pair(loss="mse")
    for e in (jest, est):
        e.fit((x, y), epochs=1, batch_size=16, grad_accum_steps=2,
              prefetch_depth=0)
    _same_params(jm, tm)
    cfg = tm.estimator.config
    assert cfg.grad_accum_steps == 2 and cfg.prefetch_depth == 2
    snapshot = dict(vars(cfg))
    for kw in ({"grad_accum_steps": 4}, {"compute_dtype": "bfloat16"},
               {"update_sharding": True}):
        for e in (jest, est):
            with pytest.raises(RuntimeError, match="cannot change"):
                e.fit((x, y), epochs=1, batch_size=16, **kw)
        assert vars(cfg) == snapshot
    # the same values again are no change
    est.fit((x, y), epochs=1, batch_size=16, grad_accum_steps=2)


def test_orca_compute_dtype_before_training_switches_to_masters():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    y = rng.normal(size=(32, 1)).astype(np.float32)
    _, est, _, tm = _orca_pair(loss="mse")
    est.fit((x, y), epochs=1, batch_size=16, compute_dtype="bfloat16")
    assert tm.estimator.config.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert np.isfinite(tm.estimator.trainer_state.last_loss)


# -------------------------------------------------------------------- PPO
def test_env_contract():
    env = CatchEnv(seed=3)
    obs = env.reset()
    assert obs.shape == (env.obs_dim,)
    total, steps, done = 0.0, 0, False
    while not done:
        obs, r, done, info = env.step(1)
        total += r
        steps += 1
    assert steps == env.H - 1 and total in (-1.0, 1.0)


def test_rollouts_are_jax_exactly():
    w = trl._mlp_init(64, 64, 3, 0)
    jw = jrl._mlp_init(64, 64, 3, 0)
    for k in w:
        np.testing.assert_array_equal(w[k], jw[k])
    got = trl.collect_rollouts(w, CatchEnv, 6, 0.99, 17)
    want = jrl.collect_rollouts(jw, JCatchEnv, 6, 0.99, 17)
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[5] == want[5]


def test_ppo_update_matches_jax():
    """Two rounds from the same rollouts (a thread pool on both sides):
    the result dicts are equal and the weights within 1e-5 of JAX's."""
    cfg = {"num_workers": 2, "episodes_per_worker": 4}
    with cf.ThreadPoolExecutor(2) as ex:
        tr = PPOTrainer(CatchEnv, config=cfg, pool=ex, device="cpu")
        jtr = JPPOTrainer(JCatchEnv, config=cfg, pool=ex)
        for _ in range(2):
            assert tr.train() == jtr.train()
            for k, v in jtr.get_weights().items():
                np.testing.assert_allclose(tr.get_weights()[k], v, rtol=0,
                                           atol=TOL, err_msg=k)
            # the next round starts from the same weights on both sides
            tr.set_weights(jtr.get_weights())


def test_ppo_train_round_and_result_dict(pool):
    with PPOTrainer(CatchEnv, config={"num_workers": 2,
                                      "episodes_per_worker": 4},
                    pool=pool, device="cpu") as tr:
        r1 = tr.train()
        r2 = tr.train()
    assert r1["training_iteration"] == 1 and r2["training_iteration"] == 2
    assert r1["episodes_this_iter"] == 8
    assert r1["timesteps_this_iter"] == 8 * (CatchEnv.H - 1)
    assert -1.0 <= r1["episode_reward_mean"] <= 1.0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPOTrainer(CatchEnv, pool=pool)


def test_weight_sync_between_trainers():
    with cf.ThreadPoolExecutor(1) as ex:
        a = PPOTrainer(CatchEnv, config={"num_workers": 1,
                                         "episodes_per_worker": 2,
                                         "seed": 0}, pool=ex, device="cpu")
        b = PPOTrainer(CatchEnv, config={"num_workers": 1,
                                         "episodes_per_worker": 2,
                                         "seed": 9}, pool=ex, device="cpu")
        a.train()
        assert any(np.abs(a.get_weights()[k] - b.get_weights()[k]).max() > 0
                   for k in a.get_weights())
        b.set_weights(a.get_weights())
        for k, v in a.get_weights().items():
            np.testing.assert_array_equal(v, b.get_weights()[k])
        a.stop()
        b.stop()
