"""ZeRO-1 update sharding and data parallelism in the PyTorch port, in 4
spawned gloo ranks on the CPU, against the JAX Estimator on a dp=4 mesh of
the 8-device CPU mesh.

Held: ``shard_spec_over_axis`` and ``make_update_sharding`` equal JAX's
over a grid of shapes and base specs; ``flat_meta`` and
``flatten_tree``/``unflatten_tree`` equal JAX's (leaf order, padding,
values); ``Estimator(update_sharding="flat")`` on dp=4 gives the JAX flat
Estimator's per-step losses and final parameters within 1e-5 over 3 steps
(f32, also with bf16 params and f32 masters within bf16 tolerance), as do
the replicated update and the per-leaf (``"gspmd"``) update, one of them
with a row-sharded table; the flat step issues exactly one reduce-scatter
and one all-gather a global step under ``grad_accum_steps=2`` (and two
all-reduces: the norm and the loss), by the port's collective counter;
with dropout on, the flat step folds the dp index into its key and the
replicated step draws the global batch's mask, as JAX does (losses within
1e-5); a flat checkpoint written by the port is the JAX layout and resumes
both ways; the optimizer state is 1/dp a rank; ``graph_checks="raise"``
passes the flat step's collective budget and fails an all-reduce exchange
before the first update, in both packages; BatchNormalization trains on
dp=4 with JAX's statistics (global under the replicated update, local
then averaged under the flat one), its moving statistics within 1e-5.
One rank pool serves the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu.parallel import update_sharding as jupd
from analytics_zoo_tpu_torch.common.config import TrainConfig, check_ported
from analytics_zoo_tpu_torch.parallel import comm
from analytics_zoo_tpu_torch.parallel import update_sharding as tupd
from analytics_zoo_tpu_torch.parallel.sharding import P

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
TOL = 1e-5
D_IN, N_ROWS, BATCH = 6, 64, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh(dp=4):
    return Mesh(np.array(jax.devices()[:dp]).reshape((dp,) + (1,) * 5), AXES)


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = {a: shape.get(a, 1) for a in AXES}


@pytest.fixture(scope="module")
def pool():
    p = comm.RankPool(4, device="cpu", timeout_s=600)
    yield p
    p.close()


# ------------------------------------------------------------ pure specs
SHAPES = [(64, 8), (8, 64), (6, 4096), (7, 64), (3, 5), (), (4, 4),
          (4, 64, 8), (16,), (12, 6, 4)]
BASES = [(), ("dp", None), ("tp", None), ("fsdp", "tp"), ("pp",)]


@pytest.mark.parametrize("base", BASES)
def test_shard_spec_over_axis_equals_jax(base):
    jm = _FakeMesh(dp=4, fsdp=2, tp=2, pp=2)
    for shape in SHAPES:
        want = jupd.shard_spec_over_axis(JP(*base), shape, jm, "dp")
        got = tupd.shard_spec_over_axis(P(*base), shape, jm, "dp")
        assert tuple(got) == tuple(want), (base, shape)
        rule = tupd.make_update_sharding(jm, lambda p, l, b=base: P(*b))
        jrule = jupd.make_update_sharding(jm, lambda p, l, b=base: JP(*b))
        leaf = np.zeros(shape, np.float32)
        assert tuple(rule("x", leaf)) == tuple(jrule(None, leaf))


def _tree(dtype=np.float32):
    rng = np.random.default_rng(0)
    return {"b_dense": {"kernel": rng.normal(size=(5, 3)).astype(dtype),
                        "bias": rng.normal(size=(3,)).astype(dtype)},
            "a_emb": {"embeddings": rng.normal(size=(7, 2)).astype(dtype)},
            "block10": {"w": rng.normal(size=(2,)).astype(dtype)},
            "block2": {"w": rng.normal(size=(1,)).astype(dtype)}}


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_flat_meta_and_flatten_equal_jax(n_shards):
    from analytics_zoo_tpu_torch.bridge import params_from_jax

    tree = _tree()
    jm = jupd.flat_meta(tree, n_shards)
    flat = params_from_jax(tree)
    tm = tupd.flat_meta(flat, n_shards)
    assert (tm.n, tm.npad, tm.shard_size) == (jm.n, jm.npad, jm.shard_size)
    assert tm.shapes == jm.shapes and tm.sizes == jm.sizes
    jv = np.asarray(jupd.flatten_tree(tree, jm))
    tv = tupd.flatten_tree(flat, tm)
    np.testing.assert_array_equal(tv.numpy(), jv)
    back = tupd.unflatten_tree(tv * 2, tm)
    jback = _np(jupd.unflatten_tree(jnp.asarray(jv) * 2, jm))
    for name, t in back.items():
        node = jback
        for k in name.split("."):
            node = node[k]
        np.testing.assert_array_equal(t.numpy(), node)


def test_update_sharding_is_accepted():
    for us in (True, "flat", "gspmd"):
        check_ported(TrainConfig(update_sharding=us))


# --------------------------------------------------------- training parity
def _jax_model(dropout):
    layers = [JL.Dense(16, activation="relu", input_shape=(D_IN,))]
    if dropout:
        layers.append(JL.Dropout(0.3))
    layers += [JL.Dense(8, activation="tanh"), JL.Dense(3)]
    return JSequential(layers)


def _port_model(dropout):
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    layers = [TL.Dense(16, activation="relu", input_shape=(D_IN,))]
    if dropout:
        layers.append(TL.Dropout(0.3))
    layers += [TL.Dense(8, activation="tanh"), TL.Dense(3)]
    return Sequential(layers, device="cpu")


def _data(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_ROWS, D_IN)).astype(np.float32)
    y = rng.normal(size=(N_ROWS, 3)).astype(np.float32)
    return x, y


def _ctx(**axes):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    reset_zoo_context()
    return init_zoo_context(platform="cpu", mesh=MeshConfig(**axes))


def _port_fit(tree, dropout, steps, cfg, counts=False, ckpt_dir=None,
              epochs=None):
    """Rank side: the port's Estimator on dp=4 from the JAX weights; losses
    a step (and, with ``counts``, the collectives each step issued), the
    final params and the optimizer state's bytes on this rank."""
    from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
    from analytics_zoo_tpu_torch.common.triggers import MaxIteration
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import optimizers as topt

    _ctx(dp=4)
    tm = _port_model(dropout)
    tm.load_state_dict(params_from_jax(tree))
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss="mse",
                    config=TrainConfig(checkpoint_dir=ckpt_dir, **cfg))
    got, per_step, step = [], [], est._step

    def record(b):
        comm.reset_collective_counts()
        loss, gnorm = step(b)
        per_step.append(comm.collective_counts())
        got.append(float(loss))
        return loss, gnorm

    est._step = record
    if epochs is not None:
        est.fit(_data(), batch_size=BATCH, epochs=epochs, seed=3)
    else:
        est.fit(_data(), batch_size=BATCH, end_trigger=MaxIteration(steps),
                seed=3)
    opt_bytes = sum(t.numel() * t.element_size() for t in
                    _tensors(est.train_state["opt_state"]))
    out = {"losses": got, "params": params_to_numpy(tm),
           "opt_bytes": opt_bytes, "mode": est._update_mode()}
    if counts:
        out["counts"] = per_step
    return out


def _tensors(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in _tensors(v)]
    if isinstance(state, (tuple, list)):
        return [t for v in state for t in _tensors(v)]
    return []


def _jax_fit(params, state, dropout, steps, cfg):
    from analytics_zoo_tpu.common.triggers import MaxIteration

    jm = _jax_model(dropout)
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss="mse",
                      mesh=_mesh(4), config=jconfig.TrainConfig(**cfg))
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def record(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = record
    jest.fit(_data(), batch_size=BATCH, end_trigger=MaxIteration(steps),
             seed=3)
    return want, _np(jest.train_state["params"]), jest


def _compare(got, want, wparams, tol=TOL):
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=tol)
    for slot, d in wparams.items():
        for leaf, v in d.items():
            np.testing.assert_allclose(
                np.asarray(got["params"][slot][leaf], np.float32),
                np.asarray(v, np.float32), rtol=0, atol=tol,
                err_msg=f"{slot}.{leaf}")


CASES = {
    "flat": dict(update_sharding="flat"),
    "flat_accum2": dict(update_sharding="flat", grad_accum_steps=2),
    "gspmd": dict(update_sharding="gspmd"),
    "replicated_accum2": dict(grad_accum_steps=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dropout", [False, True])
def test_dp4_training_matches_jax(pool, case, dropout):
    """3 Adam steps on dp=4 (f32): losses and final params within 1e-5 of
    the JAX Estimator's in the same update mode. With dropout the flat
    step's key carries the dp index and the others draw the global
    batch's mask, as in JAX."""
    cfg = CASES[case]
    params, state = _jax_model(dropout).build(jax.random.PRNGKey(1))
    tree = _np(params)
    want, wparams, jest = _jax_fit(params, state, dropout, 3, cfg)
    res = pool.run(_port_fit, tree, dropout, 3, cfg)
    assert res[0]["mode"] == jest._update_mode()
    for r in res:
        _compare(r, want, wparams)


def _jax_bn_model():
    # no bias before BN: BN cancels it, and Adam would scale its
    # rounding-noise gradient up to lr a step
    return JSequential([JL.Dense(8, use_bias=False, input_shape=(D_IN,)),
                        JL.BatchNormalization(), JL.Activation("relu"),
                        JL.Dense(3)])


def _port_bn_fit(tree, state, cfg):
    """Rank side: a Dense + BatchNormalization model on dp=4 from the JAX
    weights and statistics; losses a step, the final params and buffers."""
    from analytics_zoo_tpu_torch.bridge import (params_to_numpy,
                                                state_dict_from_jax)
    from analytics_zoo_tpu_torch.common.triggers import MaxIteration
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    _ctx(dp=4)
    tm = Sequential([TL.Dense(8, use_bias=False, input_shape=(D_IN,)),
                     TL.BatchNormalization(), TL.Activation("relu"),
                     TL.Dense(3)], device="cpu")
    tm.load_state_dict(state_dict_from_jax(tree, state))
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss="mse",
                    config=TrainConfig(**cfg))
    got, step = [], est._step

    def record(b):
        loss, gnorm = step(b)
        got.append(float(loss))
        return loss, gnorm

    est._step = record
    est.fit(_data(), batch_size=BATCH, end_trigger=MaxIteration(3), seed=3)
    return {"losses": got, "params": params_to_numpy(tm),
            "mode": est._update_mode()}


@pytest.mark.parametrize("case", ["flat", "replicated_accum2"])
def test_dp4_batchnorm_training_matches_jax(pool, case):
    """BatchNormalization in training on dp=4, 3 Adam steps: the
    replicated update normalises with the global batch's statistics (an
    all-reduce whose backward all-reduces the gradient, as under JAX's
    GSPMD), the flat one with each rank's own and then averages the
    moving statistics over dp, as JAX's flat step ``pmean``s them.
    Losses, params and moving statistics within 1e-5 of JAX's on every
    rank."""
    from analytics_zoo_tpu.common.triggers import MaxIteration

    cfg = CASES[case]
    rng = np.random.default_rng(2)
    params, state = _jax_bn_model().build(jax.random.PRNGKey(1))
    state = _np(state)
    state["1_batchnormalization"] = {
        "moving_mean": rng.normal(size=8).astype(np.float32),
        "moving_var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    tree = _np(params)
    jm = _jax_bn_model()
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss="mse",
                      mesh=_mesh(4), config=jconfig.TrainConfig(**cfg))
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def record(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = record
    jest.fit(_data(), batch_size=BATCH, end_trigger=MaxIteration(3), seed=3)
    wstate = _np(jest.train_state["model_state"])
    res = pool.run(_port_bn_fit, tree, state, cfg)
    assert res[0]["mode"] == jest._update_mode()
    for r in res:
        _compare(r, want, _np(jest.train_state["params"]))
        for leaf, v in wstate["1_batchnormalization"].items():
            np.testing.assert_allclose(
                r["params"]["1_batchnormalization"][leaf], v, rtol=0,
                atol=TOL, err_msg=leaf)
    assert not np.allclose(wstate["1_batchnormalization"]["moving_mean"],
                           state["1_batchnormalization"]["moving_mean"])


def test_bf16_flat_with_f32_masters_matches_jax(pool):
    cfg = dict(update_sharding="flat", compute_dtype="bfloat16")
    params, state = _jax_model(False).build(jax.random.PRNGKey(1))
    tree = _np(params)
    want, wparams, _ = _jax_fit(params, state, False, 3, cfg)
    res = pool.run(_port_fit, tree, False, 3, cfg)
    _compare(res[0], want, wparams, tol=2e-2)


def test_flat_step_issues_one_reduce_scatter_and_one_all_gather(pool):
    cfg = dict(update_sharding="flat", grad_accum_steps=2)
    params, state = _jax_model(False).build(jax.random.PRNGKey(1))
    res = pool.run(_port_fit, _np(params), False, 3, cfg, True)
    for r in res:
        assert len(r["counts"]) == N_ROWS // BATCH     # one epoch
        for c in r["counts"]:
            assert c == {"reduce-scatter": 1, "all-gather": 1,
                         "all-reduce": 2, "all-to-all": 0,
                         "collective-permute": 0}, c


def _graph_check_fit(tree, broken):
    """Rank side: ``graph_checks="raise"`` on the flat update with
    accumulation; ``broken`` swaps the exchange for one all-reduce of the
    flat gradients (the pre-ZeRO-1 shape). Returns the rule ids raised, or
    the steps trained."""
    from analytics_zoo_tpu_torch.analysis import GraphLintError
    from analytics_zoo_tpu_torch.bridge import params_from_jax
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import optimizers as topt

    _ctx(dp=4)
    tm = _port_model(False)
    tm.load_state_dict(params_from_jax(tree))
    keep = tupd.flat_exchange
    if broken:
        def exchange(params, grads, opt_state, meta, tx, *, axis="dp",
                     mesh=None, clip_norm=None, clip_value=None):
            flat = tupd.flatten_tree(grads, meta, torch.float32)
            g = comm.psum(flat, axis, mesh=mesh)
            return params, opt_state, torch.sqrt(torch.sum(g * g))

        tupd.flat_exchange = exchange
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss="mse",
                    config=TrainConfig(update_sharding="flat",
                                       grad_accum_steps=2,
                                       graph_checks="raise"))
    try:
        est.fit(_data(), batch_size=BATCH, epochs=1, seed=3)
    except GraphLintError as e:
        return sorted({f.rule for f in e.findings}) + [str(e)]
    finally:
        tupd.flat_exchange = keep    # the pool's ranks serve later tests
    return est.trainer_state.iteration


def test_graph_checks_flat_collective_budget_both_polarities(pool):
    """The collective budget at fit start on dp=4: the flat step's one
    reduce-scatter and one all-gather (none in the accumulation loop)
    pass and train; an all-reduce exchange fails every rank before the
    first update, as the JAX check fails the same break."""
    params, state = _jax_model(False).build(jax.random.PRNGKey(1))
    assert pool.run(_graph_check_fit, _np(params), False) == \
        [N_ROWS // BATCH] * 4
    for got in pool.run(_graph_check_fit, _np(params), True):
        assert got[0] == "collective-budget" and "reduce-scatter" in got[-1]
    from analytics_zoo_tpu import analysis as janalysis

    def broken(params, grads, opt_state, meta, tx, *, axis="dp",
               clip_norm=None, clip_value=None):
        g = jax.lax.psum(jupd.flatten_tree(grads, meta, jnp.float32), axis)
        return params, opt_state, jnp.sqrt(jnp.sum(g * g))

    keep = jupd.flat_exchange
    jupd.flat_exchange = broken
    try:
        with pytest.raises(janalysis.GraphLintError, match="reduce-scatter"):
            _jax_fit(params, state, False, 2, dict(
                update_sharding="flat", grad_accum_steps=2,
                graph_checks="raise"))
    finally:
        jupd.flat_exchange = keep


def test_flat_optimizer_state_is_one_over_dp(pool):
    params, state = _jax_model(False).build(jax.random.PRNGKey(1))
    flat = pool.run(_port_fit, _np(params), False, 1,
                    dict(update_sharding="flat"))
    rep = pool.run(_port_fit, _np(params), False, 1, {})
    n = sum(np.asarray(v).size for d in _np(params).values()
            for v in d.values())
    npad = -(-n // 4) * 4
    # Adam's mu and nu over the shard; replicated: both over every leaf
    assert flat[0]["opt_bytes"] == 2 * 4 * npad // 4
    assert rep[0]["opt_bytes"] == 2 * 4 * n


def test_flat_checkpoint_is_the_jax_layout_and_resumes(pool, tmp_path):
    """bf16 with f32 masters on dp=4, flat: the port writes its epoch-1
    checkpoint (state gathered, process 0 writing); the JAX flat Estimator
    resumes it for epoch 2 and writes its own; the port resumes that for
    epoch 3. Each resumed epoch's losses are an uninterrupted port run's
    within bf16 tolerance."""
    cfg = dict(update_sharding="flat", compute_dtype="bfloat16")
    params, state = _jax_model(False).build(jax.random.PRNGKey(1))
    tree = _np(params)
    straight = pool.run(_port_fit, tree, False, None, cfg, False,
                        str(tmp_path / "straight"), 3)[0]["losses"]
    steps = N_ROWS // BATCH
    assert len(straight) == 3 * steps
    pdir = str(tmp_path / "shared")
    first = pool.run(_port_fit, tree, False, None, cfg, False, pdir, 1)
    np.testing.assert_array_equal(first[0]["losses"], straight[:steps])
    jest = JEstimator(_jax_model(False), optimizer=jopt.Adam(lr=0.01),
                      loss="mse", mesh=_mesh(4), config=jconfig.TrainConfig(
                          checkpoint_dir=pdir, **cfg))
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def record(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = record
    jest.fit(_data(), batch_size=BATCH, epochs=2, seed=3)
    assert len(want) == steps
    np.testing.assert_allclose(want, straight[steps:2 * steps], rtol=0,
                               atol=2e-2)
    third = pool.run(_port_fit, tree, False, None, cfg, False, pdir, 3)
    np.testing.assert_allclose(third[0]["losses"], straight[2 * steps:],
                               rtol=0, atol=2e-2)


def _host_shard_fit(tree, from_shards):
    """Rank side: flat dp=4, 1 epoch, from this process's host shard of
    the rows (``data[r::4]``) or from the whole data; the loss history and
    how many comm probes ``zoo_train_comm_seconds`` observed."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.engine import estimator as est_mod
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import optimizers as topt

    _ctx(dp=4)
    r = dist.get_rank()
    x, y = _data()
    if from_shards:
        data = FeatureSet.from_host_shard((x[r::4], y[r::4]))
    else:
        # global batch b holds rank q's shard batch b as its block q
        per = BATCH // 4
        order = np.concatenate([np.arange(q, N_ROWS, 4)[b * per:(b + 1) * per]
                                for b in range(N_ROWS // BATCH)
                                for q in range(4)])
        data = FeatureSet((x[order], y[order]))
    tm_model = _port_model(False)
    tm_model.load_state_dict(params_from_jax(tree))
    est = Estimator(tm_model, optimizer=topt.Adam(lr=0.01), loss="mse",
                    config=TrainConfig(update_sharding="flat", shuffle=False,
                                       log_every_n_steps=1))

    def probes():
        return sum(h.snapshot()["count"] for _, h in
                   est_mod._COMM.children())

    before = probes()
    est.fit(data, batch_size=BATCH, epochs=1)
    return ([h["loss"] for h in est.history], params_to_numpy(tm_model),
            probes() - before)


def test_host_shards_train_as_the_whole_data(pool):
    """``FeatureSet.from_host_shard``: 4 processes each holding
    ``data[r::4]`` train (flat, dp=4, in order) to the losses and params of
    the same rows fed whole, where each global batch's rank blocks are the
    shards' batches; the comm probe feeds ``zoo_train_comm_seconds`` at
    every log point."""
    params, _ = _jax_model(False).build(jax.random.PRNGKey(1))
    tree = _np(params)
    shards = pool.run(_host_shard_fit, tree, True)
    whole = pool.run(_host_shard_fit, tree, False)
    for (l1, p1, c1), (l2, p2, _) in zip(shards, whole):
        assert len(l1) == N_ROWS // BATCH
        np.testing.assert_array_equal(l1, l2)
        for slot, d in p2.items():
            for leaf, v in d.items():
                np.testing.assert_array_equal(p1[slot][leaf], v)
        assert c1 == N_ROWS // BATCH
