"""Row-sharded embedding tables in the PyTorch port
(``parallel/embedding_sharding.py``), in 4 spawned gloo ranks on the CPU:
the port counterparts of ``tests/test_embedding_sharding.py``.

Held: the sharded gather, byte-exact with ``F.embedding`` over the whole
table, in the training exchange (each rank its block of the batch: all-
gather ids, owner gather, reduce-scatter rows) and the replicated one
(masked gather, psum), for flat and (B, 2) pair ids; zero rows for
out-of-range ids; the backward a scatter-add into the rank's own rows
only, equal to its block of the dense gradient, with no (vocab, embed)
gradient on any rank; per-rank table and Adam-moment bytes 1/n after the
Estimator places the table; the helpers equal JAX's; a FusedPairEmbedding
model trained with its table sharded over dp=4 within 5e-6 of the same
model trained replicated, and of the JAX Estimator's sharded run. One rank
pool serves the module.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu.parallel import embedding_sharding as jes
from analytics_zoo_tpu_torch.parallel import comm
from analytics_zoo_tpu_torch.parallel import embedding_sharding as tes

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
ROWS, WIDTH = 64, 16


def _ctx(**axes):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    reset_zoo_context()
    return init_zoo_context(platform="cpu", mesh=MeshConfig(**axes))


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (ROWS, WIDTH)).astype(np.float32)


@pytest.fixture(scope="module")
def pool():
    p = comm.RankPool(4, device="cpu", timeout_s=300)
    yield p
    p.close()


def _gather(ids, training):
    """Rank side: rows for ``ids`` (the whole batch) from this rank's block
    of the table; in training each rank looks up its block of the batch."""
    ctx = _ctx(dp=4)
    ax = ctx.mesh.axis("dp")
    table = torch.tensor(_table()).chunk(4, 0)[ax.index].contiguous()
    ids = torch.tensor(ids)
    if training:
        mine = ids.chunk(4, 0)[ax.index]
        with comm.batch_shard(comm.BatchShard(ax.index, 4)):
            comm.reset_collective_counts()
            out = tes.sharded_gather(table, mine, ctx.mesh)
    else:
        comm.reset_collective_counts()
        out = tes.sharded_gather(table, ids, ctx.mesh)
    return out.numpy(), comm.collective_counts()


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("pairs", [False, True])
def test_sharded_gather_byte_exact(pool, training, pairs):
    rng = np.random.default_rng(1)
    shape = (40, 2) if pairs else (40,)
    ids = rng.integers(0, ROWS, shape).astype(np.int64)
    want = F.embedding(torch.tensor(ids), torch.tensor(_table())).numpy()
    res = pool.run(_gather, ids, training)
    if training:
        got = np.concatenate([r[0] for r in res], 0)
        assert all(r[1]["all-gather"] == 1 and r[1]["reduce-scatter"] == 1
                   for r in res)
    else:
        assert all(np.array_equal(r[0], res[0][0]) for r in res)
        got = res[0][0]
        assert all(r[1]["all-reduce"] == 1 for r in res)
    np.testing.assert_array_equal(got, want)


def test_out_of_range_ids_give_zero_rows(pool):
    ids = np.array([0, 63, 64, 100, -1, 5, 70, 2], np.int64)
    res = pool.run(_gather, ids, True)
    got = np.concatenate([r[0] for r in res], 0)
    full = _table()
    for i, t in enumerate(ids):
        want = full[t] if 0 <= t < ROWS else np.zeros(WIDTH, np.float32)
        np.testing.assert_array_equal(got[i], want)


def _grad(ids, cot):
    ctx = _ctx(dp=4)
    ax = ctx.mesh.axis("dp")
    table = torch.tensor(_table()).chunk(4, 0)[ax.index].contiguous()
    table.requires_grad_(True)
    mine = torch.tensor(ids).chunk(4, 0)[ax.index]
    g = torch.tensor(cot).chunk(4, 0)[ax.index]
    with comm.batch_shard(comm.BatchShard(ax.index, 4)):
        out = tes.sharded_gather(table, mine, ctx.mesh)
    (gt,) = torch.autograd.grad(out, table, g)
    return tuple(gt.shape), gt.numpy()


def test_backward_is_a_shard_local_scatter_add(pool):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, ROWS, 48).astype(np.int64)
    ids[:4] = ids[4]                          # collisions scatter-add
    cot = rng.standard_normal((48, WIDTH)).astype(np.float32)
    full = torch.tensor(_table(), requires_grad=True)
    (dense,) = torch.autograd.grad(F.embedding(torch.tensor(ids), full),
                                   full, torch.tensor(cot))
    res = pool.run(_grad, ids, cot)
    for r, (shape, g) in enumerate(res):
        assert shape == (ROWS // 4, WIDTH)
        np.testing.assert_allclose(g, dense.numpy()[r * 16:(r + 1) * 16],
                                   rtol=0, atol=1e-6)


def test_helpers_equal_jax():
    for rows, n in ((30, 8), (32, 8), (7, 3), (64, 4)):
        assert tes.pad_rows(rows, n) == jes.pad_rows(rows, n)
        for s in range(n):
            assert tes.owned_row_range(rows, n, s) == \
                jes.owned_row_range(rows, n, s)

    class M:
        shape = {a: 1 for a in AXES} | {"dp": 8}

    for shape in ((64, 8), (30, 8), (8,), (16, 4, 2)):
        assert tuple(tes.row_shard_spec(shape, M)) == \
            tuple(jes.row_shard_spec(shape, M))


# --------------------------------------------------- end-to-end training
RU, RI, B = 40, 24, 16


def _pair_data():
    rng = np.random.default_rng(7)
    users = rng.permutation(RU)[:B].astype(np.int32)
    items = rng.permutation(RI)[:B].astype(np.int32)
    x = np.stack([users, items], axis=1)
    y = rng.integers(0, 2, (B, 1)).astype(np.float32)
    return np.concatenate([x, x[::-1]]), np.concatenate([y, y[::-1]])


def _jax_pair_model():
    return JSequential([JL.FusedPairEmbedding(RU, RI, 8, 8, mf_dim=4,
                                              input_shape=(2,)),
                        JL.Dense(8, activation="relu"), JL.Dense(1)])


def _port_pair_fit(tree, shard, update_sharding, optimizer="sgd"):
    from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    ctx = _ctx(dp=4)
    model = Sequential([TL.FusedPairEmbedding(RU, RI, 8, 8, mf_dim=4,
                                              input_shape=(2,)),
                        TL.Dense(8, activation="relu"), TL.Dense(1)],
                       device="cpu")
    model.load_state_dict(params_from_jax(tree))
    kw = {}
    if shard:
        kw["param_sharding"] = tes.shard_embedding_tables(model, ctx.mesh)
    cfg = TrainConfig(shuffle=False, log_every_n_steps=10 ** 9,
                      update_sharding=update_sharding)
    est = Estimator(model, optimizer=optimizer, loss="mse", config=cfg,
                    **kw)
    losses, step = [], est._step

    def record(b):
        loss, gnorm = step(b)
        losses.append(float(loss))
        return loss, gnorm

    est._step = record
    x, y = _pair_data()
    est.fit((x, y), batch_size=B, epochs=3)
    table = dict(model.named_parameters())["0_fusedpairembedding.embeddings"]
    moments = [t for t in _leaves(est.train_state["opt_state"])
               if t.dim() == 2 and t.shape[1] == table.shape[1]]
    full = est.checkpoint_state()["params"]
    return {"losses": losses, "table_shape": tuple(table.shape),
            "moment_shapes": [tuple(t.shape) for t in moments],
            "params": params_to_numpy(model), "full": _numpy(full),
            "mode": est._update_mode()}


def _leaves(s):
    if isinstance(s, torch.Tensor):
        return [s]
    if isinstance(s, dict):
        return [t for v in s.values() for t in _leaves(v)]
    if isinstance(s, (tuple, list)):
        return [t for v in s for t in _leaves(v)]
    return []


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _jax_pair_fit(params, shard, update_sharding, optimizer="sgd"):
    jm = _jax_pair_model()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape((4,) + (1,) * 5), AXES)
    kw = {}
    if shard:
        kw["param_sharding"] = jes.shard_embedding_tables(jm, mesh)
    cfg = jconfig.TrainConfig(shuffle=False, log_every_n_steps=10 ** 9,
                              update_sharding=update_sharding)
    est = JEstimator(jm, optimizer=optimizer, loss="mse", config=cfg,
                     mesh=mesh, **kw)
    est.initial_weights = (params, {})
    x, y = _pair_data()
    est.fit((x, y), batch_size=B, epochs=3)
    return jax.tree_util.tree_map(np.asarray, est.train_state["params"]), est


def _assert_tree_close(got, want, atol):
    for slot, d in want.items():
        for leaf, v in d.items():
            np.testing.assert_allclose(np.asarray(got[slot][leaf]), v,
                                       rtol=0, atol=atol,
                                       err_msg=f"{slot}.{leaf}")


@pytest.mark.parametrize("update_sharding,optimizer",
                         [(False, "sgd"), (True, "adam")])
def test_sharded_training_matches_replicated_and_jax(pool, update_sharding,
                                                     optimizer):
    """3 epochs of 2 steps: the table sharded over dp=4 lands within 5e-6
    of the replicated run and of JAX's sharded run; each rank holds 1/4 of
    the table's rows and, under per-leaf update sharding, 1/4 of its Adam
    moments."""
    params, _ = _jax_pair_model().build(jax.random.PRNGKey(0), (None, 2))
    tree = jax.tree_util.tree_map(np.asarray, params)
    want, jest = _jax_pair_fit(params, True, update_sharding, optimizer)
    sharded = pool.run(_port_pair_fit, tree, True, update_sharding,
                       optimizer)
    replicated = pool.run(_port_pair_fit, tree, False, update_sharding,
                          optimizer)
    width = tree["0_fusedpairembedding"]["embeddings"].shape[1]
    assert sharded[0]["mode"] == jest._update_mode()
    for r in sharded:
        assert r["table_shape"] == ((RU + RI) // 4, width)
        if update_sharding:
            assert r["moment_shapes"] and all(
                s == ((RU + RI) // 4, width) for s in r["moment_shapes"])
        _assert_tree_close(r["full"], want, 5e-6)
        _assert_tree_close(r["full"], replicated[0]["params"], 5e-6)
    np.testing.assert_allclose(sharded[0]["losses"],
                               replicated[0]["losses"], rtol=0, atol=5e-6)
