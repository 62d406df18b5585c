"""NeuralCF in the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded pairs go through both packages, the port carrying
the JAX model's own ``build`` weights through
``bridge.state_dict_from_jax``. Held: ``FusedPairEmbedding`` and the
``NeuralCF`` forward (with and without the MF tower, softmax and sigmoid
heads) within 1e-5 in f32; ``ImplicitNCF``'s training block and its
negatives for the same key (the negatives bit for bit); the per-step losses
and final parameters of ``Estimator.fit`` within 1e-5 in f32 for explicit
and implicit NCF, streaming and ``cache_on_device=True`` (at a
``scan_block_steps`` below the epoch, so log points fall mid-epoch on the
JAX block grid), and within bf16 tolerance under mixed precision;
``evaluate``'s result dict; ``Recommender`` and ``Ranker`` outputs; and
weight bundles written by either package loaded by the other. The
contracts of ``tests/test_neuralcf.py`` are mirrored on the port at the
end.

JAX runs on a one-device mesh, as the port's other training tests run it.
"""

import logging
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.data import datasets as jdata
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.common import Ranker as JRanker
from analytics_zoo_tpu.models.recommendation import ImplicitNCF as JImplicit
from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
from analytics_zoo_tpu.models.recommendation import \
    implicit_bce_loss as j_bce
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import metrics as jmetrics
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.bridge import params_to_numpy, state_dict_from_jax
from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data import datasets as tdata
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.models.common import Ranker
from analytics_zoo_tpu_torch.models.recommendation import (ImplicitNCF,
                                                           NeuralCF,
                                                           implicit_bce_loss)
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import metrics as tmetrics
from analytics_zoo_tpu_torch.nn import optimizers as topt

USERS, ITEMS, N_RATINGS, BATCH = 60, 40, 1000, 64
WIDTHS = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8)
AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ratings():
    pairs, r = tdata.synthetic_movielens(N_RATINGS, n_users=USERS,
                                         n_items=ITEMS, seed=1)
    return pairs, (r - 1).astype(np.int32)


def _models(kind, include_mf=True, seed=0):
    """The JAX model with its built params and the port model carrying
    them."""
    if kind == "implicit":
        jm = JImplicit(USERS, ITEMS, n_negatives=3, include_mf=include_mf,
                       **WIDTHS)
        tm = ImplicitNCF(USERS, ITEMS, n_negatives=3, include_mf=include_mf,
                         device="cpu", **WIDTHS)
    else:
        n_cls = 1 if kind == "sigmoid" else 5
        jm = JNCF(USERS, ITEMS, n_cls, include_mf=include_mf, **WIDTHS)
        tm = NeuralCF(USERS, ITEMS, n_cls, include_mf=include_mf,
                      device="cpu", **WIDTHS)
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return jm, params, tm


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, USERS + 1, n),
                     rng.integers(1, ITEMS + 1, n)], 1).astype(np.int32)


def _max_param_err(jtree, model):
    got = params_to_numpy(model)
    worst = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = got
        for p in path:
            node = node[p.key]
        worst = max(worst, float(np.abs(np.asarray(leaf, np.float32)
                                        - np.asarray(node, np.float32)).max()))
    return worst


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("mf_dim", [0, 6])
@pytest.mark.parametrize("user_dim,item_dim", [(8, 8), (4, 10)])
def test_fused_pair_embedding_matches_jax(mf_dim, user_dim, item_dim):
    jl = JL.FusedPairEmbedding(USERS + 1, ITEMS + 1, user_dim, item_dim,
                               mf_dim)
    params, _ = jl.build(jax.random.PRNGKey(3), (2,))
    tl = TL.FusedPairEmbedding(USERS + 1, ITEMS + 1, user_dim, item_dim,
                               mf_dim)
    tl.build((2,), torch.Generator().manual_seed(0))
    tl.load_state_dict(state_dict_from_jax(_np(params)))
    x = _pairs(128)
    want, _ = jl.apply(params, {}, x)
    got = tl.apply(torch.from_numpy(x))
    assert got.shape == (128, user_dim + item_dim + mf_dim)
    assert tl.compute_output_shape((2,)) == jl.compute_output_shape((2,))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_forward_matches_jax(kind, include_mf):
    jm, params, tm = _models(kind, include_mf)
    x = _pairs(200, seed=4)
    want, _ = jm.apply(params, {}, x)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x)).numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert sorted(tm.state_dict()) == sorted(
        f"{slot}.{leaf}" for slot, d in params.items() for leaf in d)


def test_embedding_layers_match_jax():
    table = np.random.default_rng(2).normal(size=(30, 6)).astype(np.float32)
    x = np.random.default_rng(3).integers(0, 30, (5, 7)).astype(np.int32)
    for jcls, tcls, kw in ((JL.Embedding, TL.Embedding, {}),
                           (JL.SparseEmbedding, TL.SparseEmbedding, {}),
                           (JL.WordEmbedding, TL.WordEmbedding, {})):
        jl, tl = jcls(30, 6, weights=table, **kw), tcls(30, 6, weights=table)
        p, s = jl.build(jax.random.PRNGKey(0), (7,))
        tl.build((7,), torch.Generator().manual_seed(0))
        want, _ = jl.apply(p, s, x)
        np.testing.assert_array_equal(tl.apply(torch.from_numpy(x)).detach()
                                      .numpy(), np.asarray(want))
        assert tl.compute_output_shape((7,)) == (7, 6)
        # trainable tables are parameters, frozen ones buffers (JAX: state)
        assert ("embeddings" in dict(tl.named_parameters())) == bool(p)


def test_load_glove_table_matches_jax(tmp_path):
    from analytics_zoo_tpu.nn.layers.embedding import load_glove_table as jg

    path = tmp_path / "glove.txt"
    path.write_text("the 0.1 0.2 0.3\ncat 1 2 3\ndog 4 5\n")
    index = {"the": 1, "cat": 2, "dog": 3, "emu": 4}
    for kw in ({}, {"randomize_unknown": True, "normalize": True}):
        np.testing.assert_array_equal(
            TL.load_glove_table(str(path), index, 3, **kw),
            jg(str(path), index, 3, **kw))
    with pytest.raises(ValueError, match="output_dim"):
        TL.load_glove_table(str(path), index, 7)


def test_narrow_matches_jax():
    x = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    for dim, off, n in ((0, 1, 3), (1, 2, 4), (-1, 0, 2)):
        want, _ = JL.Narrow(dim, off, n).apply({}, {}, x)
        got = TL.Narrow(dim, off, n).apply(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert TL.Narrow(dim, off, n).compute_output_shape((5, 6)) == \
            JL.Narrow(dim, off, n).compute_output_shape((5, 6))


def test_row_sharded_tables_are_not_ported():
    """Row-sharded tables are ported (tests/test_torch_embedding_sharding.py
    holds the multi-rank gather); a marked layer whose table is still
    whole (not placed by an Estimator) takes the plain gather."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import build_mesh
    from analytics_zoo_tpu_torch.parallel.embedding_sharding import \
        TableSharding

    tl = TL.Embedding(10, 4)
    tl.build((3,), torch.Generator().manual_seed(0))
    mesh = build_mesh(MeshConfig(dp=2), [torch.device("cpu")] * 2)
    tl.table_sharding = TableSharding(mesh, "dp", True)
    ids = torch.tensor([[0, 9, 3], [5, 5, 1]])
    assert torch.equal(tl.apply(ids),
                       torch.nn.functional.embedding(ids, tl.embeddings))


@pytest.mark.parametrize("seed", [0, 5, 123456])
def test_implicit_training_block_and_negatives_match_jax(seed):
    jm, params, tm = _models("implicit")
    pos = _pairs(32, seed=seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    want, _ = jm.apply(params, {}, pos, training=True, rng=key)
    want_neg = jax.random.randint(key, (32, 3), 1, ITEMS + 1,
                                  dtype=jax.numpy.int32)
    tkey = prng.fold_in(prng.PRNGKey(seed), 7)
    assert prng.as_key(key) == tkey
    tm.train()
    got = tm.apply(torch.from_numpy(pos), rng=tkey)
    neg = tm.negatives(torch.from_numpy(pos), tkey)
    tm.eval()
    assert got.shape == (32, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(neg[:, 1].reshape(32, 3).numpy(),
                                  np.asarray(want_neg))
    np.testing.assert_array_equal(neg[:, 0].reshape(32, 3).numpy(),
                                  np.repeat(pos[:, :1], 3, axis=1))
    # inference: the plain (B, 1) probability
    with torch.no_grad():
        probs = tm.apply(torch.from_numpy(pos))
    want_p, _ = jm.apply(params, {}, pos)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), atol=1e-5)


def test_implicit_bce_loss_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, (16, 5)).astype(np.float32)
    p[0, 0], p[1, 1] = 1.0, 0.0                 # saturated scores clip
    for dt in (torch.float32, torch.bfloat16):
        tp = torch.from_numpy(p).to(dt)
        want = float(j_bce(None, np.asarray(tp.float().numpy())))
        assert abs(float(implicit_bce_loss(None, tp)) - want) <= 1e-6


# ---------------------------------------------------------------- training

class _JaxLog(logging.Handler):
    def __init__(self):
        super().__init__()
        self.iters = []

    def emit(self, record):
        m = re.search(r"iter (\d+) loss", record.getMessage())
        if m:
            self.iters.append(int(m.group(1)))


def _jax_fit(jm, params, data, loss, epochs, lr, seed=0, **cfg):
    est = JEstimator(jm, optimizer=jopt.Adam(lr=lr), loss=loss,
                     mesh=_one_device_mesh(),
                     config=jconfig.TrainConfig(**cfg))
    est.initial_weights = (params, {})
    record = []
    step = est._make_train_step()

    def recording_step(state, batch):
        state, (loss_v, gnorm) = step(state, batch)
        record.append(float(loss_v))
        return state, (loss_v, gnorm)

    est._train_step = recording_step
    if cfg.get("cache_on_device"):
        block = est._make_scan_block()

        def recording_block(state, dev_data, idx_mat):
            state, (losses, gnorms) = block(state, dev_data, idx_mat)
            record.extend(float(v) for v in np.asarray(losses))
            return state, (losses, gnorms)

        est._scan_block = recording_block
    log = _JaxLog()
    jlog = logging.getLogger("analytics_zoo_tpu.estimator")
    old_level = jlog.level
    jlog.addHandler(log)
    jlog.setLevel(logging.INFO)
    try:
        est.fit(data, batch_size=BATCH, epochs=epochs, seed=seed)
    finally:
        jlog.removeHandler(log)
        jlog.setLevel(old_level)
    return record, _np(est.train_state["params"]), log.iters, est


def _port_fit(tm, data, loss, epochs, lr, seed=0, **cfg):
    est = Estimator(tm, optimizer=topt.Adam(lr=lr), loss=loss,
                    config=TrainConfig(**cfg))
    record, step = [], est._step

    def recording_step(batch):
        loss_v, gnorm = step(batch)
        record.append(float(loss_v))
        return loss_v, gnorm

    est._step = recording_step
    est.fit(data, batch_size=BATCH, epochs=epochs, seed=seed)
    return record, est


def _data(kind, ratings):
    pairs, labels = ratings
    if kind == "implicit":
        return pairs, np.zeros(len(pairs), np.float32)
    return pairs, labels


# streaming, and device-cached at 4-step blocks over a 15-step epoch: the
# log points (every 6) fall where a block crosses a multiple of 6, and the
# last 3 steps of each epoch run after the blocks
CASES = [("explicit", {}), ("implicit", {}),
         ("explicit", {"cache_on_device": True, "scan_block_steps": 4}),
         ("implicit", {"cache_on_device": True, "scan_block_steps": 4})]


@pytest.mark.parametrize("kind,cfg", CASES,
                         ids=["explicit", "implicit", "explicit-cached",
                              "implicit-cached"])
def test_fit_matches_jax_estimator(ratings, kind, cfg):
    jm, params, tm = _models(kind)
    data = _data(kind, ratings)
    loss_j = j_bce if kind == "implicit" else \
        "sparse_categorical_crossentropy"
    loss_t = implicit_bce_loss if kind == "implicit" else \
        "sparse_categorical_crossentropy"
    cfg = dict(cfg, log_every_n_steps=6)
    want, jparams, jiters, _ = _jax_fit(jm, params, data, loss_j, 2, 0.01,
                                     seed=3, **cfg)
    got, est = _port_fit(tm, data, loss_t, 2, 0.01, seed=3, **cfg)
    steps = 2 * (N_RATINGS // BATCH)
    assert len(want) == len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert _max_param_err(jparams, tm) <= 1e-5
    assert [h["iteration"] for h in est.history] == jiters
    assert est.trainer_state.iteration == steps
    assert est.trainer_state.epoch == 2


def test_device_cached_epochs_are_ported():
    cfg = TrainConfig(cache_on_device=True, scan_block_steps=10)
    from analytics_zoo_tpu_torch.common.config import check_ported

    assert check_ported(cfg) is cfg


def test_cached_epoch_order_is_jax_permutation(ratings):
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet

    pairs, labels = ratings
    fs = FeatureSet.from_numpy(pairs, labels, seed=4)
    est = Estimator(NeuralCF(USERS, ITEMS, 5, device="cpu", **WIDTHS),
                    config=TrainConfig(cache_on_device=True))
    for epoch in (0, 1, 2):
        want = jax.random.permutation(
            jax.random.PRNGKey(4 + epoch * 1_000_003),
            jax.numpy.arange(len(pairs), dtype=jax.numpy.int32))
        np.testing.assert_array_equal(est.epoch_order(fs, epoch).numpy(),
                                      np.asarray(want))


def test_grad_accumulation_folds_the_micro_step_into_the_key(ratings):
    """Under grad_accum_steps each micro-step folds its index into the
    step's key, as the JAX scan does."""
    jm, params, tm = _models("implicit")
    data = _data("implicit", ratings)
    want, jparams, _, _ = _jax_fit(jm, params, data, j_bce, 1, 0.01,
                                   grad_accum_steps=2)
    got, _ = _port_fit(tm, data, implicit_bce_loss, 1, 0.01,
                       grad_accum_steps=2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert _max_param_err(jparams, tm) <= 1e-5


@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_bf16_fit_matches_jax_within_bf16_tolerance(ratings, kind):
    """compute_dtype="bfloat16", device-cached: bf16 params, f32 masters
    in the optimizer state, per-step losses within 2e-2 of JAX's over two
    epochs. The masters are held by what training moved them: per leaf,
    |Δport − Δjax| / |Δjax| (L2 norms of master − initial) within 0.5
    (measured ≤ 0.47 explicit, ≤ 0.075 implicit). The two packages'
    step-0 bf16 gradients differ by up to 2.1% per leaf (0 in f32), and
    thirty Adam steps grow that to the size of JAX's own bf16 fit against
    its f32 fit (0.60 explicit, 0.075 implicit;
    ``scripts/torch_ncf_bf16_gap.py``), so this gate catches gross faults
    only; the update itself is held exactly by the test below. The bf16
    params are the masters cast down."""
    jm, params, tm = _models(kind)
    init = _np(params)
    data = _data(kind, ratings)
    loss_j = j_bce if kind == "implicit" else \
        "sparse_categorical_crossentropy"
    loss_t = implicit_bce_loss if kind == "implicit" else \
        "sparse_categorical_crossentropy"
    cfg = dict(compute_dtype="bfloat16", cache_on_device=True,
               scan_block_steps=15)
    want, _, _, jest = _jax_fit(jm, params, data, loss_j, 2, 0.01,
                                **cfg)
    got, est = _port_fit(tm, data, loss_t, 2, 0.01, **cfg)
    assert len(got) == len(want) == 2 * (N_RATINGS // BATCH)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    masters = est.train_state["opt_state"].master
    jmasters = _np(jest.train_state["opt_state"].master)
    model_params = dict(tm.named_parameters())
    for slot, leaves in jmasters.items():
        for leaf, value in leaves.items():
            name = f"{slot}.{leaf}"
            assert masters[name].dtype == torch.float32
            moved_jax = value - init[slot][leaf]
            moved_port = masters[name].numpy() - init[slot][leaf]
            rel = (np.linalg.norm(moved_port - moved_jax)
                   / np.linalg.norm(moved_jax))
            assert rel <= 0.5, (name, rel)
            assert torch.equal(model_params[name].detach(),
                               masters[name].to(torch.bfloat16)), name


def _bf16_steps_on_given_grads(kind, steps=4, seed=7):
    """Each package's bf16 Estimator step fed the same numpy-seeded bf16
    gradients (the gradient computation swapped for one that returns the
    batch): what the update path alone (f32 cast, norm, Adam on the f32
    masters, the cast down) makes of them. Returns the port's and JAX's
    f32 masters, bf16 params and gradient norms, keyed ``slot.leaf``."""
    jm, params, tm = _models(kind)
    loss_j = j_bce if kind == "implicit" else \
        "sparse_categorical_crossentropy"
    loss_t = implicit_bce_loss if kind == "implicit" else \
        "sparse_categorical_crossentropy"
    flat = {f"{s}.{l}": np.asarray(v) for s, d in _np(params).items()
            for l, v in d.items()}
    rng = np.random.default_rng(seed)
    grads = [{n: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-4, -1))
              .astype(np.float32) for n, v in flat.items()}
             for _ in range(steps)]
    grads = [{n: torch.from_numpy(g).to(torch.bfloat16) for n, g in gs.items()}
             for gs in grads]

    def jtree(gs):
        out = {}
        for n, g in gs.items():
            slot, leaf = n.split(".", 1)
            out.setdefault(slot, {})[leaf] = jax.numpy.asarray(
                g.float().numpy(), jax.numpy.bfloat16)
        return out

    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss=loss_j,
                      mesh=_one_device_mesh(),
                      config=jconfig.TrainConfig(compute_dtype="bfloat16"))
    jest.initial_weights = (params, {})
    pairs = _pairs(BATCH)
    state = jest._init_state((pairs, np.zeros(BATCH, np.int32)), seed=0)
    jest._grads_fn = lambda micro_constraint=None: (
        lambda p, mstate, rng_, batch: (jax.numpy.float32(0), mstate, batch))
    jstep = jest._make_train_step()
    jnorms = []
    for gs in grads:
        state, (_, gnorm) = jstep(state, jtree(gs))
        jnorms.append(float(gnorm))
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss=loss_t,
                    config=TrainConfig(compute_dtype="bfloat16"))
    est._init_state(0)
    est._grads = lambda batch, rng=None: (torch.zeros(()), batch)
    tnorms = [float(est._step(gs)[1]) for gs in grads]

    def flat_np(tree):
        return {f"{s}.{l}": np.asarray(v, np.float32)
                for s, d in _np(tree).items() for l, v in d.items()}

    port = ({n: m.numpy() for n, m in
             est.train_state["opt_state"].master.items()},
            {n: p.detach().float().numpy()
             for n, p in tm.named_parameters()}, tnorms)
    want = (flat_np(state["opt_state"].master), flat_np(state["params"]),
            jnorms)
    return port, want


@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_bf16_update_matches_jax_on_the_same_gradients(kind):
    """The bf16 step's update path, fed the same bf16 gradients in both
    packages for four steps: the f32 masters within 1e-6 of JAX's, the
    bf16 params and the gradient norms equal. This is where a fault of
    the mixed-precision update shows (a missing bias correction, Adam
    run on bf16 values, masters rounded to bf16, a wrong beta or rate):
    the fit above runs each package's own bf16 gradients, whose rounding
    alone moves the masters apart by up to half of what training moved
    them."""
    (masters, params, norms), (jmasters, jparams, jnorms) = \
        _bf16_steps_on_given_grads(kind)
    assert sorted(masters) == sorted(jmasters)
    for n, want in jmasters.items():
        np.testing.assert_allclose(masters[n], want, rtol=0, atol=1e-6,
                                   err_msg=n)
        np.testing.assert_array_equal(params[n], jparams[n], err_msg=n)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-6)


# ------------------------------------------------------------ evaluate, rank

def test_evaluate_matches_jax(ratings):
    jm, params, tm = _models("softmax")
    pairs, labels = ratings
    metrics = ["accuracy", "top5", jmetrics.TopK(2),
               jmetrics.Loss("sparse_categorical_crossentropy")]
    tmetric = ["accuracy", "top5", tmetrics.TopK(2),
               tmetrics.Loss("sparse_categorical_crossentropy")]
    jest = JEstimator(jm, loss="sparse_categorical_crossentropy",
                      mesh=_one_device_mesh())
    jest.initial_weights = (params, {})
    want = jest.evaluate((pairs, labels), batch_size=100 - 3,
                         metrics=metrics)
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=tmetric, device="cpu")
    got = tm.evaluate(pairs, labels, batch_size=100 - 3)
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert abs(got[name] - v) <= 1e-6, name
    # the compiled metrics are the default; "accuracy" when none were given
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               device="cpu")
    assert list(tm.evaluate(pairs, labels, batch_size=256)) == \
        ["sparse_categorical_accuracy"]


def test_hit_rate_on_leave_one_out_sets_matches_jax(ratings):
    jm, params, tm = _models("softmax")
    pairs, _ = ratings
    ev = jdata.leave_one_out_eval_sets(pairs, ITEMS, n_negatives=9,
                                       max_users=40)
    np.testing.assert_array_equal(
        tdata.leave_one_out_eval_sets(pairs, ITEMS, n_negatives=9,
                                      max_users=40), ev)
    flat = ev.reshape(-1, 2)
    jp, _ = jm.apply(params, {}, flat)
    with torch.no_grad():
        tp = tm.apply(torch.from_numpy(flat))
    classes = np.arange(1, 6, dtype=np.float32)
    js = (np.asarray(jp) * classes).sum(-1).reshape(ev.shape[:2])
    ts = (tp * torch.from_numpy(classes)).sum(-1).reshape(ev.shape[:2])
    for jm_, tm_ in ((jmetrics.HitRate(10), tmetrics.HitRate(10)),
                     (jmetrics.NDCG(10), tmetrics.NDCG(10))):
        want = jm_.result(jm_.update(jm_.init(), None, js))
        got = tm_.result(tm_.update(tm_.init(), None, ts))
        assert abs(got - want) <= 1e-6


def test_recommender_outputs_match_jax(ratings):
    jm, params, tm = _models("softmax")
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               mesh=_one_device_mesh())
    jm.estimator.initial_weights = (params, {})
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               device="cpu")
    pairs = ratings[0][:300]
    jp, tp = jm.predict_user_item_pair(pairs), tm.predict_user_item_pair(pairs)
    assert [(p.user_id, p.item_id, p.prediction) for p in tp] == \
        [(p.user_id, p.item_id, p.prediction) for p in jp]
    assert max(abs(a.probability - b.probability)
               for a, b in zip(tp, jp)) <= 1e-6
    for fn, n in (("recommend_for_user", 3), ("recommend_for_item", 2)):
        want = getattr(jm, fn)(pairs, n)
        got = getattr(tm, fn)(pairs, n)
        assert [(r.user_id, r.item_id, r.prediction) for r in got] == \
            [(r.user_id, r.item_id, r.prediction) for r in want]


class _JRankedNCF(JRanker, JImplicit):
    pass


class _RankedNCF(Ranker, ImplicitNCF):
    pass


def test_ranker_matches_jax(ratings):
    jm = _JRankedNCF(USERS, ITEMS, n_negatives=3, **WIDTHS)
    params, _ = jm.build(jax.random.PRNGKey(1))
    tm = _RankedNCF(USERS, ITEMS, n_negatives=3, device="cpu", **WIDTHS)
    tm.load_state_dict(state_dict_from_jax(_np(params)))
    jm.compile(optimizer="adam", loss=j_bce, mesh=_one_device_mesh())
    jm.estimator.initial_weights = (params, {})
    tm.compile(optimizer="adam", loss=implicit_bce_loss, device="cpu")
    ev = tdata.leave_one_out_eval_sets(ratings[0], ITEMS, n_negatives=9,
                                       max_users=12)
    labels = np.zeros(ev.shape[1], np.float32)
    labels[0] = 1.0
    graded = np.linspace(2.0, 0.0, ev.shape[1]).astype(np.float32)
    for lab in (labels, graded):
        groups = [(g, lab) for g in ev]
        for k in (1, 3, 10):
            assert abs(tm.evaluate_ndcg(groups, k)
                       - jm.evaluate_ndcg(groups, k)) <= 1e-6
        assert abs(tm.evaluate_map(groups) - jm.evaluate_map(groups)) <= 1e-6
    with pytest.raises(ValueError, match="no query groups"):
        tm.evaluate_map([])


# ------------------------------------------------------------------ bundles

def test_jax_bundle_loads_in_the_port(tmp_path):
    jm, params, _ = _models("softmax", seed=6)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               mesh=_one_device_mesh())
    jm.estimator.initial_weights = (params, {})
    x = _pairs(50, seed=9)
    want = jm.predict(x)
    jm.save_model(str(tmp_path / "b"))
    tm = NeuralCF.load_model(str(tmp_path / "b"), device="cpu")
    assert (tm.user_count, tm.mf_embed, tm.hidden_layers) == (USERS, 8,
                                                              [16, 8])
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               device="cpu")
    np.testing.assert_allclose(tm.predict(x), want, rtol=0, atol=1e-6)


def test_port_bundle_loads_in_jax(tmp_path):
    tm = ImplicitNCF(USERS, ITEMS, n_negatives=2, device="cpu", seed=4,
                     **WIDTHS)
    tm.compile(optimizer="adam", loss=implicit_bce_loss, device="cpu")
    x = _pairs(50, seed=10)
    want = tm.predict(x)
    tm.save_model(str(tmp_path / "b"))
    jm = JImplicit.load_model(str(tmp_path / "b"))
    assert jm.n_negatives == 2 and jm.item_count == ITEMS
    jm.compile(optimizer="adam", loss=j_bce, mesh=_one_device_mesh())
    np.testing.assert_allclose(jm.predict(x), want, rtol=0, atol=1e-6)


def test_loading_weights_into_a_trained_model_restarts_its_optimizer(
        ratings, tmp_path):
    pairs, labels = ratings
    donor = NeuralCF(USERS, ITEMS, 5, device="cpu", seed=1, **WIDTHS)
    donor.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device="cpu")
    donor.save_model(str(tmp_path / "b"))
    tm = NeuralCF(USERS, ITEMS, 5, device="cpu", **WIDTHS)
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               device="cpu")
    tm.fit(pairs, labels, batch_size=BATCH, nb_epoch=1)
    key = tm.estimator.train_state["rng"]
    tm.load_weights(str(tmp_path / "b"))
    state = tm.estimator.train_state
    assert state["step"] == 0 and state["rng"] == key
    assert all(float(m.abs().max()) == 0.0
               for m in state["opt_state"][0].mu.values())
    np.testing.assert_array_equal(tm.predict(pairs[:40]),
                                  donor.predict(pairs[:40]))


def test_bundle_mismatch_raises(tmp_path):
    tm = NeuralCF(USERS, ITEMS, 5, device="cpu", **WIDTHS)
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               device="cpu")
    tm.save_model(str(tmp_path / "b"))
    other = NeuralCF(USERS, ITEMS, 5, device="cpu", user_embed=8,
                     item_embed=8, hidden_layers=(16,), mf_embed=8)
    with pytest.raises(ValueError, match="mismatch"):
        other.load_weights(str(tmp_path / "b"))
    wider = NeuralCF(USERS + 1, ITEMS, 5, device="cpu", **WIDTHS)
    with pytest.raises(ValueError, match="saved"):
        wider.load_weights(str(tmp_path / "b"))


# ------------------------------------- tests/test_neuralcf.py on the port

@pytest.fixture()
def small_ncf():
    model = NeuralCF(user_count=50, item_count=30, class_num=5,
                     user_embed=8, item_embed=8, hidden_layers=(16, 8),
                     mf_embed=8, device="cpu")
    model.compile(optimizer=topt.Adam(lr=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    return model


def test_forward_shape(small_ncf):
    pairs = torch.tensor([[1, 2], [3, 4], [49, 29]], dtype=torch.int32)
    with torch.no_grad():
        y = small_ncf.apply(pairs)
    assert y.shape == (3, 5)
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, rtol=1e-4)


def test_no_mf_variant():
    model = NeuralCF(20, 10, 5, include_mf=False, hidden_layers=(8,),
                     device="cpu")
    with torch.no_grad():
        y = model.apply(torch.tensor([[1, 1]], dtype=torch.int32))
    assert y.shape == (1, 5)


def test_fit_and_recommend(small_ncf):
    pairs, ratings = tdata.synthetic_movielens(4000, n_users=50, n_items=30,
                                               seed=1)
    labels = (ratings - 1).astype("int32")
    (xtr, ytr), (xte, yte) = tdata.train_test_split_by_user(pairs, labels)
    small_ncf.fit(xtr, ytr, batch_size=256, nb_epoch=4)
    res = small_ncf.evaluate(xte, yte, batch_size=256)
    assert res["sparse_categorical_accuracy"] > 0.25

    preds = small_ncf.predict_user_item_pair(xte[:20])
    assert len(preds) == 20
    assert all(1 <= p.prediction <= 5 for p in preds)
    assert all(0.0 <= p.probability <= 1.0 for p in preds)
    recs = small_ncf.recommend_for_user(xte, max_items=3)
    by_user = {}
    for r in recs:
        by_user.setdefault(r.user_id, []).append((-r.prediction,
                                                  -r.probability))
    for keys in by_user.values():
        assert len(keys) <= 3
        assert keys == sorted(keys)
    recs_i = small_ncf.recommend_for_item(xte, max_users=2)
    by_item = {}
    for r in recs_i:
        by_item.setdefault(r.item_id, []).append((-r.prediction,
                                                  -r.probability))
    for keys in by_item.values():
        assert len(keys) <= 2
        assert keys == sorted(keys)


def test_hitrate_eval_layout(small_ncf):
    pairs, ratings = tdata.synthetic_movielens(3000, n_users=50, n_items=30,
                                               seed=2)
    small_ncf.fit(pairs, (ratings - 1).astype("int32"), batch_size=256,
                  nb_epoch=2)
    ev = tdata.leave_one_out_eval_sets(pairs, n_items=30, n_negatives=9,
                                       max_users=40)
    u, c, _ = ev.shape
    probs = small_ncf.predict(ev.reshape(u * c, 2), batch_size=512)
    classes = np.arange(1, probs.shape[-1] + 1, dtype="float32")
    scores = torch.from_numpy((probs * classes).sum(-1).reshape(u, c))
    m = tmetrics.HitRate(10)
    hr = m.result(m.update(m.init(), None, scores))
    assert 0.0 <= hr <= 1.0


def test_save_load_roundtrip(small_ncf, tmp_path):
    pairs, ratings = tdata.synthetic_movielens(1000, n_users=50, n_items=30,
                                               seed=3)
    small_ncf.fit(pairs, (ratings - 1).astype("int32"), batch_size=256,
                  nb_epoch=1)
    before = small_ncf.predict(pairs[:50])
    path = str(tmp_path / "ncf_bundle")
    small_ncf.save_model(path)
    loaded = NeuralCF.load_model(path, device="cpu")
    assert loaded.user_count == 50 and loaded.mf_embed == 8
    loaded.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                   device="cpu")
    np.testing.assert_allclose(before, loaded.predict(pairs[:50]),
                               rtol=1e-5, atol=1e-6)


def test_implicit_ncf_beats_random_ranking():
    """The NCF-paper implicit protocol: negatives drawn on the model's
    device each step + BCE lift HR@10 well above the 0.10 random floor of
    the 1+99 candidate layout (leave-one-out: the held-out pairs are not
    trained on)."""
    n_users, n_items = 300, 200
    pairs, _ = tdata.synthetic_movielens(30_000, n_users=n_users,
                                         n_items=n_items)
    ev = tdata.leave_one_out_eval_sets(pairs, n_items, n_negatives=99,
                                       max_users=200)
    held = {(int(u), int(i)) for u, i in ev[:, 0]}
    train = pairs[np.array([(int(u), int(i)) not in held for u, i in pairs])]
    model = ImplicitNCF(user_count=n_users, item_count=n_items,
                        n_negatives=4, user_embed=8, item_embed=8,
                        hidden_layers=(16, 8), mf_embed=8, device="cpu")
    est = Estimator(model, optimizer=topt.Adam(lr=5e-3),
                    loss=implicit_bce_loss,
                    config=TrainConfig(log_every_n_steps=10**9,
                                       cache_on_device=True))
    est.fit((train, np.zeros(len(train), "float32")), batch_size=2048,
            epochs=8)
    score = est.predict(ev.reshape(-1, 2), batch_size=4096).reshape(
        ev.shape[0], ev.shape[1])
    rank = (score[:, 1:] > score[:, 0:1]).sum(axis=1) + 1
    hr10 = float((rank <= 10).mean())
    assert hr10 > 0.25, f"implicit HR@10 {hr10} not above random 0.10"


def test_implicit_ncf_training_block_shape():
    model = ImplicitNCF(user_count=20, item_count=30, n_negatives=3,
                        user_embed=4, item_embed=4, hidden_layers=(8,),
                        mf_embed=4, device="cpu")
    pos = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    model.train()
    block = model.apply(pos, rng=prng.PRNGKey(1))
    model.eval()
    assert block.shape == (2, 4)
    assert bool(((block >= 0) & (block <= 1)).all())
    with torch.no_grad():
        assert model.apply(pos).shape == (2, 1)


def test_datasets_match_jax():
    for n in (100, 2345):
        a, b = jdata.synthetic_movielens(n, n_users=70, n_items=50, seed=n)
        c, d = tdata.synthetic_movielens(n, n_users=70, n_items=50, seed=n)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        for x, y in zip(jdata.train_test_split_by_user(a, b, seed=2),
                        tdata.train_test_split_by_user(c, d, seed=2)):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
    assert (tdata.ML1M_USERS, tdata.ML1M_ITEMS, tdata.ML1M_RATINGS) == (
        jdata.ML1M_USERS, jdata.ML1M_ITEMS, jdata.ML1M_RATINGS)


def test_movielens_reads_a_ratings_file(tmp_path):
    path = tmp_path / "ratings.dat"
    path.write_text("1::1193::5::978300760\n1::661::3::978302109\n"
                    "2::1193::4::978298413\n")
    for fn in (jdata.movielens_1m, tdata.movielens_1m):
        pairs, r = fn(str(path))
        np.testing.assert_array_equal(pairs, [[1, 2], [1, 1], [2, 2]])
        np.testing.assert_array_equal(r, [5, 3, 4])
