"""fsdp and tensor parallelism in the PyTorch port, in 8 spawned gloo ranks
on the CPU, against the JAX Estimator on the same mesh of the 8-device CPU
mesh (``make_param_sharding``'s rules on both sides).

Held, per-step losses and final params within 1e-5 in f32, the port's
params gathered whole through the Estimator's ``_full``: a
``TransformerLM(vocab=64, hidden_size=32, n_block=2, n_head=8,
seq_len=16)`` from the JAX weights (``bridge``) trained on fsdp=8 (every
leaf but the embeddings stored as its 1/8 block, gathered at use), tp=8
(one head a rank, vocab-parallel embeddings and loss), dp=2 x fsdp=2 x
tp=2 with ``grad_accum_steps=2`` and update sharding off and on (the JAX
contract of ``tests/test_update_sharding.py``: ``"gspmd"``, optimizer state
sharded over dp), and fsdp=2 x tp=2 x sp=2 with ring attention; NCF under
fsdp=8 and dp=2 x fsdp=2 x tp=2 (its MLP takes the fsdp default, its
table the vocab-parallel lookup over tp) and a ``Sequential`` with
``Dropout`` on dp=2 x fsdp=2 x tp=2 (the mask drawn for the global batch
and sliced by the combined (dp, fsdp) block; the JAX ``TransformerLM``
takes no dropout rate), under the JAX rules and with its kernels' rows
over ``("fsdp", "tp")``, two axes on one dim; a ``Sequential`` with
``BatchNormalization`` in training on dp=2 x fsdp=4 (the global batch's
moments, its moving statistics too). The chip's recipe (flash attention, remat
"flash") on dp=2 x fsdp=2 x tp=2 gives the one-process port run. Also:
placement then ``_full`` gives every JAX
leaf bit for bit, and a rank's QKV block holds its heads' q, k and v
(``qkv_tp_permutation``); the mesh's fsdp and tp groups; the vocab-parallel
loss against ``lm_loss``; without remat the backward keeps no leaf
gathered whole (it saves blocks and gathers again); a checkpoint written
on dp x fsdp x tp loads into
a one-rank port Estimator and into the JAX package bit for bit, and a JAX
checkpoint into the sharded port. One rank pool serves the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from analytics_zoo_tpu.common import MeshConfig as JMeshConfig
from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common import init_zoo_context as jinit
from analytics_zoo_tpu.common import reset_zoo_context as jreset
from analytics_zoo_tpu.engine import checkpoint as jckpt
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.models.transformer import lm_loss as jlm_loss
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.parallel import make_param_sharding as jrules
from analytics_zoo_tpu_torch.parallel import comm

from torch_fsdp_tp_ranks import (BATCH, LM, N_SEQS, WORLD, _ckpt_roundtrip,
                                 _fit_bn, _fit_lm, _fit_other, _mlp_data,
                                 _ncf_data,
                                 _placement, _port_lm, _saved_blocks, _tokens,
                                 _vocab_loss)

TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pool():
    p = comm.RankPool(WORLD, device="cpu", timeout_s=600)
    yield p
    p.close()


@pytest.fixture(scope="module")
def lm_tree():
    params, _ = JaxLM(**LM, attn_strategy="full").build(
        jax.random.PRNGKey(3))
    return _np(params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


# ------------------------------------------------------------- rank side


def _jax_fit(tree, axes, cfg, strategy="full", ckpt_dir=None):
    jreset()
    ctx = jinit(mesh=JMeshConfig(**axes))
    try:
        jm = JaxLM(**LM, attn_strategy=strategy)
        est = JEstimator(jm, optimizer=jopt.Adam(lr=1e-2, epsilon=1e-4),
                         loss=jlm_loss, mesh=ctx.mesh,
                         param_sharding=jrules(ctx.mesh),
                         config=jconfig.TrainConfig(
                             log_every_n_steps=1, checkpoint_dir=ckpt_dir,
                             **cfg))
        est.initial_weights = (jax.tree_util.tree_map(jnp.asarray, tree), {})
        want, step = [], est._make_train_step()

        def record(st, b):
            st, (loss, gnorm) = step(st, b)
            want.append(float(loss))
            return st, (loss, gnorm)

        est._train_step = record
        est.fit(_tokens(), batch_size=BATCH, epochs=1)
        return want, _flat(_np(est.train_state["params"])), est
    finally:
        jreset()


CASES = {
    "fsdp8": (dict(fsdp=8), {}, "full"),
    "tp8": (dict(tp=8), {}, "full"),
    "dp2_fsdp2_tp2_accum2": (dict(dp=2, fsdp=2, tp=2),
                             dict(grad_accum_steps=2), "full"),
    "dp2_fsdp2_tp2_accum2_update_sharding": (
        dict(dp=2, fsdp=2, tp=2),
        dict(grad_accum_steps=2, update_sharding=True), "full"),
    "fsdp2_tp2_sp2_ring": (dict(fsdp=2, tp=2, sp=2), {}, "ring"),
}


@pytest.fixture(scope="module")
def runs(pool, lm_tree):
    """Each case's port ranks and JAX run, made once for the module."""
    cache = {}

    def get(case):
        if case not in cache:
            axes, cfg, strategy = CASES[case]
            want, wparams, jest = _jax_fit(lm_tree, axes, cfg, strategy)
            res = pool.run(_fit_lm, lm_tree, axes, cfg, strategy)
            cache[case] = (res, want, wparams, jest)
        return cache[case]

    return get


def _assert_params(got, want, tol=TOL):
    assert set(got) == set(want)
    for n, v in want.items():
        np.testing.assert_allclose(got[n].astype(np.float32),
                                   v.astype(np.float32), rtol=0, atol=tol,
                                   err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_training_matches_jax(runs, case):
    res, want, wparams, jest = runs(case)
    assert len(want) == N_SEQS // BATCH
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=TOL)
        assert r["mode"] == jest._update_mode()
    _assert_params(res[0]["params"], wparams)
    for r in res[1:]:
        for n, v in r["params"].items():
            np.testing.assert_array_equal(v, res[0]["params"][n])
    tp = CASES[case][0].get("tp", 1)
    # under tp every block's attention and MLP and the LM itself split
    assert res[0]["tp_modules"] == (2 * LM["n_block"] + 1 if tp > 1 else 0)


def test_per_rank_elements_are_the_jax_rules_blocks(runs, lm_tree):
    """The elements a rank holds: every leaf's block under the rules."""
    sizes = {n: v.size for n, v in _flat(lm_tree).items()}
    total = sum(sizes.values())
    emb = sizes["token_embeddings"] + sizes["pos_embeddings"]
    # fsdp=8: all but the two tables (the tp rule takes them) split 8 ways
    assert runs("fsdp8")[0][0]["elements"] == (total - emb) // 8 + emb
    # tp=8: kernels and tables split 8 ways, biases and norms whole
    small = sum(s for n, s in sizes.items()
                if n.endswith(("bias", "gamma", "beta")))
    assert runs("tp8")[0][0]["elements"] == (total - small) // 8 + small


def test_gspmd_contract_composes_with_fsdp_tp(runs):
    """``tests/test_update_sharding.py``'s contract on the port: update
    sharding on a dp x fsdp x tp mesh takes the per-leaf ("gspmd") path,
    and optimizer-state leaves gain dp on top of their fsdp/tp spec."""
    res, _, _, jest = runs("dp2_fsdp2_tp2_accum2_update_sharding")
    assert jest._update_mode() == "gspmd"
    for r in res:
        assert r["mode"] == "gspmd"
        assert sum(d is not None for d in r["upd_dims"].values()) > 0
    # the JAX rule puts dp on qkv_kernel's fsdp dim: P(("fsdp", "dp"), "tp")
    assert res[0]["upd_dims"]["block0.attn.qkv_kernel"] == 0


def test_flash_remat_on_dp_fsdp_tp_matches_one_process(pool, lm_tree):
    """The chip's recipe at this size: flash attention (the kernels' plain
    versions here) and remat "flash" on dp=2 x fsdp=2 x tp=2, where the
    checkpointed segments issue their fsdp gathers and tp reductions again
    in backward, give the one-process port run's losses and params."""
    cfg = dict(grad_accum_steps=2, update_sharding=True)
    res = pool.run(_fit_lm, lm_tree, dict(dp=2, fsdp=2, tp=2), cfg, "flash",
                   None, "flash")
    one = _fit_lm(lm_tree, None, dict(grad_accum_steps=2), "flash")
    for r in res:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=0,
                                   atol=TOL)
    _assert_params(res[0]["params"], one["params"])


@pytest.mark.parametrize("axes", [dict(tp=8), dict(dp=2, fsdp=2, tp=2)],
                         ids=["tp8", "dp2_fsdp2_tp2"])
def test_placement_round_trip_and_qkv_blocks(pool, lm_tree, axes):
    """Place, then ``_full``: every JAX leaf bit for bit. A tp rank's QKV
    block is q, k and v of its own heads (the JAX columns read as (3, H,
    Dh)); the mesh's groups are the lines of the C-order rank array."""
    res = pool.run(_placement, lm_tree, axes)
    want = _flat(lm_tree)
    for r in res:
        for n, v in want.items():
            np.testing.assert_array_equal(r["whole"][n], v, err_msg=n)
    tp, fsdp = axes.get("tp", 1), axes.get("fsdp", 1)
    hid, heads = LM["hidden_size"], LM["n_head"]
    w = want["block0.attn.qkv_kernel"]
    b = want["block0.attn.qkv_bias"]
    shape = [axes.get(a, 1) for a in ("dp", "fsdp", "tp")]
    ids = np.arange(WORLD).reshape(shape)
    for rank, r in enumerate(res):
        t, f = r["coords"]["tp"], r["coords"]["fsdp"]
        h = heads // tp
        cols = np.concatenate([
            np.arange(s * hid + t * h * hid // heads,
                      s * hid + (t + 1) * h * hid // heads)
            for s in range(3)])
        rows = np.arange(f * hid // fsdp, (f + 1) * hid // fsdp)
        np.testing.assert_array_equal(r["stored"], w[rows][:, cols])
        np.testing.assert_array_equal(r["view"], w[:, cols])
        np.testing.assert_array_equal(r["bias_view"], b[cols])
        d, fi, ti = np.unravel_index(rank, shape)
        assert r["groups"]["fsdp"] == tuple(ids[d, :, ti])
        assert r["groups"]["tp"] == tuple(ids[d, fi, :])
        assert r["groups"]["dp"] == tuple(ids[:, fi, ti])


@pytest.mark.parametrize("axes", [dict(fsdp=8), dict(dp=2, fsdp=2, tp=2)],
                         ids=["fsdp8", "dp2_fsdp2_tp2"])
def test_backward_saves_blocks_of_gathered_leaves(pool, lm_tree, axes):
    """Without remat the backward keeps no leaf gathered whole: after the
    forward, with its graph held, none is alive, and the backward gathers
    each saved one again from its block."""
    for r in pool.run(_saved_blocks, lm_tree, axes):
        assert r["alive"] == 0, r
        assert 0 < r["bwd_gathers"] <= r["fwd_gathers"], r
        assert r["finite"], r


def test_gathering_holds_no_reference_to_what_it_saves():
    """Inside ``gathering`` a node that saves its own output and never runs
    in backward (a max taken for a detached shift) goes with its output,
    without the garbage collector: the saved-tensor hook keeps no cycle."""
    import gc
    import weakref

    import torch

    from analytics_zoo_tpu_torch.parallel import placement

    gc.disable()
    try:
        with placement.gathering():
            a = torch.ones(64, requires_grad=True)
            m = (a * 2).amax(-1)
            ref = weakref.ref(m)
            shift = m.detach()
            del m
        assert ref() is None
        assert float(shift) == 2.0
    finally:
        gc.enable()


def test_vocab_parallel_loss_matches_lm_loss(pool):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    labels = rng.integers(0, 64, size=(3, 5))
    want = float(jlm_loss(jnp.asarray(labels), jnp.asarray(logits)))
    pool.run(comm.reset_collective_counts)
    for loss, ref, g, gref, counts in pool.run(_vocab_loss, logits, labels):
        assert abs(loss - want) <= 1e-6 and abs(ref - want) <= 1e-6
        np.testing.assert_allclose(g, gref, rtol=0, atol=1e-7)
        # the max and one psum of the exp-sums beside the target logit
        assert counts["all-reduce"] == 2, counts


# ------------------------------------------------------------ checkpoints


def test_checkpoints_cross_both_ways_bit_for_bit(pool, lm_tree, tmp_path):
    """The port's dp=2 x fsdp=2 x tp=2 checkpoint (update sharding on, the
    QKV blocks permuted on the ranks) loads into a one-rank port Estimator
    and into the JAX package bit for bit; the JAX package's checkpoint of
    the same run loads into the sharded port bit for bit."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine import checkpoint as ckpt
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.nn import optimizers as topt

    axes = dict(dp=2, fsdp=2, tp=2)
    cfg = dict(grad_accum_steps=2, update_sharding=True)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    _, _, jest = _jax_fit(lm_tree, axes, cfg, ckpt_dir=jdir)
    res = pool.run(_ckpt_roundtrip, lm_tree, pdir, jdir)
    path = ckpt.latest_checkpoint(pdir)
    # the JAX package reads the port's checkpoint
    jstate, _ = jckpt.load_checkpoint(path, jest.train_state)
    got, _ = res[0]
    _assert_params(got, _flat(_np(jstate["params"])), tol=0)
    # a one-rank port Estimator restores it
    one = Estimator(_port_lm(lm_tree, "full"),
                    optimizer=topt.Adam(lr=1e-2, epsilon=1e-4), loss=lm_loss,
                    config=TrainConfig(), device="cpu")
    one._init_state()
    one._restore(path)
    for n, p in one.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got[n], err_msg=n)
    saved = ckpt.snapshot_state(one.checkpoint_state()).wait()
    file_leaves = jax.tree_util.tree_leaves(jstate)
    assert len(saved) == len(file_leaves)
    for a, b in zip(saved, file_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the sharded port restores the JAX package's checkpoint
    jleaves = jax.tree_util.tree_leaves(_np(jest.train_state))
    for _, state in res:
        assert len(state) == len(jleaves)
        for a, b in zip(state, jleaves):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------- other models
def _ncf_models(seed=0):
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF

    widths = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8),
                  mf_embed=8)
    jm = JNCF(63, 39, 5, **widths)
    params, state = jm.build(jax.random.PRNGKey(seed))
    return jm, widths, _np(params), _np(state)


def _jax_two_axes_rule(path, leaf):
    """:func:`torch_fsdp_tp_ranks.two_axes_rule` in JAX's specs."""
    from jax.sharding import PartitionSpec

    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 2 and shape[0] % 4 == 0:
        return PartitionSpec(("fsdp", "tp"), None)
    return PartitionSpec()


def _jax_other(jm, params, state, axes, data, loss, batch, two_axes=False,
               with_state=False):
    jreset()
    ctx = jinit(mesh=JMeshConfig(**axes))
    try:
        est = JEstimator(jm, optimizer=jopt.Adam(lr=1e-2), loss=loss,
                         mesh=ctx.mesh,
                         param_sharding=(_jax_two_axes_rule if two_axes
                                         else jrules(ctx.mesh)),
                         config=jconfig.TrainConfig(log_every_n_steps=1))
        est.initial_weights = (params, state)
        want, step = [], est._make_train_step()

        def record(st, b):
            st, (l, g) = step(st, b)
            want.append(float(l))
            return st, (l, g)

        est._train_step = record
        est.fit(data, batch_size=batch, epochs=1, seed=3)
        out = (want, _flat(_np(est.train_state["params"])))
        if with_state:
            out += (_flat(_np(est.train_state["model_state"])),)
        return out
    finally:
        jreset()


@pytest.mark.parametrize("axes", [dict(fsdp=8), dict(dp=2, fsdp=2, tp=2)],
                         ids=["fsdp8", "dp2_fsdp2_tp2"])
def test_ncf_matches_jax(pool, axes):
    """NCF's MLP kernels and biases take the fsdp default (the largest
    divisible dim) and each rank gathers them where its layers read them.
    Its fused table (104 rows) keeps the ``"embeddings"`` rule: whole under
    fsdp alone, as in JAX; over tp its rows are vocab-parallel (the owned
    rows looked up, then one psum)."""
    jm, widths, params, state = _ncf_models()
    want, wparams = _jax_other(jm, params, state, axes, _ncf_data(),
                               "sparse_categorical_crossentropy", 64)
    res = pool.run(_fit_other, "ncf", params, state, widths, axes)
    table = any(n.endswith("embeddings") for n in res[0][2])
    assert table == (axes.get("tp", 1) > 1)
    for losses, got, placed in res:
        np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
        assert placed
    _assert_params(res[0][1], wparams)


def _jax_mlp():
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential

    return JSequential([JL.Dense(16, activation="relu", input_shape=(8,)),
                        JL.Dropout(0.3), JL.Dense(8, activation="tanh"),
                        JL.Dense(4)])


@pytest.mark.parametrize("two_axes", [False, True],
                         ids=["jax_rules", "two_axes_on_one_dim"])
def test_dropout_on_dp_fsdp_tp_matches_jax(pool, two_axes):
    """Dropout on dp=2 x fsdp=2 x tp=2: every rank draws the global batch's
    mask and takes its (dp, fsdp) block's rows, tp ranks the same ones, as
    the JAX step draws it over the global array. With the kernels' rows
    over ``("fsdp", "tp")`` (two axes on one dim) each rank stores a
    quarter of the rows and gathers tp, then fsdp, where it reads them."""
    axes = dict(dp=2, fsdp=2, tp=2)
    jm = _jax_mlp()
    params, state = jm.build(jax.random.PRNGKey(1))
    params, state = _np(params), _np(state)
    want, wparams = _jax_other(jm, params, state, axes, _mlp_data(), "mse",
                               16, two_axes)
    res = pool.run(_fit_other, "mlp", params, state, None, axes, two_axes)
    for losses, _, placed in res:
        np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
        assert placed
    _assert_params(res[0][1], wparams)


def test_batchnorm_on_dp_fsdp_matches_jax(pool):
    """BatchNormalization in training on dp=2 x fsdp=4: the batch is
    sharded over both axes, so every rank normalises with the global
    batch's moments (``comm.batch_psum`` over dp and fsdp, the gradient
    through it), as JAX's GSPMD step does; losses, the gathered params and
    the moving statistics within 1e-5 of JAX's on every rank."""
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential

    axes = dict(dp=2, fsdp=4)
    jm = JSequential([JL.Dense(16, use_bias=False, input_shape=(8,)),
                      JL.BatchNormalization(), JL.Activation("relu"),
                      JL.Dense(4)])
    params, state = jm.build(jax.random.PRNGKey(2))
    params, state = _np(params), _np(state)
    rng = np.random.default_rng(4)
    state["1_batchnormalization"] = {
        "moving_mean": rng.normal(size=16).astype(np.float32),
        "moving_var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    want, wparams, wstate = _jax_other(jm, params, state, axes, _mlp_data(),
                                       "mse", 16, with_state=True)
    res = pool.run(_fit_bn, params, state, axes)
    for losses, got, stats in res:
        np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
        _assert_params(stats, wstate)
    _assert_params(res[0][1], wparams)

