"""Expert and pipeline parallelism in the PyTorch port, on the CPU: the
``MoE`` layer (``nn/layers/moe.py``), ``pipeline_apply``
(``parallel/pipeline.py``) and ``PipelinedTransformerLM``, against the JAX
package; the multi-rank parts in 4 spawned gloo ranks.

Held: ``MoE`` against JAX's ``MoE.apply`` from the same weights, with
capacity drops (a small capacity factor) and ties in the router (the
stable top-k's lower-index rule): output, aux loss and input/weight
gradients within 1e-5; ``n_experts=1`` equal to the dense MLP; ep=4 (each
rank its 2 of 8 experts) equal to ep=1, output and every gradient, and
``n_experts`` not divisible by ep raising; ``pipeline_apply`` over pp=4
with 4 micro-batches against JAX's, output and gradients (input and
stacked params) within 1e-5, and a batch that does not split raising;
``PipelinedTransformerLM`` logits at pp=4 within 1e-4 of JAX's (and of its
own sequential form), and 2 Estimator steps with the stages placed by
``param_spec`` within 1e-5 of the JAX Estimator's losses and final
parameters. ``Dense → MoE(cf 1.25) → Dense`` trained 3 SGD steps on dp=4,
fsdp=4 and dp=2 x ep=2 gives the JAX Estimator's losses, params and aux
loss within 1e-5 (the dispatch over the global batch, on data whose
per-block dispatch drops other tokens); under ``grad_accum_steps=2`` on
dp=2 x ep=2 the one-process run's; the flat step's first loss is the
mean of the four blocks' one-process losses (a per-block dispatch). One
rank pool serves the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.nn.layers.moe import MoE as JMoE
from analytics_zoo_tpu.parallel import pipeline as jpipe
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.nn.layers.moe import MoE, top_k_stable
from analytics_zoo_tpu_torch.parallel import comm
from analytics_zoo_tpu_torch.parallel import pipeline as tpipe

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
TOL = 1e-5
D, E = 8, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ctx(**axes):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    reset_zoo_context()
    return init_zoo_context(platform="cpu", mesh=MeshConfig(**axes))


def _reset():
    from analytics_zoo_tpu_torch.common.context import reset_zoo_context

    reset_zoo_context()


@pytest.fixture(scope="module")
def pool():
    p = comm.RankPool(4, device="cpu", timeout_s=300)
    yield p
    p.close()


def _moe_pair(n_experts=E, top_k=2, cf=0.5, seed=0):
    jl = JMoE(D, n_experts=n_experts, intermediate_size=16, top_k=top_k,
              capacity_factor=cf)
    params, _ = jl.build(jax.random.PRNGKey(seed), (None, None, D))
    return jl, _np(params)


def _port_moe(tree, n_experts=E, top_k=2, cf=0.5):
    m = MoE(D, n_experts=n_experts, intermediate_size=16, top_k=top_k,
            capacity_factor=cf)
    m.build((None, None, D), torch.Generator().manual_seed(0))
    m.load_state_dict(params_from_jax(tree))
    return m


def _x(seed=1, b=2, t=12):
    return np.random.default_rng(seed).standard_normal((b, t, D)).astype(
        np.float32)


def _port_moe_grads(m, x):
    xt = torch.tensor(x, requires_grad=True)
    y = m.apply(xt)
    loss = (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum()
    grads = torch.autograd.grad(loss, [xt] + list(m.parameters()))
    return (y.detach().numpy(), float(m.state["aux_loss"].detach()),
            [g.numpy() for g in grads])


def test_moe_matches_jax_with_capacity_drops():
    jl, tree = _moe_pair()
    x = _x()
    w = np.linspace(-1, 1, x.size, dtype=np.float32).reshape(x.shape)

    def f(p, xx):
        y, st = jl.apply(p, {}, xx)
        return jnp.sum(y * w), (y, st["aux_loss"])

    (_, (want, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree_util.tree_map(
            jnp.asarray, tree), x)
    m = _port_moe(tree)
    # the capacity drops some slots: fewer dispatched than n_tok * top_k
    probs = torch.softmax(torch.tensor(x.reshape(-1, D))
                          @ m.router_kernel.detach(), -1)
    dispatch, _ = m.dispatch(probs)
    assert dispatch.sum() < x.shape[0] * x.shape[1] * 2
    y, taux, grads = _port_moe_grads(m, x)
    np.testing.assert_allclose(y, np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(taux, float(aux), rtol=0, atol=TOL)
    np.testing.assert_allclose(grads[0], np.asarray(gx), rtol=0, atol=TOL)
    names = [n for n, _ in m.named_parameters()]
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g, np.asarray(gp[n]), rtol=0, atol=TOL,
                                   err_msg=n)


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = top_k_stable(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_single_expert_is_the_dense_mlp():
    _, tree = _moe_pair(n_experts=1, top_k=1, cf=2.0)
    m = _port_moe(tree, n_experts=1, top_k=1, cf=2.0)
    x = torch.tensor(_x())
    with torch.no_grad():
        y = m.apply(x)
        h = torch.nn.functional.gelu(x @ m.expert_up[0] + m.expert_up_bias[0],
                                     approximate="tanh")
        want = h @ m.expert_down[0] + m.expert_down_bias[0]
    torch.testing.assert_close(y, want, rtol=0, atol=TOL)


def _moe_ep(tree, x, ep):
    _ctx(ep=ep) if ep > 1 else _reset()
    try:
        return _port_moe_grads(_port_moe(tree), x)
    finally:
        _reset()


def test_ep4_equals_ep1(pool):
    _, tree = _moe_pair(seed=3)
    x = _x(4)
    want = _moe_ep(tree, x, 1)
    res = pool.run(_moe_ep, tree, x, 4)
    for y, aux, grads in res:
        np.testing.assert_allclose(y, want[0], rtol=0, atol=TOL)
        np.testing.assert_allclose(aux, want[1], rtol=0, atol=TOL)
        for g, w in zip(grads, want[2]):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def _moe_bad_ep(tree):
    _ctx(ep=4)
    try:
        m = MoE(D, n_experts=6, intermediate_size=16)
        m.build((None, None, D), torch.Generator().manual_seed(0))
        m.apply(torch.zeros(1, 4, D))
    except ValueError as e:
        return str(e)
    finally:
        _reset()
    return None


def test_experts_not_divisible_by_ep_raise(pool):
    res = pool.run(_moe_bad_ep, None)
    assert all(r and "not divisible by ep=4" in r for r in res)


# --------------------------------------------------------------- pipeline
def _stage_params(seed=5, n=4, d=D):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(
        np.float32), "b": rng.standard_normal((n, d)).astype(np.float32)}


def _stage_fn_torch(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def _port_pipe(stacked, x, n_micro, cot):
    ctx = _ctx(pp=4)
    try:
        ps = {n: torch.tensor(v, requires_grad=True)
              for n, v in stacked.items()}
        xt = torch.tensor(x, requires_grad=True)
        y = tpipe.pipeline_apply(_stage_fn_torch, ps, xt, ctx.mesh,
                                 n_microbatches=n_micro)
        grads = torch.autograd.grad(y, [xt, ps["w"], ps["b"]],
                                    torch.tensor(cot))
        return y.detach().numpy(), [g.numpy() for g in grads]
    finally:
        _reset()


def test_pipeline_apply_matches_jax(pool):
    stacked = _stage_params()
    x = np.random.default_rng(6).standard_normal((8, 3, D)).astype(
        np.float32)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 1, 1, 4, 1), AXES)

    def f(p, xx):
        y = jpipe.pipeline_apply(lambda sp, a: jnp.tanh(a @ sp["w"] + sp["b"]),
                                 p, xx, mesh, n_microbatches=4)
        return jnp.sum(y * cot), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(stacked, x)
    res = pool.run(_port_pipe, stacked, x, 4, cot)
    for y, grads in res:
        np.testing.assert_allclose(y, np.asarray(want), rtol=0, atol=TOL)
        for g, w in zip(grads, (gx, gp["w"], gp["b"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL)


def _port_pipe_bad(stacked):
    ctx = _ctx(pp=4)
    try:
        tpipe.pipeline_apply(_stage_fn_torch, {n: torch.tensor(v) for n, v
                                               in stacked.items()},
                             torch.zeros(6, D), ctx.mesh, n_microbatches=4)
    except ValueError as e:
        return str(e)
    finally:
        _reset()


def test_pipeline_rejects_a_batch_that_does_not_split(pool):
    res = pool.run(_port_pipe_bad, _stage_params())
    assert all("not divisible by 4 microbatches" in r for r in res)


def test_stack_stage_params():
    per = [{"w": torch.full((2,), float(i))} for i in range(3)]
    st = tpipe.stack_stage_params(per)
    np.testing.assert_array_equal(
        st["w"].numpy(),
        np.asarray(jpipe.stack_stage_params([{"w": jnp.full((2,), float(i))}
                                             for i in range(3)])["w"]))


# ------------------------------------------------- PipelinedTransformerLM
LM = dict(vocab=64, hidden_size=32, n_block=4, n_head=2, seq_len=8,
          n_microbatches=4)


def _jax_plm():
    from analytics_zoo_tpu.models.transformer import \
        PipelinedTransformerLM as JPLM

    return JPLM(**LM)


def _ids(n=8):
    ids = np.random.default_rng(8).integers(0, LM["vocab"], (n, 9))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _port_plm_logits(tree, x, pp):
    from analytics_zoo_tpu_torch.models.transformer import \
        PipelinedTransformerLM

    _ctx(pp=pp) if pp > 1 else _reset()
    try:
        m = PipelinedTransformerLM(**LM, device="cpu")
        m.load_state_dict(params_from_jax(tree))
        with torch.no_grad():
            return m.apply(torch.tensor(x)).numpy()
    finally:
        _reset()


def test_pipelined_lm_logits_match_jax(pool):
    from analytics_zoo_tpu.common import (MeshConfig, init_zoo_context,
                                          reset_zoo_context)

    jm = _jax_plm()
    params, _ = jm.build(jax.random.PRNGKey(2))
    tree = _np(params)
    x, _ = _ids()
    reset_zoo_context()
    init_zoo_context(mesh=MeshConfig(pp=4))
    try:
        want = np.asarray(jax.jit(lambda p, xx: jm.apply(p, {}, xx)[0])(
            params, x))
    finally:
        reset_zoo_context()
    res = pool.run(_port_plm_logits, tree, x, 4)
    seq = _port_plm_logits(tree, x, 1)
    np.testing.assert_allclose(seq, want, rtol=0, atol=1e-4)
    for logits in res:
        np.testing.assert_allclose(logits, want, rtol=0, atol=1e-4)


def _port_plm_fit(tree, data):
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import (
        PipelinedTransformerLM, lm_loss)
    from analytics_zoo_tpu_torch.nn import optimizers as topt

    _ctx(pp=4)
    try:
        m = PipelinedTransformerLM(**LM, device="cpu")
        m.load_state_dict(params_from_jax(tree))
        est = Estimator(m, optimizer=topt.Adam(lr=1e-2, epsilon=1e-4),
                        loss=lm_loss, param_sharding=m.param_spec,
                        config=TrainConfig(shuffle=False))
        losses, step = [], est._step

        def record(b):
            loss, gnorm = step(b)
            losses.append(float(loss))
            return loss, gnorm

        est._step = record
        est.fit(data, batch_size=4, epochs=1)
        local = tuple(dict(m.named_parameters())["blocks.ln1.gamma"].shape)
        full = est.checkpoint_state()["params"]
        return losses, local, jax_free_numpy(full)
    finally:
        _reset()


def jax_free_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_free_numpy(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def test_pipelined_lm_two_step_fit_matches_jax(pool):
    from analytics_zoo_tpu.common import (MeshConfig, TrainConfig,
                                          init_zoo_context,
                                          reset_zoo_context)
    from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.models.transformer import lm_loss as jlm_loss
    from analytics_zoo_tpu.nn import optimizers as jopt

    jm = _jax_plm()
    params, _ = jm.build(jax.random.PRNGKey(2))
    tree = _np(params)
    data = _ids()
    reset_zoo_context()
    ctx = init_zoo_context(mesh=MeshConfig(pp=4))
    try:
        est = JEstimator(jm, optimizer=jopt.Adam(lr=1e-2, epsilon=1e-4),
                         loss=jlm_loss, mesh=ctx.mesh,
                         param_sharding=jm.param_spec,
                         config=TrainConfig(shuffle=False))
        est.initial_weights = (params, {})
        want, step = [], est._make_train_step()

        def record(st, b):
            st, (loss, gnorm) = step(st, b)
            want.append(float(loss))
            return st, (loss, gnorm)

        est._train_step = record
        est.fit(data, batch_size=4, epochs=1)
        wparams = _np(est.train_state["params"])
    finally:
        reset_zoo_context()
    res = pool.run(_port_plm_fit, tree, data)
    for losses, local, full in res:
        assert len(losses) == len(want) == 2
        np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
        assert local == (1, LM["hidden_size"])      # one block a stage
        for path, leaf in jax.tree_util.tree_leaves_with_path(wparams):
            node = full
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, leaf, rtol=0, atol=TOL,
                                       err_msg=jax.tree_util.keystr(path))


# ------------------------------------------- MoE on a batch-sharded mesh
MOE_T, MOE_D, MOE_ROWS, MOE_BATCH = 4, 8, 48, 16
MOE_MESHES = {"dp4": dict(dp=4), "fsdp4": dict(fsdp=4),
              "dp2_ep2": dict(dp=2, ep=2)}


def _moe_net(m):
    return [m.Dense(MOE_D, input_shape=(MOE_T, 6)),
            m.MoE(MOE_D, n_experts=4, intermediate_size=16, top_k=2),
            m.Dense(3)]


def _moe_data(seed=21):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(MOE_ROWS, MOE_T, 6)).astype(np.float32)
    # a common offset: the router favours the same experts in every
    # block, so blocks fill them unevenly and the drops depend on the
    # dispatch's scope
    x[..., :3] += 1.5
    return x, rng.normal(size=(MOE_ROWS, MOE_T, 3)).astype(np.float32)


def _jax_mesh_ctx(axes):
    """The JAX context on a mesh of 4 of the CPU devices (the MoE's ep
    constraint and the Estimator read it)."""
    from analytics_zoo_tpu.common import init_zoo_context, reset_zoo_context

    reset_zoo_context()
    ctx = init_zoo_context()
    sizes = tuple(axes.get(a, 1) for a in AXES)
    ctx.mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(
        sizes), AXES)
    return ctx


def _moe_jax_fit(axes, params):
    from analytics_zoo_tpu.common import config as jconfig
    from analytics_zoo_tpu.common import reset_zoo_context
    from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn import optimizers as jopt
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential
    from analytics_zoo_tpu.parallel import make_param_sharding as jrules

    ctx = _jax_mesh_ctx(axes)
    try:
        jest = JEstimator(JSequential(_moe_net(JL)),
                          optimizer=jopt.SGD(lr=0.5), loss="mse",
                          mesh=ctx.mesh, param_sharding=jrules(ctx.mesh),
                          config=jconfig.TrainConfig(shuffle=False))
        jest.initial_weights = (params, {})
        want, step = [], jest._make_train_step()

        def record(st, b):
            st, (loss, gnorm) = step(st, b)
            want.append(float(loss))
            return st, (loss, gnorm)

        jest._train_step = record
        jest.fit(_moe_data(), batch_size=MOE_BATCH, epochs=1, seed=3)
        return (want, _np(jest.train_state["params"]),
                float(jest.train_state["model_state"]["1_moe"]["aux_loss"]))
    finally:
        reset_zoo_context()


def _moe_port_fit(tree, axes, cfg=None, rules=True):
    """Rank side (or one process, ``axes`` None): the port's Estimator on
    ``Dense → MoE → Dense`` from the JAX weights, one epoch of 3 SGD steps:
    losses a step, the whole params and the MoE's last ``aux_loss``."""
    from analytics_zoo_tpu_torch.bridge import params_from_jax
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.nn.topology import Sequential
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    mesh = _ctx(**axes).mesh if axes else None
    if not axes:
        _reset()
    try:
        tm = Sequential(_moe_net(TL), device="cpu")
        tm.load_state_dict(params_from_jax(tree))
        est = Estimator(tm, optimizer=topt.SGD(lr=0.5), loss="mse",
                        param_sharding=(make_param_sharding(mesh)
                                        if rules and mesh is not None
                                        else None),
                        config=TrainConfig(shuffle=False, **(cfg or {})))
        got, step = [], est._step

        def record(b):
            loss, gnorm = step(b)
            got.append(float(loss))
            return loss, gnorm

        est._step = record
        est.fit(_moe_data(), batch_size=MOE_BATCH, epochs=1, seed=3)
        whole = {n: est._full(n, p.detach()).numpy()
                 for n, p in tm.named_parameters()}
        return {"losses": got, "params": whole, "mode": est._update_mode(),
                "aux": float(tm.layers[1].state["aux_loss"].detach())}
    finally:
        _reset()


def _moe_kept(tree, blocks, rows=MOE_BATCH):
    """Which (token, expert) assignments the first ``rows`` rows keep at
    the initial weights, dispatched over them all and over each of
    ``blocks`` blocks alone."""
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    tm = Sequential(_moe_net(TL), device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    moe = tm.layers[1]
    with torch.no_grad():
        h = tm.layers[0](torch.from_numpy(_moe_data()[0][:rows]))
        probs = torch.softmax(h.reshape(-1, MOE_D) @ moe.router_kernel, -1)
        whole = moe.dispatch(probs)[0].sum(-1)
        per = torch.cat([moe.dispatch(p)[0].sum(-1)
                         for p in probs.chunk(blocks)])
    return whole.numpy(), per.numpy()


@pytest.mark.parametrize("case", sorted(MOE_MESHES))
def test_moe_on_a_batch_sharded_mesh_matches_jax(pool, case):
    """``Dense → MoE(cf 1.25) → Dense`` trained 3 SGD steps on a mesh whose
    batch axes split each global batch: the MoE's capacity, running fill
    and aux loss are the global batch's, as under JAX's GSPMD step.
    Losses, params and ``aux_loss`` within 1e-5 of the JAX Estimator on
    the same mesh, on every rank; the data makes a per-block dispatch
    drop other tokens than the global one."""
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential

    axes = MOE_MESHES[case]
    params, _ = JSequential(_moe_net(JL)).build(jax.random.PRNGKey(4))
    tree = _np(params)
    whole, per = _moe_kept(tree, axes.get("dp", 1) * axes.get("fsdp", 1))
    assert whole.sum() < 2 * MOE_BATCH * MOE_T         # drops, globally
    assert not np.array_equal(whole, per)
    want, wparams, waux = _moe_jax_fit(axes, params)
    for r in pool.run(_moe_port_fit, tree, axes):
        assert len(r["losses"]) == len(want) == MOE_ROWS // MOE_BATCH
        assert r["mode"] is None
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=TOL)
        np.testing.assert_allclose(r["aux"], waux, rtol=0, atol=TOL)
        for slot, d in wparams.items():
            for leaf, v in d.items():
                np.testing.assert_allclose(r["params"][f"{slot}.{leaf}"], v,
                                           rtol=0, atol=TOL,
                                           err_msg=f"{slot}.{leaf}")


def test_moe_flat_step_dispatches_per_block(pool):
    """The flat (ZeRO-1) step on dp=4 is JAX's per-replica ``shard_map``
    body: each rank dispatches its own block alone, so the first step's
    loss is the mean of four one-process forwards, one a block."""
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    params, _ = JSequential(_moe_net(JL)).build(jax.random.PRNGKey(4))
    tree = _np(params)
    tm = Sequential(_moe_net(TL), device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    x, y = (torch.from_numpy(a[:MOE_BATCH]) for a in _moe_data())
    with torch.no_grad():
        per = [float(((tm.apply(xb) - yb) ** 2).mean())
               for xb, yb in zip(x.chunk(4), y.chunk(4))]
        whole = float(((tm.apply(x) - y) ** 2).mean())
    assert abs(np.mean(per) - whole) > 10 * TOL       # the scopes differ
    for r in pool.run(_moe_port_fit, tree, dict(dp=4),
                      dict(update_sharding="flat"), False):
        assert r["mode"] == "flat"
        np.testing.assert_allclose(r["losses"][0], np.mean(per), rtol=0,
                                   atol=TOL)


def test_moe_accumulation_on_dp_matches_one_process(pool):
    """``grad_accum_steps=2`` on dp=2 (x ep=2): each micro-step dispatches
    its global micro-batch, the rank's block of which it holds, so 3 SGD
    steps give the one-process run's losses, params and aux loss within
    1e-5. (The JAX Estimator cannot accumulate over an MoE, whose state
    gains ``aux_loss`` in the step, so the port alone is the oracle.)"""
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential

    params, _ = JSequential(_moe_net(JL)).build(jax.random.PRNGKey(4))
    tree = _np(params)
    whole, per = _moe_kept(tree, 2, rows=MOE_BATCH // 2)
    assert not np.array_equal(whole, per)
    cfg = dict(grad_accum_steps=2)
    want = _moe_port_fit(tree, None, cfg)
    for r in pool.run(_moe_port_fit, tree, dict(dp=2, ep=2), cfg):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=0, atol=TOL)
        for n, v in want["params"].items():
            np.testing.assert_allclose(r["params"][n], v, rtol=0, atol=TOL,
                                       err_msg=n)
