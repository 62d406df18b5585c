"""Sequence-parallel attention in the PyTorch port (``ops/attention.py``)
in 4 spawned gloo ranks on the CPU, against the JAX package's
``sharded_attention`` on an sp=4 mesh of the 8-device CPU mesh.

Held, on the same seeded q, k, v and output cotangent: ``ring`` (causal
and not; the flash ring), ``zigzag`` and
``ulysses`` (causal and not), forward within 1e-5 and dq/dk/dv within
1e-5 of JAX's, on every rank (each holds the replicated result); the
per-block kernel calls each rank makes, counted on the wrappers the
kernels sit behind (their plain versions run here): causal ring K1 = K3 =
K4 = idx + 1 on rank idx (10 over 4 ranks: future blocks skipped),
non-causal n each, zigzag 2n + 1 each; ``zigzag_permutation`` equal to
JAX's; zigzag's fallbacks (non-causal, or T not split into 2·sp chunks)
running the ring schedule and still JAX's result; a dp=2 x sp=2 mesh;
``MultiHeadAttention(attn_strategy=...)`` under a context dispatching to
the strategies. One rank pool serves the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.ops import attention as jatt
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.parallel import comm

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
B, T, H, D = 2, 32, 4, 8
TOL = 1e-5


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, D)).astype(np.float32)
            for _ in range(4)]


def _jax(strategy, causal, q, k, v, g, sp=4, dp=1):
    devs = np.array(jax.devices()[:sp * dp]).reshape((dp, 1, 1, sp, 1, 1))
    mesh = Mesh(devs, AXES)

    def f(q_, k_, v_):
        out = jatt.sharded_attention(q_, k_, v_, mesh, strategy=strategy,
                                     causal=causal)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(strategy, causal, arrays, dp=1, sp=4):
    """Rank side: the port's sharded_attention with the kernels' wrappers
    counted."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    reset_zoo_context()
    ctx = init_zoo_context(platform="cpu", mesh=MeshConfig(dp=dp, sp=sp))
    counts = {"K1": 0, "K3": 0, "K4": 0}
    saved = {}
    for name, key in (("flash_attention_fwd", "K1"),
                      ("flash_attention_bwd_dq", "K3"),
                      ("flash_attention_bwd_dkv", "K4")):
        fn = getattr(tfa, name)
        saved[name] = fn

        def counted(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        setattr(tfa, name, counted)
    try:
        q, k, v, g = (torch.tensor(a, requires_grad=i < 3)
                      for i, a in enumerate(arrays))
        out = tatt.sharded_attention(q, k, v, ctx.mesh,
                                     strategy=strategy, causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), g)
    finally:
        for name, fn in saved.items():
            setattr(tfa, name, fn)
        reset_zoo_context()
    return (out.detach().numpy(), [x.numpy() for x in grads], counts,
            ctx.mesh.coords["sp"])


@pytest.fixture(scope="module")
def pool():
    p = comm.RankPool(4, device="cpu", timeout_s=300)
    yield p
    p.close()


CASES = [("ring", True), ("ring", False), ("zigzag", True),
         ("ulysses", True), ("ulysses", False)]


def _want_counts(strategy, causal, idx, n=4):
    if strategy == "ulysses":
        # one flash call over the whole sequence; its backward goes through
        # FlashAttentionFunction's flash_attention_bwd, which on CPU tensors
        # runs K3's and K4's joint plain version, not the wrappers
        return {"K1": 1, "K3": 0, "K4": 0}
    if strategy == "zigzag" and causal:
        c = 2 * n + 1
    elif causal:
        c = idx + 1
    else:
        c = n
    return {"K1": c, "K3": c, "K4": c}


@pytest.mark.parametrize("strategy,causal", CASES)
def test_strategy_matches_jax_forward_and_grads(pool, strategy, causal):
    q, k, v, g = _inputs(1)
    want_out, want_grads = _jax(strategy, causal, q, k, v, g)
    res = pool.run(_port, strategy, causal, (q, k, v, g))
    for out, grads, counts, idx in res:
        np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL)
        for got, want, name in zip(grads, want_grads, "qkv"):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                       err_msg=f"d{name}")
        assert counts == _want_counts(strategy, causal, idx), counts
    # the causal ring's K1 launches over the ranks: 1 + 2 + 3 + 4
    if strategy == "ring" and causal:
        assert sum(r[2]["K1"] for r in res) == 10


@pytest.mark.parametrize("strategy,causal,t", [("zigzag", False, T),
                                               ("zigzag", True, 36),
                                               ("auto", True, 36),
                                               ("auto", True, T)])
def test_zigzag_fallbacks_run_the_ring(pool, strategy, causal, t):
    q, k, v, g = _inputs(2, t)
    want_out, want_grads = _jax(strategy, causal, q, k, v, g)
    res = pool.run(_port, strategy, causal, (q, k, v, g))
    zigzag = strategy == "auto" and t % 8 == 0
    for out, grads, counts, idx in res:
        np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL)
        for got, want in zip(grads, want_grads):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert counts == _want_counts("zigzag" if zigzag else "ring",
                                      causal, idx), counts


def test_dp2_sp2_mesh(pool):
    q, k, v, g = _inputs(3)
    want_out, want_grads = _jax("ring", True, q, k, v, g, sp=2, dp=2)
    # both dp replicas see the same (global) arrays here: the dp axis only
    # carries the batch in the Estimator
    res = pool.run(_port, "ring", True, (q, k, v, g), dp=2, sp=2)
    for out, grads, counts, idx in res:
        np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL)
        for got, want in zip(grads, want_grads):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert counts["K1"] == idx + 1


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zigzag_permutation_equals_jax(n):
    for t in (2 * n, 8 * n, 24 * n):
        np.testing.assert_array_equal(tatt.zigzag_permutation(t, n),
                                      jatt.zigzag_permutation(t, n))
    with pytest.raises(ValueError, match="2\\*sp"):
        tatt.zigzag_permutation(2 * n + 1, n)


def _layer(strategy, x, tree):
    from analytics_zoo_tpu_torch.bridge import params_from_jax
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.nn.layers.attention import \
        MultiHeadAttention

    reset_zoo_context()
    init_zoo_context(platform="cpu", mesh=MeshConfig(sp=4))
    m = MultiHeadAttention(H * D, H, causal=True, attn_strategy=strategy,
                           device="cpu")
    m.load_state_dict(params_from_jax(tree))
    xt = torch.tensor(x, requires_grad=True)
    out = m.apply(xt)
    (gx,) = torch.autograd.grad(out.sum(), xt)
    reset_zoo_context()
    return out.detach().numpy(), gx.numpy()


@pytest.mark.parametrize("strategy", ["ring", "zigzag", "ulysses"])
def test_attention_layer_dispatches_over_sp(pool, strategy):
    from analytics_zoo_tpu.common import (MeshConfig, init_zoo_context,
                                          reset_zoo_context)
    from analytics_zoo_tpu.nn.layers.attention import \
        MultiHeadAttention as JMHA

    jl = JMHA(H * D, H, causal=True, attn_strategy=strategy)
    params, _ = jl.build(jax.random.PRNGKey(0), (None, H * D))
    x = np.random.default_rng(4).standard_normal((B, T, H * D)).astype(
        np.float32)
    reset_zoo_context()
    init_zoo_context(mesh=MeshConfig(dp=2, sp=4))
    try:
        def f(xx):
            y = jl.apply(params, {}, xx)[0]
            return jnp.sum(y), y

        (_, want), want_gx = jax.jit(jax.value_and_grad(f, has_aux=True))(x)
        want, want_gx = np.asarray(want), np.asarray(want_gx)
    finally:
        reset_zoo_context()
    res = pool.run(_layer, strategy, x,
                   jax.tree_util.tree_map(np.asarray, params))
    for out, gx in res:
        np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
        np.testing.assert_allclose(gx, want_gx, rtol=0, atol=TOL)
