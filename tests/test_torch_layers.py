"""Parity of the PyTorch port's layers with the JAX package, on the CPU.

The same seeded numpy inputs and the JAX layer's own ``build`` weights (loaded
through ``analytics_zoo_tpu_torch.bridge``) go through both packages; every
output must agree within 1e-5 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn.activations import gelu as jax_gelu
from analytics_zoo_tpu.nn.layers.attention import (
    MultiHeadAttention as JaxMHA, TransformerLayer as JaxLayer)
from analytics_zoo_tpu.nn.layers.normalization import (
    LayerNormalization as JaxLN)
from analytics_zoo_tpu.ops.kv_cache import PagePool as JaxPool
from analytics_zoo_tpu.ops.kv_cache import KVCacheConfig as JaxCfg
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.nn import module as tmod
from analytics_zoo_tpu_torch.nn.activations import gelu
from analytics_zoo_tpu_torch.nn.layers.attention import (
    MultiHeadAttention, TransformerLayer)
from analytics_zoo_tpu_torch.nn.layers.normalization import LayerNormalization

TOL = 1e-5
HIDDEN, HEADS = 32, 4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _load(module, params):
    module.load_state_dict(params_from_jax(_np_tree(params)))
    return module


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= tol, f"max |diff| {err} > {tol}"


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, HIDDEN)) * 3 + 1).astype(np.float32)
    jln = JaxLN()
    params = {"gamma": rng.normal(size=HIDDEN).astype(np.float32),
              "beta": rng.normal(size=HIDDEN).astype(np.float32)}
    want, _ = jln.apply(params, {}, x)
    ln = LayerNormalization(dim=HIDDEN)
    ln.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        _close(want, ln(torch.from_numpy(x)))


def test_layernorm_bf16_keeps_input_dtype():
    ln = LayerNormalization(dim=HIDDEN)
    x = torch.randn(2, 3, HIDDEN).to(torch.bfloat16)
    with torch.no_grad():
        assert ln(x).dtype == torch.bfloat16


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 401).astype(np.float32)
    _close(jax_gelu(x), gelu(torch.from_numpy(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((exact - gelu(torch.from_numpy(x))).abs().max()) > 1e-4


@pytest.mark.parametrize("strategy", ["full", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_apply_matches_jax(causal, strategy):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, HIDDEN)).astype(np.float32)
    jm = JaxMHA(HIDDEN, HEADS, causal=causal, attn_strategy=strategy)
    params, _ = jm.build(jax.random.PRNGKey(1), (None, HIDDEN))
    want, _ = jm.apply(params, {}, x)
    m = _load(MultiHeadAttention(HIDDEN, HEADS, causal=causal,
                                 attn_strategy=strategy), params)
    with torch.no_grad():
        _close(want, m.apply(torch.from_numpy(x)))


def test_mha_rejects_unported_strategy():
    """Every strategy of the JAX layer is ported (the sequence-parallel
    ones are held in tests/test_torch_sequence_parallel.py); an unknown one
    raises as JAX's dispatch does."""
    for strategy in ("ring", "zigzag", "ulysses"):
        MultiHeadAttention(HIDDEN, HEADS, attn_strategy=strategy,
                           device="cpu")
    with pytest.raises(ValueError, match="unknown attention strategy"):
        MultiHeadAttention(HIDDEN, HEADS, attn_strategy="bogus")


def _layers(seed=2, strategy="flash"):
    jl = JaxLayer(HIDDEN, HEADS, causal=True, attn_strategy=strategy)
    params, _ = jl.build(jax.random.PRNGKey(seed), (None, HIDDEN))
    tl = _load(TransformerLayer(HIDDEN, HEADS, causal=True,
                                attn_strategy=strategy), params)
    return jl, params, tl


def test_transformer_layer_apply_and_apply_with_kv_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, HIDDEN)).astype(np.float32)
    jl, params, tl = _layers()
    want, _ = jl.apply(params, {}, x)
    w_out, w_k, w_v = jl.apply_with_kv(params, x)
    with torch.no_grad():
        _close(want, tl.apply(torch.from_numpy(x)))
        out, k, v = tl.apply_with_kv(torch.from_numpy(x))
    _close(w_out, out)
    _close(w_k, k)
    _close(w_v, v)


def test_transformer_layer_decode_step_matches_jax():
    """Two slots, one mid-page and one crossing into a fresh page; the new
    token's K/V are written before attending, in place on the port side."""
    rng = np.random.default_rng(3)
    page, pps, n_slots = 4, 4, 2
    jl, params, tl = _layers(seed=3)
    cfg = JaxCfg(n_layers=1, n_heads=HEADS, head_dim=HIDDEN // HEADS,
                 n_slots=n_slots, page_size=page, pages_per_slot=pps)
    pool = JaxPool(cfg)
    n_pages = cfg.total_pages
    shape = (n_pages, page, HEADS, HIDDEN // HEADS)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    pos = np.array([6, 8], np.int32)
    table = np.zeros((n_slots, pps), np.int32)
    for i, p in enumerate(pos):
        n = p // page + 1
        table[i, :n] = pool.alloc(n)
    x = rng.normal(size=(n_slots, 1, HIDDEN)).astype(np.float32)
    want, wk, wv = jl.decode_step(params, x, jnp.asarray(kp),
                                  jnp.asarray(vp), table, pos,
                                  page_size=page)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        out, k2, v2 = tl.decode_step(torch.from_numpy(x), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(pos), page_size=page)
    assert k2 is tk and v2 is tv       # the pool is updated in place
    _close(want, out)
    _close(wk, tk)
    _close(wv, tv)


def test_precision_policy_and_as_compute():
    x = torch.ones(3)
    tmod.set_policy(compute_dtype="bfloat16")
    try:
        assert tmod.compute_dtype() == torch.bfloat16
        assert tmod.param_dtype() == torch.float32
        assert tmod.as_compute(x).dtype == torch.bfloat16
        assert tmod.as_compute(torch.ones(3, dtype=torch.int64)).dtype \
            == torch.int64
    finally:
        tmod.set_policy(compute_dtype=torch.float32)
    assert tmod.as_compute(x) is x
    with pytest.raises(ValueError, match="unsupported dtype"):
        tmod.set_policy(compute_dtype="float64")


def test_initializers_follow_the_jax_recipes():
    g = torch.Generator().manual_seed(0)
    w = tmod.glorot_uniform(g, (64, 192))
    limit = np.sqrt(6.0 / (64 + 192))
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.1 * limit
    e = tmod.embedding_normal(g, (256, 64))
    assert abs(float(e.std()) - 0.02) < 0.002
    assert float(tmod.zeros_init((5,)).abs().sum()) == 0.0
