"""The PyTorch port's TransformerLM against the JAX package's, on the CPU.

The JAX model is built with ``attn_strategy="flash"`` (its Pallas kernels
run in interpret mode here) and its own ``build`` weights are copied into the
port through ``bridge.params_from_jax``. Logits must agree within 1e-4 in
f32, and greedy decoding over both paged caches must pick identical tokens.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.ops.kv_cache import PagePool as JaxPool
from analytics_zoo_tpu.ops.kv_cache import SCRATCH_PAGE
from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
from analytics_zoo_tpu_torch.models.transformer import TransformerLM

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 96, 32, 2, 4, 64
PAGE = 4
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
               n_head=HEADS, seq_len=SEQ, attn_strategy="flash")
    params, _ = jm.build(jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                       n_head=HEADS, seq_len=SEQ, attn_strategy="flash",
                       device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    return jm, params, tree, tm


def test_apply_logits_match_jax(models):
    jm, params, _, tm = models
    x = np.random.default_rng(0).integers(0, VOCAB, size=(2, 24)) \
        .astype(np.int32)
    want, _ = jm.apply(params, {}, x)
    got = tm.apply(torch.from_numpy(x)).detach()
    assert got.shape == (2, 24, VOCAB)
    assert float(np.abs(np.asarray(want) - got.numpy()).max()) <= TOL


@pytest.mark.parametrize("paged_kernel", ["on", "default"])
def test_prefill_and_greedy_decode_match_jax(models, monkeypatch,
                                             paged_kernel):
    """Prefill two prompts of different lengths, then 6 greedy decode steps
    with both caches threaded; the JAX decode runs its interpreted K2
    (``ZOO_PAGED_ATTENTION=on``) or its default plain path."""
    if paged_kernel == "on":
        monkeypatch.setenv("ZOO_PAGED_ATTENTION", "on")
    else:
        monkeypatch.delenv("ZOO_PAGED_ATTENTION", raising=False)
    jm, params, _, tm = models
    rng = np.random.default_rng(1)
    lens = np.array([11, 6], np.int32)
    cfg, jcache = jm.init_kv_cache(2, page_size=PAGE, max_seq_len=32)
    _, tcache = tm.init_kv_cache(2, page_size=PAGE, max_seq_len=32)
    pool = JaxPool(cfg)
    table = np.full((2, cfg.pages_per_slot), SCRATCH_PAGE, np.int32)
    ids = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, VOCAB, size=n)
        table[i, :-(-n // PAGE)] = pool.alloc(-(-n // PAGE))
    jlog, jcache = jm.prefill(params, jcache, ids, lens, table,
                              page_size=PAGE)
    tlog, tcache = tm.prefill(tcache, ids, lens, table, page_size=PAGE)
    assert float(np.abs(np.asarray(jlog) - tlog.numpy()).max()) <= TOL
    jnext = np.asarray(jlog).argmax(-1).astype(np.int32)
    tnext = tlog.numpy().argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(jnext, tnext)
    zeros = np.zeros(2, np.uint32)
    temps = np.zeros(2, np.float32)
    for _ in range(6):
        for i in range(2):
            p = lens[i] // PAGE
            if table[i, p] == SCRATCH_PAGE:
                table[i, p] = pool.alloc(1)[0]
        jnext, jlog, jcache = jm.decode_step(params, jcache, jnext, lens,
                                             table, zeros, zeros, temps,
                                             page_size=PAGE)
        tn, tlog, tcache = tm.decode_step(tcache, tnext, lens, table, zeros,
                                          zeros, temps, page_size=PAGE)
        assert float(np.abs(np.asarray(jlog) - tlog.numpy()).max()) <= TOL
        jnext = np.asarray(jnext)
        tnext = tn.numpy()
        np.testing.assert_array_equal(jnext, tnext)
        lens = lens + 1
    for name in ("k", "v"):
        live = table[table != SCRATCH_PAGE]
        err = np.abs(np.asarray(jcache[name])[:, live]
                     - tcache[name][:, live].numpy()).max()
        assert float(err) <= TOL


def test_bridge_round_trip_is_lossless(models):
    _, _, tree, tm = models
    back = params_to_numpy(tm)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == leaf.dtype
        np.testing.assert_array_equal(node, leaf)


def test_bridge_keeps_bf16_bits():
    import ml_dtypes

    arr = (np.random.default_rng(2).normal(size=(3, 5))
           .astype(ml_dtypes.bfloat16))
    t = params_from_jax({"w": arr})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(t)
    np.testing.assert_array_equal(params_to_numpy(m)["w"].view(np.uint16),
                                  arr.view(np.uint16))


def test_init_kv_cache_validates_rounded_capacity(models):
    _, _, _, tm = models
    cfg, cache = tm.init_kv_cache(3, page_size=PAGE, max_seq_len=30)
    assert cfg.pages_per_slot == 8 and cache["k"].dtype == torch.float32
    assert cache["k"].shape == (BLOCKS, 3 * 8 + 1, PAGE, HEADS,
                                HIDDEN // HEADS)
    with pytest.raises(ValueError, match="position table"):
        tm.init_kv_cache(1, page_size=16, max_seq_len=SEQ + 1)


def test_entry_points_raise_without_cuda_and_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=1,
                      n_head=HEADS, seq_len=SEQ)


def test_seeded_init_is_deterministic_and_remat_unported():
    kw = dict(vocab=VOCAB, hidden_size=HIDDEN, n_block=1, n_head=HEADS,
              seq_len=SEQ, device="cpu")
    a, b = TransformerLM(seed=3, **kw), TransformerLM(seed=3, **kw)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert abs(float(a.token_embeddings.detach().std()) - 0.02) < 0.005
    # every remat mode is ported: True means "flash", as in the JAX
    # package, and an unknown mode is an error
    assert TransformerLM(remat=True, **kw).remat == "flash"
    assert TransformerLM(remat="full", **kw).remat == "full"
    assert TransformerLM(remat="dots", **kw).remat == "dots"
    assert TransformerLM(**kw).remat is False
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(remat="everything", **kw)


def test_bundles_load_in_either_direction(models, tmp_path):
    """A TransformerLM bundle the JAX package saves with its config (its
    ``save_model_bundle`` given ``constructor_config()``, as its zoo models'
    ``save_model`` do; the JAX ``KerasNet.save_model`` writes none) loads
    through the port's ``load_model_bundle`` and ``InferenceModel.
    load_zoo`` with the JAX logits within 1e-4; the port's own bundle round-trips and carries
    the JAX config keys, and both LM classes are registered."""
    from jax.sharding import Mesh

    from analytics_zoo_tpu.models.common.zoo_model import \
        save_model_bundle as jsave_model_bundle
    from analytics_zoo_tpu.models.transformer import lm_loss as jlm_loss
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.common.zoo_model import (
        MODEL_REGISTRY, load_model_bundle)
    from analytics_zoo_tpu_torch.models.transformer import \
        PipelinedTransformerLM

    jm, params, _, tm = models
    x = np.random.default_rng(5).integers(0, VOCAB, size=(3, 16)) \
        .astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6),
                ("dp", "fsdp", "tp", "sp", "pp", "ep"))
    jm.compile(optimizer="sgd", loss=jlm_loss, mesh=mesh)
    jm.estimator.initial_weights = (params, {})
    jm.estimator.train_state = jm.estimator._init_state((x, x))
    jsave_model_bundle(str(tmp_path / "jax"), jm,
                       config=jm.constructor_config())
    want = np.asarray(jm.apply(params, {}, x)[0])
    back, cfg = load_model_bundle(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back, TransformerLM) and cfg["class"] == "TransformerLM"
    assert back.constructor_config() == jm.constructor_config() == \
        tm.constructor_config()
    with torch.no_grad():
        got = back.apply(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= TOL
    im = InferenceModel(1, 8, device="cpu").load_zoo(str(tmp_path / "jax"))
    assert float(np.abs(im.predict(x) - want).max()) <= TOL
    tm.save_model(str(tmp_path / "pt"))
    again, _ = load_model_bundle(str(tmp_path / "pt"), device="cpu")
    with torch.no_grad():
        assert torch.equal(again.apply(torch.from_numpy(x)),
                           tm.apply(torch.from_numpy(x)))
    assert MODEL_REGISTRY["TransformerLM"] is TransformerLM
    assert MODEL_REGISTRY["PipelinedTransformerLM"] is PipelinedTransformerLM
    pp = PipelinedTransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=2,
                                n_head=HEADS, seq_len=SEQ, device="cpu")
    pp.save_model(str(tmp_path / "pp"))
    pback, _ = load_model_bundle(str(tmp_path / "pp"), device="cpu")
    assert pback.constructor_config() == pp.constructor_config()
    with torch.no_grad():
        assert torch.equal(pback.apply(torch.from_numpy(x)),
                           pp.apply(torch.from_numpy(x)))
