"""The PyTorch port's chunked prefill against the JAX package's, on the CPU.

The budget arithmetic (``prefill_budget_decision``, ``ServiceTimeEMA``) is
JAX's; ``TransformerLM.prefill_chunk`` gives JAX's logits and K/V pages
chunk by chunk within 1e-5, and the same as the port's whole-prompt
prefill within 1e-5 (the JAX package's chunk-vs-whole test asks for bits
and fails on its own tree by ~1e-6: the paged multi-query path sums in
another order, so the port states a tolerance). Padding rows past the
position table read its last row, so a chunk past ``seq_len`` stays finite
(the JAX lookup fills NaN there and its chunked stream emits a NaN-logit
token). In the batcher, chunking is a scheduling change only: streams
equal the whole-prompt batcher's at temperature 0 and 0.8, with and
without speculation, cold and warm prefixes, and running streams advance
every loop pass while a long prompt prefills.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.ops.kv_cache import PagePool as JaxPool
from analytics_zoo_tpu.ops.kv_cache import SCRATCH_PAGE
from analytics_zoo_tpu.serving import qos as jqos
from analytics_zoo_tpu.serving.generation import \
    ContinuousBatcher as JaxBatcher
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.serving import qos as tqos
from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

VOCAB, HIDDEN, BLOCKS, HEADS = 64, 32, 2, 2


def _pair(seq_len):
    jm = JaxLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS, n_head=HEADS,
               seq_len=seq_len)
    params, _ = jm.build(jax.random.PRNGKey(0))
    tm = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                       n_head=HEADS, seq_len=seq_len, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return _pair(256)


@pytest.fixture(scope="module")
def short_models():
    """seq_len == max_seq_len: the last chunk's padding runs past the
    position table."""
    return _pair(32)


def _mk(tm, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seq_len", 128)
    return ContinuousBatcher(tm, device="cpu", **kw)


# ------------------------------------------------------------- budget math

def test_prefill_budget_decision_matches_jax():
    grid = []
    for chunk in (0, 1, 16, 64):
        for static in (0, 10, 40, 160):
            for itl in (None, 0.0, 0.03, 0.1):
                for dec in (0.0, 0.02, 0.2):
                    for ch in (0.0, 0.01, 1.0):
                        grid.append({"chunk_tokens": chunk,
                                     "static_budget": static,
                                     "itl_target_s": itl,
                                     "decode_ema_s": dec,
                                     "chunk_ema_s": ch, "extra": 1})
    for inp in grid:
        assert tqos.prefill_budget_decision(inp) == \
            jqos.prefill_budget_decision(inp)
        if inp["itl_target_s"]:
            args = (inp["itl_target_s"], inp["decode_ema_s"],
                    inp["chunk_ema_s"], inp["chunk_tokens"])
            assert tqos.prefill_budget_from_slo(*args) == \
                jqos.prefill_budget_from_slo(*args)


def test_service_time_ema_matches_jax():
    rng = np.random.default_rng(0)
    for alpha in (0.2, 0.5, 1.0):
        t, j = tqos.ServiceTimeEMA(alpha), jqos.ServiceTimeEMA(alpha)
        assert t.value() == j.value() == 0.0
        for x in list(rng.exponential(0.01, size=50)) + [-1.0, 0.0]:
            t.observe(x)
            j.observe(x)
            assert t.value() == j.value()
        assert t.observations() == j.observations() == 52


def test_batcher_rejects_invalid_chunk_config(models):
    tm = models[2]
    kw = dict(n_slots=2, page_size=8, max_seq_len=64, autostart=False)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        ContinuousBatcher(tm, device="cpu", prefill_chunk_tokens=12, **kw)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        ContinuousBatcher(tm, device="cpu", prefill_chunk_tokens=-8, **kw)
    with pytest.raises(ValueError, match="prefill_token_budget"):
        ContinuousBatcher(tm, device="cpu", prefill_token_budget=-1, **kw)
    with pytest.raises(ValueError, match="requires"):
        ContinuousBatcher(tm, device="cpu", prefill_token_budget=64, **kw)
    b = ContinuousBatcher(tm, device="cpu", prefill_chunk_tokens=16,
                          prefill_token_budget=64, prefill_slo_itl_s=0.05,
                          **kw)
    assert b.stats()["prefill"]["chunk_tokens"] == 16
    b.close()


# ------------------------------------------------------------- model level

def _chunk_case(cfg, seq, ct, pool, start=0):
    n = len(seq)
    row = pool.alloc(-(-n // cfg.page_size))
    wide = np.full((1, cfg.pages_per_slot + ct // cfg.page_size),
                   SCRATCH_PAGE, np.int32)
    wide[0, :len(row)] = row
    chunks = []
    for n_done in range(start, n, ct):
        n_valid = min(ct, n - n_done)
        ids = np.zeros((1, ct), np.int32)
        ids[0, :n_valid] = seq[n_done:n_done + n_valid]
        chunks.append((ids, np.array([n_done], np.int32),
                       np.array([n_valid], np.int32)))
    return row, wide, chunks


def test_prefill_chunk_matches_jax_chunk_by_chunk(models):
    jm, params, tm = models
    seq = np.random.default_rng(3).integers(1, VOCAB, size=14)
    cfg, jcache = jm.init_kv_cache(n_slots=2, page_size=4, max_seq_len=32)
    _, tcache = tm.init_kv_cache(n_slots=2, page_size=4, max_seq_len=32)
    row, wide, chunks = _chunk_case(cfg, seq, 8, JaxPool(cfg))
    for ids, n_done, n_valid in chunks:
        jlog, jcache = jm.prefill_chunk(params, jcache, ids, n_done, n_valid,
                                        wide, page_size=4)
        tlog, _ = tm.prefill_chunk(tcache, ids, n_done, n_valid, wide,
                                   page_size=4)
        assert float(np.abs(np.asarray(jlog) - tlog.numpy()).max()) <= 1e-5
        for leaf in ("k", "v"):
            err = np.abs(np.asarray(jcache[leaf])[:, row]
                         - tcache[leaf][:, row].numpy()).max()
            assert float(err) <= 1e-5


def test_prefill_chunk_matches_whole_prefill(models):
    """The port's chunked prefill against its whole-prompt prefill: logits
    and the slot's pages within 1e-5."""
    _, _, tm = models
    seq = np.random.default_rng(3).integers(1, VOCAB, size=14)
    cfg, whole = tm.init_kv_cache(n_slots=2, page_size=4, max_seq_len=32)
    _, chunked = tm.init_kv_cache(n_slots=2, page_size=4, max_seq_len=32)
    row, wide, chunks = _chunk_case(cfg, seq, 8, JaxPool(cfg))
    ids = np.zeros((1, 16), np.int32)
    ids[0, :14] = seq
    table = wide[:, :cfg.pages_per_slot]
    want, _ = tm.prefill(whole, ids, np.array([14], np.int32), table,
                         page_size=4)
    for ids, n_done, n_valid in chunks:
        got, _ = tm.prefill_chunk(chunked, ids, n_done, n_valid, wide,
                                  page_size=4)
    assert float((want - got).abs().max()) <= 1e-5
    for leaf in ("k", "v"):
        assert float((whole[leaf][:, row] - chunked[leaf][:, row])
                     .abs().max()) <= 1e-5


def test_chunk_past_the_position_table_stays_finite(short_models):
    """The probe case (seq_len 32 == max_seq_len, page 4, chunks of 8): a
    20-token prefix published before a 30-token prompt that shares it, so
    the last chunk covers positions 28..35. The port's chunked stream is
    its whole-prompt stream and the JAX whole-prompt stream; the chunk's
    logits and the pool stay finite."""
    jm, params, tm = short_models
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, VOCAB, size=20).tolist()
    prompt = prefix + rng.integers(1, VOCAB, size=10).tolist()
    kw = dict(n_slots=2, page_size=4, max_seq_len=32)
    jb = JaxBatcher(jm, params, **kw)
    try:
        want = jb.generate(prompt, max_new_tokens=2)
    finally:
        jb.close()
    outs = {}
    for name, extra in (("whole", {}),
                        ("chunked", dict(prefill_chunk_tokens=8,
                                         prefix_cache_pages=16))):
        b = ContinuousBatcher(tm, device="cpu", **kw, **extra)
        try:
            b.generate(prefix, max_new_tokens=1)
            outs[name] = b.generate(prompt, max_new_tokens=2)
            for leaf in ("k", "v"):
                assert bool(torch.isfinite(b.cache[leaf]).all())
            if extra:
                st = b.stats()
                assert st["prefix"]["hits"] == 1
                assert st["prefix"]["tokens_saved"] == 20
        finally:
            b.close()
    assert outs["chunked"] == outs["whole"] == want
    # the chunks themselves, from position 20: rows 30..35 of the second
    # run past the 32-row position table
    cfg, cache = tm.init_kv_cache(n_slots=1, page_size=4, max_seq_len=32)
    row, wide, chunks = _chunk_case(cfg, np.asarray(prompt), 8,
                                    JaxPool(cfg), start=20)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :20] = prefix
    table = wide[:, :cfg.pages_per_slot]
    tm.prefill(cache, ids, np.array([20], np.int32), table, page_size=4)
    ids[0, :30] = prompt
    _, ref_cache = tm.init_kv_cache(n_slots=1, page_size=4, max_seq_len=32)
    ref, _ = tm.prefill(ref_cache, ids, np.array([30], np.int32), table,
                        page_size=4)
    for ids, n_done, n_valid in chunks:
        got, _ = tm.prefill_chunk(cache, ids, n_done, n_valid, wide,
                                  page_size=4)
    assert int(n_done[0]) + 8 > 32
    assert bool(torch.isfinite(got).all())
    assert bool(torch.isfinite(cache["k"]).all())
    assert float((got - ref).abs().max()) <= 1e-5


# ------------------------------------------------------------------ batcher

PREFIX = list(range(1, 41))     # 40 tokens, page-aligned at page_size=8


@pytest.mark.parametrize("spec_k", [0, 3])
def test_chunked_streams_identical_to_whole_prompt(models, spec_k):
    """Chunked prefill (16) is a scheduling change only: tokens identical
    to the whole-prompt batcher at both temperatures, cold and warm
    prefixes, including the whole-prompt-cached copy-on-write case, and
    one chunk shape."""
    tm = models[2]
    whole = _mk(tm, spec_k=spec_k, prefix_cache_pages=32)
    chunked = _mk(tm, spec_k=spec_k, prefix_cache_pages=32,
                  prefill_chunk_tokens=16)
    try:
        prompts = [PREFIX + [50 + u, 51 + u] for u in range(3)]
        prompts.append(PREFIX)              # block-aligned: COW boundary
        for temperature in (0.0, 0.8):
            w = [whole.generate(p, max_new_tokens=8,
                                temperature=temperature, seed=11 + i)
                 for i, p in enumerate(prompts)]
            c = [chunked.generate(p, max_new_tokens=8,
                                  temperature=temperature, seed=11 + i)
                 for i, p in enumerate(prompts)]
            assert w == c
        st = chunked.stats()
        assert st["prefill"]["distinct_chunk_shapes"] == 1
        assert st["prefill"]["chunks"] > 0
        assert st["prefix"]["hits"] >= 7    # warm suffix chunks still hit
        assert st["dispatches"]["prefill"] == 0
        if spec_k:
            assert st["spec"]["steps"] >= 1
    finally:
        whole.close()
        chunked.close()
    for b in (whole, chunked):
        b.pool.check_conservation()
        assert b.pool.free_count() == b.pool.capacity


def test_decode_advances_every_pass_while_a_long_prompt_prefills(models):
    """A 12-chunk prompt lands while a short stream decodes: at most one
    chunk (the budget floor) runs between two of the short stream's
    tokens, the short stream finishes first, and its tokens equal its solo
    run."""
    tm = models[2]
    solo = _mk(tm, prefill_chunk_tokens=8)
    b = _mk(tm, prefill_chunk_tokens=8)
    try:
        short_prompt = [7, 8, 9]
        baseline = solo.generate(short_prompt, max_new_tokens=10, seed=5)
        long_prompt = list(np.random.default_rng(0).integers(1, VOCAB, 96))
        seen_chunks = []
        first = threading.Event()

        def on_short(tokens, final, meta):
            if tokens:
                seen_chunks.append(b.prefill_chunks_total)
                first.set()

        h_short = b.submit(short_prompt, max_new_tokens=10, seed=5,
                           on_chunk=on_short)
        assert first.wait(60)
        h_long = b.submit(long_prompt, max_new_tokens=2, seed=1)
        short = h_short.result(timeout_s=120)
        chunks_when_short_done = b.prefill_chunks_total
        assert h_long.result(timeout_s=120)
        assert short == baseline
        steps = np.diff(seen_chunks)
        assert steps.max() <= 1 and steps.sum() >= 1
        assert chunks_when_short_done < 12
    finally:
        b.close()
        solo.close()
    b.pool.check_conservation()
    assert b.pool.free_count() == b.pool.capacity
