"""The PyTorch port's shared-prefix KV cache against the JAX package's, on
the CPU.

``prefix_block_key`` gives JAX's hex keys; the port's ``PagePool`` and
``PrefixCache`` keep JAX's refcount and conservation laws, LRU eviction
with active pins, the chain hash's freedom from positional collisions and
the write-isolation check's polarity; ``copy_page`` copies as JAX's does;
``TransformerLM.prefill_from`` gives JAX's logits and K/V pages within
1e-5, also where the suffix bucket reaches past the page table (those
writes are dropped, as JAX's scatter drops them). In the batcher, warm
streams equal cold ones with and without speculation, and a random
workload leaves the pool conserved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.analysis.rules.decode import \
    lint_prefix_write_isolation as jax_lint
from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.ops import kv_cache as jkv
from analytics_zoo_tpu_torch.analysis.rules.decode import \
    lint_prefix_write_isolation
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.ops.kv_cache import (KVCacheConfig, OutOfPages,
                                                  PagePool, PrefixCache,
                                                  SCRATCH_PAGE, copy_page,
                                                  prefix_block_key)
from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 64, 32, 2, 2, 256


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS, n_head=HEADS,
               seq_len=SEQ)
    params, _ = jm.build(jax.random.PRNGKey(0))
    tm = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                       n_head=HEADS, seq_len=SEQ, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _mk(tm, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seq_len", 128)
    return ContinuousBatcher(tm, device="cpu", **kw)


def _pool(n_slots=2, pages_per_slot=4, page_size=4):
    cfg = KVCacheConfig(n_layers=1, n_heads=1, head_dim=4, n_slots=n_slots,
                        page_size=page_size, pages_per_slot=pages_per_slot)
    return PagePool(cfg)


# ------------------------------------------------------------ keys and pool

def test_prefix_block_key_matches_jax():
    rng = np.random.default_rng(0)
    parent = None
    for n in (1, 4, 16, 33):
        toks = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
        for p in (None, parent):
            assert prefix_block_key(p, toks) == jkv.prefix_block_key(p, toks)
        assert prefix_block_key(parent, toks.tolist()) == \
            jkv.prefix_block_key(parent, toks)
        parent = jkv.prefix_block_key(parent, toks)
    assert len(parent) == 32


def test_pagepool_refcount_semantics():
    pool = _pool()
    (a, b) = pool.alloc(2)
    assert pool.ref_count(a) == 1 and pool.ref_count(b) == 1
    pool.incref([a])
    assert pool.ref_count(a) == 2
    assert pool.shared_count() == 1
    free_before = pool.free_count()
    pool.release([a])                       # decref: still held
    assert pool.ref_count(a) == 1
    assert pool.free_count() == free_before
    pool.release([a])                       # last ref: reclaimed
    assert pool.ref_count(a) == 0
    assert pool.free_count() == free_before + 1
    with pytest.raises(ValueError, match="double free"):
        pool.release([a])
    with pytest.raises(ValueError, match="use-after-free"):
        pool.incref([a])
    pool.release([b])
    pool.check_conservation()
    assert pool.free_count() == pool.capacity


def test_pagepool_conservation_property():
    """Random alloc/incref/release sequences: every page stays exactly one
    of free or held, and a referenced page is never reclaimed."""
    rng = np.random.default_rng(17)
    pool = _pool(n_slots=4, pages_per_slot=4)
    holders = []                           # one entry per outstanding ref
    for _ in range(600):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 4))
            try:
                pages = pool.alloc(n)
            except OutOfPages:
                continue
            holders.extend(pages)
        elif op == 1 and holders:
            p = holders[int(rng.integers(0, len(holders)))]
            pool.incref([p])
            holders.append(p)
        elif op == 2 and holders:
            p = holders.pop(int(rng.integers(0, len(holders))))
            pool.release([p])
            if p in holders:
                assert pool.ref_count(p) == holders.count(p)
        pool.check_conservation()
        assert pool.free_count() + pool.held_count() == pool.capacity
    pool.release(holders)
    pool.check_conservation()
    assert pool.free_count() == pool.capacity


def test_prefix_cache_property_random_admit_retire_evict():
    """Random streams lookup, publish and retire against a small pool with
    a tight cache budget (constant evictions); conservation holds after
    every operation."""
    rng = np.random.default_rng(23)
    pool = _pool(n_slots=8, pages_per_slot=8, page_size=4)
    cache = PrefixCache(pool, block_tokens=4, page_size=4, max_pages=10)
    prefixes = [list(rng.integers(1, 50, size=12)) for _ in range(4)]
    streams = []                    # (row_pages, keys)
    for _ in range(250):
        op = rng.integers(0, 3)
        if op == 0 and len(streams) < 6:   # admit
            prompt = (prefixes[int(rng.integers(0, 4))]
                      + list(rng.integers(50, 60,
                                          size=int(rng.integers(1, 5)))))
            n_pg = -(-len(prompt) // 4)
            match = cache.lookup(prompt)
            row = list(match.pages) if match else []
            keys = match.keys if match else []
            try:
                row += pool.alloc(n_pg - len(row))
            except OutOfPages:
                cache.reclaim_pages(n_pg - len(row))
                if keys:
                    cache.release_stream(keys)
                pool.release(row)
                pool.check_conservation()
                continue
            cache.publish(np.asarray(prompt, np.int32), len(prompt), row)
            cache.evict_to_budget()
            streams.append((row, keys))
        elif op == 1 and streams:          # retire
            row, keys = streams.pop(int(rng.integers(0, len(streams))))
            pool.release(row)
            cache.release_stream(keys)
        elif op == 2:                      # eviction sweep / invalidate
            if rng.integers(0, 10) == 0:
                cache.invalidate()
            else:
                cache.evict_to_budget()
        pool.check_conservation()
        assert cache.held_pages() <= pool.held_count()
    for row, keys in streams:
        pool.release(row)
        cache.release_stream(keys)
    cache.invalidate()
    pool.check_conservation()
    assert pool.free_count() == pool.capacity


def test_prefix_chain_hash_no_positional_collision():
    """Identical block tokens under different prefixes key differently,
    and lookup is longest-prefix."""
    pool = _pool(n_slots=4, pages_per_slot=8, page_size=4)
    cache = PrefixCache(pool, block_tokens=4, page_size=4, max_pages=64)
    blk = np.asarray([9, 9, 9, 9], np.int32)
    parent = prefix_block_key(None, np.asarray([1, 2, 3, 4], np.int32))
    assert prefix_block_key(None, blk) != prefix_block_key(parent, blk)

    p1 = pool.alloc(2)
    cache.publish(np.asarray([1, 2, 3, 4, 9, 9, 9, 9], np.int32), 8, p1)
    assert cache.lookup([9, 9, 9, 9, 7]) is None        # root block differs
    m = cache.lookup([1, 2, 3, 4, 9, 9, 9, 9, 7])
    assert m is not None and m.n_tokens == 8 and m.pages == list(p1)
    cache.release_stream(m.keys)
    pool.release(m.pages)
    m2 = cache.lookup([1, 2, 3, 4, 5, 5, 5, 5, 7])      # only first block
    assert m2 is not None and m2.n_tokens == 4
    cache.release_stream(m2.keys)
    pool.release(m2.pages)
    assert cache.stats()["hits"] == 2 and cache.stats()["misses"] == 1
    cache.invalidate()
    pool.release(p1)
    pool.check_conservation()


def test_prefix_cache_lru_eviction_and_active_pin():
    pool = _pool(n_slots=4, pages_per_slot=8, page_size=4)
    cache = PrefixCache(pool, block_tokens=4, page_size=4, max_pages=2)
    rows = [pool.alloc(1) for _ in range(3)]
    for i, row in enumerate(rows):
        cache.publish(np.asarray([i, i, i, i], np.int32), 4, row)
    assert cache.held_pages() == 3
    # entry 0 is stream-active: the sweep must skip it though it is LRU
    m = cache.lookup([0, 0, 0, 0, 7])
    assert m is not None
    sweep = cache.evict_to_budget()
    assert cache.held_pages() <= 2 and sweep["pages"] >= 1
    m2 = cache.lookup([0, 0, 0, 0, 7])   # pinned survivor still matchable
    assert m2 is not None
    for match in (m, m2):                # each lookup took its own refs
        cache.release_stream(match.keys)
        pool.release(match.pages)
    cache.invalidate()
    for row in rows:
        pool.release(row)
    pool.check_conservation()
    assert pool.free_count() == pool.capacity


def test_prefix_cache_validates_its_geometry():
    pool = _pool()
    for kw in (dict(block_tokens=6, page_size=4, max_pages=4),
               dict(block_tokens=0, page_size=4, max_pages=4),
               dict(block_tokens=4, page_size=4, max_pages=0)):
        with pytest.raises(ValueError):
            PrefixCache(pool, **kw)
        with pytest.raises(ValueError):
            jkv.PrefixCache(jkv.PagePool(pool.cfg), **kw)


def test_prefix_write_isolation_lint_polarity():
    for lint, pool in ((lint_prefix_write_isolation, _pool()),
                       (jax_lint, jkv.PagePool(_pool().cfg))):
        shared = pool.alloc(1)
        pool.incref(shared)                 # simulated second holder
        own = pool.alloc(1)
        # clean: the shared page is below start, the written one exclusive
        assert lint(pool, shared + own, 4, page_size=4) == []
        # violation: the suffix would write into the shared page
        bad = lint(pool, shared + own, 0, page_size=4)
        assert len(bad) == 1 and bad[0].rule == "prefix-share-isolation"
        assert bad[0].severity == "error" and "3 references" not in \
            bad[0].message and "2 references" in bad[0].message
        pool.release(shared + shared + own)
        pool.check_conservation()


# ------------------------------------------------------------- device ops

def test_copy_page_matches_jax():
    rng = np.random.default_rng(1)
    cache = {n: rng.normal(size=(2, 6, 4, 2, 8)).astype(np.float32)
             for n in ("k", "v")}
    want = jkv.copy_page({n: jnp.asarray(a) for n, a in cache.items()}, 2, 5)
    got = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    out = copy_page(got, 2, 5)
    assert out is got
    for n in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(want[n]), got[n].numpy())


@pytest.mark.parametrize("n_prefix,n_prompt", [(16, 26), (20, 30)])
def test_prefill_from_matches_jax(models, n_prefix, n_prompt):
    """A prefix in the cache, then the suffix from the divergence point:
    logits and the slot's pages within 1e-5. (20, 30): the 16-token bucket
    covers positions 20..35 over a table of 8 pages of 4 (32 positions),
    so its last writes fall past the table and are dropped."""
    jm, params, tm = models
    rng = np.random.default_rng(n_prefix)
    prompt = rng.integers(1, VOCAB, size=n_prompt).astype(np.int32)
    cfg, jcache = jm.init_kv_cache(2, page_size=4, max_seq_len=32)
    _, tcache = tm.init_kv_cache(2, page_size=4, max_seq_len=32)
    row = jkv.PagePool(cfg).alloc(-(-n_prompt // 4))
    table = np.full((1, cfg.pages_per_slot), SCRATCH_PAGE, np.int32)
    table[0, :len(row)] = row
    ids = np.zeros((1, 32), np.int32)
    ids[0, :n_prefix] = prompt[:n_prefix]
    lens = np.array([n_prefix], np.int32)
    _, jcache = jm.prefill(params, jcache, ids, lens, table, page_size=4)
    tm.prefill(tcache, ids, lens, table, page_size=4)
    n_suffix = n_prompt - n_prefix
    bucket = 16
    sids = np.zeros((1, bucket), np.int32)
    sids[0, :n_suffix] = prompt[n_prefix:]
    start = np.array([n_prefix], np.int32)
    total = np.array([n_prompt], np.int32)
    jlog, jcache = jm.prefill_from(params, jcache, sids, start, total,
                                   table, page_size=4)
    tlog, _ = tm.prefill_from(tcache, sids, start, total, table,
                              page_size=4)
    assert float(np.abs(np.asarray(jlog) - tlog.numpy()).max()) <= 1e-5
    for leaf in ("k", "v"):
        err = np.abs(np.asarray(jcache[leaf])[:, row]
                     - tcache[leaf][:, row].numpy()).max()
        assert float(err) <= 1e-5
    # and the whole prompt prefilled at once gives the same logits
    ids[0, :n_prompt] = prompt
    _, fresh = tm.init_kv_cache(2, page_size=4, max_seq_len=32)
    whole, _ = tm.prefill(fresh, ids, total, table, page_size=4)
    assert float((whole - tlog).abs().max()) <= 1e-5


# ------------------------------------------------------------------ batcher

PREFIX = list(range(1, 41))     # 40 tokens, page-aligned at page_size=8


@pytest.mark.parametrize("spec_k", [0, 3])
def test_warm_streams_identical_to_cold(models, spec_k):
    """A warm-prefix stream's tokens equal its cold run at both
    temperatures, including the whole-prompt copy-on-write case."""
    tm = models[2]
    cold = _mk(tm, spec_k=spec_k)
    warm = _mk(tm, spec_k=spec_k, prefix_cache_pages=32)
    try:
        prompts = [PREFIX + [50 + u, 51 + u] for u in range(3)]
        prompts.append(PREFIX)              # block-aligned: COW boundary
        for temperature in (0.0, 0.8):
            cold_out = [cold.generate(p, max_new_tokens=8,
                                      temperature=temperature, seed=11 + i)
                        for i, p in enumerate(prompts)]
            warm_out = [warm.generate(p, max_new_tokens=8,
                                      temperature=temperature, seed=11 + i)
                        for i, p in enumerate(prompts)]
            assert cold_out == warm_out
        st = warm.stats()
        # pass 1: 3 hits + 1 publishing miss; pass 2: all 4 prompts hit
        assert st["prefix"]["hits"] == 7
        assert st["prefix"]["tokens_saved"] == 5 * 40 + 2 * 39
        assert st["dispatches"]["prefill_from"] == 7
        assert st["dispatches"]["prefill"] == 1
    finally:
        cold.close()
        warm.close()
    warm.pool.check_conservation()
    assert warm.pool.free_count() == warm.pool.capacity


def test_batcher_random_workload_refcount_conservation(models):
    """Concurrent warm and cold streams over a small pool and a tight cache
    budget: afterwards the pool sums to capacity minus cache-held pages,
    every held page is reclaimable, and conservation holds."""
    tm = models[2]
    rng = np.random.default_rng(5)
    b = _mk(tm, n_slots=2, prefix_cache_pages=8, prefix_block_tokens=8)
    try:
        handles = []
        for i in range(12):
            pre = PREFIX[:16] if rng.integers(0, 2) else PREFIX[:24]
            prompt = pre + list(rng.integers(50, 60,
                                             size=int(rng.integers(1, 4))))
            handles.append(b.submit(
                prompt, max_new_tokens=int(rng.integers(2, 8)),
                temperature=float(rng.choice([0.0, 0.7])), seed=i))
        outs = [h.result(timeout_s=120) for h in handles]
        assert all(outs)
        b.pool.check_conservation()
        held = b.prefix_cache.held_pages()
        assert 0 < held <= 8                 # budget respected
        assert b.pool.free_count() == b.pool.capacity - held
        assert b.prefix_cache.reclaimable_pages() == held
        assert b.stats()["prefix"]["hits"] >= 1
    finally:
        b.close()
    b.pool.check_conservation()
    assert b.pool.free_count() == b.pool.capacity


def test_failed_prefill_releases_every_reference(models, monkeypatch):
    """A prefill that raises after a prefix hit hands back the stream's
    page references and its active marks exactly once: the pool holds
    only the cache's pages and every entry is evictable again."""
    tm = models[2]
    b = _mk(tm, n_slots=1, prefix_cache_pages=32)
    try:
        b.generate(PREFIX + [50], max_new_tokens=1)
        held = b.prefix_cache.held_pages()

        def boom(*a, **k):
            raise RuntimeError("injected prefill failure")

        monkeypatch.setattr(tm, "prefill_from", boom)
        with pytest.raises(RuntimeError, match="injected"):
            b.generate(PREFIX + [51], max_new_tokens=2)
        monkeypatch.undo()
        assert b.prefix_cache.stats()["stream_active_entries"] == 0
        assert b.pool.free_count() == b.pool.capacity - held
        b.pool.check_conservation()
        assert b.generate(PREFIX + [51], max_new_tokens=2)
    finally:
        b.close()
    assert b.pool.free_count() == b.pool.capacity
