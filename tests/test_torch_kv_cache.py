"""Parity of the PyTorch port's paged KV cache ops, page pool and sampling
with the JAX package, on the CPU (f32, max |diff| <= 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import kv_cache as jkv
from analytics_zoo_tpu_torch.ops import kv_cache as tkv

TOL = 1e-5
PAGE, PPS, H, D, SLOTS = 4, 4, 2, 8, 3


def _pool_case(rng):
    n_pages = SLOTS * PPS + 1
    shape = (n_pages, PAGE, H, D)
    pages = rng.normal(size=shape).astype(np.float32)
    table = np.zeros((SLOTS, PPS), np.int32)
    table[0, :2] = [1, 2]
    table[1, :3] = [5, 3, 7]
    # slot 2 is inactive: all scratch
    return pages, table


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy()
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol


def test_paged_write_in_place_matches_jax():
    rng = np.random.default_rng(0)
    pages, table = _pool_case(rng)
    pos = np.array([5, 9, 0], np.int32)
    new = rng.normal(size=(SLOTS, H, D)).astype(np.float32)
    want = jkv.paged_write(jnp.asarray(pages), table, pos, new,
                           page_size=PAGE)
    got = torch.from_numpy(pages.copy())
    out = tkv.paged_write(got, torch.from_numpy(table), torch.from_numpy(pos),
                          torch.from_numpy(new), page_size=PAGE)
    assert out is got
    # slot 2 writes into scratch (page 0) — identical on both sides
    _close(want, got, 0.0)


def test_paged_write_multi_and_read_match_jax():
    rng = np.random.default_rng(1)
    pages, table = _pool_case(rng)
    pos = np.array([3, 6, 0], np.int32)
    new = rng.normal(size=(SLOTS, 3, H, D)).astype(np.float32)
    want = jkv.paged_write_multi(jnp.asarray(pages), table, pos, new,
                                 page_size=PAGE)
    got = torch.from_numpy(pages.copy())
    tkv.paged_write_multi(got, torch.from_numpy(table), torch.from_numpy(pos),
                          torch.from_numpy(new), page_size=PAGE)
    # rows of live slots are exact; slot 2's 3 scratch writes race for the
    # same page-0 rows, as in the JAX scatter, so compare pages 1.. only
    _close(np.asarray(want)[1:], got[1:], 0.0)
    _close(jkv.paged_read(want, table)[:2],
           tkv.paged_read(got, torch.from_numpy(table))[:2], 0.0)


def test_prefill_write_matches_jax_and_rejects_ragged_bucket():
    rng = np.random.default_rng(2)
    pages, table = _pool_case(rng)
    kv = rng.normal(size=(SLOTS, 8, H, D)).astype(np.float32)
    want = jkv.prefill_write(jnp.asarray(pages), table, kv, page_size=PAGE)
    got = torch.from_numpy(pages.copy())
    tkv.prefill_write(got, torch.from_numpy(table), torch.from_numpy(kv),
                      page_size=PAGE)
    _close(np.asarray(want)[1:], got[1:], 0.0)
    with pytest.raises(ValueError, match="page_size"):
        tkv.prefill_write(got, torch.from_numpy(table),
                          torch.zeros(SLOTS, 6, H, D), page_size=PAGE)


@pytest.mark.parametrize("t_new", [1, 3])
def test_decode_attention_matches_jax(t_new):
    rng = np.random.default_rng(3 + t_new)
    t_max = PPS * PAGE
    q = rng.normal(size=(SLOTS, t_new, H, D)).astype(np.float32)
    k = rng.normal(size=(SLOTS, t_max, H, D)).astype(np.float32)
    v = rng.normal(size=(SLOTS, t_max, H, D)).astype(np.float32)
    lengths = np.array([t_new, 9, t_max], np.int32)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lengths))
    _close(jkv.decode_attention_multi(q, k, v, lengths),
           tkv.decode_attention_multi(tq, tk, tv, tl))
    if t_new == 1:
        _close(jkv.decode_attention(q[:, 0], k, v, lengths),
               tkv.decode_attention(tq[:, 0], tk, tv, tl))


def test_kv_cache_config_and_init_cache():
    cfg = tkv.KVCacheConfig(n_layers=2, n_heads=H, head_dim=D, n_slots=3,
                            page_size=PAGE, pages_per_slot=PPS)
    assert cfg.max_seq_len == PAGE * PPS and cfg.total_pages == 3 * PPS + 1
    cache = tkv.init_cache(cfg, "cpu")
    assert cache["k"].shape == (2, cfg.total_pages, PAGE, H, D)
    assert float(cache["v"].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        tkv.KVCacheConfig(n_layers=1, n_heads=1, head_dim=1, n_slots=1,
                          n_pages=1)


def test_page_pool_refcounts_and_conservation():
    cfg = tkv.KVCacheConfig(n_layers=1, n_heads=1, head_dim=1, n_slots=2,
                            page_size=PAGE, pages_per_slot=3)
    pool = tkv.PagePool(cfg)
    assert pool.capacity == 6
    a = pool.alloc(4)
    assert tkv.SCRATCH_PAGE not in a
    pool.incref(a[:2])
    assert pool.shared_count() == 2 and pool.ref_count(a[0]) == 2
    pool.release(a)
    assert pool.held_count() == 2 and pool.free_count() == 4
    pool.check_conservation()
    with pytest.raises(tkv.OutOfPages):
        pool.alloc(5)
    pool.release(a[:2])
    with pytest.raises(ValueError, match="double free"):
        pool.release(a[:1])
    with pytest.raises(ValueError, match="use-after-free"):
        pool.incref(a[:1])
    pool.release([tkv.SCRATCH_PAGE])          # scratch is never freed
    pool.check_conservation()
    assert pool.free_count() == pool.capacity


# ------------------------------------------------------------------ sampling

def test_greedy_sampling_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 16)).astype(np.float32)
    logits[1, [3, 9]] = 10.0       # tie: both packages take the first index
    z = np.zeros(4, np.uint32)
    want = jkv.sample_tokens(jnp.asarray(logits), z, z,
                             np.zeros(4, np.float32))
    got = tkv.sample_tokens(torch.from_numpy(logits), z, z,
                            np.zeros(4, np.float32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert int(got[1]) == 3


def test_sampling_is_keyed_by_seed_and_token_index():
    """A stream's token depends on (seed, token_idx) only — not on the row
    or the batch it is sampled in."""
    rng = np.random.default_rng(6)
    row = rng.normal(size=32).astype(np.float32)
    logits = torch.from_numpy(np.stack([row] * 4))
    temps = np.full(4, 1.0, np.float32)
    a = tkv.sample_tokens(logits, [7, 7, 8, 7], [0, 1, 0, 0], temps)
    b = tkv.sample_tokens(logits[:1], [7], [1], temps[:1])
    assert int(a[0]) == int(a[3])
    assert int(a[1]) == int(b[0])
    draws = {int(tkv.sample_tokens(logits[:1], [7], [i], temps[:1])[0])
             for i in range(40)}
    assert len(draws) > 1


def test_sampling_distribution_matches_jax_probabilities():
    """top-k mask and temperature: the distribution each row samples from
    equals the JAX package's, and draws follow it."""
    logits = np.array([[2.0, 1.0, 0.5, 0.0, -1.0, 3.0, -2.0, 1.5]],
                      np.float32)
    temp, top_k, n = 0.7, 4, 4000
    z = np.zeros(1, np.uint32)
    _, want = jkv.sample_tokens(jnp.asarray(logits), z, z,
                                np.array([temp], np.float32), top_k=top_k,
                                return_probs=True)
    _, probs = tkv.sample_tokens(torch.from_numpy(logits), [0], [0],
                                 np.array([temp], np.float32), top_k=top_k,
                                 return_probs=True)
    _close(want, probs, 1e-6)
    batch = torch.from_numpy(np.repeat(logits, n, axis=0))
    toks = tkv.sample_tokens(batch, np.full(n, 11), np.arange(n),
                             np.full(n, temp, np.float32), top_k=top_k)
    freq = np.bincount(toks.numpy(), minlength=logits.shape[1]) / n
    p = np.asarray(want)[0]
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p > 1e-6))
    np.testing.assert_allclose(freq, p, atol=0.03)


def _jax_bits(seeds, idx, v):
    import jax

    f = jax.jit(jax.vmap(lambda s, i: jax.random.bits(
        jax.random.fold_in(jax.random.PRNGKey(s), i), (v,), jnp.uint32)))
    return np.asarray(f(jnp.asarray(seeds.astype(np.uint32)),
                        jnp.asarray(idx.astype(np.uint32))))


@pytest.mark.parametrize("top_k", [0, 40])
def test_temperature_sampling_is_bit_identical_to_jax(top_k):
    """256 (seed, token_idx) pairs at V=32000: the threefry bits equal
    ``jax.random.bits`` under ``fold_in(PRNGKey(seed), idx)`` bit for bit,
    and the sampled tokens equal the JAX package's, with and without
    top-k."""
    v, n = 32000, 256
    rng = np.random.default_rng(11 + top_k)
    seeds = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.int64)
    idx = rng.integers(0, 4096, size=n)
    bits = tkv.sample_bits(seeds, idx, v)
    assert bits.dtype == torch.int64 and bits.shape == (n, v)
    np.testing.assert_array_equal(_jax_bits(seeds, idx, v).astype(np.int64),
                                  bits.numpy())
    logits = (rng.normal(size=(n, v)) * 3).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, size=n).astype(np.float32)
    temps[::17] = 0.0                      # greedy rows mixed in
    want = jkv.sample_tokens(jnp.asarray(logits),
                             jnp.asarray(seeds.astype(np.uint32)),
                             jnp.asarray(idx.astype(np.uint32)),
                             jnp.asarray(temps), top_k=top_k)
    got = tkv.sample_tokens(torch.from_numpy(logits), seeds, idx, temps,
                            top_k=top_k)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_threefry_matches_the_jax_hash_on_edge_words():
    """The hash itself on all-zero, all-one and mixed words (JAX's
    ``threefry_2x32`` over a two-element count)."""
    from jax._src import prng

    words = [0, 1, 0x1BD11BDA, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    for k1 in words:
        for k2 in words[::2]:
            for c in words[::3]:
                want = np.asarray(prng.threefry_2x32(
                    jnp.asarray([k1, k2], jnp.uint32),
                    jnp.asarray([c, k1 ^ c], jnp.uint32)))
                t = lambda x: torch.tensor([x], dtype=torch.int64)
                got = tkv.threefry2x32(t(k1), t(k2), t(c), t(k1 ^ c))
                assert [int(got[0]), int(got[1])] == want.tolist()


def test_gumbel_max_takes_its_plain_version_on_cpu():
    """The sampling kernel's wrapper runs its plain version on CPU tensors
    (no launch counted); its source is one of the built kernels."""
    from analytics_zoo_tpu_torch.ops import _build

    scaled = torch.from_numpy(
        np.random.default_rng(5).normal(size=(3, 50)).astype(np.float32))
    before = tkv.gumbel_max.launches
    got = tkv.gumbel_max(scaled, [0, 2], [7, 8], [1, 2])
    assert tkv.gumbel_max.launches == before
    assert torch.equal(got, tkv.gumbel_max_plain(scaled, [0, 2], [7, 8],
                                                 [1, 2]))
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert "sample" in _build.KERNELS
