"""The PyTorch port's speculative decode against the JAX package's, on the CPU.

The k-gram proposer must draft exactly JAX's tokens, the accept rule must
accept and emit exactly JAX's tokens (the drafts' probabilities within
1e-6), and ``TransformerLM.verify_step`` over the same cache must give
JAX's accepted counts and tokens, probabilities within 1e-5 and the slot's
K/V pages within 1e-5. In the batcher, speculation changes the cost of a
stream and never its tokens: the port's ``spec_k=3`` streams equal the JAX
batcher's, and equal the port's plain streams at temperature 0 and 0.8,
through the cache cap, under a pool too dry for the verify lookahead, and
at an eos or budget inside an accepted run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.ops import speculative as jspec
from analytics_zoo_tpu.ops.kv_cache import PagePool as JaxPool
from analytics_zoo_tpu.ops.kv_cache import SCRATCH_PAGE
from analytics_zoo_tpu.serving.generation import \
    ContinuousBatcher as JaxBatcher
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.ops import speculative as tspec
from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 64, 32, 2, 2, 64
PAGE = 4


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


# ----------------------------------------------------------- proposer/config

@pytest.mark.parametrize("n_draft", [1, 2, 3, 4])
def test_propose_kgram_matches_jax(n_draft):
    """200 seeded histories over a vocabulary of 8 (so n-grams repeat),
    lengths 0..40, at every max_ngram 1..3: the same drafts, exactly."""
    rng = np.random.default_rng(n_draft)
    for _ in range(200):
        hist = rng.integers(0, 8, size=int(rng.integers(0, 41))).tolist()
        for max_ngram in (1, 2, 3):
            assert tspec.propose_kgram(hist, n_draft, max_ngram) == \
                jspec.propose_kgram(hist, n_draft, max_ngram)


def test_spec_decode_config_validates_as_jax():
    assert tspec.SpecDecodeConfig() == tspec.SpecDecodeConfig(k=4,
                                                              max_ngram=3)
    assert dataclasses.asdict(tspec.SpecDecodeConfig()) == \
        dataclasses.asdict(jspec.SpecDecodeConfig())
    for kw in (dict(k=0), dict(k=-1), dict(max_ngram=0)):
        for cls in (tspec.SpecDecodeConfig, jspec.SpecDecodeConfig):
            with pytest.raises(ValueError):
                cls(**kw)
    assert tspec.SpecDecodeConfig(k=1, max_ngram=1).k == 1


# ---------------------------------------------------------------- accept rule

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("top_k", [0, 8])
def test_verify_draft_tokens_matches_jax(k, temperature, top_k):
    """Drafts built from JAX's own tokens (full acceptance) with a
    mismatch injected in two rows: the same accepted counts and tokens,
    the drafts' probabilities within 1e-6."""
    b = 3
    rng = np.random.default_rng(10 * k + top_k)
    logits = (rng.normal(size=(b, k, VOCAB)) * 2).astype(np.float32)
    seeds = np.array([3, 77, 2**31 + 5], np.uint32)
    tok_idx = np.array([0, 5, 2**32 - 2], np.uint32)
    temps = np.full(b, temperature, np.float32)
    _, own, _ = jspec.verify_draft_tokens(
        jnp.asarray(logits), jnp.zeros((b, k - 1), jnp.int32), seeds,
        tok_idx, temps, top_k=top_k)
    drafts = np.asarray(own)[:, : k - 1].copy()
    if k > 1:
        drafts[1, min(1, k - 2)] = (drafts[1, min(1, k - 2)] + 1) % VOCAB
        drafts[2, 0] = (drafts[2, 0] + 3) % VOCAB
    want = jspec.verify_draft_tokens(jnp.asarray(logits), jnp.asarray(drafts),
                                     seeds, tok_idx, temps, top_k=top_k)
    got = tspec.verify_draft_tokens(torch.from_numpy(logits),
                                    torch.from_numpy(drafts), seeds, tok_idx,
                                    temps, top_k=top_k)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    assert got[2].shape == (b, k - 1)
    if k > 1:
        assert float(np.abs(np.asarray(want[2]) - got[2].numpy()).max()) \
            <= 1e-6
        assert list(got[0].numpy()) == [k - 1, min(1, k - 2), 0]


# --------------------------------------------------------------- model level

def test_model_verify_step_matches_jax(models):
    """Prefill two slots in both packages, then one k=4 verify step over
    the same caches (one slot's drafts from the greedy continuation, the
    other's a mismatch): accepted and tokens identical, draft
    probabilities and the slots' K/V pages within 1e-5."""
    jm, params, tm = models
    rng = np.random.default_rng(4)
    lens = np.array([9, 14], np.int32)
    cfg, jcache = jm.init_kv_cache(2, page_size=PAGE, max_seq_len=32)
    _, tcache = tm.init_kv_cache(2, page_size=PAGE, max_seq_len=32)
    pool = JaxPool(cfg)
    table = np.full((2, cfg.pages_per_slot), SCRATCH_PAGE, np.int32)
    ids = np.zeros((2, 16), np.int32)
    k = 4
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, VOCAB, size=n)
        table[i, :-(-(n + k) // PAGE)] = pool.alloc(-(-(n + k) // PAGE))
    jlog, jcache = jm.prefill(params, jcache, ids, lens, table,
                              page_size=PAGE)
    tm.prefill(tcache, ids, lens, table, page_size=PAGE)
    first = np.asarray(jlog).argmax(-1).astype(np.int32)
    vids = np.zeros((2, k), np.int32)
    vids[:, 0] = first
    vids[0, 1:] = [first[0]] * (k - 1)
    vids[1, 1:] = rng.integers(1, VOCAB, size=k - 1)
    seeds = np.array([1, 2], np.uint32)
    tok_idx = np.array([1, 1], np.uint32)
    for temperature in (0.0, 0.8):
        temps = np.full(2, temperature, np.float32)
        ja, jt, jp, jcache2 = jm.verify_step(
            params, jcache, vids, lens, table, seeds, tok_idx, temps,
            page_size=PAGE)
        ta, tt, tp, _ = tm.verify_step(tcache, vids, lens, table, seeds,
                                       tok_idx, temps, page_size=PAGE)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        assert float(np.abs(np.asarray(jp) - tp.numpy()).max()) <= 1e-5
    live = table[table != SCRATCH_PAGE]
    for name in ("k", "v"):
        err = np.abs(np.asarray(jcache2[name])[:, live]
                     - tcache[name][:, live].numpy()).max()
        assert float(err) <= 1e-5


# ------------------------------------------------------------------- batcher

def _prompts(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=3 + 4 * i).tolist() for i in range(n)]


def test_spec_streams_identical_to_jax_batcher(models):
    jm, params, tm = models
    kw = dict(n_slots=2, page_size=PAGE, max_seq_len=48, spec_k=3)
    jb = JaxBatcher(jm, params, **kw)
    try:
        want = [jb.generate(p, max_new_tokens=12) for p in _prompts()]
    finally:
        jb.close()
    b = ContinuousBatcher(tm, device="cpu", **kw)
    try:
        hs = [b.submit(p, max_new_tokens=12) for p in _prompts()]
        got = [h.result(timeout_s=120) for h in hs]
        stats = b.stats()
    finally:
        b.close()
    assert got == want
    assert stats["spec"]["steps"] >= 1 and stats["spec"]["k"] == 3
    assert stats["tokens_per_slot_step"] >= 1.0
    b.pool.check_conservation()
    assert b.pool.free_count() == b.pool.capacity


def _run(tm, spec_k, prompts, **kw):
    opts = dict(n_slots=2, page_size=PAGE, max_seq_len=48)
    opts.update(kw.pop("batcher", {}))
    b = ContinuousBatcher(tm, device="cpu", spec_k=spec_k, **opts)
    try:
        hs = [b.submit(p, seed=50 + i, **kw) for i, p in enumerate(prompts)]
        out = []
        for h in hs:
            toks, outcome = [], None
            for tokens, final, meta in h.frames(timeout_s=120):
                toks.extend(tokens)
                if final:
                    outcome = meta["outcome"]
            out.append((toks, outcome))
        return out, b.stats()
    finally:
        b.close()
        b.pool.check_conservation()
        assert b.pool.free_count() == b.pool.capacity


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_streams_identical_to_plain(models, temperature):
    tm = models[2]
    prompts = _prompts(4, seed=1)
    plain, _ = _run(tm, 0, prompts, max_new_tokens=14,
                    temperature=temperature)
    spec, stats = _run(tm, 4, prompts, max_new_tokens=14,
                       temperature=temperature)
    assert spec == plain
    assert all(o == "ok" and len(t) == 14 for t, o in plain)
    assert stats["spec"]["steps"] >= 1
    assert stats["dispatches"]["verify"] == stats["spec"]["steps"]


def test_spec_identical_through_cache_cap(models):
    """A stream that outgrows the cache truncates at exactly the plain
    loop's point: slots within k of the cap take single-token steps."""
    tm = models[2]
    prompt = [np.random.default_rng(2).integers(1, VOCAB, size=5).tolist()]
    kw = dict(max_new_tokens=64, temperature=0.5, batcher=dict(
        max_seq_len=24))
    plain, _ = _run(tm, 0, prompt, **dict(kw))
    spec, stats = _run(tm, 4, prompt, **dict(kw))
    assert plain[0][1] == "truncated"
    assert len(plain[0][0]) == 24 - 5 + 1
    assert spec == plain
    assert stats["dispatches"]["decode"] >= 1      # the tail's steps


def test_spec_identical_under_pool_pressure(models):
    """A pool too dry for the k-page verify lookahead does not truncate
    streams plain decode completes: the squeezed slot takes the
    single-token step (``_step_plain(rows=)``) that pass."""
    tm = models[2]
    prompts = [np.random.default_rng(3 + i).integers(1, VOCAB, size=5)
               .tolist() for i in range(2)]
    kw = dict(max_new_tokens=20, batcher=dict(n_pages=13))
    plain, _ = _run(tm, 0, prompts, **dict(kw))
    spec, stats = _run(tm, 4, prompts, **dict(kw))
    assert spec == plain
    assert all(o == "ok" and len(t) == 20 for t, o in plain)
    assert stats["dispatches"]["decode"] >= 1


def test_spec_eos_and_budget_respected(models):
    """An eos or a budget inside an accepted run clips the stream exactly
    where the single-token loop stops."""
    tm = models[2]
    b = ContinuousBatcher(tm, device="cpu", n_slots=1, page_size=PAGE,
                          max_seq_len=48, spec_k=4)
    plain = ContinuousBatcher(tm, device="cpu", n_slots=1, page_size=PAGE,
                              max_seq_len=48)
    try:
        prompt = _prompts(1, seed=5)[0]
        ref = plain.generate(prompt, max_new_tokens=12)
        assert b.generate(prompt, max_new_tokens=12) == ref
        for n in (1, 5, 7):
            assert b.generate(prompt, max_new_tokens=n) == ref[:n]
        eos = ref[6]
        out = b.generate(prompt, max_new_tokens=12, eos_id=int(eos))
        assert out == ref[: ref.index(eos) + 1]
        assert out == plain.generate(prompt, max_new_tokens=12,
                                     eos_id=int(eos))
    finally:
        b.close()
        plain.close()
    assert b.pool.free_count() == b.pool.capacity
