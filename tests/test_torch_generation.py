"""The PyTorch port's ContinuousBatcher against the JAX package's, on the CPU.

Both serve the same weights (the JAX model's ``build`` output loaded through
the bridge); greedy streams of prompts in different prefill buckets must be
token-identical, the page pool must conserve its pages after every stream
retires, ``eos_id`` must stop a stream, and ``close()`` must leave no thread
behind.
"""

import threading

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.serving.generation import \
    ContinuousBatcher as JaxBatcher
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.serving.generation import (ContinuousBatcher,
                                                        _next_pow2)

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 64, 32, 2, 2, 64
KW = dict(n_slots=2, page_size=4, max_seq_len=32)


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


@pytest.fixture()
def batcher(models):
    b = ContinuousBatcher(models[2], device="cpu", **KW)
    yield b
    b.close()


def _prompts():
    rng = np.random.default_rng(0)
    # buckets 4, 8 and 16: three different prefill shapes
    return [rng.integers(1, VOCAB, size=n).tolist() for n in (3, 7, 13)]


def test_greedy_streams_identical_to_jax_batcher(models, batcher):
    jm, params, _ = models
    jb = JaxBatcher(jm, params, **KW)
    try:
        jax_handles = [jb.submit(p, max_new_tokens=9) for p in _prompts()]
        want = [h.result(timeout_s=120) for h in jax_handles]
    finally:
        jb.close()
    handles = [batcher.submit(p, max_new_tokens=9) for p in _prompts()]
    got = [h.result(timeout_s=120) for h in handles]
    assert got == want
    assert all(len(s) == 9 for s in got)
    stats = batcher.stats()
    assert stats["requests"] == {"ok": 3}
    assert stats["prefill_buckets"] == [4, 8, 16]
    assert stats["distinct_decode_shapes"] == 1
    batcher.pool.check_conservation()
    assert batcher.pool.free_count() == batcher.pool.capacity


def test_eos_stops_stream(batcher):
    prompt = _prompts()[1]
    first = batcher.generate(prompt, max_new_tokens=3)
    frames = list(batcher.submit(prompt, max_new_tokens=20,
                                 eos_id=first[1]).frames(timeout_s=60))
    tokens = [t for toks, _, _ in frames for t in toks]
    # the stream stops at the first occurrence of eos (greedy may repeat)
    assert tokens == first[:first.index(first[1]) + 1]
    assert frames[-1][2]["outcome"] == "ok"
    batcher.pool.check_conservation()


def test_sampled_streams_are_reproducible(batcher):
    prompt = _prompts()[2]
    a = batcher.generate(prompt, max_new_tokens=8, temperature=0.9, seed=5)
    b = batcher.generate(prompt, max_new_tokens=8, temperature=0.9, seed=5)
    assert a == b


def test_cancel_retires_the_stream(models):
    b = ContinuousBatcher(models[2], device="cpu", autostart=False, **KW)
    try:
        handle = b.submit(_prompts()[0], max_new_tokens=25)
        frames = handle.frames(timeout_s=60)
        b.start()
        first, final, _ = next(frames)
        assert len(first) == 1 and not final
        handle.cancel()
        *_, (_, final, meta) = list(frames)
        assert final and meta["outcome"] == "cancelled"
        assert meta["n_tokens"] < 25
        b.pool.check_conservation()
    finally:
        b.close()


def test_truncation_at_max_seq_len_and_prompt_validation(batcher):
    prompt = list(range(1, 29))
    frames = list(batcher.submit(prompt, max_new_tokens=50)
                  .frames(timeout_s=60))
    tokens = [t for toks, _, _ in frames for t in toks]
    assert frames[-1][2]["outcome"] == "truncated"
    # the last token is sampled at length 32 and never cached
    assert len(tokens) == 32 - 28 + 1
    with pytest.raises(ValueError, match="max_seq_len"):
        batcher.submit(list(range(1, 33)))
    with pytest.raises(ValueError):
        batcher.submit([])


def test_close_joins_the_loop_and_fails_queued_requests(models):
    b = ContinuousBatcher(models[2], device="cpu", autostart=False, **KW)
    handle = b.submit([1, 2, 3], max_new_tokens=4)
    b.start()
    assert handle.result(timeout_s=60)
    late = ContinuousBatcher(models[2], device="cpu", autostart=False, **KW)
    queued = late.submit([1, 2], max_new_tokens=4)
    late.close()
    b.close()
    with pytest.raises(RuntimeError, match="closed before admission"):
        queued.result(timeout_s=5)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("zoo-torch-gen") and t.is_alive()]


def test_unported_options_raise(models, batcher):
    """The decode graph and memory lints are ported: a clean step passes
    ``graph_checks="raise"`` under a roomy budget and a 1 KiB budget
    raises ``hbm-budget``; an unknown admission policy is a ValueError, as
    in JAX."""
    from analytics_zoo_tpu_torch.analysis import GraphLintError

    tm = models[2]
    for kw in (dict(graph_checks="raise"), dict(hbm_budget_bytes=1 << 30)):
        b = ContinuousBatcher(tm, device="cpu", autostart=False, **KW, **kw)
        assert b.check_decode_stability("raise") == []
        b.close()
    with pytest.raises(GraphLintError, match="hbm-budget"):
        ContinuousBatcher(tm, device="cpu", autostart=False,
                          graph_checks="raise", hbm_budget_bytes=1024, **KW)
    with pytest.raises(ValueError, match="admit_policy"):
        ContinuousBatcher(tm, device="cpu", autostart=False,
                          admit_policy="fifo", **KW)
    with pytest.raises(ValueError, match="swap params"):
        batcher.swap_params({})
    with pytest.raises(TypeError, match="spec"):
        batcher.swap_params(batcher.host_params(), spec="k=3")


def test_device_must_match_the_model(models, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(models[2], autostart=False, **KW)
    with pytest.raises(ValueError, match="model lives on"):
        ContinuousBatcher(models[2], device="meta", autostart=False, **KW)


def test_next_pow2():
    assert [_next_pow2(n) for n in (1, 2, 3, 16, 17)] == [1, 2, 4, 16, 32]
