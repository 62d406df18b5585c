"""The port's host hot-row cache against the JAX package's, on the CPU.

The same seeded Zipf id batches go through both caches: every gather is
byte-exact against ``table[ids]`` and against the JAX cache's gather, and the
hit, miss, eviction and pinned-row counts agree after every batch (the port
finds the eviction victim through a heap where the JAX cache scans every
pinned row; the victims are the same). Row deltas refresh the same pinned
rows in both.
"""

import json

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving.rowcache import HostRowCache as JaxRowCache
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.observability.debug import DebugSurface
from analytics_zoo_tpu_torch.serving import rowcache as trc
from analytics_zoo_tpu_torch.serving.rowcache import HostRowCache

pytestmark = pytest.mark.embedding

COUNTS = ("hits", "misses", "evictions", "hot_rows", "hot_capacity", "rows",
          "width", "hit_rate")


@pytest.fixture(autouse=True)
def _unregister():
    """The ``/debug/rowcache`` registry is process-wide: drop the caches a
    test made so another test in this worker sees only its own."""
    before = set(trc._REGISTRY)
    yield
    with trc._REGISTRY_LOCK:
        for name in set(trc._REGISTRY) - before:
            trc._REGISTRY.pop(name)


def _table(rows, width, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (rows, width)).astype(dtype)


def _zipf_batches(rows, n_batches, batch, seed, a=1.1):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(rows)
    return [perm[(rng.zipf(a, batch) - 1) % rows] for _ in range(n_batches)]


@pytest.mark.parametrize("rows,width,hot,batch,seed", [
    (2048, 16, 64, 256, 0),
    (4096, 8, 200, 384, 1),
    (512, 32, 500, 128, 2),
    (300, 4, 1, 64, 3),
])
def test_gather_is_byte_exact_with_jax_counts(rows, width, hot, batch, seed):
    table = _table(rows, width, seed)
    t = HostRowCache(table, hot_rows=hot, name=f"t_zipf_{seed}",
                     device="cpu")
    j = JaxRowCache(table, hot_rows=hot, name=f"t_zipf_{seed}")
    for ids in _zipf_batches(rows, 5, batch, seed):
        got = t.gather(ids)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        want = np.asarray(j.gather(ids))
        assert got.numpy().tobytes() == table[ids].tobytes() \
            == want.tobytes()
        ts, js = t.stats(), j.stats()
        assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
        assert sorted(t._slot_of) == sorted(j._slot_of)
        # every pinned slot holds its row's bytes
        pinned = {s: r for r, s in t._slot_of.items()}
        slots = sorted(pinned)
        assert t._hot[slots].numpy().tobytes() == \
            table[[pinned[s] for s in slots]].tobytes()
    if hot <= 64:
        assert ts["evictions"] > 0


def test_eviction_victims_match_jax_on_a_scripted_history():
    table = _table(32, 4, 5)
    t = HostRowCache(table, hot_rows=2, name="t_evict", device="cpu")
    j = JaxRowCache(table, hot_rows=2, name="t_evict")
    script = [[7], [7], [7], [9, 11], [13], [7]] + [[13]] * 5 + \
        [[9, 9, 2, 13], [2, 2, 2, 30, 31], [31, 31, 31, 31], [7, 13]]
    for ids in script:
        np.testing.assert_array_equal(t.gather(ids).numpy(),
                                      np.asarray(j.gather(ids)))
        assert dict(t._slot_of) == dict(j._slot_of)
        assert t.stats()["evictions"] == j.stats()["evictions"]
    assert t.stats()["evictions"] >= 2


def test_row_delta_refreshes_the_same_rows():
    table = _table(64, 8, 6)
    t = HostRowCache(table, hot_rows=8, name="t_delta", device="cpu")
    j = JaxRowCache(table, hot_rows=8, name="t_delta")
    ids = np.asarray([3, 8, 8, 40, 3, 17])
    t.gather(ids)
    j.gather(ids)
    new = np.full((3, 8), 9.5, np.float32)
    assert t.apply_row_delta([3, 20, 40], new) == \
        j.apply_row_delta([3, 20, 40], new) == 2
    probe = np.asarray([3, 20, 40, 8, 0])
    got = t.gather(probe).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.gather(probe)))
    np.testing.assert_array_equal(got[:3], new)
    with pytest.raises(ValueError, match="row delta shape"):
        t.apply_row_delta([0, 1], np.zeros((2, 5), np.float32))


def test_metrics_and_the_debug_surface():
    def lookups(tier):
        return ttm.snapshot()["zoo_embed_cache_lookups_total"][
            "samples"].get(tier, 0)

    before_hot, before_cold = lookups("hot"), lookups("cold")
    cache = HostRowCache(_table(16, 4), hot_rows=4, name="t_metrics",
                         device="cpu")
    cache.gather([0, 1])
    cache.gather([0, 1])
    assert (lookups("cold"), lookups("hot")) == (before_cold + 2,
                                                 before_hot + 2)
    assert ttm.snapshot()["zoo_embed_cache_hot_rows"]["samples"][
        "t_metrics"] == 2
    code, _, body, _ = DebugSurface().handle("/debug/rowcache")
    assert code == 200
    assert json.loads(body)["caches"]["t_metrics"]["hits"] == 2


def test_a_cache_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HostRowCache(_table(8, 2), hot_rows=2, name="t_nodev")


def test_a_slot_written_twice_in_one_pass_is_written_once(monkeypatch):
    """A row pinned and evicted again within one admission: the pass hands
    ``index_copy_`` each slot once, with the row that stays pinned (on the
    card duplicate indices are written in no defined order)."""
    table = _table(16, 4, 7)
    cache = HostRowCache(table, hot_rows=1, name="t_twice", device="cpu")
    cache.gather([9])                       # the one slot holds 9, freq 1
    writes = []
    copy = torch.Tensor.index_copy_

    def spy(self, dim, index, source):
        writes.append(index.tolist())
        return copy(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_copy_", spy)
    # 3 (freq 1) displaces 9, then 4 (freq 1) displaces 3: slot 0 twice
    got = cache.gather([3, 4])
    assert writes[-1] == [0]
    assert cache._slot_of == {4: 0}
    np.testing.assert_array_equal(cache._hot[0].numpy(), table[4])
    np.testing.assert_array_equal(got.numpy(), table[[3, 4]])
