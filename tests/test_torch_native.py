"""The port's host runtime (``analytics_zoo_tpu_torch.native``) against the
JAX package's, on the CPU: the mmap arena (alignment, full, file-backed
flush, reset), ``gather_rows`` against JAX's and numpy's over seeded
indices (negative, out of bounds, object dtype), the numpy fallback, the
sample cache's batches, and the port's ``FeatureSet`` batches over a
≥ 1 MiB array (the native gather) against the JAX ``FeatureSet``'s.
"""

import os
import sys

import numpy as np
import pytest

from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu.data.featureset import FeatureSet as JFeatureSet
from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.native import lib as native_lib


def test_native_builds_from_the_ports_own_source():
    assert native.native_available()
    so = native_lib._so_path()
    assert so.is_file() and so.parent.name == "_build"
    assert so.parent.parent.name == "analytics_zoo_tpu_torch"
    assert native_lib._SRC.parent.parent.name == "analytics_zoo_tpu_torch"
    assert native.num_gather_threads() == jnative.num_gather_threads()


def test_arena_alloc_alignment_and_reset():
    with native.HostArena(1 << 20) as arena:
        a = arena.alloc((100,), np.float32)
        b = arena.alloc((50,), np.int64)
        assert a.ctypes.data % 64 == 0 and b.ctypes.data % 64 == 0
        a[:] = 1.5
        b[:] = 7
        assert arena.used >= 100 * 4 + 50 * 8
        np.testing.assert_allclose(a, 1.5)
        arena.reset()
        assert arena.used == 0


def test_arena_full_raises():
    with native.HostArena(4096) as arena:
        with pytest.raises(MemoryError):
            arena.alloc((1 << 20,), np.float32)


def test_arena_file_backed_flush(tmp_path):
    path = str(tmp_path / "arena.bin")
    with native.HostArena(1 << 16, backing_path=path) as arena:
        v = arena.alloc((16,), np.float32)
        v[:] = np.arange(16)
        arena.flush()
        raw = np.fromfile(path, dtype=np.float32, count=16)
        np.testing.assert_allclose(raw, np.arange(16))
    assert os.path.getsize(path) == 1 << 16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_rows_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((500, 37)).astype("float32")
    idx = rng.integers(-500, 500, 200)
    got = native.gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))
    src3 = rng.standard_normal((100, 4, 5)).astype("float64")
    out = np.empty((10, 4, 5))
    rows = rng.permutation(100)[:10]
    assert native.gather_rows(src3, rows, out=out) is out
    np.testing.assert_array_equal(out, jnative.gather_rows(src3, rows))


def test_gather_rows_bounds_and_negative_indices():
    src = np.arange(20, dtype="float32").reshape(10, 2)
    np.testing.assert_array_equal(native.gather_rows(src, np.array([-1, -10])),
                                  src[[-1, -10]])
    for bad in ([10], [-11]):
        with pytest.raises(IndexError) as mine:
            native.gather_rows(src, np.array(bad))
        with pytest.raises(IndexError) as theirs:
            jnative.gather_rows(src, np.array(bad))
        assert str(mine.value) == str(theirs.value)


def test_gather_rows_fallback_path(monkeypatch):
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "_build_failed", True)
    assert not native.native_available()
    src = np.arange(20).reshape(10, 2)
    np.testing.assert_array_equal(native.gather_rows(src, np.array([3, 1])),
                                  src[[3, 1]])
    with native.HostArena(1 << 16) as arena:
        v = arena.alloc((8,), np.float32)
        v[:] = 2.0
        np.testing.assert_allclose(v, 2.0)
        assert arena.used == 32


def test_sample_cache_batches_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 17)).astype("float32")
    y = rng.integers(0, 5, 256).astype("int32")
    mine, theirs = native.NativeSampleCache((x, y)), \
        jnative.NativeSampleCache((x, y))
    idx1 = rng.permutation(256)[:64]
    bx, by = mine.batch(idx1)
    jx, jy = theirs.batch(idx1)
    np.testing.assert_array_equal(bx, jx)
    np.testing.assert_array_equal(by, jy)
    # double buffering: the previous batch survives the next gather
    idx2 = rng.permutation(256)[:64]
    bx2, _ = mine.batch(idx2)
    np.testing.assert_array_equal(bx, x[idx1])
    np.testing.assert_array_equal(bx2, theirs.batch(idx2)[0])
    tree = native.NativeSampleCache({"a": x, "b": (y, x[:, :3])})
    got = tree.batch(idx2)
    assert set(got) == {"a", "b"} and isinstance(got["b"], tuple)
    np.testing.assert_array_equal(got["b"][1], x[idx2, :3])
    np.testing.assert_array_equal(tree.arrays["a"], x)
    for c in (mine, theirs, tree):
        c.close()


def test_featureset_batches_equal_jax_over_the_native_gather(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 600)).astype("float32")  # > 1 MiB
    y = np.arange(512).astype("int32")
    calls = []
    real = native_lib.gather_rows
    monkeypatch.setattr(native_lib, "gather_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(native, "gather_rows", native_lib.gather_rows)
    mine = list(FeatureSet.from_numpy(x, y).batches(128, epoch=1,
                                                    shuffle=True))
    theirs = list(JFeatureSet.from_numpy(x, y).batches(128, epoch=1,
                                                       shuffle=True))
    assert calls                       # x went through the native gather
    assert len(mine) == len(theirs) == 4
    for (bx, by), (jx, jy) in zip(mine, theirs):
        np.testing.assert_array_equal(bx, jx)
        np.testing.assert_array_equal(by, jy)
        np.testing.assert_array_equal(bx, x[by])
    seen = sorted(int(v) for _, by in mine for v in by)
    assert seen == list(range(512))


def test_gather_rows_object_dtype_refcounts_safe():
    """Object arrays never take the C++ memcpy path: pointers copied
    without increfs would be freed twice."""
    n = 200_000                        # > 1 MiB of pointers
    src = np.empty(n, dtype=object)
    src[:] = [bytes([i % 251]) * 8 for i in range(n)]
    rc_before = sys.getrefcount(src[0])
    out = native.gather_rows(src, np.arange(0, n, 2, dtype=np.int64))
    same = out[0] is src[0]
    del out
    rc_after = sys.getrefcount(src[0])
    assert same and rc_after == rc_before, (rc_before, rc_after)
    assert src[0] == b"\x00" * 8 and src[12345] == bytes([12345 % 251]) * 8
