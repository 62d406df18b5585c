"""The port's ``common/prng.py`` against ``jax.random``, bit for bit.

Keys (``PRNGKey``, ``fold_in``, ``split``), raw bits, ``randint`` and
``permutation`` over several seeds, shapes, spans and lengths, under
``jax_threefry_partitionable`` (the default of the JAX the package is
tested against). The permutation lengths cross the round-count steps
(1 round up to ~1600 elements, 2 above); the spans cross 2**16, where
``randint``'s uint32 multiplier wraps to 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.ops import kv_cache as tkv


def _key(a):
    return tuple(int(v) for v in np.asarray(a))


def test_the_jax_under_test_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -5, 1_000_003 * 7])
def test_prng_key_matches_jax(seed):
    assert prng.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 1, 5, 2**31, 2**32 - 1, 123456789])
@pytest.mark.parametrize("seed", [0, 7])
def test_fold_in_matches_jax(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert prng.fold_in(prng.PRNGKey(seed), data) == _key(want)


@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches_jax(num):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = [_key(k) for k in jax.random.split(key, num)]
    assert prng.split(prng.as_key(key), num) == want
    assert prng.split(prng.as_key(np.asarray(key))) == [
        _key(k) for k in jax.random.split(key)]


def test_as_key_accepts_jax_numpy_and_torch_keys():
    key = jax.random.PRNGKey(9)
    want = _key(key)
    assert prng.as_key(key) == want
    assert prng.as_key(np.asarray(key)) == want
    assert prng.as_key(torch.tensor(np.asarray(key).astype(np.int64))) == want
    assert prng.as_key(want) is want
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.as_key(np.zeros(3, np.uint32))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (4096,)])
def test_random_bits_match_jax(shape):
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = prng.random_bits(prng.PRNGKey(5), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


SPANS = [(0, 10), (1, 3707), (1, 201), (-5, 5), (0, 2**16), (0, 2**16 + 3),
         (1, 2**20 + 1), (0, 2**31 - 1), (-2**31, 2**31 - 1), (3, 3),
         (5, 2), (0, 1)]


@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("shape", [(4, 3), (1000,), (8192, 4)])
def test_randint_matches_jax(lo, hi, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(2), 17)
    want = np.asarray(jax.random.randint(key, shape, lo, hi, dtype=jnp.int32))
    got = prng.randint(prng.as_key(key), shape, lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 2, 10, 1000, 1700, 70_000])
@pytest.mark.parametrize("seed", [0, 1_000_003])
def test_permutation_matches_jax(n, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.permutation(key, n))
    got = prng.permutation(prng.PRNGKey(seed), n)
    np.testing.assert_array_equal(got.numpy(), want)
    # of an array: the Estimator's cached epoch shuffles arange(n) int32
    want_a = np.asarray(jax.random.permutation(
        key, jnp.arange(n, dtype=jnp.int32)))
    got_a = prng.permutation(prng.PRNGKey(seed),
                             torch.arange(n, dtype=torch.int32))
    assert got_a.dtype == torch.int32
    np.testing.assert_array_equal(got_a.numpy(), want_a)


def test_permutation_of_values_shuffles_them():
    vals = torch.arange(100, 200, dtype=torch.int64)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.permutation(key, jnp.arange(100, 200)))
    np.testing.assert_array_equal(
        prng.permutation(prng.PRNGKey(4), vals).numpy(), want)
    with pytest.raises(ValueError, match="1-D"):
        prng.permutation(prng.PRNGKey(4), vals.reshape(10, 10))


def test_the_sampler_hashes_through_the_shared_threefry():
    """``ops/kv_cache.py`` keys its samples with this module's hash."""
    assert tkv.threefry2x32 is prng.threefry2x32
    seed, idx = 12, 40
    want = prng.fold_in(prng.PRNGKey(seed), idx)
    assert tkv._fold_keys([seed], [idx]) == [want]
    bits = tkv.sample_bits([seed], [idx], 64)
    np.testing.assert_array_equal(bits[0].numpy(),
                                  prng.random_bits(want, (64,)).numpy())


@pytest.mark.parametrize("shape", [(100_000,), (3, 7, 5), (1,)])
@pytest.mark.parametrize("seed", [0, 9])
def test_normal_is_jax_normal_within_an_ulp(seed, shape):
    """``prng.normal``: JAX's uniform bits on (-1, 1) exactly, then
    ``sqrt(2) · erf_inv`` on XLA's polynomial; the gap to
    ``jax.random.normal`` is held within 1e-6 (measured: one ulp of the
    largest draws, ~4.8e-7). ``torch.erfinv`` would miss by ~2e-5."""
    key = jax.random.PRNGKey(seed)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want_u = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    got_u = prng.uniform(prng.PRNGKey(seed), shape, float(lo), 1.0)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(prng.PRNGKey(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ends = prng.erf_inv(torch.tensor([-1.0, 1.0]))
    assert ends[0] < -1e30 and ends[1] > 1e30
