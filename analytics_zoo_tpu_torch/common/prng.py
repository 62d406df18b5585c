"""A counter-based PRNG that draws ``jax.random``'s bits.

The JAX package keys every random draw of training from
``jax.random.PRNGKey(seed)`` through ``split`` and ``fold_in`` (the
Estimator's step rng, ``ImplicitNCF``'s negatives, the device-cached
epoch order). This module computes the same functions on torch, bit for
bit, under ``jax_threefry_partitionable`` (the default of the JAX the
package is tested against):

* a key is a pair of uint32 words, carried here as a tuple of two Python
  ints; key arithmetic (``PRNGKey``, ``split``, ``fold_in``) runs on the
  host in Python ints, so keying a step never touches the card;
* :func:`random_bits` hashes the flat element index (as the 64-bit count
  pair ``(index >> 32, index & 0xffffffff)``) under the key and xors the
  two output words;
* :func:`randint` and :func:`permutation` follow ``jax.random.randint``
  (two draws from a split key, combined through the multiplier
  ``(2**16 mod span)**2 mod span`` in wrapping uint32 arithmetic) and
  ``jax.random.permutation`` (rounds of a stable sort on fresh 32-bit
  keys, the round count set by the length).

Bulk draws run as int64 tensor arithmetic (every value kept in
``[0, 2**32)``) on the device the caller names.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as ``jax.random`` computes it:
    uint32 arithmetic carried in Python ints or int64 tensors (every value
    in ``[0, 2**32)``, masked after each add). Tensor arguments broadcast;
    returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def as_key(key) -> Key:
    """A key as two Python ints: accepts such a tuple, or anything
    ``np.asarray`` reads as two words (the (2,) uint32 array
    ``jax.random.PRNGKey`` returns)."""
    if isinstance(key, tuple) and len(key) == 2 \
            and all(isinstance(k, int) for k in key):
        return key
    words = np.asarray(key).reshape(-1).tolist()
    if len(words) != 2:
        raise ValueError(f"a key is two uint32 words, got {len(words)}")
    return int(words[0]) & _M32, int(words[1]) & _M32


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in int32 range: the words
    ``(seed >> 32, seed mod 2**32)`` — ``(0, seed)`` for a non-negative
    seed, ``(0, seed mod 2**32)`` for a negative one."""
    s = int(seed)
    if s < 0:
        return 0, s & _M32
    return (s >> 32) & _M32, s & _M32


def fold_in(key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashes the count pair
    ``(0, data mod 2**32)``."""
    k1, k2 = as_key(key)
    return threefry2x32(k1, k2, 0, int(data) & _M32)


def split(key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` as a list of ``num`` keys: key ``i``
    is the hash of the count pair ``(0, i)``."""
    k1, k2 = as_key(key)
    return [threefry2x32(k1, k2, 0, i) for i in range(int(num))]


def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _key_column(words: Sequence[int], device) -> torch.Tensor:
    """``words`` as an int64 (len, 1) tensor on ``device``, written by
    fills: a host-to-device copy from pageable memory would wait for the
    card."""
    col = torch.empty((len(words), 1), dtype=torch.int64, device=device)
    for i, w in enumerate(words):
        col[i] = w
    return col


def bits_per_key(keys: Sequence[Key], n: int, device=None) -> torch.Tensor:
    """Each key's first ``n`` 32-bit draws (``jax.random.bits(key, (n,))``),
    one row a key, as an int64 (len(keys), n) tensor on ``device``: one
    hash over the broadcast (key, index) grid."""
    k1 = _key_column([k[0] for k in keys], device)
    k2 = _key_column([k[1] for k in keys], device)
    idx = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    hi = idx >> 32 if n > _M32 else 0
    b1, b2 = threefry2x32(k1, k2, hi, idx & _M32)
    return b1 ^ b2


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of
    ``shape`` on ``device`` (values in ``[0, 2**32)``)."""
    shape = _shape(shape)
    return bits_per_key([as_key(key)], math.prod(shape), device)[0].reshape(shape)


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key, shape, minval: int, maxval: int, device=None
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` as an
    int32 tensor: values in ``[minval, maxval)`` (``minval`` where
    ``maxval <= minval``), scalar bounds, int32 arithmetic as JAX's
    without x64 (bounds clipped to int32, the span widened by one when
    ``maxval`` lies past int32's top)."""
    shape = _shape(shape)
    out_of_range = int(maxval) > _I32_MAX
    lo = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    if span == 0:
        raise ValueError("randint: a span of 2**32 is not supported")
    mult = 65536 % span
    mult = ((mult * mult) & _M32) % span
    k_hi, k_lo = split(key)
    higher, lower = bits_per_key([k_hi, k_lo], math.prod(shape), device)
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (lo + off).reshape(shape).to(torch.int32)


def permutation(key, x: Union[int, torch.Tensor], device=None
                ) -> torch.Tensor:
    """``jax.random.permutation(key, x)`` for an int ``x`` (a shuffled
    ``arange(x)`` as int64 on ``device``) or a 1-D tensor (its elements
    shuffled, on the tensor's device): ``ceil(3 ln n / ln(2**32 - 1))``
    rounds, each a stable sort of the values by fresh 32-bit keys drawn
    from the next split of the key."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 1:
            raise ValueError("permutation shuffles a 1-D tensor")
        vals = x
    else:
        vals = torch.arange(int(x), dtype=torch.int64, device=device)
    n = vals.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    key = as_key(key)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), vals.device),
                           stable=True).indices
        vals = vals[order]
    return vals


__all__ = ["Key", "PRNGKey", "as_key", "bits_per_key", "fold_in", "permutation", "randint",
           "random_bits", "split", "threefry2x32"]
