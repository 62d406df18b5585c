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
  keys, the round count set by the length);
* :func:`uniform` and :func:`bernoulli` follow ``jax.random.uniform`` and
  ``jax.random.bernoulli`` in float32 (the top 23 bits of each draw OR'd
  into the bits of ``1.0``, minus 1, scaled; a draw is kept where that
  float is ``< p``), the masks of training-mode dropout;
* :func:`normal` follows ``jax.random.normal`` in float32 (a uniform draw
  on ``(-1, 1)``, then ``sqrt(2) · erf_inv`` with XLA's polynomial),
  within about one ulp of JAX's.

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


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits of each 32-bit draw as the mantissa of a float in [1, 2),
    minus 1, times ``maxval - minval``, plus ``minval`` (rounded once, as
    XLA's fused multiply-add; floored at ``minval``)."""
    bits = random_bits(key, shape, device)
    one = 0x3F800000                           # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    if float(lo) == 0.0 and float(hi) == 1.0:
        return floats
    # XLA fuses ``floats * span + lo`` into one FMA (one rounding): the
    # product of two float32s is exact in float64, so the sum rounds once
    # there and once to float32, which gives the FMA's bits
    span = (hi - lo).double().to(floats.device)
    scaled = (floats.double() * span + lo.double().to(floats.device)).float()
    return torch.maximum(lo.to(floats.device), scaled)


def bernoulli(key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: a bool
    tensor, ``uniform(key, shape) < p`` with ``p`` as float32."""
    return uniform(key, shape, device=device) < torch.tensor(
        p, dtype=torch.float32, device=device)


# Giles' single-precision erfinv, XLA's ``ErfInv32`` polynomial: the
# coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x²)``, then a degree-8
    polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times ``x``;
    ±1 maps to ±max float. In float32 throughout; XLA's CPU code rounds
    some steps differently (fused multiply-adds, its own log1p), so the
    draws of :func:`normal` part from JAX's by about one ulp (4.8e-7
    measured), where ``torch.erfinv``, another approximation, parts by
    2e-5 (``tests/test_torch_prng.py``)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).float()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge).float() + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``uniform(key, shape,
    nextafter(-1, 0), 1)`` (the same bits as JAX's), then ``sqrt(2) ·
    erf_inv``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erf_inv(uniform(key, shape, lo, 1.0, device=device)) * math.sqrt(
        2.0)


__all__ = ["Key", "PRNGKey", "as_key", "bernoulli", "bits_per_key",
           "erf_inv", "fold_in", "normal", "permutation", "randint",
           "random_bits", "split", "threefry2x32", "uniform"]
