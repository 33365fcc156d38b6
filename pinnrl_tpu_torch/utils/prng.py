"""A numpy replica of the JAX package's random draws (``jax.random`` under
jax 0.9's defaults: the threefry-2x32 key with
``jax_threefry_partitionable=True``), for float32.

The JAX package draws a few *constants* from threefry keys: the Fourier
basis of a ``feature_seed`` and the ``random`` initial condition's Fourier
series. The port reproduces those draws bit for bit where the models and
PDEs need them; everything it draws while training comes from
``torch.Generator``s.

- A key is a (2,) uint32 array. ``PRNGKey(seed)`` splits the 64-bit seed
  into (high, low) words.
- ``split(key, n)`` and the random bits of a shape hash the 64-bit iota of
  the shape, as (high, low) word pairs, under the key; ``split`` keeps both
  hashed words, the bits XOR them.
- ``fold_in(key, data)`` hashes the counts (0, data) under the key.
- ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2),
  subtracts 1, scales to [minval, maxval) (one fused multiply-add, as XLA
  compiles it) and clamps at minval.
- ``normal`` is sqrt(2) erfinv(u) with u uniform in (-1, 1), through XLA's
  float32 erfinv polynomial (M. Giles, "Approximating the erfinv
  function") as XLA's CPU code rounds it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_F = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs (x0, x1) under
    ``key``; uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _fma(a, b, c) -> np.ndarray:
    """A float32 fused multiply-add, as one float64 multiply-add (the
    product of two float32 is exact there) rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - jax's name
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (high, low) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The row-major 64-bit iota of ``shape`` as (high, low) uint32 words;
    a negative dimension raises, as jax.random does."""
    if any(d < 0 for d in shape):
        raise ValueError(f"shape {tuple(shape)} has a negative dimension")
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    a, b = threefry2x32(key, *_iota_2x32((int(num),)))
    return np.stack([a, b], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        a, b = threefry2x32(key, np.zeros((), np.uint32), np.zeros((), np.uint32))
        return np.asarray(a ^ b, np.uint32)
    a, b = threefry2x32(key, *_iota_2x32(shape))
    return a ^ b


def uniform(key: np.ndarray, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = _F(minval), _F(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(_F) - _F(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))  # XLA fuses the scale and shift


# XLA's float32 erfinv on the CPU, as its compiled code rounds: a degree-8
# polynomial in w = -log1p(-x^2), one set of coefficients for w < 5 (in
# w - 2.5), one for w >= 5 (in sqrt(w) - 3), highest degree first, each
# Horner step one fused multiply-add; log1p by XLA's rational for |a| <
# sqrt(2) - 1 and by its Cephes log of 1 + a otherwise.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1, 6.5787325942061044846969E0,
              2.9911919328553073277375E1, 6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2, 2.1642788614495947685003E2,
              6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1, 1.4249322787E-1,
          -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
def _horner(coeffs, x) -> np.ndarray:
    p = np.full_like(x, _F(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _F(c))
    return p


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log (Cephes) of positive normal ``x``."""
    bits = x.view(np.int32)
    e = ((bits >> 23) - 0x7F).astype(_F) + _F(1.0)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F)  # [0.5, 1)
    low = m < _F(0.707106781186547524)
    m2 = (m - _F(1.0)) + np.where(low, m, _F(0.0))
    e = e - np.where(low, _F(1.0), _F(0.0))
    x2 = m2 * m2
    x3 = x2 * m2
    y = _fma(_fma(m2, _F(_LOG_P[0]), _F(_LOG_P[1])), m2, _F(_LOG_P[2]))
    y1 = _fma(_fma(m2, _F(_LOG_P[3]), _F(_LOG_P[4])), m2, _F(_LOG_P[5]))
    y2 = _fma(_fma(m2, _F(_LOG_P[6]), _F(_LOG_P[7])), m2, _F(_LOG_P[8]))
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _F(-2.12194440e-4) * e)
    return ((m2 - x2 * _F(0.5)) + y) + _F(0.693359375) * e


def _log1p(a: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p of ``a`` in (-1, 0]."""
    a2 = a * a
    small = (a * a2) * (_horner(_LOG1P_NUM, a) / _horner(_LOG1P_DEN, a))
    small = a + (_F(-0.5) * a2 + small)
    is_small = np.abs(a) < _F(0.41421356237309504880)
    big = _log(np.where(is_small, _F(1.0), _F(1.0) + a).astype(_F))
    return np.where(is_small, small, big).astype(_F)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv of ``x`` in (-1, 1)."""
    x = np.asarray(x, _F)
    w = -_log1p(-x * x)
    small = w < _F(5.0)
    with np.errstate(invalid="ignore"):
        ws = np.where(small, w - _F(2.5), np.sqrt(w) - _F(3.0)).astype(_F)
    p = np.where(small, _F(_ERFINV_LT5[0]), _F(_ERFINV_GE5[0])).astype(_F)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ws, np.where(small, _F(c_lt), _F(c_ge)))
    return (p * x).astype(_F)


def normal(key: np.ndarray, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(_F(-1.0), _F(0.0), dtype=_F)
    u = uniform(key, shape, lo, 1.0)
    return (_F(np.sqrt(2)) * erfinv(u)).astype(_F)
