"""JAX's counter-based random numbers (threefry-2x32), in numpy.

The JAX package draws the weights of its ``randconv`` feature extractor with
``jax.random.PRNGKey``, ``split`` and ``normal``. For ``--extractor randconv``
to score in the same feature space, the port draws the same numbers here,
bit for bit, without JAX: JAX's threefry-2x32 hash with the partitionable
counter layout (``jax_threefry_partitionable``, on by default since
jax 0.5), its float32 uniform from the hash bits, and the float32 inverse
error function as XLA's CPU backend evaluates it (Giles' polynomial over
XLA's own ``log1p``; its multiply-adds are fused, emulated here in float64
with one rounding to float32).
"""

from __future__ import annotations

import numpy as np

_f32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under ``key`` (two uint32)."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def _counters(n: int):
    """The flat index of each value as (high, low) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s data."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32."""
    return np.stack(threefry2x32(key, *_counters(num)), axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b1, b2 = threefry2x32(key, *_counters(int(np.prod(shape))))
    return (b1 ^ b2).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32: the f32 product is exact in
    float64, and the sum is rounded there and then to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_f32)


# XLA's float32 log (the Cephes polynomial of its CPU backend).
_LOG_P = [_f32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                            -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
# XLA's log1p near 0 (a Cephes rational function).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' single-precision erfinv, for w < 5 and w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _log(v: np.ndarray) -> np.ndarray:
    bits = np.maximum(v, np.finfo(_f32).tiny).view(np.uint32)
    e = (_f32(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_f32)).astype(_f32)
    t = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(_f32)
    low = t < _f32(0.707106781186547524)
    t = ((t - _f32(1)) + np.where(low, t, _f32(0))).astype(_f32)
    e = (e - low.astype(_f32)).astype(_f32)
    x2 = (t * t).astype(_f32)
    x3 = (x2 * t).astype(_f32)
    y = _fma(_fma(t, _LOG_P[0], _LOG_P[1]), t, _LOG_P[2])
    y1 = _fma(_fma(t, _LOG_P[3], _LOG_P[4]), t, _LOG_P[5])
    y2 = _fma(_fma(t, _LOG_P[6], _LOG_P[7]), t, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (_f32(-2.12194440e-4) * e).astype(_f32))
    t = (_fma(_f32(-0.5), x2, t) + y).astype(_f32)
    return np.where(v == 0, _f32(-np.inf), _fma(_f32(0.693359375), e, t))


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _f32(c))
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    near = np.abs(x) < 0.41421356237309504880
    s = x[near]
    s2 = (s * s).astype(_f32)
    ratio = (_horner(s, _LOG1P_NUM) / _horner(s, _LOG1P_DEN)).astype(_f32)
    out[near] = s + _fma(_f32(-0.5), s2, ((s * s2).astype(_f32) * ratio).astype(_f32))
    out[~near] = _log((x[~near] + _f32(1)).astype(_f32))
    return out


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, as ``jax.lax.erf_inv`` on the CPU."""
    x = np.asarray(x, _f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -_log1p((-x * x).astype(_f32))
        lt = w < _f32(5.0)
        w = np.where(lt, w - _f32(2.5), np.sqrt(w) - _f32(3.0)).astype(_f32)
        p = np.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
        for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma(p, w, np.where(lt, _f32(lo), _f32(hi)))
        return np.where(np.abs(x) == 1, x * _f32(np.inf), p * x).astype(_f32)


def normal(key: np.ndarray, shape, chunk: int = 1 << 16) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: a uniform draw on
    (-1, 1) from the hash bits, then ``sqrt(2) * erfinv``; computed in
    chunks of ``chunk`` values, which keeps the temporaries in cache."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi, lo32 = (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
    lo = np.nextafter(_f32(-1), _f32(0))
    out = np.empty(n, _f32)
    for i in range(0, n, chunk):
        b1, b2 = threefry2x32(key, hi[i:i + chunk], lo32[i:i + chunk])
        f = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(_f32) - _f32(1.0)
        u = np.maximum(lo, (f * (_f32(1) - lo) + lo).astype(_f32))
        out[i:i + chunk] = _f32(np.sqrt(2)) * erfinv(u)
    return out.reshape(shape)
