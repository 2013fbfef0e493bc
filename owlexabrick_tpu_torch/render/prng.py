"""The JAX package's random numbers without JAX: the Threefry-2x32 hash
(20 rounds, Salmon et al., SC'11) and the ``jax.random`` calls the
Renderer makes, ``PRNGKey``, ``fold_in``, ``uniform`` of a scalar (host
numpy) or of a (P,) / (P, 2) batch (torch, on the render device) and
``normal`` of a small batch (host numpy).

The bits are those of ``jax.random`` with its default implementation
(``jax_default_prng_impl = "threefry2x32"``) under the partitionable
scheme (``jax_threefry_partitionable = True``, the default since JAX
0.5): a key is two uint32 words; ``fold_in(key, d)`` hashes the counter
pair (0, d) under the key and takes both words as the new key; draw i of
a batch hashes the counter pair (0, i) (i the row-major flat index) and
takes the XOR of the two words; ``uniform`` puts the draw's top 23 bits
in the mantissa of a float in [1, 2) and subtracts 1.  ``normal`` is
``sqrt(2) * erf_inv(u)`` for u uniform on [nextafter(-1, 0), 1)
(jax 0.9, ``jax/_src/random.py::_normal_real``), with ``erf_inv`` in
XLA's float32 form (Giles' single-precision polynomial over XLA's CPU
``log1p``), operation for operation including its fused multiply-adds.
``tests/test_torch_host.py`` and ``tests/test_torch_ao_sweep.py`` hold
these to ``jax.random`` bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .slabs import render_device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF
_F32 = np.float32


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32 on 32-bit words held in wider integers: Python ints
    or int64 tensors (torch's uint32 lacks shifts on some devices), each
    word masked to 32 bits after every add and rotate."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry2x32(key, count):
    """Threefry-2x32 of one counter pair under one key: ``key``, ``count``
    and the result are pairs of uint32 (Python ints)."""
    return _threefry(int(key[0]) & _M32, int(key[1]) & _M32,
                     int(count[0]) & _M32, int(count[1]) & _M32)


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^64): its high and
    low 32-bit words."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for data in [0, 2^32)."""
    return threefry2x32(key, (0, int(data) & _M32))


def uniform_f32(key) -> np.float32:
    """``jax.random.uniform(key, ())``: one float32 in [0, 1)."""
    b0, b1 = threefry2x32(key, (0, 0))
    bits = np.uint32(((b0 ^ b1) >> 9) | 0x3F800000)
    return np.float32(bits.view(np.float32) - np.float32(1.0))


def _bits(key, n: int, device) -> torch.Tensor:
    """The ``n`` 32-bit draws of a batch (counters (0, i), i < 2^32), as
    int64 on ``device``."""
    if n >= 1 << 32:
        raise ValueError("more than 2^32 draws in one batch")
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry(int(key[0]) & _M32, int(key[1]) & _M32,
                       torch.zeros_like(x1), x1)
    return b0 ^ b1


def uniform(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) of ``shape``
    on ``device`` (rows of a (P, 2) draw take counters 2i and 2i + 1)."""
    bits = _bits(key, math.prod(shape), render_device(device))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).reshape(shape)


def _fma(a, b, c):
    """float32 a * b + c as XLA's CPU code fuses it: the float32 product
    is exact in float64, and the sum is rounded to float64 and then to
    float32 (the draws these feed are held to ``jax.random`` bit for
    bit)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


# XLA's CPU log: Cephes' single-precision logf on the mantissa in
# [sqrt(1/2), sqrt(2)) (Eigen's plog), its multiply-adds fused
_LOG_P = tuple(_F32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
# XLA's log1p below sqrt(2) - 1: Cephes' rational approximation, Horner
# with fused multiply-adds, highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' erfinv coefficients (XLA's ErfInv32), for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _xla_log(x: np.ndarray) -> np.ndarray:
    x = np.maximum(x, np.uint32(0x00800000).view(_F32))
    bits = x.view(np.uint32)
    e = ((bits >> 23).astype(np.int32) - 0x7E).astype(_F32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(_F32)
    small = m < _F32(0.707106781186547524)
    x = (m - _F32(1.0)) + np.where(small, m, _F32(0.0))
    e = e - small.astype(_F32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(p[0], x, p[1]), x, p[2])
    y1 = _fma(_fma(p[3], x, p[4]), x, p[5])
    y2 = _fma(_fma(p[6], x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _F32(-2.12194440e-4))
    x = (x - x2 * _F32(0.5)) + y
    return x + e * _F32(0.693359375)


def _horner(x, coeffs):
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


def _xla_log1p(x: np.ndarray) -> np.ndarray:
    x2 = x * x
    small = _fma(_F32(-0.5), x2, (x * x2)
                 * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)))
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _xla_log(x + _F32(1.0))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), x + small,
                    large)


def erf_inv_f32(x) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (Giles, "Approximating the erfinv
    function", GPU Computing Gems Jade, 2011) on the host."""
    x = np.asarray(x, _F32)
    w = -_xla_log1p(-(x * x))
    lt5 = w < _F32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lt5, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lt5, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt5, _F32(lo), _F32(hi)))
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == 1.0, x * _F32(np.inf), p * x)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` as float32 numpy on the host (a
    few numbers: the AO direction pool)."""
    n = math.prod(shape)
    bits = _bits(key, n, "cpu").numpy().astype(np.uint32)
    u = ((bits >> 9) | np.uint32(0x3F800000)).view(_F32) - _F32(1.0)
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    u = np.maximum(lo, _fma(u, _F32(1.0) - lo, lo))
    return (_F32(np.sqrt(2)) * erf_inv_f32(u)).reshape(shape)
