"""Explicit counter-based random numbers: ``jax.random`` with the
threefry2x32 generator in partitionable mode (``jax_threefry_partitionable
=True``, JAX's default since 0.5).

A key is a pair of 32-bit words held as Python ints, so ``split`` and
``fold_in`` run the 20 rounds on Python ints on the host, and only the bulk
streams (``bits`` and the samplers built on it) are computed on the
device.  On a CUDA device ``bits``, ``uniform``, ``normal`` and ``randint``
launch K5 (csrc/rng.cu via kernels/rng.py); on the CPU they run their
plain twins (``*_plain``), which keep words in int64 tensors masked to 32
bits: every intermediate of threefry stays below 2**62, so no op ever
wraps in int64.

From the same integer seed the port draws the same numbers as the JAX
package:

- ``bits``, ``split``, ``fold_in`` and ``randint`` are bit-exact;
- ``uniform`` is bit-exact: XLA on the CPU contracts ``f * (hi - lo) + lo``
  into one fused multiply-add, which is emulated here in float64 (the
  float32 product is exact in float64, so only the add rounds before the
  final rounding to float32);
- ``normal`` uses XLA's float32 ``erf_inv`` polynomial with the same
  emulated FMA; its ``log1p`` is torch's, so a draw may differ from JAX's
  in the last few float32 ulps (tests/test_torch_rng.py states the bound).

K5 equals the plain twins bit for bit on the card (chip_smoke.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import rng as k5

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Key(NamedTuple):
    """A threefry2x32 key: two uint32 words as Python ints."""
    k0: int
    k1: int


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a non-negative 32-bit seed."""
    if not 0 <= int(seed) <= MASK:
        raise ValueError(f'seed must lie in [0, 2**32), got {seed}')
    return Key(0, int(seed))


def key_from_jax(key_data) -> Key:
    """Key from ``jax.random.key_data(k)`` (any array-like of 2 uint32)."""
    k = np.asarray(key_data, dtype=np.uint32).reshape(2)
    return Key(int(k[0]), int(k[1]))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k: Key, x0, x1):
    """The threefry2x32 block function (20 rounds) on words held as
    Python ints or int64 tensors."""
    ks = (k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def split(k: Key, num: int = 2) -> list:
    """``jax.random.split(k, num)`` as a list of keys (host integers)."""
    return [Key(*threefry2x32(k, i >> 32, i & MASK)) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` (host integers)."""
    return Key(*threefry2x32(k, 0, int(data) & MASK))


def _is_cuda(device) -> bool:
    return torch.device(device).type == 'cuda'


def _count_plain(device) -> None:
    if _is_cuda(device):
        kernels.PLAIN_ON_CUDA['threefry'] += 1


def uniform_params(minval, maxval) -> tuple:
    """(lo, span) of ``uniform``: float32(minval) and float32(hi - lo) as
    Python floats."""
    lo = np.float32(minval)
    hi = np.float32(maxval)
    return float(lo), float(np.float32(hi - lo))


def randint_span(minval: int, maxval: int) -> tuple:
    """(span, multiplier) of ``randint``, which depend on the bounds
    alone."""
    span = int(maxval) - int(minval)
    if not 0 < span < 2 ** 31:
        raise ValueError(f'unsupported randint range [{minval}, {maxval})')
    return span, (2 ** 16 % span) ** 2 % span


def randint_params(k: Key, minval: int, maxval: int) -> tuple:
    """(the two stream keys, span, multiplier) of ``randint``."""
    return (split(k, 2), *randint_span(minval, maxval))


# normal draws its uniform on [nextafter(-1, 0), 1)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def bits(k: Key, shape: Sequence[int], device='cpu') -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 values in an int64 tensor)."""
    if _is_cuda(device):
        return k5.fill_cuda('bits', k, shape, device)
    return bits_plain(k, shape, device)


def uniform(k: Key, shape, minval=0.0, maxval=1.0,
            device='cpu') -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    if _is_cuda(device):
        lo, span = uniform_params(minval, maxval)
        return k5.fill_cuda('uniform', k, shape, device, lo, span)
    return uniform_plain(k, shape, minval, maxval, device)


def randint(k: Key, shape, minval: int, maxval: int,
            device='cpu') -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) for
    Python-int bounds with 0 < maxval - minval < 2**31."""
    if _is_cuda(device):
        (k1, k2), span, mult = randint_params(k, minval, maxval)
        return k5.fill_cuda('randint', k1, shape, device, key2=k2,
                            ispan=span, mult=mult, minval=int(minval))
    return randint_plain(k, shape, minval, maxval, device)


def normal(k: Key, shape, device='cpu') -> torch.Tensor:
    """``jax.random.normal(k, shape)`` (float32)."""
    if _is_cuda(device):
        lo, span = uniform_params(NORMAL_LO, 1.0)
        return k5.fill_cuda('normal', k, shape, device, lo, span)
    return normal_plain(k, shape, device)


def bits_plain(k: Key, shape: Sequence[int], device='cpu') -> torch.Tensor:
    """Plain twin of ``bits``."""
    _count_plain(device)
    shape = tuple(int(s) for s in shape)
    iota = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k, iota >> 32, iota & MASK)
    return (y0 ^ y1).reshape(shape)


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded as XLA's fused multiply-add on the CPU."""
    return (a.double() * b + c).float()


def uniform_plain(k: Key, shape, minval=0.0, maxval=1.0,
                  device='cpu') -> torch.Tensor:
    """Plain twin of ``uniform``."""
    lo, span = uniform_params(minval, maxval)
    mant = (bits_plain(k, shape, device) >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(_fma_f32(f, span, lo), lo)


def randint_plain(k: Key, shape, minval: int, maxval: int,
                  device='cpu') -> torch.Tensor:
    """Plain twin of ``randint``."""
    (k1, k2), span, mult = randint_params(k, minval, maxval)
    hi_bits = bits_plain(k1, shape, device)
    lo_bits = bits_plain(k2, shape, device)
    off = (((hi_bits % span) * mult & MASK) + lo_bits % span) & MASK
    return (int(minval) + off % span).to(torch.int32)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function");
# csrc/threefry.cuh holds their float32 roundings
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv with XLA's polynomial and FMA-contracted Horner."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = lambda c: float(np.float32(c))
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        coef = torch.where(lt, f32(c_lt), f32(c_ge)).to(torch.float64)
        p = _fma_f32(p, w.double(), coef)
    out = p * x
    return torch.where(x.abs() == 1.0, x * float('inf'), out)


def normal_plain(k: Key, shape, device='cpu') -> torch.Tensor:
    """Plain twin of ``normal``."""
    u = uniform_plain(k, shape, NORMAL_LO, 1.0, device)
    return SQRT2_F32 * erf_inv_f32(u)
