"""Counter-based random numbers of the reference: threefry2x32 in JAX's
partitionable mode (jax.random with ``jax_threefry_partitionable=True``).

Keys are pairs of 32-bit words held as Python ints; ``split`` and
``fold_in`` run on the host, the streams in int64 tensor arithmetic masked
to 32 bits (no intermediate reaches 2**62, so nothing wraps).  ``uniform``
rounds ``f * span + lo`` as one fused multiply-add (emulated in float64),
``normal`` is sqrt(2) erf_inv(u) with XLA's float32 polynomial.  These are
the model's draws: a run's seeds, months, initial winds and Fourier phases
all come from them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Key(NamedTuple):
    k0: int
    k1: int


def key(seed: int) -> Key:
    """The key of a non-negative integer seed: jax.random.key(seed) below
    2**32, and above it that key of the low word with the high word folded
    in."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f'seed must be non-negative, got {seed}')
    k = Key(0, seed & MASK)
    return fold_in(k, seed >> 32) if seed >> 32 else k


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k: Key, x0, x1):
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
    return [Key(*threefry2x32(k, i >> 32, i & MASK)) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    return Key(*threefry2x32(k, 0, int(data) & MASK))


def bits_at(k: Key, index: torch.Tensor) -> torch.Tensor:
    """The stream's 32-bit words at flat positions ``index`` (int64)."""
    y0, y1 = threefry2x32(k, index >> 32, index & MASK)
    return y0 ^ y1


def bits(k: Key, shape, device) -> torch.Tensor:
    n = math.prod(int(s) for s in shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return bits_at(k, idx).reshape(tuple(int(s) for s in shape))


def unit_float(b: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 of 32-bit words (the top 23 bits as a mantissa)."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma_f32(a, b, c):
    return (a.double() * b + c).float()


def scale(f: torch.Tensor, minval, maxval) -> torch.Tensor:
    lo = np.float32(minval)
    span = float(np.float32(np.float32(maxval) - lo))
    return torch.clamp_min(_fma_f32(f, span, float(lo)), float(lo))


def uniform(k: Key, shape, minval=0.0, maxval=1.0, device='cpu'):
    return scale(unit_float(bits(k, shape, device)), minval, maxval)


def randint(k: Key, shape, minval: int, maxval: int, device='cpu'):
    span = int(maxval) - int(minval)
    mult = (2 ** 16 % span) ** 2 % span
    k1, k2 = split(k, 2)
    hi = bits(k1, shape, device)
    lo = bits(k2, shape, device)
    off = (((hi % span) * mult & MASK) + lo % span) & MASK
    return (int(minval) + off % span).to(torch.int32)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _erf_inv(x):
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = lambda c: float(np.float32(c))
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        coef = torch.where(lt, f32(c_lt), f32(c_ge)).to(torch.float64)
        p = _fma_f32(p, w.double(), coef)
    return torch.where(x.abs() == 1.0, x * float('inf'), p * x)


def normal(k: Key, shape, device='cpu'):
    u = uniform(k, shape, NORMAL_LO, 1.0, device)
    return float(np.float32(np.sqrt(2.0))) * _erf_inv(u)
