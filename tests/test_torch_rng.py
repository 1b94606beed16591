"""The port's threefry twin (tropical_cyclone_risk_tpu_torch/rng.py) against
jax.random with jax_threefry_partitionable=True (tests/conftest.py), seed by
seed.

Tolerances: bit-exact for keys, bits, uniform and randint.  normal runs
XLA's float32 erf_inv polynomial with torch's log1p, so a draw may differ
from JAX's in the last ulps: |diff| <= 1e-6 (4 ulps near |z| = 4) and at
least 95% of draws bit-exact.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch import kernels, rng
from tropical_cyclone_risk_tpu_torch.ops import fourier

SEEDS = [0, 1, 7, 123456]


def _key_tuple(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize('seed', SEEDS)
def test_key_split_fold_in(seed):
    kj, kt = jax.random.key(seed), rng.key(seed)
    assert tuple(kt) == _key_tuple(kj)
    assert rng.key_from_jax(jax.random.key_data(kj)) == kt
    assert [tuple(k) for k in rng.split(kt, 6)] == \
        [_key_tuple(k) for k in jax.random.split(kj, 6)]
    for data in (0, 5, 2016, 0x9e3779):
        assert tuple(rng.fold_in(kt, data)) == \
            _key_tuple(jax.random.fold_in(kj, data))


@pytest.mark.parametrize('seed', SEEDS)
def test_bits_and_uniform(seed):
    kj, kt = jax.random.key(seed), rng.key(seed)
    shape = (16, 3000)
    np.testing.assert_array_equal(
        rng.bits(kt, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(kj, shape)))
    lo45 = float(jnp.sin(jnp.deg2rad(-45.0)))
    for lo, hi in ((0.0, 1.0), (0.0, 360.0), (-90.0, 90.0),
                   (lo45, -lo45)):
        np.testing.assert_array_equal(
            rng.uniform(kt, shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(kj, shape, minval=lo, maxval=hi)))


@pytest.mark.parametrize('seed', SEEDS)
def test_randint(seed):
    kj, kt = jax.random.key(seed), rng.key(seed)
    for lo, hi in ((1, 13), (0, 7), (-5, 1000)):
        a = rng.randint(kt, (5000,), lo, hi).numpy()
        b = np.asarray(jax.random.randint(kj, (5000,), lo, hi))
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', SEEDS)
def test_normal(seed):
    kj, kt = jax.random.key(seed), rng.key(seed)
    a = rng.normal(kt, (50000,)).numpy()
    b = np.asarray(jax.random.normal(kj, (50000,)))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert (a == b).mean() >= 0.95


@pytest.mark.parametrize('seed', SEEDS)
def test_split_fold_in_on_host_ints(seed):
    """split and fold_in run the 20 rounds on Python ints: keys of plain
    ints equal to jax.random's, for several split counts and fold-in data
    across the 32-bit range, and the block function on ints equals the one
    on int64 tensors."""
    kj, kt = jax.random.key(seed), rng.key(seed)
    for num in (2, 3, 16):
        keys = rng.split(kt, num)
        assert all(type(w) is int for k in keys for w in k)
        assert [tuple(k) for k in keys] == \
            [_key_tuple(k) for k in jax.random.split(kj, num)]
    for data in (1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1):
        k = rng.fold_in(kt, data)
        assert all(type(w) is int for w in k)
        assert tuple(k) == _key_tuple(jax.random.fold_in(kj, data))
    x = np.arange(0, 2 ** 34, 2 ** 34 // 97, dtype=np.int64)
    y0, y1 = rng.threefry2x32(kt, torch.from_numpy(x >> 32),
                              torch.from_numpy(x & rng.MASK))
    assert list(zip(y0.tolist(), y1.tolist())) == \
        [rng.threefry2x32(kt, int(i) >> 32, int(i) & rng.MASK) for i in x]


def test_cpu_draws_launch_no_kernel():
    """On the CPU every sampler and draw_fourier take the plain twins: no
    seeding or threefry kernel is counted, and no twin on CUDA."""
    kernels.reset_counts()
    kt = rng.key(3)
    rng.bits(kt, (4, 5))
    rng.uniform(kt, (7,), -1.0, 2.0)
    rng.normal(kt, (7,))
    rng.randint(kt, (7,), 1, 13)
    fs = fourier.draw_fourier(kt, (6, 4), 3600.0)
    ref = fourier.draw_fourier_plain(kt, (6, 4), 3600.0)
    assert torch.equal(fs.A, ref.A) and torch.equal(fs.B, ref.B)
    assert kernels.LAUNCHES['seeding'] == kernels.LAUNCHES['threefry'] == 0
    assert not any(kernels.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize('case', ['order', 'random', 'all'])
def test_fourier_rows_are_the_full_draw_gathered(case):
    """draw_fourier(..., rows=order) is the full draw at those rows, bit
    for bit: a launch's integrate order (its True slots first, then the
    rest, as ops/compact.partition_take gives it), a random selection with
    repeats, and every row (m == n)."""
    n, kt = 700, rng.key(9)
    r = np.random.default_rng(4)
    if case == 'order':
        mask = torch.from_numpy(r.random(n) < 0.3)
        rows = torch.cat([torch.nonzero(mask)[:, 0],
                          torch.nonzero(~mask)[:, 0]])[:256]
    elif case == 'random':
        rows = torch.from_numpy(r.integers(0, n, 300))
    else:
        rows = torch.arange(n)
    full = fourier.draw_fourier_plain(kt, (n, 4), 3600.0)
    kernels.reset_counts()
    got = fourier.draw_fourier(kt, (n, 4), 3600.0, rows=rows)
    assert kernels.LAUNCHES['threefry'] == 0
    assert got.A.shape == (rows.shape[0], 4, fourier.N_FOURIER)
    assert torch.equal(got.A, full.A[rows]) and torch.equal(got.B,
                                                            full.B[rows])
    # each element's draw is its counter's: (row * 4 + c) * 15 + f
    phi = rng.uniform_plain(kt, (n * 4 * fourier.N_FOURIER,)).reshape(
        n, 4, fourier.N_FOURIER)[rows]
    amp = fourier._amplitudes('cpu')
    assert torch.equal(got.A, amp * torch.cos(2 * math.pi * phi))


def test_fourier_row_wrapper_refuses_cpu_tensors():
    """K5's row entry refuses CPU tensors (ValueError) at the wind
    channels of two to five steering levels, and launches nothing; its
    compile-time components are the twin's 15 (the wind channels of two,
    three and four levels have instances of their own, the others the
    run-time-count one)."""
    from tropical_cyclone_risk_tpu_torch.config import Namelist
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    kernels.reset_counts()
    for levels in ((250, 850), (250, 500, 850), (250, 500, 700, 850),
                   (250, 300, 500, 700, 850)):
        C = Namelist(steering_levels=levels).n_wind_levels
        with pytest.raises(ValueError, match='CUDA'):
            k5.fourier_rows_cuda(rng.key(1), (8, C), torch.arange(3),
                                 fourier._amplitudes('cpu'))
    assert not any(kernels.LAUNCHES.values())
    assert k5.N_FOURIER == fourier.N_FOURIER


@pytest.mark.parametrize('C', [2, 10, 7])
def test_fourier_row_wrapper_refuses_other_channel_counts(C):
    """K5's row entry takes the wind channels of two or more steering
    levels, any even count from 4: ten (five levels) reaches the device
    check (ValueError on CPU tensors); two (one level) and an odd count
    raise NotImplementedError before anything is checked; nothing is
    launched."""
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    kernels.reset_counts()
    taken = C >= 4 and C % 2 == 0
    with pytest.raises(ValueError if taken else NotImplementedError,
                       match='CUDA' if taken else 'even count'):
        k5.fourier_rows_cuda(rng.key(1), (8, C), torch.arange(3),
                             fourier._amplitudes('cpu'))
    assert not any(kernels.LAUNCHES.values())


def test_fourier_phase_quadrant_is_rint():
    """csrc/rng.cu phase_sincos rounds x * 2/pi with an add of 1.5 * 2^23:
    on every phase the Fourier entries meet, float32(2 pi) * m * 2^-23,
    that gives rint's integer (ties to even, as __float2int_rn) in the low
    bits and exactly, in float32."""
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    u = np.arange(k5.PHASES, dtype=np.float32) * np.float32(2.0 ** -23)
    x = np.float32(k5.TWO_PI_F32) * u
    v = x * np.float32(np.frombuffer(np.uint32(0x3f22f983).tobytes(),
                                     np.float32)[0])
    shift = np.float32(12582912.0)
    r = v + shift
    assert r.dtype == np.float32 and x.max() < 2 * np.pi
    np.testing.assert_array_equal(r - shift, np.rint(v))
    np.testing.assert_array_equal(r.view(np.int32) & 3,
                                  np.rint(v).astype(np.int32) & 3)


def _cuh_floats(name):
    """The float literals of a brace-initialised array in
    csrc/threefry.cuh."""
    text = (Path(rng.__file__).parent / 'csrc' / 'threefry.cuh').read_text()
    body = re.search(name + r'\[\d+\] = \{([^}]*)\}', text).group(1)
    return [float.fromhex(t.strip().rstrip('f')) for t in body.split(',')]


def test_cuda_erf_inv_constants_are_the_twins():
    """The seeding and threefry kernels' erf_inv coefficients and sqrt(2)
    are the float32 roundings the plain twin uses."""
    f32 = lambda xs: [float(np.float32(x)) for x in xs]
    assert _cuh_floats('c_lt') == f32(rng._ERFINV_LT5)
    assert _cuh_floats('c_ge') == f32(rng._ERFINV_GE5)
    text = (Path(rng.__file__).parent / 'csrc' / 'threefry.cuh').read_text()
    sqrt2 = re.search(r'TF_SQRT2_F32 (\S+)f', text).group(1)
    assert float.fromhex(sqrt2) == rng.SQRT2_F32
