"""The port's threefry twin (tropical_cyclone_risk_tpu_torch/rng.py) against
jax.random with jax_threefry_partitionable=True (tests/conftest.py), seed by
seed.

Tolerances: bit-exact for keys, bits, uniform and randint.  normal runs
XLA's float32 erf_inv polynomial with torch's log1p, so a draw may differ
from JAX's in the last ulps: |diff| <= 1e-6 (4 ulps near |z| = 4) and at
least 95% of draws bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tropical_cyclone_risk_tpu_torch import rng

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
