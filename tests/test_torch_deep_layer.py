"""The deep-layer-mean steering configuration of the benchmark
(tcbench/configs/era5_gl_dlm17.json): the NHC Beta and Advection Model's
deep layer (BAMD), the wind averaged over 850-200 hPa, on ERA5's 17
pressure levels there, with weights constant in intensity
(coupled_track False).

- Its weights are the trapezoid rule in pressure over its levels (each
  level half the pressure span of its neighbours, over 650 hPa), as exact
  fractions within the 1e-9 of their nine written decimals.
- The file encodes the same weights for the coupled form the frozen
  reference computes (y_alpha = alpha_min = alpha_max = steering_coefs,
  m_alpha 0): models/fast.py steering_coefs gives bit-identical weights
  either way, for v = 0, large, infinite and NaN, as does the JAX
  package's.
"""

import json
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fast

CONFIG = (Path(__file__).resolve().parents[1] / 'tcbench' / 'configs'
          / 'era5_gl_dlm17.json')
NL = json.loads(CONFIG.read_text())['namelist']
# ERA5's pressure levels from 200 to 850 hPa
ERA5_200_850 = (200, 225, 250, 300, 350, 400, 450, 500, 550, 600, 650, 700,
                750, 775, 800, 825, 850)
STEERING = ('steering_levels', 'steering_coefs', 'y_alpha', 'm_alpha',
            'alpha_max', 'alpha_min')
# intensities (m/s) at which the weights are compared: zero of both signs,
# the storms' range, ones whose product with the knots factor overflows
V = [0.0, -0.0, 1e-30, 4.0, 18.0, 85.0, -3.0, 1e30, 3.4e38, -3.4e38,
     float('inf'), float('-inf'), float('nan')]


def trapezoid(levels) -> list:
    """The pressure-weighted mean's weights by the trapezoid rule: half
    the span between each level's neighbours (its own at the ends) over
    the layer's depth."""
    p = [Fraction(x) for x in levels]
    depth = p[-1] - p[0]
    return [((p[min(i + 1, len(p) - 1)] - p[max(i - 1, 0)]) / 2) / depth
            for i in range(len(p))]


def namelists(coupled: bool):
    """(port, JAX) namelists of the configuration's steering."""
    kw = {k: tuple(NL[k]) for k in STEERING}
    kw['coupled_track'] = coupled
    return Namelist(**kw), JNamelist(**kw)


def test_weights_are_the_trapezoid_rule():
    levels = NL['steering_levels']
    assert tuple(levels) == ERA5_200_850
    want = trapezoid(levels)
    assert sum(want) == 1
    assert set(want) == {Fraction(1, 52), Fraction(1, 26), Fraction(3, 52),
                         Fraction(1, 13)}
    got = NL['steering_coefs']
    assert len(got) == len(levels)
    for g, w in zip(got, want):
        assert abs(Fraction(g) - w) <= Fraction(1, 10 ** 9), (g, w)
    assert abs(sum(Fraction(g) for g in got) - 1) <= Fraction(1, 10 ** 9)
    # the zero-slope encoding of the same weights
    assert NL['coupled_track'] is False
    assert NL['y_alpha'] == NL['alpha_min'] == NL['alpha_max'] == got
    assert NL['m_alpha'] == [0.0] * len(levels)


def test_steering_coefs_coupled_equals_uncoupled():
    """The coupled form clip(y + m v, min, max) with m 0 and equal bounds
    is the constant weights, bit for bit, in the port and in the JAX
    package, at every v (NaN where v * knots overflows: y)."""
    v = torch.tensor(V, dtype=torch.float32)
    want = torch.tensor(NL['steering_coefs'], dtype=torch.float32).expand(
        len(V), len(ERA5_200_850))
    for coupled in (False, True):
        cfg, jcfg = namelists(coupled)
        got = fast.steering_coefs(cfg, v)
        assert got.dtype == torch.float32
        assert torch.equal(got, want), coupled
        jgot = np.asarray(jfast.steering_coefs(jcfg, jnp.asarray(v.numpy())))
        np.testing.assert_array_equal(jgot, want.numpy())



def cholesky_rolled(cov):
    """ops/chol.py cholesky_unrolled of the JAX package as two loops:
    each entry's subtractions in ascending column order, a non-positive
    pivot clearing ok, as the unrolled factor does.  XLA on the CPU took
    297 s to compile the unrolled factor alone at W = 34 (its W^3 / 6
    steps), so tests that run the JAX package at 17 levels put this in
    its place (test_rolled_cholesky_matches_the_package's)."""
    from jax import lax
    n = cov.shape[-1]
    tiny = jnp.asarray(1e-30, cov.dtype)
    rows = jnp.arange(n)

    def column(j, carry):
        L, ok = carry
        col = lax.dynamic_index_in_dim(cov, j, axis=-1, keepdims=False)
        Lj = lax.dynamic_index_in_dim(L, j, axis=-2, keepdims=False)

        def sub(k, c):
            return c - (lax.dynamic_index_in_dim(L, k, axis=-1,
                                                 keepdims=False)
                        * lax.dynamic_index_in_dim(Lj, k, axis=-1,
                                                   keepdims=True))

        col = lax.fori_loop(0, j, sub, col)
        d = lax.dynamic_index_in_dim(col, j, axis=-1, keepdims=False)
        Ljj = jnp.sqrt(jnp.maximum(d, tiny))
        new = jnp.where(rows == j, Ljj[..., None],
                        jnp.where(rows > j, col * (1.0 / Ljj)[..., None],
                                  0.0))
        return (lax.dynamic_update_index_in_dim(L, new[..., :, None], j,
                                                axis=-1),
                ok & (d > 0))

    return lax.fori_loop(0, n, column,
                         (jnp.zeros_like(cov),
                          jnp.ones(cov.shape[:-2], dtype=bool)))


def test_rolled_cholesky_matches_the_package():
    """cholesky_rolled, compiled, against the JAX package's unrolled
    factor run op by op at W = 34, on 64 covariances of the synthetic
    pack's form (off-diagonals 0.2 base cos(lon): positive definite at
    some longitudes only): the same ok mask, the factors within 1e-5 of
    their scale where ok (XLA contracts the compiled loop's
    multiply-subtracts)."""
    import jax
    from tropical_cyclone_risk_tpu.ops import chol as jchol
    W = 34
    r = np.random.default_rng(34)
    base = r.uniform(5.0, 40.0, 64)
    cos_lon = np.cos(np.deg2rad(r.uniform(0.0, 360.0, 64)))
    i, j = np.tril_indices(W)
    tri = np.where(i == j, base[:, None] * (1.0 + 0.1 * i),
                   0.2 * base[:, None] * cos_lon[:, None]).astype(np.float32)
    cov = jchol.lower_tri_to_full(jnp.asarray(tri), W)
    with jax.disable_jit():
        L_pkg, ok_pkg = jchol.cholesky_unrolled(cov)
    L, ok = jax.jit(cholesky_rolled)(cov)
    ok, ok_pkg = np.asarray(ok), np.asarray(ok_pkg)
    np.testing.assert_array_equal(ok, ok_pkg)
    assert 0.2 < ok.mean() < 0.9
    np.testing.assert_allclose(np.asarray(L)[ok], np.asarray(L_pkg)[ok],
                               rtol=0, atol=1e-5 * float(base.max()))
