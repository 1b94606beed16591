"""The port's ops (interp, chol, fourier, compact) and basin helpers against
the JAX package's, on the same numpy inputs made from a seed.

Tolerances: interp, chol and the Fourier synthesis are float32 elementwise
or short-sum arithmetic; XLA on the CPU contracts a*b+c into fused
multiply-adds and torch does not, and the two libraries' sin/cos/sqrt may
round differently, so they agree to rtol 1e-6 / atol 1e-5 (a few ulps of
values of order 10-100).  Permutations, masks and integer outputs are
bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.ops import chol as jchol
from tropical_cyclone_risk_tpu.ops import compact as jcompact
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.ops import interp as jinterp
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.ops import chol, compact, fourier, interp
from tropical_cyclone_risk_tpu_torch.utils import basins

RTOL, ATOL = 1e-6, 1e-5

GRID = interp.UniformGrid(0.0, 2.0, 180, -90.0, 2.0, 91)


def _queries(n, seed, margin=5.0):
    r = np.random.default_rng(seed)
    lon = r.uniform(-margin, 360.0 + margin, n).astype(np.float32)
    lat = r.uniform(-90.0 - margin, 90.0 + margin, n).astype(np.float32)
    return lon, lat


@pytest.mark.parametrize('planes', [None, 3])
def test_bilinear_matches_jax(planes):
    r = np.random.default_rng(1)
    shape = ((planes,) if planes else ()) + (GRID.nlat, GRID.nlon, 6)
    field = r.standard_normal(shape).astype(np.float32)
    lon, lat = _queries(4000, 2)
    plane = (r.integers(0, planes, 4000).astype(np.int32)
             if planes else None)
    jgrid = jinterp.UniformGrid(*GRID)
    pj = None if plane is None else jnp.asarray(plane)
    pt = None if plane is None else torch.from_numpy(plane)
    ref = np.asarray(jax.jit(jinterp.bilinear, static_argnums=1)(
        jnp.asarray(field), jgrid, lon, lat, pj))
    ft = torch.from_numpy(field)
    got = interp.bilinear(ft, GRID, torch.from_numpy(lon),
                          torch.from_numpy(lat), pt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    packed = interp.pack_corners(ft)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jinterp.pack_corners(jnp.asarray(field))))
    np.testing.assert_array_equal(
        interp.bilinear_packed(packed, GRID, torch.from_numpy(lon),
                               torch.from_numpy(lat), pt).numpy(),
        got.numpy())


def test_bilinear_scalar_and_cell_weights():
    r = np.random.default_rng(3)
    field = r.standard_normal((GRID.nlat, GRID.nlon)).astype(np.float32)
    lon, lat = _queries(2000, 4)
    ref = np.asarray(jinterp.bilinear_scalar(jnp.asarray(field),
                                             jinterp.UniformGrid(*GRID),
                                             lon, lat))
    got = interp.bilinear_scalar(torch.from_numpy(field), GRID,
                                 torch.from_numpy(lon), torch.from_numpy(lat))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    ij, wj = jinterp._cell_and_weight(jnp.asarray(lon), 0.0, 2.0, 180)
    it, wt = interp._cell_and_weight(torch.from_numpy(lon), 0.0, 2.0, 180)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert interp.UniformGrid.from_axes(np.arange(0, 360, 2.0),
                                        np.linspace(-90, 90, 91)) == GRID


def test_cholesky_matches_jax():
    r = np.random.default_rng(5)
    a = r.standard_normal((3000, 4, 4)).astype(np.float32)
    cov = a @ np.swapaxes(a, 1, 2) + 0.1 * np.eye(4, dtype=np.float32)
    cov[:50, 3, 3] = -1.0                       # some non-PD matrices
    tri = np.stack([cov[:, i, j] for i in range(4) for j in range(i + 1)],
                   axis=-1)
    full_j = np.asarray(jchol.lower_tri_to_full(jnp.asarray(tri), 4))
    full_t = chol.lower_tri_to_full(torch.from_numpy(tri), 4)
    np.testing.assert_array_equal(full_t.numpy(), full_j)
    Lj, okj = jax.jit(jchol.cholesky_unrolled)(jnp.asarray(full_j))
    Lt, okt = chol.cholesky_unrolled(full_t)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() == 3000 - 50
    np.testing.assert_allclose(Lt.numpy()[ok], np.asarray(Lj)[ok],
                               rtol=RTOL, atol=ATOL)


def test_fourier_matches_jax():
    kj = jax.random.key(11)
    kt = rng.key_from_jax(jax.random.key_data(kj))
    T_s = 20 * 86400.0
    fj = jfourier.draw_fourier(kj, (500, 4), T_s)
    ft = fourier.draw_fourier(kt, (500, 4), T_s)
    for a, b in ((ft.A, fj.A), (ft.B, fj.B)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-6)
    # evaluate the same coefficients on both sides
    fs_t = fourier.FourierSeries(torch.from_numpy(np.asarray(fj.A)),
                                 torch.from_numpy(np.asarray(fj.B)), T_s)
    ts = np.arange(0, 40, dtype=np.float32) * 3600.0
    grid_j = np.asarray(jax.jit(lambda f, t: f.evaluate_grid(t))(fj, ts))
    grid_t = fs_t.evaluate_grid(torch.from_numpy(ts))
    assert grid_t.shape == (40, 500, 4)
    np.testing.assert_allclose(grid_t.numpy(), grid_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fs_t.evaluate(7200.0).numpy(),
                               np.asarray(fj.evaluate(7200.0)), rtol=RTOL,
                               atol=ATOL)


def test_evaluate_in_order_is_the_ordered_sum():
    """evaluate_in_order adds the A sin and the B cos terms in index order,
    each chain on its own, then the two, bit for bit; evaluate (matrix
    products) agrees within 1e-6."""
    r = np.random.default_rng(2)
    A, B = (r.normal(0, 0.3, (50, 4, 15)).astype(np.float32)
            for _ in range(2))
    T_s, t = 20 * 86400.0, 7200.0
    fs = fourier.FourierSeries(torch.from_numpy(A), torch.from_numpy(B), T_s)
    phase = fourier._omega(T_s, 'cpu') * float(np.float32(t))
    sa, cb = (A * torch.sin(phase).numpy(), B * torch.cos(phase).numpy())
    a, b = sa[..., 0].copy(), cb[..., 0].copy()
    for n in range(1, fourier.N_FOURIER):
        a, b = a + sa[..., n], b + cb[..., n]
    np.testing.assert_array_equal(fs.evaluate_in_order(t).numpy(), a + b)
    np.testing.assert_allclose(fs.evaluate(t).numpy(), a + b, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('frac, w', [(0.3, None), (0.5, 700), (0.0, 256),
                                     (1.0, 100)])
def test_stable_partition_order_bit_exact(frac, w):
    mask = np.random.default_rng(7).random(2000) < frac
    got = compact.stable_partition_order(torch.from_numpy(mask), w).numpy()
    ref = np.asarray(jcompact.stable_partition_order(jnp.asarray(mask), w))
    np.testing.assert_array_equal(got, ref)
    n = mask.shape[0]
    slot = np.arange(n)
    argsort = np.argsort(np.where(mask, slot, slot + n), kind='stable')
    np.testing.assert_array_equal(got, argsort[:w])


def test_basins_match_jax():
    from tropical_cyclone_risk_tpu.config import Namelist
    cfg = Namelist()
    lon, lat = _queries(3000, 9, margin=40.0)
    for b in cfg.basin_bounds_dict:
        bounds = basins.basin_bounds(cfg, b)
        assert bounds == jbasins.basin_bounds(cfg, b)
        np.testing.assert_array_equal(
            basins.in_basin(torch.from_numpy(lon), torch.from_numpy(lat),
                            bounds, 1.0).numpy(),
            np.asarray(jbasins.in_basin(jnp.asarray(lon), jnp.asarray(lat),
                                        bounds, 1.0)))
    np.testing.assert_array_equal(
        basins.to_0360(torch.from_numpy(lon)).numpy(),
        np.asarray(jbasins.to_0360(jnp.asarray(lon))))
    assert basins.validate_basin_id(cfg, 'na') == 'NA'
    with pytest.raises(ValueError):
        basins.validate_basin_id(cfg, 'XX')
