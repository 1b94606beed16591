"""The port's uncoupled beta-advection track model (models/bam.py) and
fast.sample_env_winds against the JAX package's, on numpy-seeded
synthetic packs (12 planes, 46 x 90) with the same genesis points, planes
and Fourier A/B (drawn with numpy) on both sides; the port runs on the CPU
here and on the card in chip_smoke.py [BAM].

Tolerances, with their reasons:
- winds: rtol 1e-5 (plus 1e-6 of the largest magnitude): XLA on the CPU
  contracts the Cholesky coloring's a*b+c into fused multiply-adds and
  rounds sin/cos otherwise, torch does neither;
- tracks over 361 forward-Euler steps: lon/lat within 1e-3 degrees where
  both are alive (the largest differences found: 3.1e-5 degrees of lon
  and 7.6e-6 of lat in GL, 1.5e-5 and 7.6e-6 in SI), the same rounding
  seeds carried along the track; alive histories equal, except for a
  storm that leaves the basin at a point within 1e-3 degrees of the
  1-degree margin, where that rounding can move the exit by one step
  (none does on these inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import bam as jbam
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.models import bam, fast, fields
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins

CFG = Namelist()
N = 64
# genesis belts: GL in the northern tropics (and 8 storms near the pole),
# SI in the southern ones
BELTS = {'GL': ((100.0, 260.0), (5.0, 30.0)), 'SI': ((40.0, 95.0),
                                                    (-30.0, -5.0))}
# GL's last 8 storms: at or past 80 degrees (the polar stop), and just
# below it, drifting poleward into it
POLAR_LAT = np.array([80.5, 81.0, -80.0, -83.0, 79.6, 79.9, -79.7, 79.95],
                     np.float32)


def _fourier_numpy(r, n):
    """A/B [n, 4, 15] as the JAX draw makes them (amplitude n^-1.5 with
    the reference's normalization, uniform phases), drawn with numpy."""
    k = np.arange(1, fourier.N_FOURIER + 1, dtype=np.float32)
    amp = np.sqrt(2.0 / np.sum(k ** -3.0)) * k ** -1.5
    phi = r.random((n, 4, fourier.N_FOURIER))
    return ((amp * np.cos(2 * np.pi * phi)).astype(np.float32),
            (amp * np.sin(2 * np.pi * phi)).astype(np.float32))


def _inputs(basin, seed):
    """(lon0, lat0, plane, A, B) of N storms in the basin's belt."""
    r = np.random.default_rng(seed)
    (lo0, lo1), (la0, la1) = BELTS[basin]
    lon = r.uniform(lo0, lo1, N).astype(np.float32)
    lat = r.uniform(la0, la1, N).astype(np.float32)
    if basin == 'GL':
        lat[-POLAR_LAT.size:] = POLAR_LAT
    plane = r.integers(0, 12, N).astype(np.int32)
    return (lon, lat, plane, *_fourier_numpy(r, N))


@pytest.fixture(scope='module')
def packs():
    out = {}
    for basin in BELTS:
        jpack = jfields.synthetic_pack(CFG, 12, 46, 90, seed=5,
                                       run_basin=basin)
        out[basin] = (jpack, fields.pack_from_numpy(jpack, device='cpu'))
    return out


@pytest.fixture(scope='module')
def tracks(packs):
    """{basin: (inputs, the JAX tracks, the port's tracks)}."""
    out = {}
    for i, basin in enumerate(BELTS):
        jpack, tpack = packs[basin]
        lon, lat, plane, A, B = _inputs(basin, 11 + i)
        want = jbam.gen_tracks(
            jpack, CFG, basin, lon, lat, jnp.asarray(plane),
            jfourier.FourierSeries(jnp.asarray(A), jnp.asarray(B),
                                   jnp.float32(CFG.T_fourier_s)))
        kernels.reset_counts()
        got = bam.gen_tracks(
            tpack, CFG, basin, torch.from_numpy(lon), torch.from_numpy(lat),
            torch.from_numpy(plane),
            fourier.FourierSeries(torch.from_numpy(A), torch.from_numpy(B),
                                  CFG.T_fourier_s))
        assert not any(kernels.LAUNCHES.values())
        out[basin] = ((lon, lat), [np.asarray(x) for x in want],
                      [x.numpy() for x in got])
    return out


def test_sample_env_winds_matches_jax(packs):
    """Winds at 512 points on their planes, at a track time, from the
    pack's statistics colored by the storms' Fourier series."""
    jpack, tpack = packs['GL']
    r = np.random.default_rng(3)
    n = 512
    lon = r.uniform(0.0, 359.0, n).astype(np.float32)
    lat = r.uniform(-60.0, 60.0, n).astype(np.float32)
    plane = r.integers(0, 12, n).astype(np.int32)
    A, B = _fourier_numpy(r, n)
    t = 3600.0 * 37
    want = np.asarray(jfast.sample_env_winds(
        jpack, CFG, jnp.asarray(lon), jnp.asarray(lat), jnp.asarray(plane),
        jfourier.FourierSeries(jnp.asarray(A), jnp.asarray(B),
                               jnp.float32(CFG.T_fourier_s)),
        jnp.float32(t)))
    got = fast.sample_env_winds(
        tpack, CFG, torch.from_numpy(lon), torch.from_numpy(lat),
        torch.from_numpy(plane),
        fourier.FourierSeries(torch.from_numpy(A), torch.from_numpy(B),
                              CFG.T_fourier_s), t).numpy()
    assert got.shape == want.shape == (n, CFG.n_wind_levels)
    assert np.abs(want).max() > 5.0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize('basin', sorted(BELTS))
def test_gen_tracks_matches_jax(tracks, basin):
    """lon, lat and alive [N, 361] against the JAX package in GL and SI
    (the beta drift's sign flips south of the equator): every storm alive
    at genesis, the same alive history (up to exits on the margin), lon
    and lat within 1e-3 degrees, NaN exactly after each exit, and the
    drift poleward in each hemisphere."""
    (lon0, lat0), (wl, wa, walive), (gl, ga, galive) = tracks[basin]
    T = CFG.n_steps_output
    assert gl.shape == ga.shape == galive.shape == (N, T)
    assert galive[:, 0].all() and walive[:, 0].all()
    lon_lo, lat_lo, lon_hi, lat_hi = basins.basin_bounds(CFG, basin)
    for i in np.flatnonzero((galive != walive).any(axis=1)):
        d = int(np.argmax(galive[i] != walive[i]))
        x, y = (gl[i, d], ga[i, d]) if galive[i, d] else (wl[i, d], wa[i, d])
        margin = min(abs(x - (lon_lo + 1)), abs(x - (lon_hi - 1)),
                     abs(y - (lat_lo + 1)), abs(y - (lat_hi - 1)))
        assert margin <= 1e-3, (i, d, x, y)
    both = galive & walive
    assert both.sum() > N * 48
    np.testing.assert_allclose(gl[both], wl[both], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ga[both], wa[both], rtol=0, atol=1e-3)
    assert np.isnan(gl[~galive]).all() and np.isfinite(gl[galive]).all()
    assert np.isnan(ga[~galive]).all() and np.isfinite(ga[galive]).all()
    # storms move, and drift poleward (the beta drift's sign)
    belt = np.abs(lat0) < 70.0
    assert np.nanmax(np.abs(gl[belt, 24] - gl[belt, 0])) > 0.1
    drift = np.nanmean(ga[belt, 48] - ga[belt, 0])
    assert drift * np.sign(lat0[belt][0]) > 0


def test_gen_tracks_polar_stop(tracks):
    """At |lat| >= 80 a storm's winds and motion are zero: it stays where
    it is, alive in GL (whose margin is 89 degrees), in both packages;
    a storm drifting poleward stops at its first sample past 80."""
    (lon0, lat0), (wl, wa, walive), (gl, ga, galive) = tracks['GL']
    polar = slice(N - POLAR_LAT.size, N)
    assert galive[polar].all() and walive[polar].all()
    # starting at or past 80 degrees: the genesis point throughout
    at = np.flatnonzero(np.abs(lat0) >= 80.0)
    assert at.size == 4
    for lon, lat in ((gl, ga), (wl, wa)):
        np.testing.assert_array_equal(lon[at], lon0[at, None] + 0 * lon[at])
        np.testing.assert_array_equal(lat[at], lat0[at, None] + 0 * lat[at])
    # starting below it: moving until the first sample past 80
    stopped = 0
    for lon, lat in ((gl, ga), (wl, wa)):
        for i in range(N - POLAR_LAT.size, N):
            past = np.flatnonzero(np.abs(lat[i]) >= 80.0)
            assert past.size, i
            k = past[0]
            np.testing.assert_array_equal(lat[i, k:], lat[i, k])
            np.testing.assert_array_equal(lon[i, k:], lon[i, k])
            stopped += k > 0
    assert stopped == 2 * (POLAR_LAT.size - at.size)
