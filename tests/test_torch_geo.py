"""Land and bathymetry on their own grids: the port's twins against the JAX
package on the CPU in the two stack layouts of models/fields.py
GatherStacks besides the in-cell one, and the host side of the integrator
and genesis gate kernels there (their parameter blocks and pointers).

Packs: the 91x180 synthetic pack of tests/test_torch_models.py with its
land mask on a 0.5-degree grid (361 x 720) and the bathymetry either the
land-derived proxy on that grid ("fused": land_geo4 holds both) or its own
field on a 0.25-degree grid (721 x 1440, "separate"), the same numpy
arrays on both sides.

Tolerances, those of tests/test_torch_models.py and
tests/test_torch_pipeline.py, with their reasons:
- field samples: rtol 1e-5 plus an atol of 1e-6 of the largest magnitude
  (XLA on the CPU contracts the blend's a*b+c into fused multiply-adds,
  torch does not);
- a <= 30-step integration: 1e-4 deg in lon/lat, 1e-3 m/s in v and the
  winds, 1e-4 in m, alive masks exact;
- the genesis gate: keep masks exact;
- one launch: tolerance (a) of tests/test_torch_pipeline.py (>= 99.5% of
  keep verdicts equal, matched survivors within 1e-3 deg and 1e-2 m/s).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import pipeline as jpipeline
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.ops.interp import UniformGrid as JGrid
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import kernels, rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import (fast, fields, pipeline,
                                                    simulator)
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins, synthetic_era5

CFG = Namelist(seed_batch=2048)
JCFG = JNamelist(seed_batch=2048)
N = 1500
LAYOUTS = {'fused': integrator.FUSED_GEO, 'separate': integrator.SEPARATE_GEO}
SEG = dict(integrate_cap=0.5, recompact_schedule=((90, 0.375), (180, 0.25)))
TRACK_KEYS = ('lon', 'lat', 'v', 'm', 'vmax', 'wnds')
TRACK_TOL = {'lon': 1e-3, 'lat': 1e-3, 'v': 1e-2, 'm': 1e-3, 'vmax': 1e-2,
             'wnds': 1e-2}
STEP_TOL = {'lon': 1e-4, 'lat': 1e-4, 'v': 1e-3, 'm': 1e-4, 'wnds': 1e-3}


def _grid(res):
    lon, lat = synthetic_era5.res_axes(res)
    return lon, lat, JGrid.from_axes(lon, lat)


def _geo_pack(jpack, layout):
    """The JAX synthetic pack with land on 0.5 degrees and the bathymetry
    on that grid (fused) or on 0.25 degrees (separate)."""
    lon, lat, g_land = _grid(0.5)
    LO, LA = np.meshgrid(lon, lat)
    # the synthetic pack's continents, resolved at 0.5 degrees
    land = ((np.abs(LA) > 66) | ((LO > 270) & (LO < 310) & (LA > -60))
            ).astype(np.float32)
    if layout == 'fused':
        g_bathy = g_land
        bathy = np.where(land > 0, 100.0, -4500.0).astype(np.float32)
    else:
        b_lon, b_lat, g_bathy = _grid(0.25)
        bathy = synthetic_era5.bathy_2d(b_lon, b_lat)
    return jpack._replace(land_grid=g_land, land=jnp.asarray(land),
                          bathy_grid=g_bathy, bathy=jnp.asarray(bathy))


@pytest.fixture(scope='module', params=list(LAYOUTS))
def packs(request):
    jpack = _geo_pack(jfields.synthetic_pack(JCFG, 12, 91, 180, seed=0),
                      request.param)
    return request.param, jpack, fields.pack_from_numpy(jpack, device='cpu')


@pytest.fixture(scope='module')
def storms():
    """Same seeds on both sides: positions over the globe, coasts and
    shelves included, intensities, planes and Fourier draws from one
    key."""
    r = np.random.default_rng(42)
    lon = r.uniform(0.0, 360.0, N).astype(np.float32)
    lat = (r.choice([-1.0, 1.0], N) * r.uniform(3.0, 60.0, N)
           ).astype(np.float32)
    v = r.uniform(8.0, 60.0, N).astype(np.float32)
    m = r.uniform(0.2, 0.9, N).astype(np.float32)
    plane = r.integers(0, 12, N).astype(np.int32)
    h_bl = r.choice(CFG.h_bl_by_basin(), N).astype(np.float32)
    fj = jfourier.draw_fourier(jax.random.key(3), (N, 4), CFG.T_fourier_s)
    jy = jfast.State(*(jnp.asarray(x) for x in (lon, lat, v, m)))
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl), fj)
    ty = fast.State(*(torch.from_numpy(x) for x in (lon, lat, v, m)))
    tp = fast.SeedParams(
        torch.from_numpy(plane), torch.from_numpy(h_bl),
        fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                              torch.from_numpy(np.array(fj.B)),
                              CFG.T_fourier_s))
    return jy, jp, ty, tp


def _close(got, ref, err_msg=''):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max() + 1e-30,
                               err_msg=err_msg)


def test_stacks_are_the_jax_stacks(packs):
    """build_stacks gives the JAX package's stacks bit for bit, in the
    layout the kernels read for it."""
    layout, jpack, tpack = packs
    js, ts = jfields.build_stacks(jpack), fields.build_stacks(tpack)
    assert not ts.geo_in_cell and not js.geo_in_cell
    assert ts.fused_geo == js.fused_geo == (layout == 'fused')
    assert integrator.geo_layout(ts) == LAYOUTS[layout]
    assert ts.cell4.shape[-1] == integrator.cell_row(LAYOUTS[layout], 2)
    for name in ('cell4', 'land_geo4', 'bathy4'):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ('grid', 'land_grid', 'bathy_grid'):
        assert tuple(getattr(ts, name)) == tuple(getattr(js, name)), name


@pytest.mark.parametrize('t', [None, 0.0, 7 * 86400.0, 40 * 86400.0])
def test_sample_fields_matches_jax(packs, storms, t):
    """sample_fields (t None) and sample_fields_at_time with
    time_interp_fields at track times within and past the first month:
    every channel, land and bathymetry from their own grids."""
    _, jpack, tpack = packs
    jy, jp, ty, tp = storms
    js, ts = jfields.build_stacks(jpack), fields.build_stacks(tpack)
    if t is None:
        want = jfast.sample_fields(js, jy.lon, jy.lat, jp.plane)
        got = fast.sample_fields(ts, ty.lon, ty.lat, tp.plane)
    else:
        jcfg, cfg = (c.replace(time_interp_fields=True) for c in (JCFG, CFG))
        want = jfast.sample_fields_at_time(js, jcfg, jy.lon, jy.lat,
                                           jp.plane, t)
        got = fast.sample_fields_at_time(ts, cfg, ty.lon, ty.lat, tp.plane,
                                         t)
    for name, a, b in zip(got._fields, got, want):
        _close(a.numpy(), b, err_msg=name)
    # the land fraction takes fractional values on the 0.5-degree coasts
    land = got.land.numpy()
    assert ((land > 0) & (land < 1)).any() and (land >= 1).any()


@pytest.mark.parametrize('interp', [False, True])
def test_integrate_segment_matches_jax(packs, storms, interp):
    """One 20-step segment (strided blocks and per-step remainder) in the
    default mode and with time_interp_fields."""
    _, jpack, tpack = packs
    jy, jp, ty, tp = storms
    jcfg = JCFG.replace(time_interp_fields=interp)
    cfg = CFG.replace(time_interp_fields=interp)
    bounds = jbasins.basin_bounds(JCFG, 'GL')
    alive0 = np.random.default_rng(1).random(N) < 0.9

    @functools.partial(jax.jit, static_argnums=(4, 5))
    def ref(pack, y, a0, params, k0, n):
        return jsim.integrate_segment(jfields.build_stacks(pack), jcfg,
                                      bounds, y, a0, params, k0, n)

    outs_j, (yend_j, aend_j) = ref(jpack, jy, jnp.asarray(alive0), jp, 0, 20)
    kernels.reset_counts()
    outs, (yend, aend) = simulator.integrate_segment(
        fields.build_stacks(tpack), cfg, basins.basin_bounds(CFG, 'GL'), ty,
        torch.from_numpy(alive0), tp, 0, 20)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    np.testing.assert_array_equal(outs[5].numpy(), np.asarray(outs_j[5]))
    np.testing.assert_array_equal(aend.numpy(), np.asarray(aend_j))
    for name, a, b in zip(('lon', 'lat', 'v', 'm', 'wnds'), outs, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=STEP_TOL[name], err_msg=name)
    for name, a, b in zip(('lon', 'lat', 'v', 'm'), yend, yend_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=STEP_TOL[name], err_msg=name)


def test_genesis_alive_matches_jax(packs, storms):
    _, jpack, tpack = packs
    jy, jp, ty, tp = storms
    mask = np.random.default_rng(2).random(N) < 0.7
    want = jax.jit(lambda pack, y, p, msk: jsim.genesis_alive(
        pack, JCFG, y, p, msk))(jpack, jy, jp, jnp.asarray(mask))
    kernels.reset_counts()
    got = simulator.genesis_alive(fields.build_stacks(tpack), CFG, ty, tp,
                                  torch.from_numpy(mask))
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < mask.sum()


def test_launch_matches_jax(packs):
    """One 2048-seed multi-segment launch (_simulate_batch: launch_body and
    compact_survivors) in both packages, tolerance (a)."""
    _, jpack, tpack = packs
    cfg, jcfg = CFG.replace(**SEG), JCFG.replace(**SEG)
    tt, mt = (
        {k: np.asarray(v) for k, v in d.items()}
        for d in pipeline._simulate_batch(rng.key(5), tpack, cfg, 'GL',
                                          CFG.seed_batch, 256, 0))
    tj, mj = (
        {k: np.asarray(v) for k, v in d.items()}
        for d in jpipeline._simulate_batch(jax.random.key(5), jpack, jcfg,
                                           'GL', CFG.seed_batch, 256,
                                           jnp.int32(0)))
    assert (mt['keep'] == mj['keep']).mean() >= 0.995
    np.testing.assert_array_equal(mt['counted'], mj['counted'])
    both = mt['keep'] & mj['keep']
    assert both.sum() > 20
    rt = (np.cumsum(mt['keep']) - 1)[both]
    rj = (np.cumsum(mj['keep']) - 1)[both]
    for k in TRACK_KEYS:
        a, b = tt[k][rt], tj[k][rj]
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=TRACK_TOL[k], err_msg=k)


def test_kernel_params_carry_each_grid(packs):
    """K1's and K7's parameter blocks carry the layout and the land and
    bathymetry grids as the twin's UniformGrids hold them (float32 origins
    and spacings, int32 sizes); the cell grid stays where it was."""
    layout, _, tpack = packs
    stacks = fields.build_stacks(tpack)
    f32 = lambda g: np.float32([g.lon0, g.dlon, g.lat0, g.dlat])
    fp, ip = integrator._params(stacks, CFG, (0.0,) * 4, 64, 10, 3, 3, 0,
                                0.0, False, (64, 64, 1))
    fg, ig = integrator.gate_params(stacks, CFG, 64)
    for f, i in ((fp, ip), (fg, ig)):
        np.testing.assert_array_equal(f[:4], f32(stacks.grid))
        np.testing.assert_array_equal(f[-8:-4], f32(stacks.land_grid))
        np.testing.assert_array_equal(f[-4:], f32(stacks.bathy_grid))
        assert i[15:20].tolist() == [
            LAYOUTS[layout], stacks.land_grid.nlon, stacks.land_grid.nlat,
            stacks.bathy_grid.nlon, stacks.bathy_grid.nlat]
    # the kernels read land_geo4 in both layouts, bathy4 in the separate one
    geo = integrator.geo_inputs(stacks)
    assert geo['geo4'] is stacks.land_geo4
    assert (geo['bathy4'] is stacks.bathy4) == (layout == 'separate')
    assert stacks.land_geo4.shape[-1] == (8 if layout == 'fused' else 4)


def test_kernel_wrappers_take_the_layout_on_cuda_alone(packs, storms):
    """The wrappers no longer refuse these layouts: on CPU tensors they
    refuse the device (ValueError), as for the in-cell layout, and a cell
    row whose channels do not fit the layout is refused as before."""
    _, _, tpack = packs
    _, _, ty, tp = storms
    stacks = fields.build_stacks(tpack)
    keep_in = torch.ones(N, dtype=torch.bool)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks, CFG, ty, tp, keep_in)
    with pytest.raises(ValueError, match='CUDA'):
        integrator.integrate_segment_cuda(
            stacks, CFG, (0.0,) * 4, ty, keep_in, tp, 0, 2, None, 1, 0)
    in_cell = fields.build_stacks(fields.synthetic_pack(
        CFG, 12, 91, 180, seed=0, device='cpu'))
    with pytest.raises(NotImplementedError, match='76-channel'):
        integrator.genesis_gate_cuda(stacks._replace(cell4=in_cell.cell4),
                                     CFG, ty, tp, keep_in)
    assert not any(kernels.LAUNCHES.values())
