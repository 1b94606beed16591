"""The port's analysis surface against the JAX package's: ops/sphere, the
per-track diagnostics, analysis.py and utils/util.py.

Tolerances, with their reasons:
- sphere and axi_to_max_wind on float32 inputs: torch's and XLA's float32
  sin, cos, arcsin, sqrt and tanh round apart by an ulp or so, so
  haversine within 1e-6 relative (~1 cm on 10 km), translation speeds and
  vmax within 1e-4 m/s, to_sphere_dist within 1e-4 deg; NaN exactly
  where the JAX package has NaN; _extrapolate_nan_tail (additions and
  subtractions only) and vmax_filter's verdicts bit for bit;
- analysis and util: numpy code shared line for line, reading one tracks
  file the port wrote (and its _e0 sibling) through each package's own
  netcdf reader, so every value is equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu import analysis as janalysis
from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import diagnostics as jdiag
from tropical_cyclone_risk_tpu.ops import sphere as jsphere
from tropical_cyclone_risk_tpu.utils import util as jutil
from tropical_cyclone_risk_tpu_torch import analysis, runtime
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import diagnostics, fields
from tropical_cyclone_risk_tpu_torch.ops import sphere
from tropical_cyclone_risk_tpu_torch.utils import util

SPEED_TOL = 1e-4        # m/s
DEG_TOL = 1e-4
HAV_RTOL = 1e-6
DT = 3600.0


def _tracks():
    """[8, 30] float32 tracks: random walks, two across the date line (one
    in -180..180 longitudes, one across 360/0), NaN tails of several
    lengths, one track with a single valid sample; env winds [8, 30, 4]
    and intensities."""
    r = np.random.default_rng(0)
    n, T = 8, 30
    lon = 120 + np.cumsum(r.normal(0.3, 0.4, (n, T)), axis=1)
    lat = 12 + np.cumsum(r.normal(0.15, 0.2, (n, T)), axis=1)
    lon[1] = np.where(lon[1] - 120 + 178.5 > 180, lon[1] - 120 + 178.5 - 360,
                      lon[1] - 120 + 178.5)
    lon[2] = (lon[2] + 236.0) % 360.0
    v = np.clip(r.normal(35, 12, (n, T)), 5, None)
    v[[4, 6]] = 8.0                     # two tracks below the vmax filter
    wnds = r.normal(0, 8, (n, T, 4))
    for i, end in enumerate([30, 30, 22, 9, 2, 17, 1, 25]):
        lon[i, end:] = lat[i, end:] = v[i, end:] = np.nan
        wnds[i, end:] = np.nan
    return tuple(a.astype(np.float32) for a in (lon, lat, v, wnds))


def _close(ours, theirs, atol=0.0, rtol=0.0):
    a, b = ours.numpy(), np.asarray(theirs)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol)


def test_haversine_and_to_sphere_dist():
    lon, lat, _, _ = _tracks()
    t = torch.from_numpy
    _close(sphere.haversine(t(lon[:, :-1]), t(lat[:, :-1]), t(lon[:, 1:]),
                            t(lat[:, 1:])),
           jsphere.haversine(lon[:, :-1], lat[:, :-1], lon[:, 1:],
                             lat[:, 1:]), rtol=HAV_RTOL)
    dx = np.linspace(-2e5, 2e5, lon.size, dtype=np.float32).reshape(lon.shape)
    for ours, theirs in zip(
            sphere.to_sphere_dist(t(lon), t(lat), t(dx), t(-dx)),
            jsphere.to_sphere_dist(lon, lat, dx, -dx)):
        _close(ours, theirs, atol=DEG_TOL)


@pytest.mark.parametrize('T', [30, 1])
def test_translational_speed(T):
    """Every track's speeds, and the single-sample guard (T = 1: NaN of
    the input's shape)."""
    lon, lat, _, _ = _tracks()
    lon, lat = lon[:, :T], lat[:, :T]
    for ours, theirs in zip(
            sphere.translational_speed(torch.from_numpy(lon),
                                       torch.from_numpy(lat), DT),
            jsphere.translational_speed(lon, lat, DT)):
        _close(ours, theirs, atol=SPEED_TOL)
        assert ours.shape == lon.shape


def test_extrapolate_nan_tail():
    lon, lat, _, _ = _tracks()
    pos = np.stack([lon, lat])
    ours = diagnostics._extrapolate_nan_tail(torch.from_numpy(pos))
    _close(ours, jdiag._extrapolate_nan_tail(jnp.asarray(pos)))
    assert np.isfinite(ours.numpy()).all()


@pytest.mark.parametrize('with_cfg', [False, True])
def test_axi_to_max_wind_and_vmax_filter(with_cfg):
    lon, lat, v, wnds = _tracks()
    t = torch.from_numpy
    ours = diagnostics.axi_to_max_wind(t(lon), t(lat), DT, t(v), t(wnds),
                                       Namelist() if with_cfg else None)
    theirs = jdiag.axi_to_max_wind(lon, lat, DT, v, wnds,
                                   JNamelist() if with_cfg else None)
    _close(ours, theirs, atol=SPEED_TOL)
    # the last valid sample gets the edge extrapolation, not NaN
    assert np.isfinite(ours.numpy()[np.isfinite(v)]).all()
    keep = diagnostics.vmax_filter(Namelist(), ours)
    np.testing.assert_array_equal(
        keep.numpy(), np.asarray(jdiag.vmax_filter(JNamelist(), theirs)))
    assert keep.any() and not keep.all()


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """One tracks file the port wrote (two years) and its _e0 sibling,
    and the synthetic pack's land mask with its axes."""
    tmp = tmp_path_factory.mktemp('an')
    cfg = Namelist(seed_batch=2048, end_year=2017, tracks_per_year=6,
                   output_directory=str(tmp), exp_name='an',
                   integrate_cap=0.5,
                   recompact_schedule=((90, 0.375), (180, 0.25)))
    pack_np = fields.synthetic_pack_numpy(cfg, 24, 91, 180, seed=0)
    pack = fields.pack_from_numpy(pack_np, device='cpu')
    fns = [runtime.run_downscaling(cfg, 'GL', pack, seed=s) for s in (1, 2)]
    assert fns[1] == fns[0][:-3] + '_e0.nc'
    land = (pack_np['land'], np.arange(0.0, 360.0, 2.0),
            np.linspace(-90.0, 90.0, 91))
    return fns, land


@pytest.fixture(scope='module')
def ensembles(files):
    fns, _ = files
    return analysis.open_tracks(fns), janalysis.open_tracks(fns)


def test_open_tracks_reads_port_files(files, ensembles):
    ours, theirs = ensembles
    assert ours.n_ensemble == 2
    assert ours.lon.shape == (2, 12, Namelist().n_steps_output)
    assert list(ours.year) == [2016, 2017]
    assert ours.basin == theirs.basin == list(Namelist().basin_ids_sorted())
    for k in ('lon', 'lat', 'vmax', 'v', 'tc_month', 'tc_years',
              'tc_basins', 'seeds_per_month', 'year'):
        a, b = getattr(ours, k), getattr(theirs, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the two members are different draws
    assert not np.array_equal(ours.lat[0], ours.lat[1], equal_nan=True)


def _calls(ens, land, poi, basin):
    """Every public analysis function (the notebook's calls among them)
    on one ensemble; basin: the one most tracks of the ensemble start in."""
    return {
        'seasonal_cycle': lambda a: a.seasonal_cycle(ens, basin),
        'interannual_frequency': lambda a: a.interannual_frequency(
            ens, basin, obs_tracks_per_year=14.0),
        'interannual_frequency_quota': lambda a: a.interannual_frequency(
            ens, basin, 6, obs_tracks_per_year=14.0),
        'max_wind_near_point': lambda a: a.max_wind_near_point(
            ens, *poi, radius_km=500.0),
        'return_periods': lambda a: a.return_periods(ens, *poi,
                                                     radius_km=500.0),
        'track_density': lambda a: a.track_density(ens, res_deg=2.0),
        'genesis_density': lambda a: a.genesis_density(ens, res_deg=5.0),
        'lmi_distribution': lambda a: a.lmi_distribution(ens),
        'landfalls': lambda a: a.landfalls(ens, *land),
        'landfalls_substeps': lambda a: a.landfalls(ens, *land, substeps=4),
        'landfall_return_periods': lambda a: a.landfall_return_periods(
            ens, *land),
        'return_period_ci': lambda a: a.return_period_ci(
            ens, *poi, radius_km=500.0, n_boot=200),
        'landfall_return_period_ci': lambda a: a.landfall_return_period_ci(
            ens, *land, region=(0.0, 360.0, -60.0, 60.0), n_boot=200),
        'intensity_change': lambda a: a.intensity_change(ens, *land),
        'pdi': lambda a: a.pdi(ens),
    }


def _flat(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _flat(x[k])]
    if isinstance(x, tuple):
        return [y for v in x for y in _flat(v)]
    return [np.asarray(x)]


@pytest.mark.parametrize('name', sorted(_calls(None, None, None, None)))
def test_analysis_equals_jax(files, ensembles, name):
    """Each public analysis function: the port's on its own ensemble and
    the JAX package's on its own, equal bit for bit."""
    _, land = files
    ours, theirs = ensembles
    poi = (float(ours.lon[0, 0, 0]), float(ours.lat[0, 0, 0]))
    basins, counts = np.unique(ours.tc_basins, return_counts=True)
    basin = str(basins[counts.argmax()])
    a = _flat(_calls(ours, land, poi, basin)[name](analysis))
    b = _flat(_calls(theirs, land, poi, basin)[name](janalysis))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert any(np.isfinite(x).any() and np.any(x != 0) for x in a
               if x.dtype.kind == 'f')


def test_analysis_surface_is_complete():
    """The port's analysis module has every public name of the JAX
    package's, and this file's calls cover every public function."""
    public = lambda m: {k for k, v in vars(m).items() if not k.startswith(
        '_') and getattr(v, '__module__', m.__name__) == m.__name__}
    assert public(analysis) == public(janalysis)
    covered = {k.replace('_quota', '').replace('_substeps', '')
               for k in _calls(None, None, None, None)}
    funcs = {k for k in public(analysis) if callable(getattr(analysis, k))
             and k != 'TrackEnsemble'}
    assert funcs - covered == {'open_tracks'}


def test_util_equals_jax(files, tmp_path):
    fns, _ = files
    data = np.random.default_rng(1).gamma(2.0, 10.0, 500)
    np.testing.assert_array_equal(
        util.inv_trans_sampling(data, rng=np.random.default_rng(5)),
        jutil.inv_trans_sampling(data, rng=np.random.default_rng(5)))
    bad = tmp_path / 'not.nc'
    bad.write_bytes(b'not a netcdf file')
    for fn, want in ((fns[0], True), (fns[1], True), (str(bad), False)):
        assert util.is_nc_file_valid(fn) is jutil.is_nc_file_valid(fn) is want
