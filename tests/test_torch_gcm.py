"""The port's GCM (CMIP6) path against the JAX package's on the CPU: the
synthetic GFDL-CM4 ssp585-style workspace (utils/synthetic_cmip6.py against
tools/make_synthetic_cmip6.py), the noleap calendar, levels in Pa, the
wind statistics, the thermo file with its SST regrid from the finer ocean
grid, the pack builder, and cli.main GL seed by seed; the thermo driver's
and the pack builder's regrids take tensors on the run's device.

One module-scoped coarse workspace, as tests/test_cmip6_e2e.py builds its
own: 4 degrees, 2030-2031, tracks_per_year = 2, seed_batch = 1024; the
port's land masks, wind statistics and thermo on the CPU.  Each test
states its tolerance and why.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from test_torch_workspace import TRACK_TOL
from tools import make_synthetic_cmip6
from tropical_cyclone_risk_tpu import cli as jcli
from tropical_cyclone_risk_tpu import config as jconfig
from tropical_cyclone_risk_tpu.io import input as jtcin
from tropical_cyclone_risk_tpu.io import netcdf as jnetcdf
from tropical_cyclone_risk_tpu.ops import interp as jinterp
from tropical_cyclone_risk_tpu.preprocess import thermo_driver as jthermo
from tropical_cyclone_risk_tpu.preprocess import winds as jwinds
from tropical_cyclone_risk_tpu_torch import cli, config, kernels, runtime
from tropical_cyclone_risk_tpu_torch.io import input as tcin
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.ops import interp
from tropical_cyclone_risk_tpu_torch.preprocess import (land_masks,
                                                        thermo_driver, winds)
from tropical_cyclone_risk_tpu_torch.utils import synthetic_cmip6

Y0, Y1 = 2030, 2031
LEVELS4 = dict(steering_levels=(250, 500, 700, 850),
               steering_coefs=(0.1, 0.2, 0.2, 0.5),
               y_alpha=(0.1, 0.2, 0.2, 0.5), m_alpha=(0.001, 0.0, 0.0, -0.001),
               alpha_max=(0.4, 0.4, 0.4, 0.9),
               alpha_min=(0.05, 0.05, 0.05, 0.5))


@pytest.fixture(scope='module')
def gcm(tmp_path_factory):
    """The coarse workspace, its namelist and the port's preprocessing
    outputs (land masks, wind statistics, thermo) run on the CPU."""
    root = tmp_path_factory.mktemp('gcm')
    nl = synthetic_cmip6.build(str(root), Y0, Y1, coarse=True, seed=0,
                               tracks_per_year=2, seed_batch=1024)
    cfg = config.load_namelist_py(nl)
    assert cfg.dataset_type == 'GCM'
    land_masks.generate_land_masks(cfg.fn_land, cfg.mask_dir)
    cli.compute_downscaling_inputs(cfg, device='cpu')
    return root, nl, cfg


def _same_tree(a, b):
    """Every NetCDF file under a/raw and a/static equals b's: names,
    variables, dtypes, values (NaN where NaN) and attributes."""
    for sub in ('raw', 'static'):
        names = sorted(os.listdir(a / sub))
        assert names == sorted(os.listdir(b / sub)), sub
        for f in names:
            da = netcdf.read(str(a / sub / f))
            db = netcdf.read(str(b / sub / f))
            assert set(da.variables) == set(db.variables), f
            for k in da.variables:
                x, y = np.asarray(da[k].data), np.asarray(db[k].data)
                assert (x.dtype, x.shape, da[k].dims) == (
                    y.dtype, y.shape, db[k].dims), (f, k)
                np.testing.assert_array_equal(x, y, err_msg=f'{f} {k}')
                assert da[k].attrs == db[k].attrs, (f, k)


def test_synthetic_cmip6_equals_the_jax_tool(gcm, tmp_path):
    """utils/synthetic_cmip6.build writes the arrays and attributes of
    tools/make_synthetic_cmip6.build at the same seed, years and grid, and
    its namelist (with test_cmip6_e2e.py's two edits)."""
    root, nl, _ = gcm
    make_synthetic_cmip6.build(str(tmp_path), Y0, Y1, coarse=True, seed=0)
    _same_tree(root, tmp_path)
    theirs = (tmp_path / 'namelist.py').read_text()
    theirs = theirs.replace('tracks_per_year = 14', 'tracks_per_year = 2')
    theirs = theirs.replace('seed_batch = 16384', 'seed_batch = 1024')
    assert open(nl).read() == theirs.replace(str(tmp_path), str(root))


def test_decode_time_noleap_matches_jax(gcm):
    """The noleap and 365_day decoding (tests/test_gcm_inputs.py:23 and
    :119) equals the JAX package's on the same values, and so do the
    workspace's daily and monthly time axes and their months: Feb 29 does
    not exist, day 59 of a year is March 1, fractions keep the time of
    day, 45 years of days decode at once."""
    root, _, _ = gcm
    cases = [(np.array([58.0, 59.0, 60.0]), 'days since 2016-01-01',
              'noleap'),
             (np.array([0.5, 400.25]), 'days since 2000-1-1', '365_day'),
             (np.arange(45 * 365, dtype=np.float64), 'days since 1979-1-1',
              'noleap')]
    for vals, units, cal in cases:
        t0 = time.perf_counter()
        got = tcin.decode_time(vals, units, cal)
        assert time.perf_counter() - t0 < 0.5
        np.testing.assert_array_equal(got, jtcin.decode_time(vals, units,
                                                             cal))
    got = tcin.decode_time(np.array([58.0, 59.0, 60.0]),
                           'days since 2016-01-01', 'noleap')
    assert [str(t)[:10] for t in got] == ['2016-02-28', '2016-03-01',
                                         '2016-03-02']
    days = tcin.decode_time(np.arange(45 * 365, dtype=np.float64),
                            'days since 1979-1-1', 'noleap')
    assert days[365 + 59] == np.datetime64('1980-03-01', 's')
    assert days[-1] == np.datetime64('2023-12-31', 's')
    tag = synthetic_cmip6.TAG
    for f in (f'ua_day_{tag}_20310101-20311231.nc',
              f'tos_Omon_{tag}_20300101-20301231.nc'):
        ds = netcdf.read(str(root / 'raw' / f))
        t = tcin.times_of(ds)
        np.testing.assert_array_equal(t, jtcin.times_of(jnetcdf.read(
            str(root / 'raw' / f))))
        months = tcin.month_of(t)
        assert np.bincount(months)[1:].tolist() == (
            [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
            if 'day' in f else [1] * 12)


def test_gcm_wind_stats_match_jax(gcm, tmp_path):
    """The wind statistics of the daily ua/va on plev in Pa (the 250 and
    850 hPa levels of [25000, 85000] Pa) equal the JAX package's bit for
    bit: both are the same numpy reduction on the same files."""
    _, nl, cfg = gcm
    jcfg = jconfig.load_namelist_py(nl).replace(
        output_directory=str(tmp_path))
    ours = netcdf.read(winds.get_env_wnd_fn(cfg))
    theirs = jnetcdf.read(jwinds.gen_wind_mean_cov(jcfg))
    assert set(ours.variables) == set(theirs.variables)
    assert 'ua250_Mean' in ours.variables and 'va850_Var' in ours.variables
    for k in ours.variables:
        np.testing.assert_array_equal(ours[k].data, theirs[k].data,
                                      err_msg=k)
    assert ours['ua250_Mean'].data.shape == (24, 46, 90)


def test_gcm_thermo_matches_jax(gcm, tmp_path):
    """The thermo file from the Amon ta/hus on six levels in Pa and the
    tos in degC on the finer ocean grid, against the JAX package's:
    coords and times equal (24 mid-months of the noleap years), tropical PI
    above 50 m/s (the Kelvin shift applied); vmax, chi and rh_mid within
    tests/test_torch_workspace.py's thermo tolerances (2e-2 m/s, 2e-3,
    1e-5, for its reasons), vmax where either PI is at least 1 m/s.
    Below that (cold high-latitude ocean on six Amon levels) PI is the
    square root of a CAPE difference near zero, which turns a rounding
    difference d into d / (2 PI): there vmax**2 within 0.05 m2/s2, the
    size of a 2e-2 m/s difference at 1.25 m/s."""
    _, nl, cfg = gcm
    jcfg = jconfig.load_namelist_py(nl).replace(
        output_directory=str(tmp_path))
    got = thermo_driver.read_thermo(thermo_driver.get_fn_thermo(cfg))
    want = jthermo.read_thermo(jthermo.gen_thermo(jcfg))
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(a, b)
    assert tcin.month_of(got[5]).tolist() == list(range(1, 13)) * 2
    assert got[0].shape == (24, 46, 90)
    assert np.nanmax(got[0][:, np.abs(got[4]) < 25]) > 50.0
    strong = np.maximum(got[0], want[0]) >= 1.0
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    np.testing.assert_allclose(got[0][strong], want[0][strong], rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(got[0][~strong] ** 2, want[0][~strong] ** 2,
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)


def test_sst_regrid_runs_on_the_runs_device(gcm, tmp_path, monkeypatch):
    """gen_thermo hands the regrid each month's SST as a tensor on the
    run's device (not a numpy array, which regrid would keep on the CPU),
    and the month's thermo that regridded SST (the PI itself is
    test_gcm_thermo_matches_jax's, here a stub);
    regrid's result stays on its input's device (the meta device stands in
    for the card here) and, on the CPU, equals the JAX package's regrid
    bit for bit on every month of the ocean grid."""
    _, _, cfg = gcm
    seen = []
    orig = interp.regrid

    def spy(field, *a):
        seen.append((type(field), getattr(field, 'device', None)))
        return orig(field, *a)

    sst_in = []

    def thermo_stub(cfg, table, sst_k, psl, *a):
        sst_in.append(sst_k)
        return (torch.zeros_like(sst_k),) * 3

    monkeypatch.setattr(interp, 'regrid', spy)
    monkeypatch.setattr(thermo_driver, 'compute_thermo_month', thermo_stub)
    thermo_driver.gen_thermo(cfg.replace(output_directory=str(tmp_path)),
                             device='cpu')
    assert len(seen) == 24
    assert set(seen) == {(torch.Tensor, torch.device('cpu'))}
    monkeypatch.setattr(interp, 'regrid', orig)
    (sst_k,) = sst_in
    assert sst_k.dtype == torch.float32 and sst_k.shape == (24, 46, 90)

    ds = netcdf.read(str(gcm[0] / 'raw' / f'tos_Omon_{synthetic_cmip6.TAG}_'
                         f'{Y0}0101-{Y0}1231.nc'))
    tos = np.nan_to_num(np.asarray(ds['tos'].data, np.float32))
    lon_s, lat_s = np.asarray(ds['lon'].data), np.asarray(ds['lat'].data)
    lon_a, lat_a = synthetic_cmip6.grids(True)
    on_meta = interp.regrid(torch.zeros(tos.shape[1:], device='meta'),
                            lon_s, lat_s, lon_a, lat_a)
    assert on_meta.device.type == 'meta'
    assert tuple(on_meta.shape) == (lat_a.size, lon_a.size)
    for i, month in enumerate(tos):
        got = interp.regrid(torch.from_numpy(month), lon_s, lat_s, lon_a,
                            lat_a)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jinterp.regrid(month, lon_s, lat_s, lon_a, lat_a)))
        np.testing.assert_array_equal(
            sst_k[i].numpy(), got.numpy() + np.float32(273.15))


def test_pack_builder_matches_jax_regridding_on_the_runs_device(
        gcm, monkeypatch):
    """build_field_pack on the GCM workspace hands the regrid of the mld
    and strat climatologies (12 months each) tensors on the run's device,
    as the JAX package regrids on its device, and its pack equals the JAX
    builder's (tests/test_torch_workspace.py's tolerance, 1e-5: the same
    float32 regrid, and chi's nan_to_num and scaling in numpy)."""
    from tropical_cyclone_risk_tpu.models import pack_builder as jpack_builder
    from tropical_cyclone_risk_tpu_torch.models import pack_builder
    _, nl, cfg = gcm
    seen, orig = [], interp.regrid

    def spy(field, *a):
        seen.append((type(field), getattr(field, 'device', None)))
        return orig(field, *a)

    monkeypatch.setattr(interp, 'regrid', spy)
    ours = pack_builder.build_field_pack(cfg, 'GL', device='cpu')
    monkeypatch.setattr(interp, 'regrid', orig)
    assert len(seen) == 24
    assert set(seen) == {(torch.Tensor, torch.device('cpu'))}
    theirs = jpack_builder.build_field_pack(jconfig.load_namelist_py(nl),
                                            'GL')
    for name in ours._fields:
        a, b = getattr(ours, name), getattr(theirs, name)
        if name.endswith('grid'):
            assert tuple(a) == tuple(b), name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_cli_gcm_matches_jax_seed_by_seed(gcm, tmp_path):
    """cli.main GL --device cpu against the JAX cli.main from the same
    thermo, wind-stat and mask files: no kernel launched, the variables of
    tests/test_cmip6_e2e.py, the same track count, months, basins, years
    and seeds_per_month, every track within the survivor tolerances of
    tests/test_torch_workspace.py (TRACK_TOL)."""
    root, nl, cfg = gcm
    kernels.reset_counts()
    assert cli.main(['GL', '--namelist', nl, '--seed', '3', '--device',
                     'cpu']) == 0
    assert not any(kernels.LAUNCHES.values())
    jroot = tmp_path / 'jws'
    shutil.copytree(root / 'land', jroot / 'land')
    os.makedirs(jroot / 'out')
    for f in (thermo_driver.get_fn_thermo(cfg), winds.get_env_wnd_fn(cfg)):
        shutil.copy(f, jroot / 'out')
    jnl = jroot / 'namelist.py'
    jnl.write_text(open(nl).read()
                   .replace(f'{root}/out', f'{jroot}/out')
                   .replace(f'{root}/land', f'{jroot}/land'))
    assert jcli.main(['GL', '--namelist', str(jnl), '--seed', '3']) == 0
    fn = os.path.basename(runtime.get_fn_tracks(cfg, 'GL'))
    assert fn == 'tracks_GL_ssp585_203001_203112.nc'
    ours = netcdf.read(os.path.join(cfg.output_directory, cfg.exp_name, fn))
    theirs = jnetcdf.read(str(jroot / 'out' / cfg.exp_name / fn))
    assert set(ours.variables) == set(theirs.variables)
    for nm in ('lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
               'u250_trks', 'v850_trks', 'tc_month', 'tc_basins', 'tc_years',
               'seeds_per_month'):
        assert nm in ours.variables, nm
    assert ours['v_trks'].data.shape == (4, 361)
    assert sorted(set(ours['tc_years'].data.tolist())) == [Y0, Y1]
    for k in ('tc_month', 'tc_basins', 'tc_years', 'seeds_per_month'):
        np.testing.assert_array_equal(ours[k].data, theirs[k].data,
                                      err_msg=k)
    for k, tol in TRACK_TOL.items():
        a, b = ours[k].data, theirs[k].data
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol,
                                   err_msg=k)


def test_wind_stats_plev8_four_levels_match_jax(tmp_path):
    """A one-year coarse workspace with the daily winds on CMIP6's plev8
    and a namelist steering at 250/500/700/850 hPa: the wind statistics
    (eight means, 36 covariance entries) equal the JAX package's bit for
    bit."""
    nl = synthetic_cmip6.build(str(tmp_path / 'ws'), Y0, Y0, coarse=True,
                               seed=1, day_levels=synthetic_cmip6.PLEV8)
    with open(nl, 'a') as f:
        f.write(''.join(f'{k} = {v!r}\n' for k, v in LEVELS4.items()))
    ds = netcdf.read(str(tmp_path / 'ws' / 'raw' / (
        f'va_day_{synthetic_cmip6.TAG}_{Y0}0101-{Y0}1231.nc')))
    assert ds['plev'].data.tolist() == list(synthetic_cmip6.PLEV8)
    cfg = config.load_namelist_py(nl)
    jcfg = jconfig.load_namelist_py(nl).replace(
        output_directory=str(tmp_path / 'jout'))
    assert cfg.n_steering_levels == 4
    ours = netcdf.read(winds.gen_wind_mean_cov(cfg))
    theirs = jnetcdf.read(jwinds.gen_wind_mean_cov(jcfg))
    names = winds.wind_mean_names(cfg) + winds.wind_cov_names(cfg)
    assert len(names) == 8 + 36 and set(names) <= set(ours.variables)
    assert set(ours.variables) == set(theirs.variables)
    for k in ours.variables:
        np.testing.assert_array_equal(ours[k].data, theirs[k].data,
                                      err_msg=k)
