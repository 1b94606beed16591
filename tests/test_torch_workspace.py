"""The port's workspace path against the JAX package's on the CPU: NetCDF
I/O, the namelist, thermo preprocessing, the pack builder and the CLI.

One small raw workspace of tests/test_preprocess.py's shapes (36 x 19
one-year ERA5-style files), written with the port's writer by
utils/synthetic_era5.py, on the 28 ERA5 pressure levels.  Each test states
its tolerance and why.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu import cli as jcli
from tropical_cyclone_risk_tpu import config as jconfig
from tropical_cyclone_risk_tpu.io import netcdf as jnetcdf
from tropical_cyclone_risk_tpu.models import pack_builder as jpack_builder
from tropical_cyclone_risk_tpu.preprocess import thermo_driver as jthermo
from tropical_cyclone_risk_tpu_torch import cli, config, kernels, runtime
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.models import pack_builder
from tropical_cyclone_risk_tpu_torch.preprocess import (land_masks,
                                                        thermo_driver, winds)
from tropical_cyclone_risk_tpu_torch.utils import synthetic_era5

NLAT, NLON = 19, 36
# the survivor tolerances of tests/test_torch_pipeline.py: XLA on the CPU
# contracts multiply-adds and rounds transcendentals otherwise than torch,
# and 361 RK4 steps grow those seeds
TRACK_TOL = {'lon_trks': 1e-3, 'lat_trks': 1e-3, 'v_trks': 1e-2,
             'm_trks': 1e-3, 'vmax_trks': 1e-2, 'u250_trks': 1e-2,
             'v250_trks': 1e-2, 'u850_trks': 1e-2, 'v850_trks': 1e-2}


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    """The raw workspace, its namelist, and the port's preprocessing
    outputs (land masks, wind statistics, thermo) run on the CPU."""
    root = tmp_path_factory.mktemp('ws')
    nl = synthetic_era5.make_workspace(str(root), 2016, 2016, NLAT, NLON,
                                       seed_batch=1024, tracks_per_year=4)
    cfg = config.load_namelist_py(nl)
    land_masks.generate_land_masks(cfg.fn_land, cfg.mask_dir)
    cli.compute_downscaling_inputs(cfg, device='cpu')
    return root, nl, cfg


def _fields(ds):
    return {k: (v.dims, np.asarray(v.data), v.attrs)
            for k, v in ds.variables.items()}


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_netcdf_files_read_back_in_both_packages(tmp_path, writer):
    """A file written by either package's writer reads back identically in
    both readers: dims, values (exact), strings and attributes."""
    write = (netcdf if writer == 'port' else jnetcdf).write
    rng = np.random.default_rng(0)
    data = {'a': (('time', 'lat'), rng.standard_normal((3, 4))
                  .astype(np.float32)),
            'b': (('time',), np.arange(3, dtype=np.int64)),
            'c': (('lat',), np.array(['NA', 'EP', 'WP', 'SI']))}
    fn = str(tmp_path / 'x.nc')
    write(fn, data, coords={'time': np.arange(3.0), 'lat': np.linspace(0, 1, 4)},
          attrs={'source': 'test'}, var_attrs={'time': {'units': 'days'}})
    got = [netcdf.read(fn), jnetcdf.read(fn)]
    assert got[0].attrs == got[1].attrs == {'source': 'test'}
    f0, f1 = _fields(got[0]), _fields(got[1])
    assert f0.keys() == f1.keys() == {'a', 'b', 'c', 'time', 'lat'}
    for k in f0:
        assert f0[k][0] == f1[k][0], k
        np.testing.assert_array_equal(f0[k][1], f1[k][1], err_msg=k)
        assert f0[k][2].keys() == f1[k][2].keys(), k
    np.testing.assert_array_equal(f0['a'][1], data['a'][1])
    assert f0['time'][2]['units'] == 'days'


def test_namelists_agree_field_for_field(ws):
    """Namelist() and load_namelist_py agree with the JAX package's, field
    for field (names, order, values)."""
    _, nl, _ = ws
    names = [f.name for f in dataclasses.fields(config.Namelist)]
    assert names == [f.name for f in dataclasses.fields(jconfig.Namelist)]
    for ours, theirs in ((config.Namelist(), jconfig.Namelist()),
                         (config.load_namelist_py(nl),
                          jconfig.load_namelist_py(nl))):
        for n in names:
            assert getattr(ours, n) == getattr(theirs, n), n
        assert ours.var_keys == theirs.var_keys
        assert ours.basin_ids_sorted() == theirs.basin_ids_sorted()


def test_gen_thermo_matches_jax(ws, tmp_path):
    """The port's thermo file (its own entropy table, on the CPU) against
    the JAX package's from the same raw files: coords and times equal; vmax
    within 2e-2 m/s (the tables differ by <= 2e-4 K and XLA's libm and
    multiply-add contraction differ from torch's; a column at a threshold
    may move a level's contribution); chi within 2e-3 (a quotient of
    entropy differences) and rh_mid within 1e-5."""
    _, _, cfg = ws
    jcfg = jconfig.load_namelist_py(ws[1]).replace(
        output_directory=str(tmp_path))
    fn_j = jthermo.gen_thermo(jcfg)
    got = thermo_driver.read_thermo(thermo_driver.get_fn_thermo(cfg))
    want = jthermo.read_thermo(fn_j)
    for a, b in zip(got[3:5], want[3:5]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[5], want[5])
    assert got[0].shape == (12, NLAT, NLON)
    assert want[0].max() > 40.0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-2)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize('basin', ['GL', 'WP'])
def test_build_field_pack_matches_jax(ws, basin):
    """build_field_pack against the JAX builder on the same files, every
    FieldPack field, for GL and for a regional basin (crop_pack): grids
    equal, masks and land/bathy exact, wind and env within 1e-5 relative
    (the mld/strat climatologies go through a float32 bilinear regrid in
    each package)."""
    _, _, cfg = ws
    jcfg = jconfig.load_namelist_py(ws[1])
    ours = pack_builder.build_field_pack(cfg, basin, device='cpu')
    theirs = jpack_builder.build_field_pack(jcfg, basin)
    assert ours.wind.device.type == 'cpu'
    assert ours._fields == theirs._fields
    for name in ours._fields:
        a, b = getattr(ours, name), getattr(theirs, name)
        if name.endswith('grid'):
            assert tuple(a) == tuple(b), name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    if basin != 'GL':
        assert ours.grid.nlon < NLON


@pytest.mark.parametrize('layout', ['fused', 'separate'])
def test_geo_grids_pack_matches_jax(ws, tmp_path, layout):
    """The workspace writer's static files with land on its own grid (5
    degrees here, the wind grid being 10), and either no bathymetry (the
    proxy then lies on the land grid: the fused layout) or bathymetry on a
    2.5-degree grid (the separate layout): build_field_pack gives a pack
    whose land and bathymetry keep those grids, so build_stacks leaves
    them out of the cell row, and equals the JAX builder's on the same
    files (tolerances of test_build_field_pack_matches_jax)."""
    from tropical_cyclone_risk_tpu.models import fields as jfields
    from tropical_cyclone_risk_tpu_torch.models import fields
    root, nl, cfg = ws
    lon, lat = synthetic_era5.axes(NLAT, NLON)
    bathy_res = 2.5 if layout == 'separate' else None
    synthetic_era5.write_static(str(tmp_path), lon, lat, land_res=5.0,
                                bathy_res=bathy_res)
    files = dict(fn_land=str(tmp_path / 'static' / 'land.nc'),
                 fn_bathy=str(tmp_path / 'static' / 'bathymetry.nc'))
    assert os.path.exists(files['fn_bathy']) == (layout == 'separate')
    ours = pack_builder.build_field_pack(cfg.replace(**files), 'GL',
                                         device='cpu')
    theirs = jpack_builder.build_field_pack(
        jconfig.load_namelist_py(nl).replace(**files), 'GL')
    for name in ours._fields:
        a, b = getattr(ours, name), getattr(theirs, name)
        if name.endswith('grid'):
            assert tuple(a) == tuple(b), name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert (ours.land_grid.nlat, ours.land_grid.nlon) == (37, 72)
    want_bathy = (73, 144) if layout == 'separate' else (37, 72)
    assert (ours.bathy_grid.nlat, ours.bathy_grid.nlon) == want_bathy
    stacks, jstacks = fields.build_stacks(ours), jfields.build_stacks(theirs)
    assert not stacks.geo_in_cell and not jstacks.geo_in_cell
    assert stacks.fused_geo == jstacks.fused_geo == (layout == 'fused')
    bathy = ours.bathy.numpy()
    assert (bathy == 100.0).any() and (bathy == -4500.0).any()
    assert ((bathy == -30.0).any()) == (layout == 'separate')


def test_cli_matches_jax_seed_by_seed(ws, tmp_path):
    """cli.main(..., '--device', 'cpu') against the JAX cli.main, both from
    the same thermo, wind-stat and mask files: the same track count,
    months, basins, years and seeds_per_month, and every track within the
    survivor tolerances of tests/test_torch_pipeline.py (TRACK_TOL)."""
    root, nl, cfg = ws
    kernels.reset_counts()
    assert cli.main(['GL', '--namelist', nl, '--seed', '3', '--device',
                     'cpu']) == 0
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    # the JAX run: a copy of the workspace whose outputs hold the port's
    # preprocessing files, so both simulate from the same inputs
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
    ours = netcdf.read(os.path.join(cfg.output_directory, cfg.exp_name, fn))
    theirs = jnetcdf.read(str(jroot / 'out' / cfg.exp_name / fn))
    assert set(ours.variables) == set(theirs.variables)
    n = ours['lon_trks'].data.shape[0]
    assert n == theirs['lon_trks'].data.shape[0] == cfg.tracks_per_year
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


def test_cli_refuses_to_fall_back_to_the_cpu(ws, monkeypatch):
    """Without a GPU, the CLI raises unless --device cpu asks for the CPU,
    with --devices too; --devices 2 --device cpu shards every launch over
    two virtual CPU shards and writes the year's tracks."""
    _, nl, cfg = ws
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        cli.main(['GL', '--namelist', nl, '--seed', '0'])
    with pytest.raises(RuntimeError, match='--device cpu'):
        cli.main(['GL', '--namelist', nl, '--devices', '2'])
    seen = []
    orig = runtime.run_downscaling
    monkeypatch.setattr(runtime, 'run_downscaling', lambda *a, **k: (
        seen.append(k['mesh']), orig(*a, **k))[1])
    kernels.reset_counts()
    assert cli.main(['GL', '--namelist', nl, '--devices', '2', '--device',
                     'cpu', '--seed', '0']) == 0
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    (mesh,) = seen
    assert mesh.size == 2 and {d.type for d in mesh.devices} == {'cpu'}
    out = os.path.join(cfg.output_directory, cfg.exp_name)
    fn = max((os.path.join(out, f) for f in os.listdir(out)
              if f.endswith('.nc')), key=os.path.getmtime)
    lon = netcdf.read(fn)['lon_trks'].data
    assert lon.shape[0] == cfg.tracks_per_year
    assert np.isfinite(lon[:, 0]).all()


def test_entry_points_default_to_the_gpu():
    """Public constructors and entry points take device='cuda' unless the
    caller asks for the CPU."""
    import inspect
    from tropical_cyclone_risk_tpu_torch.models import fields
    for fn in (fields.pack_from_numpy, fields.synthetic_pack,
               pack_builder.build_field_pack, thermo_driver.gen_thermo,
               cli.compute_downscaling_inputs):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
