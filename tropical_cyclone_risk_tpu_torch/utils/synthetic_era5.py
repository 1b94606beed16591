"""A synthetic ERA5-shaped raw workspace, made from a seed, for end-to-end
runs of the CLI without downloaded data (after tools/make_synthetic_era5.py
of the JAX package, on the 28 pressure levels of the real ERA5 request,
scripts/download_era5.py:20-22).

    python -m tropical_cyclone_risk_tpu_torch.utils.synthetic_era5 WS \
        [Y0 [Y1]] [--nlat 181 --nlon 360 --seed-batch N]

writes WS/raw (monthly sst/sp/t/q and twice-daily 250/850 hPa u/v per
year), WS/static (land, mld, strat) and WS/namelist.py, which
``python -m tropical_cyclone_risk_tpu_torch.cli GL --namelist
WS/namelist.py`` reads.
"""

from __future__ import annotations

import argparse
import calendar
import os
import numpy as np

from tropical_cyclone_risk_tpu_torch.io import netcdf

# the 28 pressure levels of the ERA5 request (hPa, ascending as ERA5 has
# them; the thermo driver puts the surface first)
LEVELS_HPA = np.array([70, 100, 125, 150, 175, 200, 225, 250, 300, 350, 400,
                       450, 500, 550, 600, 650, 700, 750, 775, 800, 825,
                       850, 875, 900, 925, 950, 975, 1000], np.float64)
_T_UNITS = {'units': 'hours since 1900-01-01 00:00:00.0'}


def axes(nlat: int, nlon: int):
    """(lon, lat): 0-360 longitudes and pole-to-pole latitudes."""
    return (np.arange(nlon) * (360.0 / nlon), np.linspace(-90.0, 90.0, nlat))


def land_2d(lon, lat) -> np.ndarray:
    """Polar caps and two idealized continents."""
    LO, LA = np.meshgrid(lon, lat)
    return ((np.abs(LA) > 70) | ((LO > 265) & (LO < 310) & (LA > -55) &
                                 (LA < 60)) |
            ((LO > 10) & (LO < 50) & (LA > -35) & (LA < 35))
            ).astype(np.float32)


def _hours(t: np.ndarray) -> np.ndarray:
    return (t - np.datetime64('1900-01-01', 's')) / np.timedelta64(1, 'h')


def write_year(base: str, year: int, lon, lat, rng) -> None:
    """One year of raw files: monthly sst/sp/t/q on LEVELS_HPA and
    twice-daily u/v at 250 and 850 hPa."""
    nlat, nlon = lat.size, lon.size
    land = land_2d(lon, lat)
    LA = lat[:, None] + 0 * lon[None, :]
    t_num = _hours(np.array([np.datetime64(f'{year}-{m:02d}-01', 's')
                             for m in range(1, 13)]))
    coords = {'time': t_num, 'latitude': lat, 'longitude': lon}

    seasonal = np.cos(2 * np.pi * (np.arange(12)[:, None, None] - 7.5) / 12)
    sst = (302.0 + 0.015 * (year - 2000) - 30.0 * (LA / 90.0) ** 2
           + 1.5 * seasonal + 0.3 * rng.standard_normal((12, nlat, nlon))
           ).astype(np.float32)
    sst = np.where(land[None] > 0, np.float32(np.nan), sst)
    netcdf.write(f'{base}/era5_sst_{year}.nc',
                 {'sst': (('time', 'latitude', 'longitude'), sst)},
                 coords=coords, var_attrs={'time': _T_UNITS,
                                           'sst': {'units': 'K'}})
    netcdf.write(f'{base}/era5_sp_{year}.nc',
                 {'sp': (('time', 'latitude', 'longitude'),
                         np.full((12, nlat, nlon), 101000.0, np.float32))},
                 coords=coords, var_attrs={'time': _T_UNITS})
    p = LEVELS_HPA * 100.0
    t_sfc = np.nan_to_num(sst, nan=285.0) - 1.0
    shape = (12, p.size, nlat, nlon)
    T = (t_sfc[:, None] * ((p / 101000.0) ** 0.19)[None, :, None, None]
         ).astype(np.float32).reshape(shape)
    q = (0.016 * np.exp(-(101000.0 - p) / 25000.0)[None, :, None, None]
         * np.clip((t_sfc[:, None] - 260.0) / 40.0, 0.05, 1.2)
         ).astype(np.float32).reshape(shape)
    for nm, arr in (('t', T), ('q', q)):
        netcdf.write(f'{base}/era5_{nm}_{year}.nc',
                     {nm: (('time', 'level', 'latitude', 'longitude'), arr)},
                     coords={'time': t_num, 'level': LEVELS_HPA,
                             'latitude': lat, 'longitude': lon},
                     var_attrs={'time': _T_UNITS,
                                'level': {'units': 'millibars'}})

    # twice-daily winds: jets, a seasonal cycle and AR(1) synoptic noise
    t_w = (np.datetime64(f'{year}-01-01', 's') + np.arange(
        2 * (366 if calendar.isleap(year) else 365)) * np.timedelta64(12, 'h'))
    season = np.cos(2 * np.pi * ((t_w - np.datetime64(f'{year}-01-01', 's'))
                                 / np.timedelta64(1, 'D') / 365.0 - 0.6))
    jets = {'u': np.stack([-8.0 + 20.0 * np.sin(np.deg2rad(LA)) ** 2,
                           -5.0 + 6.0 * np.sin(np.deg2rad(LA)) ** 2]),
            'v': np.zeros((2, nlat, nlon))}
    for nm in ('u', 'v'):
        arr = np.zeros((t_w.size, 2, nlat, nlon), np.float32)
        noise = rng.standard_normal((2, nlat, nlon)).astype(np.float32) * 3
        for it in range(t_w.size):
            noise = 0.9 * noise + 0.44 * rng.standard_normal(
                (2, nlat, nlon)).astype(np.float32) * 3
            arr[it] = jets[nm] + 2.0 * season[it] + noise
        netcdf.write(f'{base}/era5_{nm}_daily_{year}.nc',
                     {nm: (('time', 'level', 'latitude', 'longitude'), arr)},
                     coords={'time': _hours(t_w),
                             'level': np.array([250.0, 850.0]),
                             'latitude': lat, 'longitude': lon},
                     var_attrs={'time': _T_UNITS,
                                'level': {'units': 'millibars'}})


def write_static(ws: str, lon, lat) -> None:
    """Land fraction and the monthly MLD / stratification climatologies."""
    land = land_2d(lon, lat)
    nlat, nlon = lat.size, lon.size
    os.makedirs(f'{ws}/static', exist_ok=True)
    netcdf.write(f'{ws}/static/land.nc', {'land': (('lat', 'lon'), land)},
                 coords={'lat': lat, 'lon': lon})
    mld = np.where(land[:, :, None] > 0, np.nan,
                   40.0 + 20.0 * np.cos(np.deg2rad(lat))[:, None, None]
                   * np.ones((nlat, nlon, 12))).astype(np.float32)
    strat = np.where(land[:, :, None] > 0, np.nan,
                     np.full((nlat, nlon, 12), 5.0)).astype(np.float32)
    month = np.arange(1.0, 13.0)
    for nm, arr in (('mld', mld), ('strat', strat)):
        netcdf.write(f'{ws}/static/{nm}.nc',
                     {nm: (('lat', 'lon', 'month'), arr)},
                     coords={'lat': lat, 'lon': lon, 'month': month})


def make_workspace(ws: str, y0: int = 2016, y1: int = 2016, nlat: int = 181,
                   nlon: int = 360, tracks_per_year: int = 20,
                   seed_batch: int = 16384) -> str:
    """Write the workspace and its namelist (random fields from seed 0);
    returns the namelist's path."""
    os.makedirs(f'{ws}/raw', exist_ok=True)
    os.makedirs(f'{ws}/out', exist_ok=True)
    lon, lat = axes(nlat, nlon)
    rng = np.random.default_rng(0)
    write_static(ws, lon, lat)
    for year in range(y0, y1 + 1):
        write_year(f'{ws}/raw', year, lon, lat, rng)
    path = f'{ws}/namelist.py'
    with open(path, 'w') as f:
        f.write(f"""
base_directory = {ws + '/raw'!r}
output_directory = {ws + '/out'!r}
exp_name = 'prod'
exp_prefix = 'era5'
dataset_type = 'ERA5'
start_year = {y0}
start_month = 1
end_year = {y1}
end_month = 12
tracks_per_year = {tracks_per_year}
fn_land = {ws + '/static/land.nc'!r}
fn_bathy = {ws + '/static/bathymetry.nc'!r}
fn_mld = {ws + '/static/mld.nc'!r}
fn_strat = {ws + '/static/strat.nc'!r}
mask_dir = {ws + '/land'!r}
seed_batch = {seed_batch}
""")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('ws')
    ap.add_argument('y0', type=int, nargs='?', default=2016)
    ap.add_argument('y1', type=int, nargs='?', default=None)
    ap.add_argument('--nlat', type=int, default=181)
    ap.add_argument('--nlon', type=int, default=360)
    ap.add_argument('--seed-batch', type=int, default=16384)
    a = ap.parse_args(argv)
    print(make_workspace(a.ws, a.y0, a.y1 if a.y1 is not None else a.y0,
                         a.nlat, a.nlon, seed_batch=a.seed_batch))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
