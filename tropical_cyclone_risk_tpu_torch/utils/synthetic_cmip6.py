"""A synthetic CMIP6-shaped (GFDL-CM4 ssp585-style) raw workspace, made
from a seed, for GCM-forced end-to-end runs of the CLI without downloaded
data (the port's copy of the JAX package's tools/make_synthetic_cmip6.py,
on the port's NetCDF writer).

    python -m tropical_cyclone_risk_tpu_torch.utils.synthetic_cmip6 WS \
        [Y0 [Y1]] [--coarse] [--plev8] [--seed-batch N]

writes WS/raw, WS/static and WS/namelist.py (dataset_type = 'GCM'), which
``python -m tropical_cyclone_risk_tpu_torch.cli GL --namelist
WS/namelist.py`` reads.  The files follow the real ESGF downloads'
conventions (scripts/download_cmip6.py): the noleap calendar, plev in Pa,
Amon ta/hus on six levels and psl, Omon tos in degC (NaN over land) on an
ocean grid twice as fine, and daily ua/va, named
{var}_{table}_GFDL-CM4_ssp585_r1i1p1f1_gr1_{Y}0101-{Y}1231.nc.  The daily
winds are on day_levels (Pa): 250 and 850 hPa by default, where the files
equal the JAX tool's array for array at the same seed, years and grid;
PLEV8 is CMIP6's plev8 (the `day` table's levels).  A namelist that steers
at other levels than the default names them, with their coefficients
(steering_levels, steering_coefs, y_alpha, m_alpha, alpha_max, alpha_min),
each among the daily levels.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tropical_cyclone_risk_tpu_torch.io import netcdf

PLEV_AMON = np.array([100000.0, 85000.0, 60000.0, 40000.0, 25000.0,
                      10000.0])
PLEV_DAY = (25000.0, 85000.0)
# CMIP6 plev8 (Pa, descending as the files have it)
PLEV8 = (100000.0, 85000.0, 70000.0, 50000.0, 25000.0, 10000.0, 5000.0,
         1000.0)
TAG = 'GFDL-CM4_ssp585_r1i1p1f1_gr1'


def grids(coarse: bool):
    """(lon, lat) of the atmosphere: 1 degree, or 4 with coarse."""
    step = 4.0 if coarse else 1.0
    return (np.arange(0.0, 360.0, step),
            np.arange(-90.0, 90.0 + step / 2, step))


def land_2d(lon, lat) -> np.ndarray:
    """Polar caps and two idealized continents."""
    LO, LA = np.meshgrid(lon, lat)
    return ((np.abs(LA) > 70) | ((LO > 265) & (LO < 310) & (LA > -55) &
                                 (LA < 60)) |
            ((LO > 10) & (LO < 50) & (LA > -35) & (LA < 35))
            ).astype(np.float32)


def noleap_midmonths(year: int, epoch_year: int) -> np.ndarray:
    """Mid-month day offsets (noleap) from Jan 1 of epoch_year."""
    days = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    cum = np.concatenate([[0], np.cumsum(days)[:-1]])
    return (year - epoch_year) * 365.0 + cum + 14.0


def jet_u(p_pa: float, LA) -> np.ndarray:
    """The daily ua's jet at p_pa: -8 + 20 sin^2(lat) m/s at 250 hPa,
    -5 + 6 sin^2(lat) at 850 hPa, linear in pressure between (and beyond)
    them."""
    f = (p_pa - 25000.0) / 60000.0
    return (-8.0 + 3.0 * f) + (20.0 - 14.0 * f) * np.sin(np.deg2rad(LA)) ** 2


def write_year(base: str, year: int, rng, lon, lat, epoch_year: int,
               day_levels=PLEV_DAY) -> None:
    """One year of raw files: Omon tos, Amon psl/ta/hus and day ua/va."""
    from scipy.interpolate import RegularGridInterpolator
    nlat, nlon = lat.size, lon.size
    LA = lat[:, None] + 0 * lon[None, :]
    tattrs = {'units': f'days since {epoch_year}-01-01',
              'calendar': 'noleap'}
    t_mon = noleap_midmonths(year, epoch_year)
    span = f'{year}0101-{year}1231'

    seasonal = np.cos(2 * np.pi * (np.arange(12)[:, None, None] - 7.5) / 12)
    warm = 0.015 * (year - 2030)
    sst_c = (29.0 + warm - 30.0 * (LA / 90.0) ** 2 + 1.5 * seasonal
             + 0.3 * rng.standard_normal((12, nlat, nlon))).astype(np.float32)
    # tos on the finer ocean grid (degC, NaN over land)
    olon = np.arange(0.0, 360.0, 360.0 / (2 * nlon))
    olat = np.linspace(lat[0], lat[-1], 2 * nlat - 1)
    tos = np.empty((12, olat.size, olon.size), np.float32)
    pts = np.stack(np.meshgrid(olat, np.minimum(olon, lon.max()),
                               indexing='ij'), -1)
    for i in range(12):
        f = RegularGridInterpolator((lat, lon), sst_c[i], bounds_error=False,
                                    fill_value=None)
        tos[i] = f(pts.reshape(-1, 2)).reshape(olat.size, olon.size)
    tos = np.where(land_2d(olon, olat)[None] > 0, np.nan, tos)
    netcdf.write(f'{base}/tos_Omon_{TAG}_{span}.nc',
                 {'tos': (('time', 'lat', 'lon'), tos)},
                 coords={'time': t_mon, 'lat': olat, 'lon': olon},
                 var_attrs={'time': tattrs, 'tos': {'units': 'degC'}})

    psl = np.full((12, nlat, nlon), 101000.0, np.float32)
    netcdf.write(f'{base}/psl_Amon_{TAG}_{span}.nc',
                 {'psl': (('time', 'lat', 'lon'), psl)},
                 coords={'time': t_mon, 'lat': lat, 'lon': lon},
                 var_attrs={'time': tattrs, 'psl': {'units': 'Pa'}})

    t_sfc = np.nan_to_num((sst_c + 273.15 - 1.0).astype(np.float32),
                          nan=285.0)
    ta = np.zeros((12, PLEV_AMON.size, nlat, nlon), np.float32)
    hus = np.zeros_like(ta)
    for li, p in enumerate(PLEV_AMON):
        ta[:, li] = t_sfc * (p / 101000.0) ** 0.19
        hus[:, li] = (0.016 * np.exp(-(101000.0 - p) / 25000.0)
                      * np.clip((t_sfc - 260.0) / 40.0, 0.05, 1.2))
    for nm, arr in (('ta', ta), ('hus', hus)):
        netcdf.write(f'{base}/{nm}_Amon_{TAG}_{span}.nc',
                     {nm: (('time', 'plev', 'lat', 'lon'), arr)},
                     coords={'time': t_mon, 'plev': PLEV_AMON,
                             'lat': lat, 'lon': lon},
                     var_attrs={'time': tattrs, 'plev': {'units': 'Pa'}})

    # daily winds (noleap: 365 days): jets, a seasonal cycle and AR(1)
    # synoptic noise, one draw of every level a day
    nt = 365
    t_day = (year - epoch_year) * 365.0 + np.arange(nt) + 0.5
    plev = np.asarray(day_levels, np.float64)
    shape = (plev.size, nlat, nlon)
    base_of = {'ua': np.stack([jet_u(p, LA) for p in plev]),
               'va': np.zeros(shape)}
    for nm in ('ua', 'va'):
        arr = np.empty((nt,) + shape, np.float32)
        noise = rng.standard_normal(shape).astype(np.float32) * 3
        for it in range(nt):
            season = np.cos(2 * np.pi * (it / 365.0 - 0.6))
            noise = 0.9 * noise + 0.44 * rng.standard_normal(shape).astype(
                np.float32) * 3
            arr[it] = base_of[nm] + 2.0 * season + noise
        netcdf.write(f'{base}/{nm}_day_{TAG}_{span}.nc',
                     {nm: (('time', 'plev', 'lat', 'lon'), arr)},
                     coords={'time': t_day, 'plev': plev,
                             'lat': lat, 'lon': lon},
                     var_attrs={'time': tattrs, 'plev': {'units': 'Pa'}})


def write_static(ws: str, lon, lat) -> None:
    """Land fraction and the monthly MLD / stratification climatologies on
    the atmosphere grid (no bathymetry file: the pack builder puts its
    land-derived proxy there)."""
    land = land_2d(lon, lat)
    os.makedirs(f'{ws}/static', exist_ok=True)
    netcdf.write(f'{ws}/static/land.nc', {'land': (('lat', 'lon'), land)},
                 coords={'lat': lat, 'lon': lon})
    nlat, nlon = lat.size, lon.size
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


def build(ws: str, y0: int = 2030, y1: int = 2031, coarse: bool = False,
          seed: int = 0, day_levels=PLEV_DAY, tracks_per_year: int = 14,
          seed_batch: int = 16384) -> str:
    """Write the workspace and its namelist (random fields from seed);
    returns the namelist's path.  day_levels: the daily winds' pressure
    levels in Pa."""
    lon, lat = grids(coarse)
    os.makedirs(f'{ws}/raw', exist_ok=True)
    os.makedirs(f'{ws}/out', exist_ok=True)
    rng = np.random.default_rng(seed)
    write_static(ws, lon, lat)
    for year in range(y0, y1 + 1):
        write_year(f'{ws}/raw', year, rng, lon, lat, y0, tuple(day_levels))
    path = f'{ws}/namelist.py'
    with open(path, 'w') as f:
        f.write(f"""
base_directory = {ws + '/raw'!r}
output_directory = {ws + '/out'!r}
exp_name = 'proj'
exp_prefix = 'ssp585'
dataset_type = 'GCM'
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
    ap.add_argument('y0', type=int, nargs='?', default=2030)
    ap.add_argument('y1', type=int, nargs='?', default=None)
    ap.add_argument('--coarse', action='store_true',
                    help='a 4-degree atmosphere grid (default: 1 degree)')
    ap.add_argument('--seed-batch', type=int, default=16384)
    ap.add_argument('--plev8', action='store_true',
                    help="the daily winds on CMIP6's plev8 (default: 250 "
                         "and 850 hPa)")
    a = ap.parse_args(argv)
    y1 = a.y1 if a.y1 is not None else a.y0 + 1
    print(build(a.ws, a.y0, y1, a.coarse,
                day_levels=PLEV8 if a.plev8 else PLEV_DAY,
                seed_batch=a.seed_batch))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
