"""ERA5 data acquisition via the Copernicus CDS API (copy of
tropical_cyclone_risk_tpu/scripts/download_era5.py).

Reference equivalent: scripts/download_era5.py -- six requests per year
(monthly SST / surface pressure / T / q at 1 degree on 28 levels; daily
250/850 hPa u, v at 00Z and 12Z) over a process pool.  The request bodies
are built (and testable) without the client; ``download_year`` raises a
clear error where the cdsapi package is not installed, and fetching needs
the network.
"""

from __future__ import annotations

import concurrent.futures as _fut
import os
from typing import Dict, List, Tuple

from tropical_cyclone_risk_tpu_torch.config import Namelist

PRESSURE_LEVELS_28 = [
    '10', '20', '30', '50', '70', '100', '125', '150', '175', '200', '225',
    '250', '300', '350', '400', '450', '500', '550', '600', '650', '700',
    '750', '775', '800', '825', '850', '875', '900', '925', '950', '975',
    '1000'][-28:]
ALL_MONTHS = ['%02d' % m for m in range(1, 13)]
ALL_DAYS = ['%02d' % d for d in range(1, 32)]


def monthly_single_level_request(var: str, year: int) -> Dict:
    """Monthly-mean single-level field at 1 degree (reference request shape,
    scripts/download_era5.py:36-75)."""
    return {
        'product_type': 'monthly_averaged_reanalysis',
        'variable': var,
        'year': str(year),
        'month': ALL_MONTHS,
        'time': '00:00',
        'grid': [1.0, 1.0],
        'format': 'netcdf',
    }


def monthly_pressure_request(var: str, year: int) -> Dict:
    """Monthly-mean pressure-level field (T or q) on 28 levels."""
    req = monthly_single_level_request(var, year)
    req['pressure_level'] = PRESSURE_LEVELS_28
    return req


def daily_wind_request(var: str, year: int) -> Dict:
    """Twice-daily 250/850 hPa wind component (reference request shape,
    scripts/download_era5.py:111-158)."""
    return {
        'product_type': 'reanalysis',
        'variable': var,
        'pressure_level': ['250', '850'],
        'year': str(year),
        'month': ALL_MONTHS,
        'day': ALL_DAYS,
        'time': ['00:00', '12:00'],
        'grid': [1.0, 1.0],
        'format': 'netcdf',
    }


def year_requests(year: int) -> List[Tuple[str, str, Dict]]:
    """The six (dataset, out_name, request) tuples of one year."""
    return [
        ('reanalysis-era5-single-levels-monthly-means',
         f'era5_sst_{year}.nc',
         monthly_single_level_request('sea_surface_temperature', year)),
        ('reanalysis-era5-single-levels-monthly-means',
         f'era5_sp_{year}.nc',
         monthly_single_level_request('surface_pressure', year)),
        ('reanalysis-era5-pressure-levels-monthly-means',
         f'era5_t_{year}.nc', monthly_pressure_request('temperature', year)),
        ('reanalysis-era5-pressure-levels-monthly-means',
         f'era5_q_{year}.nc',
         monthly_pressure_request('specific_humidity', year)),
        ('reanalysis-era5-pressure-levels', f'era5_u_daily_{year}.nc',
         daily_wind_request('u_component_of_wind', year)),
        ('reanalysis-era5-pressure-levels', f'era5_v_daily_{year}.nc',
         daily_wind_request('v_component_of_wind', year)),
    ]


def download_year(cfg: Namelist, year: int, retries: int = 3) -> List[str]:
    """Download all six files for one year (idempotent; reference retry
    loop, scripts/download_era5.py:25-32)."""
    try:
        import cdsapi
    except ImportError as e:
        raise RuntimeError(
            'cdsapi is required for ERA5 downloads (pip install cdsapi and '
            'configure ~/.cdsapirc); alternatively place pre-downloaded '
            f'files under {cfg.base_directory}') from e
    client = cdsapi.Client()
    out = []
    os.makedirs(cfg.base_directory, exist_ok=True)
    for dataset, name, req in year_requests(year):
        path = os.path.join(cfg.base_directory, name)
        out.append(path)
        if os.path.exists(path):
            continue
        for attempt in range(retries):
            try:
                client.retrieve(dataset, req, path)
                break
            except Exception:
                if attempt == retries - 1:
                    raise
    return out


def download_all(cfg: Namelist, max_workers: int = 6) -> List[str]:
    """All configured years concurrently (reference Pool(6),
    scripts/download_era5.py:168-171)."""
    with _fut.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = [ex.submit(download_year, cfg, y) for y in cfg.years()]
        return [p for f in futs for p in f.result()]
