"""Dataset discovery, loading, and calendar handling for ERA5 / CMIP6 inputs
(copy of tropical_cyclone_risk_tpu/io/input.py).

Reference equivalent: util/input.py (recursive glob by variable prefix,
multifile time concatenation, namelist-driven variable-key mapping, calendar
conversion between np.datetime64 and cftime no-leap).  Loading goes through
io.netcdf, and the no-leap calendar arithmetic is implemented directly
(month bucketing is all the pipeline needs from the calendar).
"""

from __future__ import annotations

import calendar as _cal
import datetime
import glob
import os
import re
from typing import List, Sequence, Tuple

import numpy as np

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import netcdf

# ---------------------------------------------------------------- discovery

def glob_prefix(cfg: Namelist, var_prefix: str) -> List[str]:
    """Recursive '*{exp_prefix}*.nc' glob filtered to '_{var}_' basenames
    (util/input.py:23-28; the reference filters the FULL path, so a data
    directory whose name happens to contain '_{var}_' matches every file —
    basename filtering here, reference bug not replicated)."""
    fns = glob.glob('%s/**/*%s*.nc' % (cfg.base_directory, cfg.exp_prefix),
                    recursive=True)
    base = {x: os.path.basename(x) for x in fns}
    fns_var = sorted(x for x in fns if '_%s_' % var_prefix in base[x])
    if not fns_var:
        fns_var = sorted(x for x in fns if '%s_' % var_prefix in base[x])
    return fns_var


def var_key(cfg: Namelist, name: str) -> str:
    """Dataset-type-driven variable key (util/input.py:60-88)."""
    return cfg.var_keys[cfg.dataset_type][name]


# ---------------------------------------------------------------- calendar

_UNITS_RE = re.compile(
    r'^\s*(seconds|minutes|hours|days)\s+since\s+'
    r'(\d{1,4})-(\d{1,2})-(\d{1,2})[\sT]?(\d{1,2})?:?(\d{1,2})?')

_UNIT_SECONDS = {'seconds': 1, 'minutes': 60, 'hours': 3600, 'days': 86400}
_NOLEAP_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
_NOLEAP_CUM = np.concatenate([[0], np.cumsum(_NOLEAP_DAYS)])


def decode_time(values: np.ndarray, units: str, cal: str = 'standard'
                ) -> np.ndarray:
    """CF numeric time -> np.datetime64[s].

    Standard/gregorian calendars use datetime64 arithmetic; noleap/365_day
    (CMIP6 GFDL-CM4, util/input.py:111-133) is decomposed manually and
    re-expressed as the same (year, month, day, time-of-day) in datetime64 —
    the pipeline only ever buckets by calendar month, so identifying a
    no-leap date with its proleptic-Gregorian namesake is lossless here.
    """
    m = _UNITS_RE.match(units)
    if not m:
        raise ValueError(f'unsupported time units: {units!r}')
    unit, y0, mo0, d0, h0, mi0 = (m.group(1), int(m.group(2)), int(m.group(3)),
                                  int(m.group(4)), int(m.group(5) or 0),
                                  int(m.group(6) or 0))
    vals = np.asarray(values, np.float64) * _UNIT_SECONDS[unit]
    cal = (cal or 'standard').lower()
    if cal in ('standard', 'gregorian', 'proleptic_gregorian', ''):
        epoch = np.datetime64(
            f'{y0:04d}-{mo0:02d}-{d0:02d}T{h0:02d}:{mi0:02d}', 's')
        return epoch + vals.astype('timedelta64[s]')
    if cal in ('noleap', '365_day'):
        # seconds from the epoch date in a 365-day calendar
        base = ((y0 * 365 + int(_NOLEAP_CUM[mo0 - 1]) + (d0 - 1)) * 86400
                + h0 * 3600 + mi0 * 60)
        tot = (vals + base).astype(np.int64)
        days = tot // 86400
        secs = tot - days * 86400
        year = days // 365
        doy = days - year * 365
        month = np.searchsorted(_NOLEAP_CUM, doy, side='right')
        dom = doy - _NOLEAP_CUM[month - 1] + 1
        # vectorized (year, month, day, sec) -> datetime64[s]: daily axes of
        # multi-decade CMIP6 files are ~16k timestamps, so no Python loop
        y64 = (year - 1970).astype('timedelta64[Y]') + np.datetime64('1970',
                                                                     'Y')
        m64 = y64.astype('datetime64[M]') + (month - 1).astype(
            'timedelta64[M]')
        d64 = m64.astype('datetime64[D]') + (dom - 1).astype('timedelta64[D]')
        return (d64.astype('datetime64[s]')
                + secs.astype('timedelta64[s]')).reshape(vals.shape)
    raise ValueError(f'unsupported calendar: {cal!r}')


def encode_time_days(times: Sequence[np.datetime64],
                     epoch: str = '1900-01-01') -> Tuple[np.ndarray, str]:
    """datetime64 -> CF 'days since epoch' float64 for classic NetCDF output."""
    t = np.asarray(times, 'datetime64[s]')
    e = np.datetime64(epoch, 's')
    return ((t - e) / np.timedelta64(1, 'D')).astype(np.float64), \
        f'days since {epoch}'


def times_of(ds: netcdf.Dataset, time_name: str = 'time') -> np.ndarray:
    v = ds[time_name]
    return decode_time(v.data, v.attrs.get('units', ''),
                       v.attrs.get('calendar', 'standard'))


def month_of(times: np.ndarray) -> np.ndarray:
    return times.astype('datetime64[M]').astype(int) % 12 + 1


def year_of(times: np.ndarray) -> np.ndarray:
    return times.astype('datetime64[Y]').astype(int) + 1970


def bounding_times(cfg: Namelist) -> Tuple[datetime.datetime, datetime.datetime]:
    """Namelist-driven date range (util/input.py:135-139)."""
    s = datetime.datetime(cfg.start_year, cfg.start_month, 1)
    n_day = _cal.monthrange(cfg.end_year, cfg.end_month)[1]
    return s, datetime.datetime(cfg.end_year, cfg.end_month, n_day)


def month_midpoints(cfg: Namelist) -> np.ndarray:
    """Mid-month (15th) timestamps over the configured range — the time axis
    of every monthly intermediate (thermo/calc_thermo.py:104-110;
    track/env_wind.py:130-146)."""
    out = []
    y, m = cfg.start_year, cfg.start_month
    for _ in range(cfg.n_months):
        out.append(np.datetime64(f'{y:04d}-{m:02d}-15', 's'))
        y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    return np.asarray(out)


# ---------------------------------------------------------------- loading

class MonthlyVar:
    """A monthly variable lazily concatenated over its source files."""

    def __init__(self, files: List[str], key: str):
        if not files:
            raise FileNotFoundError(f'no input files found for {key!r}')
        self.files = files
        self.key = key

    def load_range(self, t0: datetime.datetime, t1: datetime.datetime):
        """Concatenate [time, ...] data within [t0, t1].  Returns
        (times [T], data [T, ...], dataset-of-last-file for axis metadata).

        Silent-wrongness guards (SURVEY.md section 7's "where silent
        wrongness lives"; fuzz-tested in tests/test_reader_fuzz.py):
        scrambled dimension order (time not leading) raises instead of
        slicing a spatial axis; non-time coordinate axes must match across
        the file set (catches mixed hPa/Pa level axes and mixed lon
        conventions, which would otherwise concatenate into one silently
        inconsistent stack); an all-fill selection raises instead of
        flowing NaNs into preprocessing."""
        datas, times = [], []
        last = None
        ref_coords = None
        ref_fn = None
        t0_64 = np.datetime64(t0, 's')
        t1_64 = np.datetime64(t1, 's')
        for fn in self.files:
            ds = netcdf.read(fn)
            t = times_of(ds)
            v = ds[self.key]
            if v.dims and len(v.dims) > 1 and v.dims[0] != 'time':
                raise ValueError(
                    f'{fn}: variable {self.key!r} has dims {v.dims} — the '
                    f'time axis must lead; transpose the file or fix its '
                    f'dimension metadata')
            if np.asarray(v.data).shape[:1] != t.shape:
                raise ValueError(
                    f'{fn}: variable {self.key!r} first-axis length '
                    f'{np.asarray(v.data).shape[:1]} does not match the '
                    f'time axis {t.shape} — corrupted or mislabeled file')
            coords = {d: np.asarray(ds[d].data, np.float64)
                      for d in v.dims[1:] if d in ds}
            if ref_coords is None:
                ref_coords, ref_fn = coords, fn
            else:
                for d, ax in coords.items():
                    ref = ref_coords.get(d)
                    if ref is not None and (ref.shape != ax.shape or
                                            not np.allclose(ref, ax)):
                        raise ValueError(
                            f'{fn}: coordinate {d!r} differs from '
                            f'{ref_fn} (e.g. {ax.ravel()[:3]} vs '
                            f'{ref.ravel()[:3]}) — mixed units, level '
                            f'order, or lon conventions in one file set; '
                            f'normalize the inputs before ingestion')
            sel = (t >= t0_64) & (t <= t1_64)
            if not sel.any():
                continue
            block = np.asarray(v.data)[sel]
            if block.dtype.kind == 'f' and block.size and \
                    not np.isfinite(block).any():
                raise ValueError(
                    f'{fn}: variable {self.key!r} is entirely fill/NaN in '
                    f'[{t0}, {t1}] — wrong _FillValue/missing_value '
                    f'sentinel or a corrupted file')
            datas.append(block)
            times.append(t[sel])
            last = ds
        if last is None:
            raise ValueError(f'{self.key}: no data within [{t0}, {t1}]')
        return np.concatenate(times), np.concatenate(datas, axis=0), last


def open_monthly(cfg: Namelist, name: str) -> MonthlyVar:
    key = var_key(cfg, name)
    return MonthlyVar(glob_prefix(cfg, key), key)


def axes_of(cfg: Namelist, ds: netcdf.Dataset) -> Tuple[np.ndarray, np.ndarray]:
    """(lon, lat) axes of a dataset using the namelist key mapping."""
    return (np.asarray(ds[var_key(cfg, 'lon')].data, np.float64),
            np.asarray(ds[var_key(cfg, 'lat')].data, np.float64))


def level_axis_pa(cfg: Namelist, ds: netcdf.Dataset) -> np.ndarray:
    """Pressure-level axis in Pa regardless of source units
    (thermo/calc_thermo.py:59-62; track/env_wind.py:180-184)."""
    v = ds[var_key(cfg, 'lvl')]
    lvl = np.asarray(v.data, np.float64)
    units = str(v.attrs.get('units', ''))
    if units in ('millibars', 'hPa') or (units == '' and lvl.max() < 2000):
        return lvl * 100.0
    return lvl


def normalize_latlon(lon: np.ndarray, lat: np.ndarray, *arrs,
                     lat_axis: int, lon_axis: int):
    """THE ingestion normalization: ascending latitude and ascending 0-360
    longitude for every gridded array (the bilinear engine requires it;
    reference equivalents: lat reindex at util/compute.py:80-84 and the
    transform_lon rotation at util/basins.py:93-107).

    Returns (lon, lat, [arrs...]).
    """
    arrs = list(arrs)
    lat = np.asarray(lat, np.float64)
    if lat.size > 1 and lat[0] > lat[-1]:
        lat = lat[::-1].copy()
        arrs = [np.flip(a, axis=lat_axis).copy() for a in arrs]
    lon0360 = np.mod(np.asarray(lon, np.float64), 360.0)
    order = np.argsort(lon0360, kind='stable')
    # grids carrying both seam endpoints (0 AND 360, or -180 AND 180) map
    # to a duplicate column under mod — keep the first; the duplicate
    # would otherwise surface later as an opaque 'grid is not uniform'
    keep = np.concatenate([[True], np.diff(lon0360[order]) > 1e-9])
    order = order[keep]
    if not np.array_equal(order, np.arange(lon0360.size)):
        arrs = [np.take(a, order, axis=lon_axis) for a in arrs]
    return lon0360[order], lat, arrs
