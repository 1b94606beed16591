"""Environmental steering-wind statistics: monthly mean + covariance fields
(copy of tropical_cyclone_risk_tpu/preprocess/winds.py).

Reference equivalent: track/env_wind.py (gen_wind_mean_cov / calc_wnd_stat).
One einsum over the packed daily wind stack [D, W, nlat, nlon] gives the
full covariance matrix for every grid point at once.  The stage is bound by
file reads, so it runs on the host in numpy: a ~100 MFLOP/month reduction
is not worth a device round trip.

Variable-name and file-name contracts match the reference exactly
(track/env_wind.py:13-42, 104-113).  Quirk kept for parity: variances are
population variances (ddof=0) and covariances sample covariances (ddof=1),
as in calc_wnd_stat (track/env_wind.py:205-219).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import input as tcin
from tropical_cyclone_risk_tpu_torch.io import netcdf


def get_env_wnd_fn(cfg: Namelist) -> str:
    """Output filename contract (track/env_wind.py:13-18)."""
    return '%s/env_wnd_%s_%d%02d_%d%02d.nc' % (
        cfg.output_directory, cfg.exp_prefix, cfg.start_year, cfg.start_month,
        cfg.end_year, cfg.end_month)


def wind_mean_names(cfg: Namelist) -> List[str]:
    """['ua250_Mean', 'va250_Mean', ...] (track/env_wind.py:22-27)."""
    names = []
    for p in cfg.steering_levels:
        names += ['ua%s' % p, 'va%s' % p]
    return [x + '_Mean' for x in names]


def wind_cov_names(cfg: Namelist) -> List[str]:
    """Row-major lower-triangle names: diag '<v>_Var', off-diag
    '<vi>_<vj>_cov' (track/env_wind.py:30-42)."""
    names = []
    for p in cfg.steering_levels:
        names += ['ua%s' % p, 'va%s' % p]
    out = []
    for i in range(len(names)):
        for j in range(i + 1):
            out.append(names[i] + '_Var' if i == j
                       else names[i] + '_' + names[j] + '_cov')
    return out


def _monthly_stats(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x: [D, W, nlat, nlon] daily winds -> (mean [W, ...], cov [W, W, ...]).

    Diagonal uses ddof=0 and off-diagonals ddof=1 (reference quirk, see
    module docstring).

    Host-side numpy on purpose: this one-pass reduction is ~100 MFLOP per
    month while the raw daily fields are ~60 MB/month, so a copy to the
    device would cost more than the arithmetic.  float32 throughout, as
    xarray reduces the reference's float32 ERA5 inputs."""
    D, W = x.shape[0], x.shape[1]
    x = np.asarray(x, np.float32)
    mean = np.zeros(x.shape[1:], np.float32)
    x.mean(axis=0, out=mean)
    xc = x - mean[None]
    prod = np.einsum('dinm,djnm->ijnm', xc, xc)
    eye = np.eye(W, dtype=np.float32).reshape(W, W, 1, 1)
    cov = prod * (eye / np.float32(D)
                  + (np.float32(1.0) - eye) / np.float32(max(D - 1, 1)))
    return mean, cov.astype(np.float32, copy=False)


def _daily_means(u: np.ndarray, times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Group sub-daily samples into daily means (track/env_wind.py:187-195).
    u: [T, ...]; times datetime64[s].  Returns (days, u_daily)."""
    days = times.astype('datetime64[D]')
    uniq, inv = np.unique(days, return_inverse=True)
    if uniq.size == times.size:
        return uniq, u
    cnt = np.bincount(inv, minlength=uniq.size)
    k = cnt[0]
    if np.all(cnt == k) and np.array_equal(inv, np.repeat(
            np.arange(uniq.size), k)):
        # uniform sub-daily sampling (e.g. 00Z/12Z): contiguous reshape-mean
        # instead of np.add.at (which runs ~100 MB/s on GB-scale stacks);
        # out= into a calloc-backed buffer dodges the ~0.2 GB/s np.empty
        # first-touch penalty of the reduction's internal allocation
        out = np.zeros((uniq.size,) + u.shape[1:], u.dtype)
        return uniq, u.reshape((uniq.size, k) + u.shape[1:]).mean(
            axis=1, out=out)
    if np.all(np.diff(inv) >= 0):
        # ragged but day-sorted (e.g. a bounding_times cut that leaves the
        # last day with one sample): contiguous-run reduceat, ~GB/s where
        # np.add.at crawled at ~100 MB/s (15 s on one year of daily winds)
        starts = np.flatnonzero(np.r_[True, np.diff(inv) > 0])
        out = np.add.reduceat(u, starts, axis=0)
        out /= cnt.reshape((-1,) + (1,) * (u.ndim - 1)).astype(u.dtype)
        return uniq, out
    out = np.zeros((uniq.size,) + u.shape[1:], np.float64)
    np.add.at(out, inv, u)
    return uniq, (out / cnt.reshape((-1,) + (1,) * (u.ndim - 1))
                  ).astype(u.dtype)


def _level_indices(cfg: Namelist, ds: netcdf.Dataset) -> List[int]:
    """Steering-level indices in a file's level axis
    (track/env_wind.py:180-184, hPa vs Pa)."""
    lvl_pa = tcin.level_axis_pa(cfg, ds)
    idx = []
    for p_hPa in cfg.steering_levels:
        i = int(np.argmin(np.abs(lvl_pa - p_hPa * 100.0)))
        if abs(lvl_pa[i] - p_hPa * 100.0) > 1.0:
            raise ValueError(f'steering level {p_hPa} hPa not in file '
                             f'(levels: {lvl_pa / 100.0})')
        idx.append(i)
    return idx


def compute_pair_stats(cfg: Namelist, fn_u: str, fn_v: str,
                       pair_ds=None
                       ) -> Optional[Dict[Tuple[int, int], np.ndarray]]:
    """Monthly wind stats from one (u, v) daily file pair
    (track/env_wind.py:120-228).  Returns {(year, month): [14, nlat, nlon]}.

    pair_ds: optional pre-read (ds_u, ds_v) (the prefetch thread of
    gen_wind_mean_cov overlaps the next pair's file IO with this pair's
    reduction)."""
    ds_u, ds_v = pair_ds if pair_ds is not None else (netcdf.read(fn_u),
                                                     netcdf.read(fn_v))
    # classic NetCDF is big-endian: convert whole arrays to native float32
    # up front (contiguous vectorized byteswap, ~GB/s) — every strided
    # slice-assignment from a '>f4' view would otherwise fall into numpy's
    # per-element byteswap loops
    u_raw = np.ascontiguousarray(ds_u[tcin.var_key(cfg, 'u')].data,
                                 np.float32)
    v_raw = np.ascontiguousarray(ds_v[tcin.var_key(cfg, 'v')].data,
                                 np.float32)
    times = tcin.times_of(ds_u)

    t0, t1 = tcin.bounding_times(cfg)
    sel = (times >= np.datetime64(t0, 's')) & (times <= np.datetime64(t1, 's'))
    if not sel.any():
        return None
    if not sel.all():              # common case: whole file in range, no copy
        u_raw, v_raw, times = u_raw[sel], v_raw[sel], times[sel]

    # interleave to (ua_l1, va_l1, ua_l2, va_l2, ...) in one allocation:
    # the reference's wind vector order is per-level (u, v) pairs
    # (track/env_wind.py:24-25)
    idx_u = _level_indices(cfg, ds_u)
    idx_v = _level_indices(cfg, ds_v)
    W = 2 * len(cfg.steering_levels)
    # np.zeros, not np.empty: calloc-backed zero pages take huge-page
    # faults on first write (this buffer is ~760 MB per year pair)
    wnds = np.zeros((u_raw.shape[0], W) + u_raw.shape[2:], np.float32)
    for i in range(len(cfg.steering_levels)):
        wnds[:, 2 * i] = u_raw[:, idx_u[i]]
        wnds[:, 2 * i + 1] = v_raw[:, idx_v[i]]

    days, daily = _daily_means(wnds, times)
    ym = np.stack([tcin.year_of(days), tcin.month_of(days)], axis=1)
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for (yy, mm) in np.unique(ym, axis=0):
        m_sel = (ym[:, 0] == yy) & (ym[:, 1] == mm)
        mean, cov = _monthly_stats(daily[m_sel])
        tri = [cov[i, j] for i in range(W) for j in range(i + 1)]
        out[(int(yy), int(mm))] = np.concatenate(
            [mean, np.stack(tri)], axis=0)          # [W + W(W+1)/2, ...]
    return out


def gen_wind_mean_cov(cfg: Namelist) -> str:
    """Compute and write the monthly wind mean/cov file; idempotent
    (track/env_wind.py:83-118)."""
    fn_out = get_env_wnd_fn(cfg)
    if os.path.exists(fn_out):
        return fn_out

    fns_u = tcin.glob_prefix(cfg, tcin.var_key(cfg, 'u'))
    fns_v = tcin.glob_prefix(cfg, tcin.var_key(cfg, 'v'))
    if not fns_u or not fns_v:
        raise FileNotFoundError(
            f'no daily wind files under {cfg.base_directory} '
            f'(prefix {cfg.exp_prefix})')

    # the reduction stays serial on purpose — both a compute THREAD pool
    # (GIL + memory thrash, 3x slower) and a 4-worker PROCESS pool
    # (parallel cold reads thrash the virtio disk: 96 s vs 62 s on the
    # cold 6-year workspace) were measured worse than one stream.  A
    # single prefetch thread reads the NEXT pair's files while the
    # current pair reduces (file IO releases the GIL; at most two pairs
    # resident).
    import threading
    if len(fns_u) != len(fns_v):
        raise ValueError(
            f'unpaired daily wind files: {len(fns_u)} u-files vs '
            f'{len(fns_v)} v-files under {cfg.base_directory}')
    pairs = list(zip(fns_u, fns_v))

    # skip pairs entirely outside the configured date range BEFORE paying
    # for a full read: the time axis alone costs a header parse + a few KB
    # (a subset run on a multi-decade archive otherwise streams every GB
    # only for compute_pair_stats to drop it)
    t0, t1 = (np.datetime64(t, 's') for t in tcin.bounding_times(cfg))

    def _pair_in_range(fn_u: str) -> bool:
        try:
            ts = tcin.times_of(netcdf.read(fn_u, variables=('time',)))
        except Exception:
            return True          # no/odd time axis: let the full read decide
        return bool(ts.size) and ts.min() <= t1 and ts.max() >= t0

    pairs = [p for p in pairs if _pair_in_range(p[0])]
    stats: Dict[Tuple[int, int], np.ndarray] = {}
    lon = lat = None

    def read_pair(i):
        return (netcdf.read(pairs[i][0]), netcdf.read(pairs[i][1]))

    def prefetch(j):
        # store the result OR the exception: a corrupt/truncated file must
        # fail the run loudly, not silently reuse the previous pair
        try:
            nxt[0] = read_pair(j)
        except Exception as e:        # noqa: BLE001 — re-raised on consume
            nxt[0] = e

    nxt: List = [read_pair(0)] if pairs else []
    for i, (fn_u, fn_v) in enumerate(pairs):
        cur = nxt[0]
        if isinstance(cur, Exception):
            raise RuntimeError(f'failed reading wind pair {fn_u}, {fn_v}'
                               ) from cur
        t = None
        if i + 1 < len(pairs):
            t = threading.Thread(target=prefetch, args=(i + 1,))
            t.start()
        pair = compute_pair_stats(cfg, fn_u, fn_v, pair_ds=cur)
        if pair:
            dup = sorted(set(pair) & set(stats))
            if dup:
                # a month split across two file pairs would overwrite the
                # first pair's stats with a partial-month estimate — the
                # covariance cannot be merged from the written moments, so
                # demand month-aligned files (the reference would emit a
                # duplicated time axis here, track/env_wind.py:104-113)
                raise ValueError(
                    f'months {dup} appear in more than one daily wind '
                    f'file pair ({fn_u}); split a file set on month '
                    f'boundaries')
            stats.update(pair)
            if lon is None:
                lon, lat = tcin.axes_of(cfg, cur[0])
        if t is not None:
            t.join()

    if not stats:
        raise ValueError('no wind data within the configured date range')

    months = sorted(stats.keys())
    stack = np.stack([stats[k] for k in months])     # [P, C, nlat, nlon]
    t_mid = np.asarray([np.datetime64(f'{y:04d}-{m:02d}-15', 's')
                        for (y, m) in months])
    t_num, t_units = tcin.encode_time_days(t_mid)

    names = wind_mean_names(cfg) + wind_cov_names(cfg)
    data_vars = {nm: (('time', 'lat', 'lon'), stack[:, i].astype(np.float32))
                 for i, nm in enumerate(names)}
    os.makedirs(os.path.dirname(fn_out) or '.', exist_ok=True)
    netcdf.write(fn_out, data_vars,
                 coords={'time': t_num, 'lat': lat, 'lon': lon},
                 var_attrs={'time': {'units': t_units}})
    print('Saved %s' % fn_out)
    return fn_out


def read_env_wnd(cfg: Namelist, fn: str) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
    """Read the wind-stats file into a packed channel-last stack.

    Returns (wind [P, nlat, nlon, W + W(W+1)/2], lon, lat, times) with
    channels ordered means-then-lower-triangle — the FieldPack layout
    (reference reader equivalent: track/env_wind.py:60-77)."""
    ds = netcdf.read(fn)
    names = wind_mean_names(cfg) + wind_cov_names(cfg)
    stack = np.stack([np.asarray(ds[nm].data, np.float32) for nm in names],
                     axis=-1)
    lon = np.asarray(ds['lon'].data, np.float64)
    lat = np.asarray(ds['lat'].data, np.float64)
    return stack, lon, lat, tcin.times_of(ds)


def deep_layer_winds(cfg: Namelist, env_wnds):
    """Extract (u250, v250, u850, v850) from wind vectors [..., W]
    (track/env_wind.py:49-55) — the deep-layer shear components.

    API parity only (the reference calls its copy; nothing here does) —
    the hot path resolves shear channels positionally via
    models.fast.deep_layer_indices, which also handles non-250/850
    steering-level configurations."""
    names = wind_mean_names(cfg)
    idx = [names.index(n) for n in
           ('ua250_Mean', 'va250_Mean', 'ua850_Mean', 'va850_Mean')]
    return tuple(env_wnds[..., i] for i in idx)
