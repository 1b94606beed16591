"""Thermodynamic preprocessing: monthly PI, entropy deficit, mid-level RH
(twin of tropical_cyclone_risk_tpu/preprocess/thermo_driver.py).

Reference equivalent: thermo/calc_thermo.py (gen_thermo / compute_thermo).
Months are batched in chunks through ``ops.pi.cape_pi``, which on the GPU
is the hand-written CAPE-PI kernel (K6); chi and rh_mid are a few plain
torch operations at one level on the same device.

File and variable contracts match the reference (thermo_{prefix}_{dates}.nc
with vmax/chi/rh_mid on (time, lat, lon), mid-month timestamps —
thermo/calc_thermo.py:17-21, 104-117).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import input as tcin
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.ops import interp, pi as pi_ops
from tropical_cyclone_risk_tpu_torch.ops import thermo as th


def get_fn_thermo(cfg: Namelist) -> str:
    """Output filename contract (thermo/calc_thermo.py:17-21)."""
    return '%s/thermo_%s_%d%02d_%d%02d.nc' % (
        cfg.output_directory, cfg.exp_prefix, cfg.start_year, cfg.start_month,
        cfg.end_year, cfg.end_month)


def _sort_levels_descending(lvl_pa: np.ndarray, *fields):
    """Surface level (largest pressure) first (thermo/calc_thermo.py:53-56).
    fields are [T, L, ...]."""
    if lvl_pa[0] < lvl_pa[1]:
        return lvl_pa[::-1].copy(), tuple(f[:, ::-1] for f in fields)
    return lvl_pa, fields


def compute_thermo_month(cfg: Namelist, table, sst_k: torch.Tensor,
                         psl: torch.Tensor, lvl_pa: np.ndarray,
                         ta: torch.Tensor, hus: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vmax, chi, rh_mid) on the atmospheric grid
    (thermo/calc_thermo.py:39-74).

    sst_k [..., nlat, nlon] K (already regridded); psl [..., nlat, nlon] Pa;
    ta/hus [L, ..., nlat, nlon] with the surface level first; lvl_pa [L] Pa.
    Leading batch axes (a month chunk) broadcast through: every operation
    is per column.
    """
    # cecd inside the PI (thermo/thermo.py:268,410) is separate from the
    # PI_reduc*sqrt(Ck/Cd) applied when the pack is built: the reference
    # applies the ratio in both places
    p_env = torch.as_tensor(np.asarray(lvl_pa, np.float32),
                            device=sst_k.device)
    vmax = pi_ops.cape_pi(sst_k, psl, p_env, ta, hus, table,
                          cecd=cfg.Ck / cfg.Cd,
                          select_thermo=cfg.select_thermo,
                          select_interp=cfg.select_interp)
    i_mid = int(np.argmin(np.abs(lvl_pa - cfg.p_midlevel)))
    p_mid = float(lvl_pa[i_mid])
    ta_mid = ta[i_mid]
    hus_mid = hus[i_mid]
    chi = torch.clamp(th.sat_deficit(sst_k, psl, ta_mid, p_mid, hus_mid,
                                     cfg.select_thermo), 0.0, 10.0)
    rh_mid = th.conv_q_to_rh(ta_mid, hus_mid, p_mid)
    return vmax, chi, rh_mid


def gen_thermo(cfg: Namelist, table=None, month_chunk: int = 24,
               device='cuda') -> str:
    """Compute and write the monthly thermo file on ``device`` (the GPU
    unless the caller asks for the CPU); idempotent
    (thermo/calc_thermo.py:78-117).  ``month_chunk`` months go through
    one cape_pi call."""
    fn_out = get_fn_thermo(cfg)
    if os.path.exists(fn_out):
        return fn_out
    device = torch.device(device)
    if table is not None:
        table = table.to(device)
    elif cfg.select_thermo == 2 and cfg.select_interp == 2:
        table = pi_ops.EntropyTable3.create(device)
    else:
        table = pi_ops.EntropyTable.create(cfg.select_thermo, device)

    t0, t1 = tcin.bounding_times(cfg)
    sst_t, sst, ds_sst = tcin.open_monthly(cfg, 'sst').load_range(t0, t1)
    psl_t, psl, ds_psl = tcin.open_monthly(cfg, 'mslp').load_range(t0, t1)
    ta_t, ta, ds_ta = tcin.open_monthly(cfg, 'temp').load_range(t0, t1)
    hus_t, hus, ds_hus = tcin.open_monthly(cfg, 'sp_hum').load_range(t0, t1)
    n_t = min(len(sst_t), len(psl_t), len(ta_t), len(hus_t))
    # the four variables are sliced by index and timestamps come from psl
    # alone: a file set missing leading months for one variable would shift
    # every field by a month
    ref_ym = (tcin.year_of(psl_t[:n_t]) * 12 + tcin.month_of(psl_t[:n_t]))
    for name, tv in (('sst', sst_t), ('temp', ta_t), ('sp_hum', hus_t)):
        ym = tcin.year_of(tv[:n_t]) * 12 + tcin.month_of(tv[:n_t])
        if not np.array_equal(ym, ref_ym):
            raise ValueError(
                f'{name} monthly time axis is misaligned with mslp '
                f'(first differing index '
                f'{int(np.argmax(ym != ref_ym))}); check for missing '
                f'files in {cfg.base_directory}')

    lon_a, lat_a = tcin.axes_of(cfg, ds_ta)
    lon_s, lat_s = tcin.axes_of(cfg, ds_sst)
    lvl_pa = tcin.level_axis_pa(cfg, ds_ta)
    lvl_pa, (ta, hus) = _sort_levels_descending(lvl_pa, ta, hus)

    sst_units = str(ds_sst[tcin.var_key(cfg, 'sst')].attrs.get('units', 'K'))
    celsius = 'C' in sst_units

    # SST -> atmospheric grid (the reference's nan_to_num-then-regrid,
    # thermo/calc_thermo.py:39-43; land NaNs become 0 and are excluded
    # downstream by the land mask and the PI gate)
    needs_regrid = (lon_s.shape != lon_a.shape or lat_s.shape != lat_a.shape
                    or not (np.allclose(lon_s, lon_a)
                            and np.allclose(lat_s, lat_a)))
    if needs_regrid:
        # normalize the SST grid fully (ascending lat and 0-360 lon) and
        # query it in the same convention; the output keeps the atmosphere
        # file's own axes
        lon_s, lat_s, (sst,) = tcin.normalize_latlon(lon_s, lat_s, sst,
                                                     lat_axis=1, lon_axis=2)

    def fix_lat(lat, arrs, axis):
        if lat[0] > lat[-1]:
            return lat[::-1].copy(), tuple(np.flip(a, axis=axis) for a in arrs)
        return lat, arrs

    if not needs_regrid:
        lat_s, (sst,) = fix_lat(lat_s, (sst,), 1)
    lat_a_asc, (psl_a, ta_a, hus_a) = fix_lat(lat_a, (psl, ta, hus), -2)

    # months are independent columns: chunks of M months per call, the
    # last one edge-padded to the same shape
    M = min(month_chunk, n_t)
    vmax = np.zeros((n_t,) + (lat_a.size, lon_a.size), np.float32)
    chi = np.zeros_like(vmax)
    rh = np.zeros_like(vmax)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=device)
    for c0 in range(0, n_t, M):
        c1 = min(c0 + M, n_t)
        s = np.nan_to_num(np.asarray(sst[c0:c1], np.float32))
        if needs_regrid:
            s = np.stack([interp.regrid(
                s[i], lon_s, lat_s, np.mod(lon_a, 360.0), lat_a_asc).numpy()
                for i in range(s.shape[0])])
        if celsius:
            s = s + np.float32(273.15)
        pad = M - (c1 - c0)
        padded = lambda a: (np.concatenate(
            [a, np.repeat(a[-1:], pad, axis=0)]) if pad else a)
        ta_c = np.moveaxis(padded(ta_a[c0:c1]), 1, 0)   # [L, M, lat, lon]
        hus_c = np.moveaxis(padded(hus_a[c0:c1]), 1, 0)
        v_i, c_i, r_i = compute_thermo_month(
            cfg, table, dev(padded(s)), dev(padded(psl_a[c0:c1])), lvl_pa,
            dev(ta_c), dev(hus_c))
        n_c = c1 - c0
        vmax[c0:c1] = v_i[:n_c].cpu().numpy()
        chi[c0:c1] = c_i[:n_c].cpu().numpy()
        rh[c0:c1] = r_i[:n_c].cpu().numpy()

    # undo the ingestion flip so the file matches the source grid exactly
    if lat_a[0] > lat_a[-1]:
        vmax, chi, rh = (np.flip(a, axis=1).copy()
                         for a in (vmax, chi, rh))

    t_mid = np.asarray([np.datetime64(
        f'{tcin.year_of(psl_t[i:i+1])[0]:04d}-'
        f'{tcin.month_of(psl_t[i:i+1])[0]:02d}-15', 's')
        for i in range(n_t)])
    t_num, t_units = tcin.encode_time_days(t_mid)

    os.makedirs(os.path.dirname(fn_out) or '.', exist_ok=True)
    netcdf.write(fn_out, {
        'vmax': (('time', 'lat', 'lon'), vmax),
        'chi': (('time', 'lat', 'lon'), chi),
        'rh_mid': (('time', 'lat', 'lon'), rh),
    }, coords={'time': t_num, 'lat': lat_a, 'lon': lon_a},
        var_attrs={'time': {'units': t_units}})
    print('Saved %s' % fn_out)
    return fn_out


def read_thermo(fn: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray, np.ndarray]:
    """Read the thermo file: (vmax, chi, rh_mid, lon, lat, times)."""
    ds = netcdf.read(fn)
    return (np.asarray(ds['vmax'].data, np.float32),
            np.asarray(ds['chi'].data, np.float32),
            np.asarray(ds['rh_mid'].data, np.float32),
            np.asarray(ds['lon'].data, np.float64),
            np.asarray(ds['lat'].data, np.float64),
            tcin.times_of(ds))
