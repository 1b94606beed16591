"""Assemble the device-resident FieldPack from the preprocessing outputs
(twin of tropical_cyclone_risk_tpu/models/pack_builder.py).

Reference equivalent: the per-month interpolant construction at the top of
run_tracks (util/compute.py:66-121) plus BetaAdvectionTrack._load_wnd_stat
(track/bam_track.py:76-91): the same data becomes the packed arrays of one
FieldPack, built once per run.

Plane layout: plane = (year - start_year) * 12 + (month - start_month); the
thermo and wind-stat files carry mid-month timestamps, so the reference's
time interpolation at the month midpoint (compute.py:108-112) is an exact
plane select.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import input as tcin
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.models import fields as F
from tropical_cyclone_risk_tpu_torch.ops import interp
from tropical_cyclone_risk_tpu_torch.preprocess import (land_masks, static,
                                                        thermo_driver, winds)


def _plane_index(cfg: Namelist, times: np.ndarray) -> np.ndarray:
    yy = tcin.year_of(times)
    mm = tcin.month_of(times)
    return (yy - cfg.start_year) * 12 + (mm - cfg.start_month)


def _regrid_stack(a: np.ndarray, src_lon, src_lat, dst_lon, dst_lat,
                  device) -> np.ndarray:
    """Bilinear regrid of every plane of a [P, lat, lon] host stack on
    ``device`` (float32, as the JAX package regrids on its device); the
    result comes back to the host, where the builder assembles its
    arrays."""
    a = torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return torch.stack([interp.regrid(x, src_lon, src_lat, dst_lon, dst_lat)
                        for x in a]).cpu().numpy()


def build_field_pack(cfg: Namelist, basin_id: str,
                     fn_thermo: Optional[str] = None,
                     fn_wnd: Optional[str] = None,
                     device='cuda') -> F.FieldPack:
    """Load the thermo, wind-stat, static and mask files into a FieldPack on
    ``device`` (the GPU unless the caller asks for the CPU), cropped to the
    run basin."""
    fn_thermo = fn_thermo or thermo_driver.get_fn_thermo(cfg)
    fn_wnd = fn_wnd or winds.get_env_wnd_fn(cfg)

    # ---- wind statistics (define the atmospheric grid) ----
    wind, w_lon, w_lat, w_times = winds.read_env_wnd(cfg, fn_wnd)
    w_lon, w_lat, (wind,) = tcin.normalize_latlon(
        w_lon, w_lat, wind, lat_axis=1, lon_axis=2)
    grid = interp.UniformGrid.from_axes(w_lon, w_lat)

    # ---- thermo fields ----
    vmax, chi_raw, rh, t_lon, t_lat, t_times = thermo_driver.read_thermo(
        fn_thermo)
    t_lon, t_lat, (vmax, chi_raw, rh) = tcin.normalize_latlon(
        t_lon, t_lat, vmax, chi_raw, rh, lat_axis=1, lon_axis=2)

    n_planes = cfg.n_months
    if not (np.array_equal(_plane_index(cfg, w_times), np.arange(n_planes))
            and np.array_equal(_plane_index(cfg, t_times),
                               np.arange(n_planes))):
        raise ValueError('thermo/wind-stat files do not cover the configured '
                         'month range contiguously')

    same_grid = (t_lon.size == w_lon.size and t_lat.size == w_lat.size
                 and np.allclose(t_lon, w_lon) and np.allclose(t_lat, w_lat))
    if not same_grid:
        vmax, chi_raw, rh = (_regrid_stack(a, t_lon, t_lat, w_lon, w_lat,
                                           device)
                             for a in (vmax, chi_raw, rh))

    # PI scaling and chi fudge applied at load time (util/compute.py:76,
    # 110-115)
    vpot = np.nan_to_num(vmax * cfg.PI_reduc * math.sqrt(cfg.Ck / cfg.Cd))
    chi = F.prepare_chi(chi_raw, cfg)
    # wind stats: NaN (e.g. GCM below-orography fill) -> 0, like the
    # reference's nan_to_num when building each wind interpolant
    # (track/bam_track.py:74)
    wind = np.nan_to_num(wind)

    # ---- monthly ocean climatologies -> atmospheric grid, tiled over years
    mld12, m_lon, m_lat = static.load_monthly_climatology(cfg.fn_mld, 'mld')
    strat12, s_lon, s_lat = static.load_monthly_climatology(cfg.fn_strat,
                                                            'strat')
    mld12 = _regrid_stack(mld12, m_lon, m_lat, w_lon, w_lat, device)
    strat12 = _regrid_stack(strat12, s_lon, s_lat, w_lon, w_lat, device)
    # plane p covers month (start_month - 1 + p) % 12
    month_idx = (cfg.start_month - 1 + np.arange(n_planes)) % 12
    env = np.stack([chi, vpot, mld12[month_idx], strat12[month_idx], rh],
                   axis=-1).astype(np.float32)
    if env.shape[-1] != F.N_ENV:
        raise ValueError(f'env has {env.shape[-1]} channels, not {F.N_ENV}')

    # ---- static land / bathymetry ----
    land, l_lon, l_lat = static.load_land(cfg.fn_land)
    bathy, b_lon, b_lat = static.load_bathy(
        cfg.fn_bathy if os.path.exists(cfg.fn_bathy) else None,
        land, l_lon, l_lat)

    # ---- basin masks ----
    masks, k_lon, k_lat = land_masks.load_basin_masks(cfg, cfg.mask_dir)
    ds_run = netcdf.read(os.path.join(cfg.mask_dir, f'{basin_id}.nc'))
    _, _, (run_mask,) = tcin.normalize_latlon(
        np.asarray(ds_run['lon'].data), np.asarray(ds_run['lat'].data),
        np.asarray(ds_run['basin'].data, np.float32),
        lat_axis=0, lon_axis=1)

    pack = F.pack_from_numpy(dict(
        grid=grid, wind=wind, env=env,
        land_grid=interp.UniformGrid.from_axes(l_lon, l_lat), land=land,
        bathy_grid=interp.UniformGrid.from_axes(b_lon, b_lat), bathy=bathy,
        mask_grid=interp.UniformGrid.from_axes(k_lon, k_lat),
        basin_masks=masks, run_mask=run_mask), device)
    # single-basin runs never sample outside bounds + margin
    return F.crop_pack(pack, cfg, basin_id)
