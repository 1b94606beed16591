"""Device-resident environment field packs (twin of
tropical_cyclone_risk_tpu/models/fields.py).

  wind [P, nlat, nlon, W + W(W+1)/2] - steering-wind means + lower-tri cov
  env  [P, nlat, nlon, 5]            - chi, vpot, mld, strat, rh_mid
  land / bathy                        - static fields on their own grids
  basin_masks [nlat_m, nlon_m, B]    - per-basin ocean masks

P indexes (year, month) planes: plane = year_idx * 12 + (month - 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.ops.interp import (UniformGrid,
                                                        pack_corners)
from tropical_cyclone_risk_tpu_torch.utils import basins as basins_mod
from tropical_cyclone_risk_tpu_torch.utils import obs

# env channel indices
CHI, VPOT, MLD, STRAT, RH = range(5)
N_ENV = 5


class FieldPack(NamedTuple):
    grid: UniformGrid          # atmospheric grid (env + wind stats)
    wind: torch.Tensor         # [P, nlat, nlon, W + W(W+1)/2]
    env: torch.Tensor          # [P, nlat, nlon, N_ENV]
    land_grid: UniformGrid
    land: torch.Tensor         # [nlat_l, nlon_l] (1.0 = land)
    bathy_grid: UniformGrid
    bathy: torch.Tensor        # [nlat_b, nlon_b] (m; >= 0 over land)
    mask_grid: UniformGrid
    basin_masks: torch.Tensor  # [nlat_m, nlon_m, B] per-basin genesis masks
    run_mask: torch.Tensor     # [nlat_m, nlon_m] mask of the simulated basin

    @property
    def n_planes(self) -> int:
        return self.wind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.wind.device

    def to(self, device) -> 'FieldPack':
        """The pack with every tensor on ``device`` (itself where they are
        there already)."""
        return FieldPack(*(x.to(device) if isinstance(x, torch.Tensor)
                           else x for x in self))


class GatherStacks(NamedTuple):
    """Corner-packed gather sources of a FieldPack: wind statistics, env and
    (when they share the atmospheric grid) land/bathy fused into one cell
    row, so one lookup per storm reads everything a step needs."""
    grid: UniformGrid
    cell4: torch.Tensor        # [P, nlat, nlon, 4*n_cell_ch]
    n_wind_ch: int             # channels 0..n_wind_ch-1 are wind stats
    geo_in_cell: bool          # land/bathy are the last 2 cell channels
    land_grid: UniformGrid
    land_geo4: torch.Tensor    # [nlat_l, nlon_l, 4*(1 or 2)] (land[, bathy])
    bathy_grid: UniformGrid
    bathy4: torch.Tensor

    @property
    def fused_geo(self) -> bool:
        return self.land_geo4.shape[-1] == 8


def build_stacks(pack: FieldPack) -> GatherStacks:
    """Fused, corner-packed gather stacks (see GatherStacks)."""
    with obs.span('tc.launch.stacks'):
        cell = torch.cat([pack.wind, pack.env], dim=-1)
        geo_in_cell = (pack.land_grid == pack.grid
                       and pack.bathy_grid == pack.grid)
        if geo_in_cell:
            geo = torch.stack([pack.land, pack.bathy], dim=-1)
            cell = torch.cat([cell, geo[None].expand((cell.shape[0],) +
                                                     geo.shape)], dim=-1)
        if pack.land_grid == pack.bathy_grid:
            land_geo = torch.stack([pack.land, pack.bathy], dim=-1)
        else:
            land_geo = pack.land[..., None]
        return GatherStacks(grid=pack.grid, cell4=pack_corners(cell),
                            n_wind_ch=pack.wind.shape[-1],
                            geo_in_cell=geo_in_cell,
                            land_grid=pack.land_grid,
                            land_geo4=pack_corners(land_geo),
                            bathy_grid=pack.bathy_grid,
                            bathy4=pack_corners(pack.bathy[..., None]))


def crop_pack(pack: FieldPack, cfg: Namelist, basin_id: str,
              margin_deg: float = 2.5) -> FieldPack:
    """Crop the atmospheric stacks to the run basin's bounds plus a margin
    (models/fields.py crop_pack of the JAX package).

    Tracks end one degree outside the basin bounds, so fields beyond
    bounds + margin are never sampled; the reference crops the same way
    when it builds its per-basin splines (util/basins.py:57-75).
    Land/bathy/basin masks keep their own grids unless they share the
    atmospheric grid; GL returns the pack unchanged."""
    lo0, la0, lo1, la1 = basins_mod.basin_bounds(cfg, basin_id)
    g = pack.grid
    if (lo1 - lo0) >= 360.0 - g.dlon and (la1 - la0) >= 180.0 - g.dlat:
        return pack
    lon = g.lon_axis()
    lat = g.lat_axis()
    jsel = np.nonzero((lon >= lo0 - margin_deg) & (lon <= lo1 + margin_deg)
                      )[0]
    isel = np.nonzero((lat >= la0 - margin_deg) & (lat <= la1 + margin_deg)
                      )[0]
    j0, j1 = int(jsel[0]), int(jsel[-1]) + 1
    i0, i1 = int(isel[0]), int(isel[-1]) + 1
    new_grid = UniformGrid(float(lon[j0]), g.dlon, j1 - j0,
                           float(lat[i0]), g.dlat, i1 - i0)
    # copies, not views: a view would keep the uncropped stacks alive
    crop = lambda a: a[..., i0:i1, j0:j1, :].contiguous()
    repl = {'grid': new_grid, 'wind': crop(pack.wind), 'env': crop(pack.env)}
    if pack.land_grid == pack.grid:
        repl.update(land_grid=new_grid,
                    land=pack.land[..., i0:i1, j0:j1].contiguous())
    if pack.bathy_grid == pack.grid:
        repl.update(bathy_grid=new_grid,
                    bathy=pack.bathy[..., i0:i1, j0:j1].contiguous())
    return pack._replace(**repl)


def year_plane_indices(cfg: Namelist, n_planes: int, year_idx: int
                       ) -> tuple:
    """(plane index [12] int32, vpot-validity [12] float32) of one year."""
    base = year_idx * 12 + 1 - cfg.start_month
    gl = base + np.arange(12)
    valid = (gl >= 0) & (gl < n_planes)
    return (np.clip(gl, 0, n_planes - 1).astype(np.int32),
            valid.astype(np.float32))


def slice_pack_year(pack: FieldPack, cfg: Namelist, year_idx: int
                    ) -> FieldPack:
    """The 12 calendar-month planes of one simulated year; months outside
    the data range get a clamped plane with vpot zeroed, so the PI gate
    rejects them (util/compute.py:107-121)."""
    return gather_year(pack, *year_plane_indices(cfg, pack.n_planes,
                                                 year_idx))


def gather_year(pack: FieldPack, idx_np: np.ndarray, valid: np.ndarray
                ) -> FieldPack:
    """The planes idx_np of pack, vpot zeroed where valid is 0 (one row of
    year_plane_indices; the per-year loop and the fused years share it).
    A year inside the data range is a run of 12 planes, taken as a view:
    no index goes up from the host, so issuing the year does not wait for
    the launches queued before it."""
    if valid.all():
        lo = int(idx_np[0])
        return pack._replace(wind=pack.wind[lo:lo + 12],
                             env=pack.env[lo:lo + 12])
    idx = torch.as_tensor(idx_np, dtype=torch.int64, device=pack.device)
    env = pack.env[idx]
    env[..., VPOT] *= torch.as_tensor(valid, device=pack.device)[:, None,
                                                                  None]
    return pack._replace(wind=pack.wind[idx], env=env)


def prepare_chi(chi_raw: np.ndarray, cfg: Namelist) -> np.ndarray:
    """The chi fudge of util/compute.py:112-115: NaN -> 5, then
    clip(exp(log(chi + 1e-3) + log_chi_fac) + chi_fac, 1e-5, 5)."""
    chi = np.where(np.isnan(chi_raw), 5.0, chi_raw)
    chi = np.exp(np.log(chi + 1e-3) + cfg.log_chi_fac) + cfg.chi_fac
    return np.clip(chi, 1e-5, 5.0)


def synthetic_pack_numpy(cfg: Namelist, n_planes: int = 12, nlat: int = 181,
                         nlon: int = 360, seed: int = 0,
                         run_basin: str = 'GL') -> dict:
    """The numpy arrays of ``synthetic_pack``: the JAX package's generator
    (models/fields.py synthetic_pack) step for step, so both packages get
    the same bytes from the same seed."""
    rng = np.random.default_rng(seed)
    W = cfg.n_wind_levels
    lat = np.linspace(-90.0, 90.0, nlat)
    lon = np.arange(0.0, 360.0, 360.0 / nlon)
    grid = UniformGrid.from_axes(lon, lat)
    LA = lat[:, None] + 0 * lon[None, :]
    LO = lon[None, :] + 0 * lat[:, None]

    months = np.arange(n_planes) % 12
    seasonal = np.cos(2 * np.pi * (months[:, None, None] - 7.5) / 12.0)

    means = []
    n_lvls = W // 2
    for li in range(n_lvls):
        depth = 1.0 - li / max(n_lvls - 1, 1)      # 1 at top, 0 at bottom
        u_l = (-5.0 - 3.0 * depth
               + (6.0 + 14.0 * depth) * np.sin(np.deg2rad(LA)) ** 2
               + (2.0 + 2.0 * depth) * seasonal)
        v_l = ((1.0 + depth) * np.sin(np.deg2rad((2 - li % 2) * LO))[None]
               + 0 * seasonal)
        means += [u_l, v_l]

    tri = []
    base_var = 8.0 + 4.0 * np.cos(np.deg2rad(LA))[None] + 0 * seasonal
    for i in range(W):
        for j in range(i + 1):
            if i == j:
                tri.append(base_var * (1.0 + 0.1 * i))
            else:
                tri.append(0.2 * base_var * np.cos(np.deg2rad(LO))[None])
    wind = np.stack(means + tri, axis=-1).astype(np.float32)

    land = ((np.abs(LA) > 66) | ((LO > 270) & (LO < 310) & (LA > -60))
            ).astype(np.float32)
    vpot = 72.0 * np.exp(-((LA / 28.0) ** 4))[None] * \
        (1.0 + 0.15 * seasonal) * (1 - land)[None]
    chi_raw = 0.4 + 0.6 * np.abs(np.sin(np.deg2rad(LA)))[None] * \
        (1.0 + 0.2 * seasonal)
    chi = prepare_chi(np.where(land[None] > 0, np.nan, chi_raw), cfg)
    mld = (30.0 + 40.0 * np.cos(np.deg2rad(LA)) ** 2)[None] * \
        (1.0 + 0.1 * seasonal) * (1 - land)[None]
    strat = (4.0 + 2.0 * np.cos(np.deg2rad(LA)))[None] * \
        (1 + 0 * seasonal) * (1 - land)[None]
    rh = np.clip(0.45 + 0.25 * np.cos(np.deg2rad(LA))[None] *
                 (1 + 0.1 * seasonal) + 0.05 * rng.standard_normal(
                     (n_planes, nlat, nlon)), 0.0, 1.0)
    env = np.stack([chi, vpot, mld, strat, rh], axis=-1).astype(np.float32)
    bathy = np.where(land > 0, 100.0, -4500.0).astype(np.float32)

    basin_ids = cfg.basin_ids_sorted()
    masks = []
    for b in basin_ids:
        lo0, la0, lo1, la1 = basins_mod.basin_bounds(cfg, b)
        masks.append(((LO >= lo0) & (LO <= lo1) & (LA >= la0) & (LA <= la1)
                      & (land < 0.5)).astype(np.float32))
    basin_masks = np.stack(masks, axis=-1)
    if run_basin == 'GL':
        run_mask = ((np.abs(LA) <= 50) & (land < 0.5)).astype(np.float32)
    else:
        run_mask = masks[basin_ids.index(run_basin)]
    return dict(grid=grid, wind=wind, env=env, land_grid=grid, land=land,
                bathy_grid=grid, bathy=bathy, mask_grid=grid,
                basin_masks=basin_masks, run_mask=run_mask)


def pack_from_numpy(pack_np, device='cuda') -> FieldPack:
    """A FieldPack on ``device`` (the GPU unless the caller asks for the
    CPU) from numpy arrays: a dict of FieldPack's fields, or any
    FieldPack-shaped tuple such as the JAX package's (each array goes
    through np.asarray, each grid through UniformGrid)."""
    if not isinstance(pack_np, dict):
        pack_np = pack_np._asdict()
    out = {}
    for name in FieldPack._fields:
        v = pack_np[name]
        if name.endswith('grid'):
            out[name] = UniformGrid(*v)
        else:
            out[name] = torch.tensor(np.asarray(v, dtype=np.float32),
                                     device=device)
    return FieldPack(**out)


def synthetic_pack(cfg: Namelist, n_planes: int = 12, nlat: int = 181,
                   nlon: int = 360, seed: int = 0, run_basin: str = 'GL',
                   device='cuda') -> FieldPack:
    """A physically plausible synthetic global environment on ``device``
    (zonal jets with seasonal modulation, warm-pool PI, idealized land);
    shapes mirror a 1-degree ERA5 preprocessing output."""
    return pack_from_numpy(synthetic_pack_numpy(cfg, n_planes, nlat, nlon,
                                                seed, run_basin), device)
