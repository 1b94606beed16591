"""The cell's environment, made on the device from --seed.

A frozen copy of the synthetic ERA5-shaped recipe the port's tests use
(zonal jets with a seasonal cycle, a warm-pool potential intensity,
idealised land): every channel is computed in float64 on the device and
stored in float32, one channel at a time, so a fifteen-level wind stack
(495 channels a plane) is made in well under a second.  The only random
part is the mid-level humidity's noise, drawn by a torch.Generator on the
device from the seed; the rest is fixed by the configuration.

The result is a dict of plain tensors and grids that the harness hands to
the program (as its FieldPack) and the reference reads alike.
"""

from __future__ import annotations

import math

import torch

CHI, VPOT, MLD, STRAT, RH = range(5)


def parse_bound(bound: str) -> float:
    """'260E' / '45S' -> degrees (W and S negative)."""
    x = float(bound[:-1])
    return -x if bound[-1] in ('W', 'S') else x


def basin_bounds(cfg: dict, basin: str) -> tuple:
    """(lon_min, lat_min, lon_max, lat_max) of a basin of the config."""
    return tuple(parse_bound(b) for b in cfg['basin_bounds'][basin])


def basin_ids(cfg: dict) -> tuple:
    """The sorted basins other than GL: the order of every per-basin
    array and of the seed counts."""
    return tuple(sorted(b for b in cfg['basin_bounds'] if b != 'GL'))


def prepare_chi(chi_raw, log_chi_fac: float, chi_fac: float):
    chi = torch.where(torch.isnan(chi_raw), 5.0, chi_raw)
    chi = torch.exp(torch.log(chi + 1e-3) + log_chi_fac) + chi_fac
    return torch.clamp(chi, 1e-5, 5.0)


def make_pack(cfg: dict, n_planes: int, seed: int, device) -> dict:
    """The environment of a run: wind [P, nlat, nlon, W + W(W+1)/2], env
    [P, nlat, nlon, 5], land, bathy [nlat, nlon], basin_masks [nlat, nlon,
    B], run_mask [nlat, nlon], on `device`, all on the config's grid."""
    g = cfg['grid']
    nl = cfg['namelist']
    W = 2 * len(nl['steering_levels'])
    nlat, nlon = g['nlat'], g['nlon']
    f64 = dict(dtype=torch.float64, device=device)
    lat = g['lat0'] + g['dlat'] * torch.arange(nlat, **f64)
    lon = g['lon0'] + g['dlon'] * torch.arange(nlon, **f64)
    LA = lat[:, None].expand(nlat, nlon)
    LO = lon[None, :].expand(nlat, nlon)
    months = torch.arange(n_planes, **f64) % 12
    seasonal = torch.cos(2 * math.pi * (months - 7.5) / 12.0)[:, None, None]
    rad = math.pi / 180.0

    wind = torch.empty((n_planes, nlat, nlon, W + W * (W + 1) // 2),
                       dtype=torch.float32, device=device)
    n_lvls = W // 2
    for li in range(n_lvls):
        depth = 1.0 - li / max(n_lvls - 1, 1)      # 1 at the top, 0 at 850
        wind[..., 2 * li] = (-5.0 - 3.0 * depth
                             + (6.0 + 14.0 * depth) * torch.sin(LA * rad) ** 2
                             + (2.0 + 2.0 * depth) * seasonal)
        wind[..., 2 * li + 1] = ((1.0 + depth)
                                 * torch.sin((2 - li % 2) * LO * rad))
    base_var = (8.0 + 4.0 * torch.cos(LA * rad))[None].expand(
        n_planes, nlat, nlon)
    off = 0.2 * base_var * torch.cos(LO * rad)
    c = W
    for i in range(W):
        for j in range(i + 1):
            wind[..., c] = base_var * (1.0 + 0.1 * i) if i == j else off
            c += 1

    land = ((LA.abs() > 66) | ((LO > 270) & (LO < 310) & (LA > -60))).to(
        torch.float64)
    sea = (1 - land)[None]
    env = torch.empty((n_planes, nlat, nlon, 5), dtype=torch.float32,
                      device=device)
    env[..., VPOT] = 72.0 * torch.exp(-((LA / 28.0) ** 4))[None] * \
        (1.0 + 0.15 * seasonal) * sea
    chi_raw = 0.4 + 0.6 * torch.sin(LA * rad).abs()[None] * \
        (1.0 + 0.2 * seasonal)
    env[..., CHI] = prepare_chi(torch.where(land[None] > 0, math.nan, chi_raw),
                                nl['log_chi_fac'], nl['chi_fac'])
    env[..., MLD] = (30.0 + 40.0 * torch.cos(LA * rad) ** 2)[None] * \
        (1.0 + 0.1 * seasonal) * sea
    env[..., STRAT] = ((4.0 + 2.0 * torch.cos(LA * rad))[None]
                       * torch.ones_like(seasonal) * sea)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((n_planes, nlat, nlon), generator=gen, **f64)
    env[..., RH] = torch.clamp(0.45 + 0.25 * torch.cos(LA * rad)[None]
                               * (1 + 0.1 * seasonal) + 0.05 * noise, 0.0, 1.0)
    bathy = torch.where(land > 0, 100.0, -4500.0)

    masks = []
    for b in basin_ids(cfg):
        lo0, la0, lo1, la1 = basin_bounds(cfg, b)
        masks.append((LO >= lo0) & (LO <= lo1) & (LA >= la0) & (LA <= la1)
                     & (land < 0.5))
    if cfg['basin'] == 'GL':
        run_mask = (LA.abs() <= 50) & (land < 0.5)
    else:
        run_mask = masks[basin_ids(cfg).index(cfg['basin'])]
    f32 = lambda x: x.to(torch.float32).contiguous()
    grid = (g['lon0'], g['dlon'], nlon, g['lat0'], g['dlat'], nlat)
    return dict(grid=grid, wind=wind, env=env, land=f32(land),
                bathy=f32(bathy), basin_masks=f32(torch.stack(masks, -1)),
                run_mask=f32(run_mask))
