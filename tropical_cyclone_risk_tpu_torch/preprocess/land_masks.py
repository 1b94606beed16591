"""Land and per-basin genesis mask generation (copy of
tropical_cyclone_risk_tpu/preprocess/land_masks.py).

Reference equivalent: scripts/generate_land_masks.py.  The land raster is
derived by sampling a high-resolution land-fraction NetCDF (the 0.125-degree
``land.nc`` the intensity model already requires) onto a 0.25-degree grid;
the basin geometry (boxes, bounds, the GL |lat| <= 50 cut) matches the
reference definitions exactly.  Every mask is written with self-consistent
ascending 0-360 coordinates.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from tropical_cyclone_risk_tpu_torch.io import netcdf

MASK_FILES = ('land.nc', 'NA.nc', 'EP.nc', 'NI.nc', 'SI.nc',
              'AU.nc', 'SP.nc', 'WP.nc', 'GL.nc')


def quarter_degree_grid() -> Tuple[np.ndarray, np.ndarray]:
    """0-360 x [-90, 90] at 0.25 deg (reference grid after rotation,
    scripts/generate_land_masks.py:24-33)."""
    lat = np.linspace(-90, 90, 721)
    lon = np.arange(0.0, 360.0, 0.25)
    return lon, lat


def land_from_netcdf(fn_land: str) -> np.ndarray:
    """Rasterize is-land onto the 0.25-degree grid by nearest sampling of a
    land-fraction file.  Axis conventions (descending lat, +/-180 lon) are
    normalized by the shared loader so any land file usable by the intensity
    model is usable here."""
    from tropical_cyclone_risk_tpu_torch.preprocess.static import load_land
    src, src_lon, src_lat = load_land(fn_land)   # ascending 0-360
    lon, lat = quarter_degree_grid()
    ii = np.clip(np.round((lat - src_lat[0]) / (src_lat[1] - src_lat[0])
                          ).astype(int), 0, src_lat.size - 1)
    jj = np.clip(np.round((lon - src_lon[0]) / (src_lon[1] - src_lon[0])
                          ).astype(int), 0, src_lon.size - 1)
    return (src[np.ix_(ii, jj)] >= 0.5)


def build_masks(land: np.ndarray) -> Dict[str, np.ndarray]:
    """All basin masks from the boolean land raster (geometry from
    scripts/generate_land_masks.py:39-110)."""
    lon, lat = quarter_degree_grid()
    LO, LA = np.meshgrid(lon, lat)
    ocean = ~land
    masks: Dict[str, np.ndarray] = {}

    # North Atlantic: eastern boxes carved along the Central-American divide
    lat_box_NA = [0, 9, 10, 14, 18]
    lon_box_NA = [285, 278, 276, 271, 262]
    na = (LO >= 255) & (LO <= 360) & (LA >= 0) & (LA <= 60)
    na_box = np.zeros_like(na)
    for la, lo in zip(lat_box_NA, lon_box_NA):
        na_box |= (LA >= la) & (LO >= lo) & ocean
    masks['NA'] = na & na_box

    # Eastern Pacific: west of the Atlantic divide
    lat_box_EP = [7.5, 8.8, 9, 10, 15, 18, 60]
    lon_box_EP = [295, 282, 277, 276.5, 276, 271, 262]
    ep = (LO >= 180) & (LO <= 290) & (LA >= 0) & (LA <= 60)
    ep_box = np.zeros_like(ep)
    for la, lo in zip(lat_box_EP, lon_box_EP):
        ep_box |= (LA <= la) & (LO <= lo) & ocean
    masks['EP'] = ep & ep_box

    masks['WP'] = (LO >= 100) & (LO <= 180) & (LA >= 0) & (LA <= 60) & ocean
    masks['NI'] = (LO >= 30) & (LO <= 100) & (LA >= 0) & (LA <= 49) & ocean
    masks['SI'] = (LO >= 10) & (LO <= 100) & (LA >= -45) & (LA <= 0) & ocean
    masks['AU'] = (LO >= 100) & (LO <= 170) & (LA >= -45) & (LA <= 0) & ocean
    masks['SP'] = (LO >= 170) & (LO <= 260) & (LA >= -45) & (LA <= 0) & ocean
    gl = ocean.copy()
    gl[np.abs(LA) > 50] = False
    masks['GL'] = gl
    return masks


def generate_land_masks(fn_land: str, out_dir: str = 'land',
                        force: bool = False) -> Dict[str, str]:
    """Generate land/*.nc idempotently (reference run.py:14 calls this once
    per run).  Returns the written/existing paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {f[:-3]: os.path.join(out_dir, f) for f in MASK_FILES}
    if not force and all(os.path.exists(p) for p in paths.values()):
        return paths

    lon, lat = quarter_degree_grid()
    land = land_from_netcdf(fn_land)
    netcdf.write(paths['land'],
                 {'land': (('lat', 'lon'), land.astype(np.int8))},
                 coords={'lon': lon, 'lat': lat})
    for bid, mask in build_masks(land).items():
        netcdf.write(paths[bid],
                     {'basin': (('lat', 'lon'), mask.astype(np.int8))},
                     coords={'lon': lon, 'lat': lat})
    return paths


def load_basin_masks(cfg, mask_dir: str = 'land'):
    """Load the per-basin masks + run-basin mask as float arrays for a
    FieldPack: ([nlat, nlon, B], grid axes)."""
    from tropical_cyclone_risk_tpu_torch.io import input as tcin

    ids = cfg.basin_ids_sorted()
    arrs = []
    lon = lat = None
    for b in ids:
        ds = netcdf.read(os.path.join(mask_dir, f'{b}.nc'))
        # normalize like every other field loader: externally supplied
        # masks on a -180..180 or descending-lat grid would otherwise
        # silently clamp every seeding gather
        lon, lat, (m,) = tcin.normalize_latlon(
            np.asarray(ds['lon'].data), np.asarray(ds['lat'].data),
            np.asarray(ds['basin'].data, np.float32),
            lat_axis=0, lon_axis=1)
        arrs.append(m)
    return np.stack(arrs, axis=-1), lon, lat
