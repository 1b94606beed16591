"""Static geo/ocean fields: land mask, bathymetry, MLD and stratification
climatologies (copy of tropical_cyclone_risk_tpu/preprocess/static.py).

Reference equivalents: intensity/geo.py and intensity/ocean.py.  When no
bathymetry file is supplied, a land-derived proxy (+100 m over land, -4500 m
over ocean) stands in for it, as in the JAX package
(docs/bathy_ablation.md bounds the effect).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.io.input import normalize_latlon


def load_land(fn: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Land mask [lat, lon] float32 plus ascending 0-360 axes
    (intensity/geo.py:23-34)."""
    ds = netcdf.read(fn)
    land = np.asarray(ds['land'].data, np.float32)
    lon = np.asarray(ds['lon'].data, np.float64)
    lat = np.asarray(ds['lat'].data, np.float64)
    lon, lat, (land,) = normalize_latlon(lon, lat, land,
                                         lat_axis=0, lon_axis=1)
    return land, lon, lat


def load_bathy(fn: Optional[str], land: np.ndarray, lon: np.ndarray,
               lat: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bathymetry [lat, lon] (m, >=0 over land) (intensity/geo.py:9-20).
    Falls back to the land-derived proxy when fn is None/missing."""
    if fn and os.path.exists(fn):
        ds = netcdf.read(fn)
        bathy = np.asarray(ds['bathymetry'].data, np.float32)
        blon = np.asarray(ds['lon'].data, np.float64)
        blat = np.asarray(ds['lat'].data, np.float64)
        blon, blat, (bathy,) = normalize_latlon(blon, blat, bathy,
                                                lat_axis=0, lon_axis=1)
        return bathy, blon, blat
    proxy = np.where(land >= 0.5, 100.0, -4500.0).astype(np.float32)
    return proxy, lon, lat


def load_monthly_climatology(fn: str, var: str
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Monthly ocean climatology [12, lat, lon] with NaN -> 0 (matching the
    nan_to_num at field-build time, util/compute.py:117-118) and ascending
    0-360 axes.  Source files store [lat, lon, month]
    (intensity/ocean.py:11-64)."""
    ds = netcdf.read(fn)
    data = np.asarray(ds[var].data, np.float64)        # [lat, lon, 12]
    lon = np.asarray(ds['lon'].data, np.float64)
    lat = np.asarray(ds['lat'].data, np.float64)
    data = np.moveaxis(data, -1, 0)                    # [12, lat, lon]
    # drop a duplicated wrap column if lon spans the full circle twice
    if lon.size > 1 and np.isclose(lon[-1] - lon[0], 360.0):
        lon = lon[:-1]
        data = data[:, :, :-1]
    lon, lat, (data,) = normalize_latlon(lon, lat, data,
                                         lat_axis=1, lon_axis=2)
    return np.nan_to_num(data).astype(np.float32), lon, lat
