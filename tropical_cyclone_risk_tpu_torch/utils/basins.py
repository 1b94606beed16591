"""Basin bounds on a 0-360 longitude grid (twin of the tensor parts of
tropical_cyclone_risk_tpu/utils/basins.py; the string parsing is copied,
since that module imports jax)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist


def parse_bound(bound: str) -> float:
    """Parse '260E' / '45S' style bound strings (util/basins.py:23-27)."""
    xd = float(bound[:-1])
    if bound[-1] in ('W', 'S'):
        xd *= -1
    return xd


def validate_basin_id(cfg: Namelist, basin_id: str) -> str:
    bid = basin_id.upper()
    if bid not in cfg.basin_bounds_dict:
        raise ValueError(f'Basin ID {basin_id!r} is not valid. '
                         f'Valid: {sorted(cfg.basin_bounds_dict)}')
    return bid


def basin_bounds(cfg: Namelist, basin_id: str
                 ) -> Tuple[float, float, float, float]:
    """(lon_min, lat_min, lon_max, lat_max) (util/basins.py:42-50)."""
    b0, b1, b2, b3 = cfg.basin_bounds_dict[validate_basin_id(cfg, basin_id)]
    return (parse_bound(b0), parse_bound(b1), parse_bound(b2),
            parse_bound(b3))


def in_basin(lon, lat, bounds: Tuple[float, float, float, float],
             dx: float):
    """True where (lon, lat) is strictly inside the basin shrunk by dx."""
    lon_min, lat_min, lon_max, lat_max = bounds
    return ((lon > (lon_min + dx)) & (lon < (lon_max - dx)) &
            (lat > (lat_min + dx)) & (lat < (lat_max - dx)))


def to_0360(lon):
    """Map longitudes into [0, 360)."""
    if isinstance(lon, torch.Tensor):
        return torch.remainder(lon, 360.0)
    return np.mod(lon, 360.0)


def roll_field_to_0360(lon: np.ndarray, field: np.ndarray):
    """A [..., lon]-last field whose longitudes may run -180..180,
    reordered to ascending 0..360 (the reference's transform_lon_r,
    util/basins.py:103-107); host numpy, for ingestion."""
    lon0360 = np.mod(np.asarray(lon), 360.0)
    order = np.argsort(lon0360, kind='stable')
    return lon0360[order], np.take(field, order, axis=-1)
