"""Spherical geometry on tensors of any shape (twin of
tropical_cyclone_risk_tpu/ops/sphere.py; reference util/sphere.py).

The per-track API of one-shot callers (diagnostics.axi_to_max_wind); the
launch's vmax pass has its own collapsed forms (diagnostics._translation_tm).
"""

from __future__ import annotations

import math

import torch

from tropical_cyclone_risk_tpu_torch import constants


def haversine(lon1, lat1, lon2, lat2):
    """Great-circle distance in km (util/sphere.py:15-30)."""
    lon1, lat1, lon2, lat2 = map(torch.deg2rad, (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = (torch.square(torch.sin(dlat / 2)) + torch.cos(lat1) * torch.cos(lat2)
         * torch.square(torch.sin(dlon / 2)))
    c = 2 * torch.arcsin(torch.sqrt(a))
    return (constants.earth_R / 1000.0) * c


def to_sphere_dist(clon, clat, dx, dy):
    """Advance (lon, lat) by Cartesian displacements (m)
    (util/sphere.py:48-51)."""
    p_lat = clat + (dy / constants.earth_R) * (180.0 / math.pi)
    p_lon = clon + ((dx / constants.earth_R) * (180.0 / math.pi)
                    / torch.cos(clat * math.pi / 180.0))
    return p_lon, p_lat


def translational_speed(lon, lat, dt_s):
    """Centered-difference storm translation speed in m/s along the last
    axis, with linear extrapolation at the edges (util/sphere.py:58-83).

    lon, lat: [..., T] track positions at spacing dt_s seconds.
    Returns (ut, vt) with shape [..., T].
    """
    if lon.shape[-1] <= 1:
        # single-sample track: no difference exists (the reference returns
        # NaN; the edge extrapolation below would need two samples)
        nan = torch.full(lon.shape, math.nan, device=lon.device,
                         dtype=torch.promote_types(lon.dtype, torch.float32))
        return nan, nan
    e_lon = torch.cat([2 * lon[..., :1] - lon[..., 1:2], lon,
                       2 * lon[..., -1:] - lon[..., -2:-1]], dim=-1)
    e_lat = torch.cat([2 * lat[..., :1] - lat[..., 1:2], lat,
                       2 * lat[..., -1:] - lat[..., -2:-1]], dim=-1)
    dlon = 0.5 * (torch.sign(e_lon[..., 2:] - e_lon[..., :-2]) *
                  haversine(e_lon[..., 2:], e_lat[..., 1:-1],
                            e_lon[..., :-2], e_lat[..., 1:-1]))
    dlat = 0.5 * (torch.sign(e_lat[..., 2:] - e_lat[..., :-2]) *
                  haversine(e_lon[..., 1:-1], e_lat[..., 2:],
                            e_lon[..., 1:-1], e_lat[..., :-2]))
    return dlon * 1000.0 / dt_s, dlat * 1000.0 / dt_s
