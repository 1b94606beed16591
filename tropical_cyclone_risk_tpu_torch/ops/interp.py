"""Batched bilinear field interpolation (twin of
tropical_cyclone_risk_tpu/ops/interp.py).

Fields are packed channel-last, ``[..., nlat, nlon, C]``; a kx=ky=1
RectBivariateSpline is exactly bilinear interpolation with the query clamped
to the grid, which is what ``_cell_and_weight`` reproduces.  The corner-packed
form (``pack_corners``) puts the four corner cells of each lookup in one
contiguous row, so one lookup is one row read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class UniformGrid(NamedTuple):
    """A uniform lon/lat grid: lon[i] = lon0 + i*dlon (ascending),
    lat[j] = lat0 + j*dlat (ascending).  Compares equal to the JAX
    package's UniformGrid with the same fields (both are plain tuples)."""
    lon0: float
    dlon: float
    nlon: int
    lat0: float
    dlat: float
    nlat: int

    @staticmethod
    def from_axes(lon: np.ndarray, lat: np.ndarray) -> 'UniformGrid':
        lon = np.asarray(lon, dtype=np.float64)
        lat = np.asarray(lat, dtype=np.float64)
        if lat[1] < lat[0]:
            raise ValueError('latitude axis must be ascending')
        dlon = float(lon[1] - lon[0])
        dlat = float(lat[1] - lat[0])
        if not (np.allclose(np.diff(lon), dlon, rtol=1e-4) and
                np.allclose(np.diff(lat), dlat, rtol=1e-4)):
            raise ValueError('grid is not uniform')
        return UniformGrid(float(lon[0]), dlon, int(lon.size),
                           float(lat[0]), dlat, int(lat.size))

    def lon_axis(self) -> np.ndarray:
        return self.lon0 + self.dlon * np.arange(self.nlon)

    def lat_axis(self) -> np.ndarray:
        return self.lat0 + self.dlat * np.arange(self.nlat)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, rounded as one float division on
    every device (as the JAX package and the CUDA kernels divide): torch's
    CUDA kernel computes ``tensor / python_scalar`` as a multiply by the
    reciprocal, which can differ in the last bit."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _cell_and_weight(x, x0: float, dx: float, n: int):
    """Cell index (int64) and fractional offset, clamped to the grid."""
    u = torch.clamp(true_div(x - x0, dx), 0.0, n - 1.0)
    # a NaN query reads cell 0 with a NaN weight (the CUDA kernels' float
    # to int conversion gives 0 for NaN; torch's is undefined)
    i = torch.nan_to_num(torch.clamp(torch.floor(u), 0, n - 2)).to(
        torch.int64)
    return i, u - i.to(u.dtype)


def _flat_base(field, grid: UniformGrid, lon, lat,
               plane_idx: Optional[torch.Tensor]):
    """(flat [rows, C], base row [N], wx [N, 1], wy [N, 1])."""
    ix, wx = _cell_and_weight(lon, grid.lon0, grid.dlon, grid.nlon)
    iy, wy = _cell_and_weight(lat, grid.lat0, grid.dlat, grid.nlat)
    if field.dim() == 3:
        if plane_idx is not None:
            raise ValueError('plane_idx given but the field has no plane axis')
        base = iy * grid.nlon + ix
    else:
        if plane_idx is None:
            raise ValueError('plane_idx required for a stacked field')
        base = (plane_idx.to(torch.int64) * grid.nlat + iy) * grid.nlon + ix
    flat = field.reshape(-1, field.shape[-1])
    return flat, base, wx[:, None], wy[:, None]


def _blend(c00, c01, c10, c11, wx, wy):
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01) +
            wy * ((1 - wx) * c10 + wx * c11))


def bilinear(field, grid: UniformGrid, lon, lat,
             plane_idx: Optional[torch.Tensor] = None):
    """field [nlat, nlon, C] or [P, nlat, nlon, C]; lon/lat [N] -> [N, C]."""
    flat, base, wx, wy = _flat_base(field, grid, lon, lat, plane_idx)
    return _blend(flat[base], flat[base + 1], flat[base + grid.nlon],
                  flat[base + grid.nlon + 1], wx, wy)


def bilinear_scalar(field2d, grid: UniformGrid, lon, lat,
                    plane_idx: Optional[torch.Tensor] = None):
    """Single-channel bilinear: field2d [nlat, nlon] (or [P, ...]) -> [N]."""
    return bilinear(field2d[..., None], grid, lon, lat, plane_idx)[..., 0]


def regrid(field, src_lon, src_lat, dst_lon, dst_lat):
    """Regrid a [lat, lon] field bilinearly to a new grid (reference
    interp_2d_grid, util/mat.py:159-164).  ``field`` is a tensor or a numpy
    array; the result is a tensor [dst_lat, dst_lon] on the field's device
    (the CPU for numpy input), in float32 as in the JAX package."""
    grid = UniformGrid.from_axes(np.asarray(src_lon), np.asarray(src_lat))
    field = torch.as_tensor(field).to(torch.float32)
    axis = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                     device=field.device)
    qlat, qlon = torch.meshgrid(axis(dst_lat), axis(dst_lon), indexing='ij')
    vals = bilinear_scalar(field, grid, qlon.reshape(-1), qlat.reshape(-1))
    return vals.reshape(qlat.shape)


def pack_corners(field):
    """[..., nlat, nlon, C] -> [..., nlat, nlon, 4C] with channels
    (c00, c01, c10, c11) = (y,x), (y,x+1), (y+1,x), (y+1,x+1), edge-clamped."""
    shift_x = torch.cat([field[..., 1:, :], field[..., -1:, :]], dim=-2)
    shift_y = torch.cat([field[..., 1:, :, :], field[..., -1:, :, :]], dim=-3)
    shift_xy = torch.cat([shift_y[..., 1:, :], shift_y[..., -1:, :]], dim=-2)
    return torch.cat([field, shift_x, shift_y, shift_xy], dim=-1)


def bilinear_packed(field4, grid: UniformGrid, lon, lat,
                    plane_idx: Optional[torch.Tensor] = None):
    """Bilinear lookup from a corner-packed stack: one row per query.
    field4 [nlat, nlon, 4C] or [P, nlat, nlon, 4C] -> [N, C]."""
    C = field4.shape[-1] // 4
    flat, base, wx, wy = _flat_base(field4, grid, lon, lat, plane_idx)
    row = flat[base]
    return _blend(row[:, :C], row[:, C:2 * C], row[:, 2 * C:3 * C],
                  row[:, 3 * C:], wx, wy)
