"""Track diagnostics: azimuthal -> maximum wind conversion (twin of
tropical_cyclone_risk_tpu/models/diagnostics.py, the standalone vmax pass).

``axi_to_max_wind_raw`` runs over every launch row.  On a CUDA tensor it
launches the Triton kernel of kernels/vmax.py; on a CPU tensor it runs
``axi_to_max_wind_raw_plain``, the same arithmetic in torch ops.
"""

from __future__ import annotations

import math

import torch

from tropical_cyclone_risk_tpu_torch import constants
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import vmax as vmax_kernel
from tropical_cyclone_risk_tpu_torch.models.fast import deep_layer_indices

DEG2RAD = math.pi / 180.0
KM2 = constants.earth_R / 1000.0 * 2      # twice the earth radius in km


def _vmax_from_inc(tc_v, mag_inc):
    """vmax = tc_v + min(|inc|, v/2): the closed form of the reference's
    optimal-azimuth construction (wind/tc_wind.py:14-21)."""
    return tc_v + torch.minimum(mag_inc, 0.5 * tc_v)


def _translation_tm(lon, lat, lon_prev, lat_prev, lon_next, lat_next, dt_s):
    """Centered-difference translation speed (m/s) from explicit previous /
    next positions, with the degenerate zonal and meridional haversines
    collapsed (the JAX package's float32-exact forms: a 3-term arcsin
    series for the zonal chord, 2|dp/2| for the meridional arc)."""
    s = torch.cos(lat * DEG2RAD) * torch.abs(
        torch.sin((lon_prev * DEG2RAD - lon_next * DEG2RAD) / 2))
    s2 = s * s
    hav_lon = KM2 * (s * (1.0 + s2 * (1.0 / 6.0 + s2 * (3.0 / 40.0))))
    hav_lat = KM2 * torch.abs((lat_prev * DEG2RAD - lat_next * DEG2RAD) / 2)
    dlon = 0.5 * (torch.sign(lon_next - lon_prev) * hav_lon)
    dlat = 0.5 * (torch.sign(lat_next - lat_prev) * hav_lat)
    return dlon * 1000.0 / dt_s, dlat * 1000.0 / dt_s


def _shear_channels(cfg):
    return deep_layer_indices(cfg) if cfg is not None else (0, 1, 2, 3)


def vmax_step(cfg, lat, tc_v, env_wnds, ut, vt):
    """vmax of samples given their translation (wind/tc_wind.py:6-21)."""
    iu2, iv2, iu8, iv8 = _shear_channels(cfg)
    G = torch.clamp_max(0.8 + 0.35 * (1.0 + torch.tanh((lat - 35.0) / 10.0)),
                        1.0)
    u_shr = env_wnds[..., iu2] - env_wnds[..., iu8]
    v_shr = env_wnds[..., iv2] - env_wnds[..., iv8]
    U_inc = G * ut + 0.1 * u_shr * tc_v / 15.0
    V_inc = G * vt + 0.1 * v_shr * tc_v / 15.0
    return _vmax_from_inc(tc_v, torch.sqrt(U_inc * U_inc + V_inc * V_inc))


def _take_rows(x, i):
    """x[i[n], n] for each column n, with i clipped to the row range."""
    return torch.gather(x, 0, i.clamp(0, x.shape[0] - 1)[None, :])[0]


def axi_to_max_wind_raw_plain(lon, lat, dt_track, tc_v, env_wnds, alive,
                              last_step, cfg=None, pos_before=None,
                              pos_after=None):
    """vmax over time-major unmasked buffers [T, N]; returns (vmax [T, N]
    valid where alive, alive-masked lifetime peak [N]).

    Samples past death hold the frozen state, so centered differences are
    exact at every valid sample but each track's last one (segment-local
    index last_step), which gets the reference's linear edge extrapolation
    (util/sphere.py:66-69).  pos_before / pos_after ([2, N] lon/lat) are
    the samples neighbouring a segment's first / last row."""
    if lon.is_cuda:
        kernels.PLAIN_ON_CUDA['vmax'] += 1
    if pos_before is None:
        lon_b = torch.cat([(2 * lon[0] - lon[1])[None], lon[:-1]])
        lat_b = torch.cat([(2 * lat[0] - lat[1])[None], lat[:-1]])
    else:
        lon_b = torch.cat([pos_before[0][None], lon[:-1]])
        lat_b = torch.cat([pos_before[1][None], lat[:-1]])
    after = (lon[-1], lat[-1]) if pos_after is None else pos_after
    lon_a = torch.cat([lon[1:], after[0][None]])
    lat_a = torch.cat([lat[1:], after[1][None]])
    ut, vt = _translation_tm(lon, lat, lon_b, lat_b, lon_a, lat_a, dt_track)

    # the last valid sample L: next position pos[L] + (pos[L] - pos[L-1])
    L = last_step
    Lm1 = torch.clamp_min(L - 1, 0)
    lon_L, lat_L = _take_rows(lon, L), _take_rows(lat, L)
    lon_P, lat_P = _take_rows(lon, Lm1), _take_rows(lat, Lm1)
    if pos_before is not None:
        lon_P = torch.where(L == 0, pos_before[0], lon_P)
        lat_P = torch.where(L == 0, pos_before[1], lat_P)
    ut_L, vt_L = _translation_tm(lon_L, lat_L, lon_P, lat_P,
                                 lon_L + (lon_L - lon_P),
                                 lat_L + (lat_L - lat_P), dt_track)
    rows = torch.arange(lon.shape[0], device=lon.device)
    at_L = rows[:, None] == L[None, :]
    ut = torch.where(at_L, ut_L[None, :], ut)
    vt = torch.where(at_L, vt_L[None, :], vt)

    vmax = vmax_step(cfg, lat, tc_v, env_wnds, ut, vt)
    peak = torch.where(alive, vmax, -math.inf).amax(dim=0)
    return vmax, peak


def axi_to_max_wind_raw(lon, lat, dt_track, tc_v, env_wnds, alive,
                        last_step, cfg=None, pos_before=None,
                        pos_after=None):
    """axi_to_max_wind_raw_plain on CPU tensors; on any other device the
    Triton vmax kernel, which raises on what it does not take."""
    if lon.device.type == 'cpu':
        return axi_to_max_wind_raw_plain(lon, lat, dt_track, tc_v, env_wnds,
                                         alive, last_step, cfg, pos_before,
                                         pos_after)
    return vmax_kernel.axi_to_max_wind_raw_triton(
        lon, lat, dt_track, tc_v, env_wnds, alive, last_step,
        _shear_channels(cfg), pos_before, pos_after)
