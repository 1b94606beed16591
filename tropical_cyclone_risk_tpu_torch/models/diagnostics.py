"""Track diagnostics: azimuthal -> maximum wind conversion (twin of
tropical_cyclone_risk_tpu/models/diagnostics.py).

``axi_to_max_wind``, ``_extrapolate_nan_tail`` and ``vmax_filter`` are the
per-track API of one-shot callers, in plain torch.  ``axi_to_max_wind_raw``
is the launch's vmax pass and runs over every launch row; with the in-scan
vmax (Namelist.vmax_in_scan) ``fix_in_scan`` re-derives each track's final
sample instead, over every segment of the launch, and banks it into the
lifetime peak (``fix_last_sample`` on one segment).  On a CUDA tensor each
launches its entry of csrc/vmax.cu (kernels/vmax.py); on a CPU tensor it
runs its ``*_plain`` twin, the same arithmetic in torch ops.
"""

from __future__ import annotations

import math

import torch

from tropical_cyclone_risk_tpu_torch import constants
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import vmax as vmax_kernel
from tropical_cyclone_risk_tpu_torch.models.fast import deep_layer_indices
from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
from tropical_cyclone_risk_tpu_torch.ops import sphere

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


def _extrapolate_nan_tail(x):
    """Replace the NaN tail of each track (last axis) with linear
    extrapolation from the last two valid samples: the reference's edge
    handling (util/sphere.py:66-69), which NaN-padded buffers would
    otherwise turn into a NaN speed at each track's final valid sample.
    A loop over time, step for step the JAX package's scan."""
    prev, delta = x[..., 0], torch.zeros_like(x[..., 0])
    out = []
    for t in range(x.shape[-1]):
        xt = x[..., t]
        bad = torch.isnan(xt)
        cur = torch.where(bad, prev + delta, xt)
        delta = torch.where(bad, delta, cur - prev)
        prev = cur
        out.append(cur)
    return torch.stack(out, dim=-1)


def axi_to_max_wind(track_lon, track_lat, dt_track, tc_v, env_wnds,
                    cfg=None):
    """Maximum wind from azimuthal wind + translation + shear asymmetries
    (wind/tc_wind.py:6-21) over NaN-padded track buffers.

    track_lon/lat/tc_v: [..., T]; env_wnds: [..., T, W] in (u_l1, v_l1,
    u_l2, v_l2, ...) channel order; cfg resolves which channels are the
    250/850 hPa shear layers (default: the two-level layout).  NaN samples
    beyond a track's death yield NaN vmax; the final valid sample gets the
    reference's edge extrapolation rather than NaN."""
    pos = _extrapolate_nan_tail(torch.stack([track_lon, track_lat]))
    utran, vtran = sphere.translational_speed(pos[0], pos[1], dt_track)
    return vmax_step(cfg, track_lat, tc_v, env_wnds, utran, vtran)


def vmax_filter(cfg, vmax):
    """Lifetime-max filter (util/compute.py:205): keep where the NaN-aware
    maximum over the last axis reaches seed_vmax_threshold_ms."""
    peak = torch.where(torch.isnan(vmax), -math.inf, vmax).amax(dim=-1)
    return peak >= cfg.seed_vmax_threshold_ms


def _take_rows(x, i):
    """x[i[n], n] for each column n, with i clipped to the row range."""
    return torch.gather(x, 0, i.clamp(0, x.shape[0] - 1)[None, :])[0]


def _last_sample(lon, lat, tc_v, env_wnds, last_step, dt_s, cfg,
                 pos_before):
    """(vmax, clipped row) of each track's sample L = last_step with the
    reference's linear edge extrapolation: next position pos[L] + (pos[L]
    - pos[L-1]), pos[L-1] being pos_before's sample where L is 0."""
    L = last_step
    lon_L, lat_L = _take_rows(lon, L), _take_rows(lat, L)
    Lm1 = L - 1
    lon_P, lat_P = _take_rows(lon, Lm1), _take_rows(lat, Lm1)
    if pos_before is not None:
        lon_P = torch.where(L == 0, pos_before[0], lon_P)
        lat_P = torch.where(L == 0, pos_before[1], lat_P)
    ut, vt = _translation_tm(lon_L, lat_L, lon_P, lat_P,
                             lon_L + (lon_L - lon_P),
                             lat_L + (lat_L - lat_P), dt_s)
    Lc = L.clamp(0, lon.shape[0] - 1)
    wnds_L = torch.gather(env_wnds, 0, Lc[None, :, None].expand(
        1, -1, env_wnds.shape[-1]))[0]
    return vmax_step(cfg, lat_L, _take_rows(tc_v, L), wnds_L, ut, vt), Lc


def fix_last_sample_plain(vmax_tm, lon, lat, tc_v, env_wnds, alive,
                          last_step, dt_s, cfg=None, pos_before=None):
    """The reference's edge extrapolation at each track's final valid
    sample of an in-scan vmax buffer [T, N] (segment-local last_step; a
    value outside [0, T) means the track ends in another segment, and its
    column is left as it is).  The in-scan value there used the real next
    position; the reference's valid window ends at L, so its centred
    difference extrapolates (util/sphere.py:66-69).  Returns (vmax fixed,
    vmax_L [N], ok [N]), ok flagging the tracks whose final sample is in
    this segment (their vmax_L joins the lifetime peak)."""
    if lon.is_cuda:
        kernels.PLAIN_ON_CUDA['vmax_last'] += 1
    T = lon.shape[0]
    vmax_L, Lc = _last_sample(lon, lat, tc_v, env_wnds, last_step, dt_s, cfg,
                              pos_before)
    ok = (last_step >= 0) & (last_step < T) & _take_rows(alive, last_step)
    cols = torch.arange(lon.shape[1], device=lon.device)
    fixed = vmax_tm.clone()
    fixed[Lc, cols] = torch.where(ok, vmax_L, vmax_tm[Lc, cols])
    return fixed, vmax_L, ok


def fix_last_sample(vmax_tm, lon, lat, tc_v, env_wnds, alive, last_step,
                    dt_s, cfg=None, pos_before=None):
    """fix_last_sample_plain on CPU tensors; on any other device K2's
    last-sample entry on this one segment, which writes the fixed samples
    into vmax_tm in place and returns it."""
    if lon.device.type == 'cpu':
        return fix_last_sample_plain(vmax_tm, lon, lat, tc_v, env_wnds,
                                     alive, last_step, dt_s, cfg, pos_before)
    return vmax_kernel.fix_last_sample_cuda(
        vmax_tm, lon, lat, tc_v, env_wnds, alive, last_step, dt_s,
        _shear_channels(cfg), pos_before)


def bank_peak(peak, values, a_idx):
    """max(peak, values) on the m axis: values [w] of a segment whose
    slots a_idx [w] (injective; None for the m axis itself) are on it
    (jnp's .at[a_idx].max)."""
    if a_idx is None:
        return torch.maximum(peak, values)
    return torch.maximum(peak, compact_ops.scatter_fill(
        peak.shape[0], a_idx, values, -math.inf))


def fix_in_scan_plain(raws, edges, a_idxs, orders, last_step, peak, dt_s,
                      cfg=None):
    """The in-scan launch's last-sample fix (JAX models/pipeline.py:515-535
    with use_diag): for each segment k, fix_last_sample_plain at its
    segment-local last steps last_step[a_idxs[k-1]] - edges[k], with the
    previous segment's last row gathered by orders[k-1] as pos_before,
    and bank_peak of where(ok, vmax_L, -inf) into peak.  raws: per segment
    its time-major dict ('lon', 'lat', 'v', 'wnds', 'alive', 'vmax');
    a_idxs / orders: per later segment its slot map and its boundary's
    order.  Returns (the fixed vmax buffers, the banked peak)."""
    fixed = []
    for k, r in enumerate(raws):
        a_prev = a_idxs[k - 1] if k else None
        ls_k, pos_before = last_step, None
        if k:
            ls_k = last_step[a_prev] - edges[k]
            prev = raws[k - 1]
            pos_before = torch.stack([prev['lon'][-1][orders[k - 1]],
                                      prev['lat'][-1][orders[k - 1]]])
        vmax_k, vmax_L, ok = fix_last_sample_plain(
            r['vmax'], r['lon'], r['lat'], r['v'], r['wnds'], r['alive'],
            ls_k, dt_s, cfg, pos_before)
        peak = bank_peak(peak, torch.where(ok, vmax_L, -math.inf), a_prev)
        fixed.append(vmax_k)
    return tuple(fixed), peak


def fix_in_scan(raws, edges, a_idxs, orders, last_step, peak, dt_s,
                cfg=None):
    """fix_in_scan_plain on CPU tensors; on any other device K2's
    last-sample entry in one launch over every segment, which fixes each
    segment's vmax buffer and the peak in place (the launch's own
    buffers) and returns them."""
    if last_step.device.type == 'cpu':
        return fix_in_scan_plain(raws, edges, a_idxs, orders, last_step,
                                 peak, dt_s, cfg)
    return vmax_kernel.fix_in_scan_cuda(
        in_scan_segments(raws, edges, a_idxs, orders), last_step, peak,
        dt_s, _shear_channels(cfg))


def in_scan_segments(raws, edges, a_idxs, orders):
    """The segment table of K2's last-sample entry (kernels/vmax.py
    last_launcher) for fix_in_scan's arguments: each segment's buffers and
    edge, and after segment 0 its slot map, its boundary's order and the
    previous segment's last row."""
    segs = []
    for k, r in enumerate(raws):
        seg = {name: r[name] for name in ('lon', 'lat', 'v', 'wnds',
                                          'alive', 'vmax')}
        seg['edge'] = edges[k]
        if k:
            seg.update(a_idx=a_idxs[k - 1], order=orders[k - 1],
                       before_lon=raws[k - 1]['lon'][-1],
                       before_lat=raws[k - 1]['lat'][-1])
        segs.append(seg)
    return segs


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
    vmax = vmax_step(cfg, lat, tc_v, env_wnds, ut, vt)
    # the last valid sample L takes the edge extrapolation
    vmax_L, _ = _last_sample(lon, lat, tc_v, env_wnds, last_step, dt_track,
                             cfg, pos_before)
    rows = torch.arange(lon.shape[0], device=lon.device)
    vmax = torch.where(rows[:, None] == last_step[None, :], vmax_L[None, :],
                       vmax)
    peak = torch.where(alive, vmax, -math.inf).amax(dim=0)
    return vmax, peak


def axi_to_max_wind_raw(lon, lat, dt_track, tc_v, env_wnds, alive,
                        last_step, cfg=None, pos_before=None,
                        pos_after=None):
    """axi_to_max_wind_raw_plain on CPU tensors; on any other device the
    CUDA vmax kernel, which raises on what it does not take."""
    if lon.device.type == 'cpu':
        return axi_to_max_wind_raw_plain(lon, lat, dt_track, tc_v, env_wnds,
                                         alive, last_step, cfg, pos_before,
                                         pos_after)
    return vmax_kernel.axi_to_max_wind_raw_cuda(
        lon, lat, dt_track, tc_v, env_wnds, alive, last_step,
        _shear_channels(cfg), pos_before, pos_after)
