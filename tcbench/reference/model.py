"""The plain reference of one seed batch: seeding, the genesis gate, the
coupled integration, the vmax diagnostic and the TC filters, in plain torch
operations at the configuration's precision.

It follows the model of Lin et al. (coupled FAST intensity with
intensity-dependent beta-advection steering, util/compute.py of the
reference implementation) in the float32 operation order that the JAX
package fixed: every expression below rounds as that order does, so on the
same inputs it gives the same tracks as any implementation that keeps it.
It reads only the environment the benchmark made (tcbench/pack.py) and the
configuration file; it computes everything else itself, at the slots it is
asked about, without a compaction, a cap or a stack.

``dtype`` is float32 for the reference; the control runs it in bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tcbench import pack as pack_mod
from tcbench.reference import rng

R_ROUNDS = 16          # proposal rounds per slot
MASK_PASS = 1e-2       # a proposal lands on the run mask
BASIN_MIN = 1e-3       # the largest basin-mask value assigns a basin
LAT_VORT_SCALE = 12.0  # equatorward rejection: (|lat| - fac) / 12 degrees
VPOT_GATE = 35.0       # potential-intensity gate (m/s)
N_FOURIER = 15

EPSILON = 0.33
KAPPA = 0.1
BETA = 1.0 - EPSILON - KAPPA
MS_TO_KTS = 1.94384
DEG2RAD = math.pi / 180.0
EARTH_R = 6.3781e6
RAD_PER_M = 180.0 / math.pi / EARTH_R
KM2 = EARTH_R / 1000.0 * 2


class Model(NamedTuple):
    """What a batch needs of the configuration, resolved once."""
    cfg: dict
    nl: dict
    W: int
    shear: tuple          # channels (u250, v250, u850, v850)
    bounds: tuple         # run basin (lon_min, lat_min, lon_max, lat_max)
    basins: tuple
    T: int                # output samples a track
    dt: float
    stride: int
    dtype: torch.dtype


def model(cfg: dict, dtype=torch.float32) -> Model:
    nl = cfg['namelist']
    levels = list(nl['steering_levels'])
    i2, i8 = levels.index(250), levels.index(850)
    T = int(nl['total_track_time_days'] * 86400 / nl['output_interval_s']) + 1
    return Model(cfg, nl, 2 * len(levels),
                 (2 * i2, 2 * i2 + 1, 2 * i8, 2 * i8 + 1),
                 pack_mod.basin_bounds(cfg, cfg['basin']),
                 pack_mod.basin_ids(cfg), T, float(nl['output_interval_s']),
                 max(1, int(nl['field_sample_stride'])), dtype)


# ---- interpolation ---------------------------------------------------------

def true_div(x, c: float):
    """x / c rounded as one division (not x times 1/c)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _cell_weight(x, x0: float, dx: float, n: int):
    u = torch.clamp(true_div(x - x0, dx), 0.0, n - 1.0)
    i = torch.nan_to_num(torch.clamp(torch.floor(u), 0, n - 2)).to(
        torch.int64)
    return i, u - i.to(u.dtype)


def cell_index(grid, lon, lat, plane=None):
    """The flat index of each query's lower-left cell."""
    lon0, dlon, nlon, lat0, dlat, nlat = grid
    ix, _ = _cell_weight(lon, lon0, dlon, nlon)
    iy, _ = _cell_weight(lat, lat0, dlat, nlat)
    base = iy * nlon + ix
    return base if plane is None else base + plane * (nlat * nlon)


def bilinear(field, grid, lon, lat, plane=None):
    """field [(P,) nlat, nlon, C] at the queries -> [N, C]: bilinear with
    the query clamped to the grid."""
    lon0, dlon, nlon, lat0, dlat, nlat = grid
    ix, wx = _cell_weight(lon, lon0, dlon, nlon)
    iy, wy = _cell_weight(lat, lat0, dlat, nlat)
    base = iy * nlon + ix
    if plane is not None:
        base = base + plane * (nlat * nlon)
    flat = field.reshape(-1, field.shape[-1])
    wx, wy = wx[:, None], wy[:, None]
    return ((1 - wy) * ((1 - wx) * flat[base] + wx * flat[base + 1])
            + wy * ((1 - wx) * flat[base + nlon] + wx * flat[base + nlon + 1]))


# ---- seeding ---------------------------------------------------------------

def _sin_deg(x: float) -> float:
    return float(torch.sin(torch.tensor([x], dtype=torch.float32)
                           * (math.pi / 180.0))[0])


class Seeds(NamedTuple):
    lon: torch.Tensor
    lat: torch.Tensor
    month: torch.Tensor       # int32 1..12
    basin_idx: torch.Tensor   # int64
    counted: torch.Tensor
    integrate: torch.Tensor
    v_init: torch.Tensor
    m_init: torch.Tensor
    h_bl: torch.Tensor
    plane: torch.Tensor       # int64 plane of the year's twelve


def propose(md: Model, pk: dict, key: rng.Key, n: int) -> Seeds:
    """n seed proposals of one batch key on the year's twelve planes."""
    nl, dt = md.nl, md.dtype
    dev = pk['env'].device
    b = pack_mod.basin_bounds(md.cfg, md.cfg['basin'])
    k_lon, k_lat0, k_latr, k_month, k_reject, k_vinit = rng.split(key, 6)
    lon_r = rng.uniform(k_lon, (R_ROUNDS, n), b[0], b[2], dev).to(dt)
    lat_lo = _sin_deg(3.0 if b[1] >= 0 else -45.0)
    lat_hi = _sin_deg(45.0 if b[3] >= 0 else -3.0)
    y = rng.uniform(k_lat0, (n,), lat_lo, lat_hi, dev).to(dt)
    lat_r = rng.uniform(k_latr, (R_ROUNDS, n), b[1], b[3], dev).to(dt)
    lat_r[0] = torch.asin(y) * (180.0 / math.pi)
    grid = pk['grid']
    run_mask = pk['run_mask'].to(dt)[..., None]
    passes = (bilinear(run_mask, grid, lon_r.reshape(-1), lat_r.reshape(-1))
              [:, 0].reshape(R_ROUNDS, n) >= MASK_PASS)
    first = torch.argmax(passes.to(torch.uint8), dim=0)
    any_pass = passes.any(dim=0)
    first = torch.where(any_pass, first, 0)
    lon = torch.gather(lon_r, 0, first[None])[0]
    lat = torch.gather(lat_r, 0, first[None])[0]

    month = rng.randint(k_month, (n,), 1, 13, dev)
    plane_raw = month.to(torch.int64) - 1     # start_month 1, 12 planes
    n_planes = pk['env'].shape[0]
    plane_ok = (plane_raw >= 0) & (plane_raw < n_planes)
    plane = torch.clamp(plane_raw, 0, n_planes - 1)

    basin_vals = bilinear(pk['basin_masks'].to(dt), grid, lon, lat)
    basin_max, basin_idx = torch.max(basin_vals, dim=1)
    basin_ok = basin_max > BASIN_MIN
    powers = torch.tensor([nl['lat_vort_power'][x] for x in md.basins],
                          dtype=dt, device=dev)
    p_lat = torch.clamp(true_div(torch.abs(lat) - nl['lat_vort_fac'],
                                 LAT_VORT_SCALE), 0.0, 1.0) ** powers[basin_idx]
    u = rng.uniform(k_reject, (n,), device=dev).to(dt)
    counted = any_pass & basin_ok & (u < p_lat)

    env = bilinear(pk['env'].to(dt), grid, lon, lat, plane)
    integrate = counted & plane_ok & (env[:, pack_mod.VPOT] > VPOT_GATE)
    v_init = nl['seed_v_init_ms'] + rng.normal(k_vinit, (n,), dev).to(dt)
    rh = env[:, pack_mod.RH]
    den = 1.0 + torch.exp(-(rh - nl['m_init_mid']) * nl['m_init_slope'])
    m_init = torch.clamp_min(torch.full_like(rh, nl['m_init_amp']) / den
                             + nl['m_init_base'], 0.0)
    h_bls = torch.tensor([nl['atm_bl_depth'][x] for x in md.basins],
                         dtype=dt, device=dev)
    return Seeds(lon, lat, month, basin_idx, counted, integrate, v_init,
                 m_init, h_bls[basin_idx], plane)


# ---- the Fourier flow ------------------------------------------------------

def amplitudes(device) -> torch.Tensor:
    """n^-1.5 sqrt(2 / sum n^-3), rounded on the CPU in float32."""
    n = torch.arange(1, N_FOURIER + 1, dtype=torch.float32)
    return (torch.sqrt(2.0 / torch.sum(n ** -3.0)) * n ** -1.5).to(device)


def fourier_rows(md: Model, key: rng.Key, n: int, rows: torch.Tensor):
    """(A, B) [k, W, 15] of the batch's draw of shape (n, W, 15) at the
    seed rows `rows`: phases uniform in [0, 1) cycles."""
    per = md.W * N_FOURIER
    idx = rows[:, None] * per + torch.arange(per, device=rows.device)
    phi = rng.scale(rng.unit_float(rng.bits_at(key, idx)), 0.0, 1.0)
    phi = phi.reshape(-1, md.W, N_FOURIER)
    amp = amplitudes(rows.device)
    A = amp * torch.cos(2 * math.pi * phi)
    B = amp * torch.sin(2 * math.pi * phi)
    return A.to(md.dtype), B.to(md.dtype)


def fourier_grid(md: Model, A, B) -> torch.Tensor:
    """F(t) at every output sample, [T, k, W]."""
    dev = A.device
    ks = torch.arange(md.T, dtype=torch.float32, device=dev)
    n = torch.arange(1, N_FOURIER + 1, dtype=torch.float32, device=dev)
    T_s = float(np.float32(md.nl['T_days'] * 86400.0))
    omega = true_div(2.0 * math.pi * n, T_s)
    phase = ((ks * md.dt)[:, None] * omega[None, :]).to(md.dtype)
    out = (torch.sin(phase) @ A.reshape(-1, N_FOURIER).T
           + torch.cos(phase) @ B.reshape(-1, N_FOURIER).T)
    return out.reshape(md.T, A.shape[0], md.W)


def fourier_at_zero(B) -> torch.Tensor:
    """F(0): the cosine coefficients summed in index order."""
    f0 = B[..., 0]
    for i in range(1, N_FOURIER):
        f0 = f0 + B[..., i]
    return f0


# ---- wind statistics -> environmental winds ---------------------------------

def cholesky(md: Model, tri: torch.Tensor):
    """Lower Cholesky factors [k, W, W] of the packed lower triangles
    [k, W(W+1)/2] (row-major: (0,0), (1,0), (1,1), ...), right-looking,
    each entry's updates in ascending column order; ok is False where a
    pivot is not strictly positive."""
    W = md.W
    i, j = np.tril_indices(W)
    full = np.zeros((W, W), np.int64)
    full[i, j] = np.arange(len(i))
    full[j, i] = full[i, j]
    A = tri[:, torch.as_tensor(full.reshape(-1), device=tri.device)].reshape(
        -1, W, W).clone()
    L = torch.zeros_like(A)
    ok = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
    for k in range(W):
        d = A[:, k, k]
        ok = ok & (d > 0)
        Lkk = torch.sqrt(torch.clamp_min(d, 1e-30))
        L[:, k, k] = Lkk
        if k + 1 < W:
            col = A[:, k + 1:, k] * (1.0 / Lkk)[:, None]
            L[:, k + 1:, k] = col
            A[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
    return L, ok


def color(md: Model, means, L, ok, f):
    """Monthly mean + Cholesky-coloured Fourier flow, zero where the
    covariance is not positive definite."""
    col = L[:, :, 0] * f[:, None, 0]
    for j in range(1, md.W):
        col = col + L[:, :, j] * f[:, None, j]
    return torch.where(ok[:, None], means + col, 0.0)


def shear(md: Model, w):
    iu2, iv2, iu8, iv8 = md.shear
    u = w[:, iu2] - w[:, iu8]
    v = w[:, iv2] - w[:, iv8]
    return torch.sqrt(u * u + v * v)


class Sample(NamedTuple):
    means: torch.Tensor
    L: torch.Tensor
    ok: torch.Tensor
    env: torch.Tensor
    land: torch.Tensor
    bathy: torch.Tensor


def sample(md: Model, pk: dict, lon, lat, plane) -> Sample:
    """Fields at the storms' positions on their planes, the covariance
    factored."""
    g, dt = pk['grid'], md.dtype
    stats = bilinear(pk['wind'], g, lon, lat, plane).to(dt)
    env = bilinear(pk['env'], g, lon, lat, plane).to(dt)
    geo = bilinear(pk['geo'], g, lon, lat).to(dt)
    L, ok = cholesky(md, stats[:, md.W:])
    return Sample(stats[:, :md.W], L, ok, env, geo[:, 0], geo[:, 1])


def v_pot(smp: Sample):
    return torch.where(smp.land >= 1.0 - 1e-5, 0.0, smp.env[:, pack_mod.VPOT])


def gate(md: Model, pk: dict, seeds: Seeds, rows, B):
    """The genesis gate at t = 0: reject where shear * chi / v_pot >= 1
    with v_pot > 0."""
    smp = sample(md, pk, seeds.lon[rows], seeds.lat[rows], seeds.plane[rows])
    w = color(md, smp.means, smp.L, smp.ok, fourier_at_zero(B))
    vp = v_pot(smp)
    vent = shear(md, w) * smp.env[:, pack_mod.CHI] / vp
    return ~((vp > 0) & (vent >= 1.0))


# ---- the coupled integration -----------------------------------------------

class Drv(NamedTuple):
    z_fac: torch.Tensor
    v_pot: torch.Tensor
    no_mixing: torch.Tensor
    chi: torch.Tensor


def derive(smp: Sample) -> Drv:
    h_m = smp.env[:, pack_mod.MLD]
    t_strat = smp.env[:, pack_mod.STRAT]
    no_mixing = (smp.bathy >= 0) | (-h_m <= smp.bathy) | (t_strat == 0)
    return Drv(0.01 * t_strat ** -0.4 * h_m, v_pot(smp), no_mixing,
               smp.env[:, pack_mod.CHI])


def rhs(md: Model, y, h_bl, drv: Drv, wnds_raw, coef_t):
    """dy/dt of (lon, lat, v, m) given the step's winds, and the winds
    zeroed poleward of 80 degrees."""
    lon, lat, v, m = y
    nl = md.nl
    m_alpha, y_alpha, a_min, a_max = coef_t
    polar = torch.abs(lat) >= 80.0
    wnds = torch.where(polar[:, None], 0.0, wnds_raw)
    a = (v[:, None] * MS_TO_KTS) * m_alpha + y_alpha
    a = torch.clamp(a, a_min, a_max)
    coefs = torch.where(torch.isnan(a), y_alpha, a)
    w_lat = torch.cos(lat * DEG2RAD)
    u_s = wnds[:, 0] * coefs[:, 0]
    v_s = wnds[:, 1] * coefs[:, 0]
    for lv in range(1, coefs.shape[1]):
        u_s = u_s + wnds[:, 2 * lv] * coefs[:, lv]
        v_s = v_s + wnds[:, 2 * lv + 1] * coefs[:, lv]
    u_bam = torch.where(polar, 0.0, u_s + nl['u_beta'] * w_lat)
    v_bam = torch.where(polar, 0.0,
                        v_s + torch.sign(lat) * nl['v_beta'] * w_lat)
    u_T = torch.sqrt(u_bam * u_bam + v_bam * v_bam)
    z = drv.z_fac * u_T * drv.v_pot / v
    fac = torch.exp(-torch.clamp(z, 0.0, 100.0))
    alpha = torch.where(drv.no_mixing, 1.0, 1.0 - 0.87 * fac)
    gamma = EPSILON + alpha * KAPPA
    ck_2h = torch.full_like(h_bl, 0.5 * nl['Ck']) / h_bl
    m3 = m * (m * m)
    dvdt = ck_2h * (alpha * BETA * (drv.v_pot * drv.v_pot) * m3
                    - (1 - gamma * m3) * (v * v))
    dvdt = torch.nan_to_num(dvdt)
    venti = shear(md, wnds) * drv.chi
    dmdt = ck_2h * ((1 - m) * v - venti * m)
    dlon = u_bam * RAD_PER_M / torch.cos(lat * DEG2RAD)
    dlat = v_bam * RAD_PER_M
    return (dlon, dlat, dvdt, dmdt), wnds


def rk4(md: Model, y, h_bl, drv, wnds, coef_t):
    """One classical RK4 step with the fields and winds frozen at the step
    start; returns (y1, the first stage's polar-zeroed winds)."""
    dt = md.dt
    f = lambda yy: rhs(md, yy, h_bl, drv, wnds, coef_t)
    add = lambda a, ka, h: tuple(x + h * dx for x, dx in zip(a, ka))
    k1, w0 = f(y)
    k2, _ = f(add(y, k1, dt / 2))
    k3, _ = f(add(y, k2, dt / 2))
    k4, _ = f(add(y, k3, dt))
    return tuple(x + dt / 6 * (a + 2 * b + 2 * c + d)
                 for x, a, b, c, d in zip(y, k1, k2, k3, k4)), w0


class Tracks(NamedTuple):
    """Time-major buffers [T, k] (winds [T, k, W]); past a storm's death
    they hold its frozen state."""
    lon: torch.Tensor
    lat: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    wnds: torch.Tensor
    alive: torch.Tensor
    cells: torch.Tensor     # [G, k] cell read at each gather, -1 if dead


def integrate(md: Model, pk: dict, seeds: Seeds, rows, A, B, alive0):
    """The storms of `rows` through the model's T output samples: hourly
    RK4 steps, fields gathered once per `stride` steps (and at each step of
    the remainder), winds coloured every step; a storm dies on leaving
    the basin shrunk by 1 degree, at |lat| <= 2 or at v <= 4 m/s, and
    freezes in place."""
    dt, T, dev = md.dtype, md.T, A.device
    nl = md.nl
    coef_t = tuple(torch.tensor(nl[k], dtype=dt, device=dev)
                   for k in ('m_alpha', 'y_alpha', 'alpha_min', 'alpha_max'))
    h_bl = seeds.h_bl[rows]
    plane = seeds.plane[rows]
    f_all = fourier_grid(md, A, B)
    y = (seeds.lon[rows], seeds.lat[rows], seeds.v_init[rows],
         seeds.m_init[rows])
    alive = alive0
    k = rows.shape[0]
    out = [torch.empty((T, k), dtype=dt, device=dev) for _ in range(4)]
    wout = torch.empty((T, k, md.W), dtype=dt, device=dev)
    aout = torch.empty((T, k), dtype=torch.bool, device=dev)
    n_blocks = T // md.stride if (md.stride > 1 and T >= md.stride) else 0
    lo0, la0, lo1, la1 = md.bounds
    cells = []
    for step in range(T):
        remainder = step >= n_blocks * md.stride
        if remainder or step % md.stride == 0:
            smp = sample(md, pk, y[0], y[1], plane)
            drv = derive(smp)
            cells.append(torch.where(alive, cell_index(pk['grid'], y[0], y[1],
                                                       plane), -1))
        wnds = color(md, smp.means, smp.L, smp.ok, f_all[step])
        y_next, w0 = rk4(md, y, h_bl, drv, wnds, coef_t)
        y1 = tuple(torch.where(alive, a, b) for a, b in zip(y_next, y))
        in_b = ((y1[0] > lo0 + 1.0) & (y1[0] < lo1 - 1.0)
                & (y1[1] > la0 + 1.0) & (y1[1] < la1 - 1.0))
        alive1 = alive & in_b & (torch.abs(y1[1]) > 2.0) & (y1[2] > 4.0)
        for o, x in zip(out, y):
            o[step] = x
        wout[step] = w0 if remainder else wnds
        aout[step] = alive
        y, alive = y1, alive1
    return Tracks(*out, wout, aout, torch.stack(cells))


# ---- diagnostics and filters -----------------------------------------------

def translation(lon, lat, lon_p, lat_p, lon_n, lat_n, dt_s):
    """Centred-difference translation speed (m/s)."""
    s = torch.cos(lat * DEG2RAD) * torch.abs(
        torch.sin((lon_p * DEG2RAD - lon_n * DEG2RAD) / 2))
    s2 = s * s
    hav_lon = KM2 * (s * (1.0 + s2 * (1.0 / 6.0 + s2 * (3.0 / 40.0))))
    hav_lat = KM2 * torch.abs((lat_p * DEG2RAD - lat_n * DEG2RAD) / 2)
    dlon = 0.5 * (torch.sign(lon_n - lon_p) * hav_lon)
    dlat = 0.5 * (torch.sign(lat_n - lat_p) * hav_lat)
    return dlon * 1000.0 / dt_s, dlat * 1000.0 / dt_s


def vmax_step(md: Model, lat, tc_v, wnds, ut, vt):
    iu2, iv2, iu8, iv8 = md.shear
    G = torch.clamp_max(0.8 + 0.35 * (1.0 + torch.tanh((lat - 35.0) / 10.0)),
                        1.0)
    u_shr = wnds[..., iu2] - wnds[..., iu8]
    v_shr = wnds[..., iv2] - wnds[..., iv8]
    U = G * ut + 0.1 * u_shr * tc_v / 15.0
    V = G * vt + 0.1 * v_shr * tc_v / 15.0
    return tc_v + torch.minimum(torch.sqrt(U * U + V * V), 0.5 * tc_v)


def _rows_at(x, i):
    return torch.gather(x, 0, i.clamp(0, x.shape[0] - 1)[None, :])[0]


def vmax(md: Model, tr: Tracks):
    """(vmax [T, k], alive-masked lifetime peak [k]): the maximum wind from
    the azimuthal wind, the translation and the shear; each track's last
    valid sample takes the linear edge extrapolation of its position."""
    lon, lat, v, wn = tr.lon, tr.lat, tr.v, tr.wnds
    last = torch.clamp_min(tr.alive.sum(dim=0) - 1, 0)
    lon_b = torch.cat([(2 * lon[0] - lon[1])[None], lon[:-1]])
    lat_b = torch.cat([(2 * lat[0] - lat[1])[None], lat[:-1]])
    lon_a = torch.cat([lon[1:], lon[-1:]])
    lat_a = torch.cat([lat[1:], lat[-1:]])
    ut, vt = translation(lon, lat, lon_b, lat_b, lon_a, lat_a, md.dt)
    vm = vmax_step(md, lat, v, wn, ut, vt)
    lon_L, lat_L = _rows_at(lon, last), _rows_at(lat, last)
    lon_P, lat_P = _rows_at(lon, last - 1), _rows_at(lat, last - 1)
    ut, vt = translation(lon_L, lat_L, lon_P, lat_P, lon_L + (lon_L - lon_P),
                         lat_L + (lat_L - lat_P), md.dt)
    w_L = torch.gather(wn, 0, last[None, :, None].expand(1, -1, md.W))[0]
    vm_L = vmax_step(md, lat_L, _rows_at(v, last), w_L, ut, vt)
    steps = torch.arange(lon.shape[0], device=lon.device)
    vm = torch.where(steps[:, None] == last[None, :], vm_L[None, :], vm)
    peak = torch.where(tr.alive, vm, -math.inf).amax(dim=0)
    return vm, peak


def keep(md: Model, tr: Tracks, peak):
    """The TC filters: seed_v_threshold reached while alive, v at two
    days (or at death) above the 2-day threshold, alive at genesis, and a
    lifetime vmax above seed_vmax_threshold."""
    nl = md.nl
    last = torch.clamp_min(tr.alive.sum(dim=0) - 1, 0)
    steps_2d = int(2 * 24 * 3600 / md.dt)
    v_2d = _rows_at(tr.v, torch.clamp_max(last, steps_2d))
    reached = (torch.where(tr.alive, tr.v, 0.0)
               >= nl['seed_v_threshold_ms']).any(dim=0)
    is_tc = reached & (v_2d >= nl['seed_v_2d_threshold_ms']) & tr.alive[0]
    return is_tc & (peak >= nl['seed_vmax_threshold_ms'])
