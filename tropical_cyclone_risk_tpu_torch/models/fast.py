"""Coupled FAST intensity + intensity-dependent beta-advection RHS (twin of
tropical_cyclone_risk_tpu/models/fast.py).

State layout: y = (lon, lat, v, m), batched [N].  Each expression keeps the
JAX package's operation order, so the float32 results differ from it only
where XLA on the CPU contracts a*b+c into a fused multiply-add or its
transcendental functions round differently.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from tropical_cyclone_risk_tpu_torch import constants
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fields as F
from tropical_cyclone_risk_tpu_torch.ops import chol, interp
from tropical_cyclone_risk_tpu_torch.ops.fourier import FourierSeries

# FAST dimensionless constants (intensity/coupled_fast.py:25-27)
EPSILON = 0.33
KAPPA = 0.1
BETA = 1.0 - EPSILON - KAPPA

MS_TO_KTS = 1.94384
DEG2RAD = math.pi / 180.0
RAD_PER_M = 180.0 / math.pi / constants.earth_R   # degrees per metre


class SeedParams(NamedTuple):
    """Per-seed static-through-time parameters of one integration batch."""
    plane: torch.Tensor     # [N] int: (year, month) plane in the FieldPack
    h_bl: torch.Tensor      # [N] boundary-layer depth (basin-dependent)
    fourier: FourierSeries  # A/B: [N, W, n_fourier]


class State(NamedTuple):
    lon: torch.Tensor
    lat: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor


def steering_coefs(cfg: Namelist, v):
    """Intensity-dependent steering weights, clipped
    (coupled_fast.py:183-192).  Returns [N, L]."""
    if cfg.coupled_track:
        t = lambda x: torch.tensor(x, dtype=v.dtype, device=v.device)
        y_a = t(cfg.y_alpha)
        a = (v[:, None] * MS_TO_KTS) * t(cfg.m_alpha) + y_a
        a = torch.clamp(a, t(cfg.alpha_min), t(cfg.alpha_max))
        return torch.where(torch.isnan(a), y_a, a)
    coefs = torch.tensor(cfg.steering_coefs, dtype=v.dtype, device=v.device)
    return coefs.expand(v.shape + coefs.shape)


def color_winds_given_f(cfg: Namelist, stats, f):
    """Environmental winds from gathered wind statistics [N, W + W(W+1)/2]
    and a Fourier sample f [N, W]: monthly mean + Cholesky-colored flow
    (track/bam_track.py:116-128); non-PD covariance -> zero winds."""
    W = cfg.n_wind_levels
    L, ok = chol.cholesky_unrolled(chol.lower_tri_to_full(stats[:, W:], W))
    col = L[:, :, 0] * f[:, None, 0]
    for j in range(1, W):
        col = col + L[:, :, j] * f[:, None, j]
    return torch.where(ok[:, None], stats[:, :W] + col, 0.0)


def color_winds(cfg: Namelist, stats, fourier: FourierSeries, t: float):
    """color_winds_given_f with F(t) evaluated analytically at t."""
    return color_winds_given_f(cfg, stats, fourier.evaluate(t))


def sample_env_winds(pack: F.FieldPack, cfg: Namelist, lon, lat, plane,
                     fourier: FourierSeries, t: float):
    """Winds [N, W] at (lon, lat) on each storm's plane and track time t,
    gathered from the pack directly (one-shot callers such as the
    uncoupled BAM, models/bam.py; the integration loop gathers through the
    fused stacks instead)."""
    stats = interp.bilinear(pack.wind, pack.grid, lon, lat, plane)
    return color_winds(cfg, stats, fourier, t)


def deep_layer_indices(cfg: Namelist):
    """Channel indices (iu250, iv250, iu850, iv850) of the deep-layer shear
    components in the (u_l1, v_l1, u_l2, v_l2, ...) wind vector."""
    levels = list(cfg.steering_levels)
    if 250 not in levels or 850 not in levels:
        raise ValueError('deep-layer shear needs 250 and 850 hPa among '
                         f'steering_levels, got {levels}')
    i250 = levels.index(250)
    i850 = levels.index(850)
    return 2 * i250, 2 * i250 + 1, 2 * i850, 2 * i850 + 1


def shear_magnitude(cfg: Namelist, wnds):
    """250-850 hPa shear magnitude (coupled_fast.py:115-122)."""
    iu2, iv2, iu8, iv8 = deep_layer_indices(cfg)
    u_shr = wnds[:, iu2] - wnds[:, iu8]
    v_shr = wnds[:, iv2] - wnds[:, iv8]
    return torch.sqrt(u_shr * u_shr + v_shr * v_shr)


def _is_land(land_val):
    # interpolated land fraction == 1 up to the last float32 ulp
    return land_val >= 1.0 - 1e-5


class FieldSample(NamedTuple):
    """Per-seed field values gathered at one position."""
    wind_stats: torch.Tensor   # [N, W + W(W+1)/2]
    env: torch.Tensor          # [N, N_ENV]
    land: torch.Tensor         # [N]
    bathy: torch.Tensor        # [N]


class DerivedSample(NamedTuple):
    """Stage-independent derivations of one FieldSample, hoisted out of the
    per-RK-stage RHS (z_fac keeps ocean_alpha's multiplication order)."""
    z_fac: torch.Tensor        # [N] 0.01 * t_strat^-0.4 * h_m
    v_pot: torch.Tensor        # [N] land-zeroed potential intensity
    no_mixing: torch.Tensor    # [N] bool: alpha = 1 (land/shallow/unstrat)


def derive_sample(cfg: Namelist, smp: FieldSample) -> DerivedSample:
    env = smp.env
    h_m = env[:, F.MLD]
    t_strat = env[:, F.STRAT]
    v_pot = torch.where(_is_land(smp.land), 0.0, env[:, F.VPOT])
    no_mixing = (smp.bathy >= 0) | (-h_m <= smp.bathy) | (t_strat == 0)
    return DerivedSample(0.01 * t_strat ** -0.4 * h_m, v_pot, no_mixing)


def ocean_alpha(cfg: Namelist, env, land_val, bathy_val, u_T, v, drv=None):
    """Ocean feedback parameter alpha (coupled_fast.py:65-94): 1 over land /
    shallow / unstratified water, else 1 - 0.87 exp(-z) with
    z = 0.01 strat^-0.4 h_m u_T v_pot / v."""
    if drv is None:
        drv = derive_sample(cfg, FieldSample(None, env, land_val, bathy_val))
    z = drv.z_fac * u_T * drv.v_pot / v
    fac = torch.exp(-torch.clamp(z, 0.0, 100.0))
    return torch.where(drv.no_mixing, 1.0, 1.0 - 0.87 * fac), drv.v_pot


def sample_fields(stacks: F.GatherStacks, lon, lat, plane) -> FieldSample:
    """All field gathers for one batch position: one corner-packed row per
    seed when land/bathy share the atmospheric grid, two otherwise."""
    cell = interp.bilinear_packed(stacks.cell4, stacks.grid, lon, lat, plane)
    nw = stacks.n_wind_ch
    if stacks.geo_in_cell:
        return FieldSample(cell[:, :nw], cell[:, nw:-2], cell[:, -2],
                           cell[:, -1])
    geo = interp.bilinear_packed(stacks.land_geo4, stacks.land_grid,
                                 lon, lat)
    if stacks.fused_geo:
        bathy = geo[:, 1]
    else:
        bathy = interp.bilinear_packed(stacks.bathy4, stacks.bathy_grid,
                                       lon, lat)[:, 0]
    return FieldSample(cell[:, :nw], cell[:, nw:], geo[:, 0], bathy)


SECONDS_PER_MONTH = 30.44 * 86400.0     # mean month, plane-interp time axis


def sample_fields_at_time(stacks: F.GatherStacks, cfg: Namelist, lon, lat,
                          plane, t) -> FieldSample:
    """Field sample at track time t (seconds, a float),
    with linear time interpolation between monthly planes when
    cfg.time_interp_fields: genesis sits on the seed month's plane p and
    the sample blends toward p+1 (the last plane holds) as the track ages,
    tau = clip(t / SECONDS_PER_MONTH, 0, 1) as a true division."""
    if not cfg.time_interp_fields:
        return sample_fields(stacks, lon, lat, plane)
    n_planes = stacks.cell4.shape[0]
    t = torch.full((), t, dtype=torch.float32, device=lon.device)
    tau = torch.clamp(interp.true_div(t, SECONDS_PER_MONTH), 0.0, 1.0)
    p1 = torch.clamp_max(plane + 1, n_planes - 1)
    s0 = sample_fields(stacks, lon, lat, plane)
    if stacks.geo_in_cell:
        s1 = sample_fields(stacks, lon, lat, p1)
    else:
        # land/bathy are plane-independent: only the cell row is re-read
        cell = interp.bilinear_packed(stacks.cell4, stacks.grid, lon, lat,
                                      p1)
        nw = stacks.n_wind_ch
        s1 = FieldSample(cell[:, :nw], cell[:, nw:], s0.land, s0.bathy)
    return FieldSample(*(a + tau * (b - a) for a, b in zip(s0, s1)))


def bam_velocity(cfg: Namelist, lat, v, wnds_raw):
    """Beta-advection velocity with the polar hard stop
    (track/bam_track.py:131-144).  Returns (u_bam, v_bam, wnds)."""
    polar = torch.abs(lat) >= 80.0
    wnds = torch.where(polar[:, None], 0.0, wnds_raw)
    coefs = steering_coefs(cfg, v)
    w_lat = torch.cos(lat * DEG2RAD)
    # the levels summed in order, as the integrator kernel adds them
    u_steer = wnds[:, 0] * coefs[:, 0]
    v_steer = wnds[:, 1] * coefs[:, 0]
    for lv in range(1, coefs.shape[1]):
        u_steer = u_steer + wnds[:, 2 * lv] * coefs[:, lv]
        v_steer = v_steer + wnds[:, 2 * lv + 1] * coefs[:, lv]
    u_bam = torch.where(polar, 0.0, u_steer + cfg.u_beta * w_lat)
    v_bam = torch.where(polar, 0.0,
                        v_steer + torch.sign(lat) * cfg.v_beta * w_lat)
    return u_bam, v_bam, wnds


def rhs_given_winds(cfg: Namelist, y: State, params: SeedParams,
                    smp: FieldSample, wnds_raw, drv=None
                    ) -> Tuple[State, torch.Tensor]:
    """Coupled tendency (coupled_fast.py:196-207) given gathered fields and
    colored winds.  Returns (dy/dt as a State, polar-zeroed winds)."""
    lon, lat, v, m = y
    env = smp.env
    u_bam, v_bam, wnds = bam_velocity(cfg, lat, v, wnds_raw)
    u_T = torch.sqrt(u_bam * u_bam + v_bam * v_bam)
    alpha, v_pot = ocean_alpha(cfg, env, smp.land, smp.bathy, u_T, v, drv)
    gamma = EPSILON + alpha * KAPPA

    # a true division: torch evaluates `scalar / tensor` as
    # reciprocal(tensor) * scalar, which rounds differently
    ck_2h = torch.full_like(params.h_bl, 0.5 * cfg.Ck) / params.h_bl
    m3 = m * (m * m)
    dvdt = ck_2h * (alpha * BETA * (v_pot * v_pot) * m3
                    - (1 - gamma * m3) * (v * v))
    dvdt = torch.nan_to_num(dvdt)          # coupled_fast.py:150

    venti = shear_magnitude(cfg, wnds) * env[:, F.CHI]
    dmdt = ck_2h * ((1 - m) * v - venti * m)

    dlon = u_bam * RAD_PER_M / torch.cos(lat * DEG2RAD)
    dlat = v_bam * RAD_PER_M
    if cfg.debug_fixed_position:
        dlon = torch.zeros_like(dlon)
        dlat = torch.zeros_like(dlat)
    return State(dlon, dlat, dvdt, dmdt), wnds


def rhs_from_sample(cfg: Namelist, t: float, y: State, params: SeedParams,
                    smp: FieldSample) -> Tuple[State, torch.Tensor]:
    """Coupled tendency with the winds colored at time t (the exact
    per-stage form; the default integrator colors once per step)."""
    wnds = color_winds_given_f(cfg, smp.wind_stats,
                               params.fourier.evaluate_in_order(t))
    return rhs_given_winds(cfg, y, params, smp, wnds)


def rhs(stacks: F.GatherStacks, cfg: Namelist, t: float, y: State,
        params: SeedParams) -> Tuple[State, torch.Tensor]:
    """Full coupled tendency: gather at y's position and track time t, then
    the dynamics.  Returns (dy/dt as a State, polar-zeroed winds)."""
    smp = sample_fields_at_time(stacks, cfg, y.lon, y.lat, params.plane, t)
    return rhs_from_sample(cfg, t, y, params, smp)


def _cbrt(x):
    """Real cube root (torch has none): |x|^(1/3) in float64, rounded to
    x's type, with x's sign."""
    return torch.sign(x) * (x.abs().double() ** (1.0 / 3.0)).to(x.dtype)


def init_m_dvdt0(pack: F.FieldPack, cfg: Namelist, lon, lat, v,
                 params: SeedParams, dvdt: float = 0.0):
    """m initialization by dv/dt = dvdt inversion (coupled_fast.py:152-167),
    cfg.m_init_mode='dvdt0':

        m = clip(cbrt((2 h_bl/Ck dvdt + v^2)
                      / (alpha beta vpot_5^2 + gamma v^2)), 0, 1)

    with vpot_5 the max of the (land-zeroed) potential intensity over the
    seed point and the four (+/-0.25 deg, +/-0.25 deg) corners, and alpha
    evaluated with the BAM translation speed at t=0.  Batched [N]; gathers
    from the pack directly (it runs once per launch)."""
    stats = interp.bilinear(pack.wind, pack.grid, lon, lat, params.plane)
    wnds = color_winds(cfg, stats, params.fourier, 0.0)
    u_bam, v_bam, _ = bam_velocity(cfg, lat, v, wnds)
    u_T = torch.sqrt(u_bam * u_bam + v_bam * v_bam)

    def vpot_at(lo, la):
        env = interp.bilinear(pack.env, pack.grid, lo, la, params.plane)
        land = interp.bilinear_scalar(pack.land, pack.land_grid, lo, la)
        return torch.where(_is_land(land), 0.0, env[:, F.VPOT])

    vpot5 = vpot_at(lon, lat)
    for dx, dy in ((-0.25, -0.25), (-0.25, 0.25), (0.25, -0.25),
                   (0.25, 0.25)):
        vpot5 = torch.maximum(vpot5, vpot_at(lon + dx, lat + dy))

    env_c = interp.bilinear(pack.env, pack.grid, lon, lat, params.plane)
    land_c = interp.bilinear_scalar(pack.land, pack.land_grid, lon, lat)
    bathy_c = interp.bilinear_scalar(pack.bathy, pack.bathy_grid, lon, lat)
    alpha, _ = ocean_alpha(cfg, env_c, land_c, bathy_c, u_T, v)
    gamma = EPSILON + alpha * KAPPA

    numer = interp.true_div(2.0 * params.h_bl, cfg.Ck) * dvdt + v * v
    denom = alpha * BETA * (vpot5 * vpot5) + gamma * (v * v)
    return torch.clamp(_cbrt(numer / denom), 0.0, 1.0)


def ventilation_index_reject(stacks: F.GatherStacks, cfg: Namelist,
                             y0: State, params: SeedParams):
    """Genesis gate: reject when S * chi / v_pot >= 1 at t=0 with v_pot > 0
    (coupled_fast.py:237-244).  Returns a boolean keep-mask [N].  F(0) is
    the index-ordered sum of the B components (the genesis gate kernel,
    csrc/integrator.cu genesis_gate_kernel, adds them in that order)."""
    smp = sample_fields(stacks, y0.lon, y0.lat, params.plane)
    wnds = color_winds_given_f(cfg, smp.wind_stats,
                               params.fourier.evaluate_at_zero())
    v_pot = torch.where(_is_land(smp.land), 0.0, smp.env[:, F.VPOT])
    vent = shear_magnitude(cfg, wnds) * smp.env[:, F.CHI] / v_pot
    return ~((v_pot > 0) & (vent >= 1.0))
