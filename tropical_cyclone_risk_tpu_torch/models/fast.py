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


def sample_fields_at_time(stacks: F.GatherStacks, cfg: Namelist, lon, lat,
                          plane, t) -> FieldSample:
    """Field sample at a track time.  Plane-to-plane time interpolation
    (cfg.time_interp_fields) is not ported yet."""
    if cfg.time_interp_fields:
        raise NotImplementedError('time_interp_fields is not ported yet')
    return sample_fields(stacks, lon, lat, plane)


def bam_velocity(cfg: Namelist, lat, v, wnds_raw):
    """Beta-advection velocity with the polar hard stop
    (track/bam_track.py:131-144).  Returns (u_bam, v_bam, wnds)."""
    polar = torch.abs(lat) >= 80.0
    wnds = torch.where(polar[:, None], 0.0, wnds_raw)
    coefs = steering_coefs(cfg, v)
    w_lat = torch.cos(lat * DEG2RAD)
    u_steer = (wnds[:, 0::2] * coefs).sum(dim=1)
    v_steer = (wnds[:, 1::2] * coefs).sum(dim=1)
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


def ventilation_index_reject(stacks: F.GatherStacks, cfg: Namelist,
                             y0: State, params: SeedParams):
    """Genesis gate: reject when S * chi / v_pot >= 1 at t=0 with v_pot > 0
    (coupled_fast.py:237-244).  Returns a boolean keep-mask [N]."""
    smp = sample_fields(stacks, y0.lon, y0.lat, params.plane)
    wnds = color_winds(cfg, smp.wind_stats, params.fourier, 0.0)
    v_pot = torch.where(_is_land(smp.land), 0.0, smp.env[:, F.VPOT])
    vent = shear_magnitude(cfg, wnds) * smp.env[:, F.CHI] / v_pot
    return ~((v_pot > 0) & (vent >= 1.0))
