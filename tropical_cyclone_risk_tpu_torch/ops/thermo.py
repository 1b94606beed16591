"""Saturation thermodynamics, entropy and LCL, elementwise over any shape
(twin of tropical_cyclone_risk_tpu/ops/thermo.py).

Reference equivalent: thermo/thermo.py:19-134; the pseudoadiabatic
(select_thermo=1) and reversible (=2) branches are both here.  Each
expression keeps the JAX package's operation order, and a division by a
constant goes through ``true_div`` (one rounded division, as in the JAX
package and the CAPE-PI kernel, csrc/cape_pi.cu), so the CUDA kernel can
reproduce this module bit for bit.
"""

from __future__ import annotations

import math

import torch

from tropical_cyclone_risk_tpu_torch import constants as pr
from tropical_cyclone_risk_tpu_torch.ops.interp import true_div


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` for a constant ``c``, rounded as one float division (torch
    computes ``python_scalar / tensor`` as ``reciprocal(x) * c``).  The
    dividend is a 0-d tensor filled on x's device (no host-to-device copy,
    so no synchronisation), as in ``true_div``."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def sat_thermo_pog(T, p):
    """O'Gorman constant-Lv saturation formulas (thermo/thermo.py:19-26)."""
    es = pr.e_trip * torch.exp(pr.Lv / pr.Rv * (1.0 / pr.T_trip - 1.0 / T))
    rs = pr.Rd / pr.Rv * es / (p - es)
    return es, rs


def sat_thermo(T, p):
    """Bolton saturation vapor pressure / mixing ratio
    (thermo/thermo.py:29-38); NaN temperatures propagate NaN."""
    T_c = T - 273.0
    es = 610.94 * torch.exp(torch.clamp_max(17.625 * T_c / (T_c + 243.04),
                                            10.0))
    rs = pr.Rd / pr.Rv * es / (p - es)
    return es, rs


def conv_q_to_rh(T, q, p_Pa):
    """Specific humidity -> relative humidity, clipped to [1e-5, 1]
    (thermo/thermo.py:41-46)."""
    _, rs = sat_thermo(T, p_Pa)
    qs = rs / (1 + rs)
    return torch.clamp(q / qs, 1e-5, 1.0)


def _latent(T):
    """Temperature-dependent latent heat of the reversible branch."""
    return pr.Lv - (pr.cpv - pr.cl) * (273.15 - T)


def s_unsat(T, p, r, r_t, select_thermo: int = 1):
    """Moist entropy of an unsaturated parcel (thermo/thermo.py:49-60)."""
    es, rs = sat_thermo(T, p)
    rh = torch.clamp_min(r / rs * (1 + true_div(rs, pr.eps))
                         / (1 + true_div(r, pr.eps)), 0.0)
    if select_thermo == 1:
        return (pr.cp * torch.log(T) - pr.Rd * torch.log(p - es * rh)
                + pr.L0 * r / T - r * pr.Rv * torch.log(rh))
    return ((pr.cp + pr.cl * r_t) * torch.log(T)
            - pr.Rd * torch.log(p - es * rh) + _latent(T) * r / T
            - r * pr.Rv * torch.log(rh))


def s_sat(T, p, r_t, select_thermo: int = 1, use_pog: bool = False):
    """Saturation entropy (thermo/thermo.py:64-75); use_pog selects the
    O'Gorman saturation formula the reference's bundled entropy table was
    generated with."""
    es, rs = sat_thermo_pog(T, p) if use_pog else sat_thermo(T, p)
    T = torch.clamp_min(T, 1e-4)
    log_pd = torch.log(torch.clamp_min(p - es, 1e-4))
    if select_thermo == 1:
        return pr.cp * torch.log(T) - pr.Rd * log_pd + pr.L0 * rs / T
    return ((pr.cp + r_t * pr.cl) * torch.log(T) - pr.Rd * log_pd
            + _latent(T) * rs / T)


def s_sat_der(T, p, r_t, select_thermo: int = 1, use_pog: bool = False):
    """Analytic dT derivative of saturation entropy
    (thermo/thermo.py:78-89)."""
    es, rs = sat_thermo_pog(T, p) if use_pog else sat_thermo(T, p)
    moist = 1 - true_div(rs, pr.eps)
    if select_thermo == 1:
        return (1 / T) * (pr.cp + true_div(pr.L0 ** 2 * rs, pr.Rv) / T ** 2
                          * moist)
    L = _latent(T)
    return (1 / T) * (pr.cp + pr.cpv * rs + pr.cl * (r_t - rs)
                      + true_div(L ** 2 * rs, pr.Rv) / T ** 2 * moist)


def sat_deficit(sst, ps, T, pm, rv, select_thermo: int = 1):
    """Normalized mid-level saturation entropy deficit chi
    (thermo/thermo.py:92-104)."""
    sp = s_unsat(T, pm, rv, rv, select_thermo)
    sps = s_sat(T, pm, rv, select_thermo)
    spss = s_sat(sst, ps, rv, select_thermo)
    return (sps - sp) / (spss - sps)


def lambertw_m1(x):
    """Lambert W, branch -1, for x in [-1/e, 0): a branch-point series or
    asymptotic initial guess refined by four Halley iterations."""
    p = torch.sqrt(torch.clamp_min(2.0 * (1.0 + math.e * x), 0.0))
    w_series = -1.0 - p - true_div(p * p, 3.0) - 11.0 / 72.0 * p ** 3
    L1 = torch.log(-x)
    L2 = torch.log(torch.clamp_min(-L1, 1e-30))
    w_asym = L1 - L2 + L2 / L1
    w = torch.where(x > -0.27, w_asym, w_series)
    for _ in range(4):
        ew = torch.exp(w)
        f = w * ew - x
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
        w = w - f / denom
    return w


# constants of the exact LCL (Romps 2017): E0v, cvv, cvl and the derived
# cpv, (cvl - cpv) / Rv and -(E0v - (cvv - cvl) T_trip), as Python floats
LCL_E0V, LCL_CVV, LCL_CVL = 2.3740e6, 1418.0, 4119.0
LCL_CPV = LCL_CVV + pr.Rv
LCL_A0 = (LCL_CVL - LCL_CPV) / pr.Rv
LCL_B0 = -(LCL_E0V - (LCL_CVV - LCL_CVL) * pr.T_trip)


def get_LCL(p, T, r, rh):
    """Exact lifting-condensation-level pressure (Romps 2017;
    thermo/thermo.py:107-126)."""
    q = r / (1 + r)
    Rm = (1 - q) * pr.Rd + q * pr.Rv
    cpm = (1 - q) * pr.cp + q * LCL_CPV
    a = cpm / Rm + LCL_A0
    b = rdiv(LCL_B0, pr.Rv * T)
    c = b / a
    T_LCL = c * T / lambertw_m1(rh ** (1 / a) * c * torch.exp(c))
    return p * (T_LCL / T) ** (cpm / Rm)


def calc_T_rho(T, rv, rt, select_thermo: int = 1):
    """Density temperature (thermo/thermo.py:129-134)."""
    if select_thermo == 1:
        return T * (1 + true_div(rv, pr.eps)) / (1 + rv)
    return T * (1 + true_div(rv, pr.eps)) / (1 + rt)


# invert_entropy_newton's start, steps and clamps (the CAPE-PI kernel's
# Newton instances take the same, kernels/cape_pi.py params)
NEWTON_T0, NEWTON_ITERS = 250.0, 25
NEWTON_STEP, NEWTON_T_MIN, NEWTON_T_MAX = 30.0, 40.0, 400.0


def invert_entropy_newton(p, s_ref, r_t=0.0, select_thermo: int = 1,
                          T0=NEWTON_T0, iters: int = NEWTON_ITERS,
                          use_pog: bool = False):
    """Solve s_sat(T, p, r_t) = s_ref for T by damped Newton iteration from
    T0 (the JAX package's replacement for the reference's BFGS / Nelder-Mead
    inversions, thermo/thermo.py:214-221, 451-481)."""
    shape = torch.broadcast_shapes(torch.as_tensor(p).shape,
                                   torch.as_tensor(s_ref).shape)
    ref = p if isinstance(p, torch.Tensor) else s_ref
    T = torch.full(shape, T0, dtype=torch.float32, device=ref.device)
    for _ in range(iters):
        f = s_sat(T, p, r_t, select_thermo, use_pog) - s_ref
        df = s_sat_der(T, p, r_t, select_thermo, use_pog)
        step = torch.clamp(f / df, -NEWTON_STEP, NEWTON_STEP)
        T = torch.clamp(T - step, NEWTON_T_MIN, NEWTON_T_MAX)
    return T


def linspace_f32(start: float, stop: float, num: int):
    """``jnp.linspace`` in float32: start * (1 - t) + stop * t with
    t = i / (num - 1), and the exact endpoint."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32) / float(div)
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    return torch.cat([a * (1 - t) + b * t, b[None]])


def gpi(PI, chi, vort, S):
    """Genesis potential index (thermo/thermo.py:415-419; API only, the
    reference pipeline never calls it); PI thresholded at 35 m/s."""
    PI_abs = torch.clamp_min(PI - 35.0, 0.0)
    return torch.abs(vort) ** 3 * chi ** (-4.0 / 3.0) * PI_abs ** 2 \
        / (S + 25.0) ** 4


def gpi_en04(PI, rh, vort, S):
    """Emanuel (2004) genesis potential index (thermo/thermo.py:421-425;
    API only)."""
    return (1e5 * torch.abs(vort)) ** (rh / 50.0) ** 3 * (PI / 70.0) ** 3 \
        / (1.0 + 0.1 * S) ** 2


def generate_entropy_table(pmin_hPa=25.0, pmax_hPa=1050.0, nprs=200,
                           smin=2337.3348599644537, smax=3585.9052076596804,
                           ns=200, select_thermo: int = 1,
                           use_pog: bool = True):
    """The (p, s) -> T entropy-inversion table by Newton inversion: the
    reference's bundled table axes (200 x 200, p in [2500, 105000] Pa, s in
    [2337.33, 3585.91] J/kg/K), O'Gorman saturation by default as that
    table was made.  Returns (p[nprs], s[ns], T[nprs, ns])."""
    s_look = linspace_f32(smin, smax, ns)
    p_look = 100.0 * linspace_f32(pmin_hPa, pmax_hPa, nprs)
    P, S = torch.meshgrid(p_look, s_look, indexing='ij')
    T = invert_entropy_newton(P, S, 0.0, select_thermo, use_pog=use_pog)
    return p_look, s_look, T


def generate_entropy_table_reversible(pmin_hPa=25.0, pmax_hPa=1050.0,
                                      nprs=200, smin=2337.3348599644537,
                                      smax=3585.9052076596804, ns=200,
                                      rtmax=0.035, nrt=16):
    """The 3-D (p, s, r_t) -> T reversible-entropy table (the reference's
    entropy_table_reversible.npz, thermo/thermo.py:159-163, 230), by
    Newton inversion of s_sat(select_thermo=2).
    Returns (p[nprs], s[ns], rt[nrt], T[nprs, ns, nrt])."""
    s_look = linspace_f32(smin, smax, ns)
    p_look = 100.0 * linspace_f32(pmin_hPa, pmax_hPa, nprs)
    rt_look = linspace_f32(0.0, rtmax, nrt)
    P, S, R = torch.meshgrid(p_look, s_look, rt_look, indexing='ij')
    T = invert_entropy_newton(P, S, R, select_thermo=2, use_pog=False)
    return p_look, s_look, rt_look, T
