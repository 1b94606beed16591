"""K6's design (csrc/cape_pi.cu) emulated in torch and held bit for bit
against the plain twin ops/pi.cape_pi_plain on the CPU.

The kernel computes what depends on the level alone once, in a block
prologue (the pressure, -dlnp, the dry-adiabat factor (p / p_ns)^(Rd/cp)
and the entropy table's pressure cell and weights), and what depends on the
column alone once per column (the entropy cells and weights of its two
parcels); its walk over the levels keeps the running sums and the outflow
pair.  The emulation makes the kernel's float32 operations in the kernel's
order, level by level over all columns at once, with torch's CPU functions
standing in for CUDA's; the twin (held against the JAX package in
tests/test_torch_thermo.py) computes every level of every column in full.
They agree bit for bit, which is the claim the kernel rests on: hoisting
moves operations, it changes none.

The grid is 2 x 16 x 32 columns on the 28 levels of tests/test_torch_thermo
(1024 columns, numpy-seeded): tropical soundings, land columns (SST 0 K),
cold columns (SST 270 K, never buoyant), columns with a very cold top
(buoyant to the top level), and a fine sweep of surface humidity that puts
the LCL just above and just below levels.  1024 columns keep every torch
kernel on [columns] and [levels, columns] in whole vectors of one chunk on
the CPU, so the transcendentals of both sides take the same code path.
"""

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch import constants as pr
from tropical_cyclone_risk_tpu_torch.ops import pi as tpi
from tropical_cyclone_risk_tpu_torch.ops import thermo
from tropical_cyclone_risk_tpu_torch.ops.interp import (_cell_and_weight,
                                                        true_div)

SHAPE = (2, 16, 32)
P_ENV = np.array([1000, 975, 950, 925, 900, 875, 850, 825, 800, 775, 750,
                  700, 650, 600, 550, 500, 450, 400, 350, 300, 250, 225, 200,
                  175, 150, 125, 100, 70], np.float64) * 100.0


def _sat_rs(T, p):
    """Bolton saturation mixing ratio in float64 (the inputs' humidity)."""
    es = 610.94 * np.exp(17.625 * (T - 273.0) / (T - 273.0 + 243.04))
    return pr.Rd / pr.Rv * es / (p - es)


def _columns():
    """(sst, p_surf, p_env, T_env, r_env) as float32 torch tensors of the
    grid: 1024 columns, the cases of the module's docstring."""
    rng = np.random.default_rng(7)
    n = int(np.prod(SHAPE))
    L = P_ENV.size
    sst = rng.uniform(295.0, 304.0, n)
    p_surf = rng.uniform(1.004e5, 1.016e5, n)
    T0 = sst - rng.uniform(0.5, 1.5, n)
    T_env = 200.0 + (T0[None] - 200.0) * (P_ENV[:, None] / P_ENV[0]) ** 0.45
    rh = np.clip(0.85 - 0.45 * (1 - P_ENV / P_ENV[0])[:, None]
                 + rng.uniform(-0.05, 0.05, (L, n)), 0.05, 0.99)
    # the sweep: surface humidity from 0.3 to 0.99 in 512 steps, so the
    # LCL crosses the levels from 1000 to ~700 hPa
    rh[0, 512:] = np.linspace(0.3, 0.99, n - 512)
    sst[:24] = 0.0                        # land
    sst[24:48] = 270.0                    # cold
    T_env[-3:, 48:72] = 120.0             # a very cold top
    r_env = rh * np.stack([_sat_rs(T_env[l], P_ENV[l]) for l in range(L)])
    f32 = lambda a, s: torch.tensor(np.asarray(a, np.float32).reshape(s))
    return (f32(sst, SHAPE), f32(p_surf, SHAPE), f32(P_ENV, (L,)),
            f32(T_env, (L,) + SHAPE), f32(r_env, (L,) + SHAPE))


def cape_pi_hoisted(sst, p_surf, p_env, T_env, r_env, table, cecd=1.0):
    """csrc/cape_pi.cu's order in torch: (PI [...], {the walk's last
    buoyant levels before the never-buoyant fix, the LCL pressures})."""
    L = p_env.shape[0]
    shape = sst.shape
    sst, p_surf = sst.reshape(-1), p_surf.reshape(-1)
    T_env, r_env = T_env.reshape(L, -1), r_env.reshape(L, -1)
    g = table.grid
    ns = g.nlon
    T_flat = table.T.reshape(-1)

    # the block prologue: once per level
    p_ns = p_env[0]
    lnp = torch.log(p_env)
    neg_dlnp = torch.stack([
        -((lnp[l + 1] - lnp[l]) if l + 1 < L
          else (2 * lnp[l] - lnp[L - 2]) - lnp[l]) for l in range(L)])
    dry = ((p_env.reshape(L, 1) / p_ns) ** (pr.Rd / pr.cp)).reshape(L)
    iy, wy = _cell_and_weight(p_env, g.lat0, g.dlat, g.nlat)
    omwy = 1 - wy
    iyns = iy * ns

    # once per column: the lifted parcel's start, its LCL, both entropies
    # and their table cells
    T_ns, r_ns = T_env[0], r_env[0]
    _, rs = thermo.sat_thermo(sst, p_surf)
    rh = r_ns / rs * (1 + true_div(rs, pr.eps)) / (1 + true_div(r_ns, pr.eps))
    s_ns = thermo.s_unsat(T_ns, p_ns, r_ns, r_ns)
    ss = thermo.s_sat(sst, p_surf, rs)
    pLCL = thermo.get_LCL(p_ns, T_ns, r_ns, rh)
    ix_a, wx_a = _cell_and_weight(s_ns, g.lon0, g.dlon, ns)
    ix_s, wx_s = _cell_and_weight(ss, g.lon0, g.dlon, ns)
    omwx_a, omwx_s = 1 - wx_a, 1 - wx_s

    def blend(l, ix, wx, omwx):
        base = iyns[l] + ix
        c00, c01 = T_flat[base], T_flat[base + 1]
        c10, c11 = T_flat[base + ns], T_flat[base + ns + 1]
        return omwy[l] * (omwx * c00 + wx * c01) + wy[l] * (omwx * c10 +
                                                            wx * c11)

    def outflow(p1, p2, dT1, dT2, Te1, Te2):
        p_out = (p1 * dT2 - p2 * dT1) / (dT2 - dT1)
        T_out = (Te1 * (p_out - p2) + Te2 * (p1 - p_out)) / (p1 - p2)
        return T_out, pr.Rd * dT1 * (p1 - p_out) / (p1 + p_out)

    zero = torch.zeros_like(sst)
    sum_a, sum_s, cape_a, cape_s = zero, zero, zero, zero
    area_a, area_s, T_out_s = zero, zero, zero
    out_a = out_s = torch.full(sst.shape, -1)
    condensed = torch.zeros(sst.shape, dtype=torch.bool)
    buoy_a = buoy_s = torch.zeros(sst.shape, dtype=torch.bool)
    prev_p, prev_Te, prev_dTa, prev_dTs = zero, zero, zero, zero
    for l in range(L):
        pl, Te, re = p_env[l], T_env[l], r_env[l]
        Trho_env = thermo.calc_T_rho(Te, re, re)
        condensed = condensed | (pLCL > pl) | (l == L - 1)
        Ta_moist = blend(l, ix_a, wx_a, omwx_a)
        Ta = torch.where(condensed, Ta_moist, T_ns * dry[l])
        ra = torch.where(condensed, thermo.sat_thermo(Ta_moist, pl)[1], r_ns)
        Ts = blend(l, ix_s, wx_s, omwx_s)
        rsp = thermo.sat_thermo(Ts, pl)[1]
        Trho_a = thermo.calc_T_rho(Ta, ra, ra)
        Trho_s = thermo.calc_T_rho(Ts, rsp, rsp)
        dTa, dTs = Trho_a - Trho_env, Trho_s - Trho_env
        sum_a = sum_a + pr.Rd * dTa * neg_dlnp[l]
        sum_s = sum_s + pr.Rd * dTs * neg_dlnp[l]
        _, a_new = outflow(prev_p, pl, prev_dTa, dTa, prev_Te, Te)
        area_a = torch.where(buoy_a, a_new, area_a)
        t_new, s_new = outflow(prev_p, pl, prev_dTs, dTs, prev_Te, Te)
        T_out_s = torch.where(buoy_s, t_new, T_out_s)
        area_s = torch.where(buoy_s, s_new, area_s)
        buoy_a, buoy_s = Trho_a >= Trho_env, Trho_s >= Trho_env
        out_a = torch.where(buoy_a, l, out_a)
        cape_a = torch.where(buoy_a, sum_a, cape_a)
        out_s = torch.where(buoy_s, l, out_s)
        cape_s = torch.where(buoy_s, sum_s, cape_s)
        prev_p, prev_Te, prev_dTa, prev_dTs = pl.expand(sst.shape), Te, dTa, \
            dTs
    walk = {'out_a': out_a, 'out_s': out_s, 'pLCL': pLCL}
    # never buoyant: the top level, with every level summed
    cape_a = torch.where(out_a < 0, sum_a, cape_a)
    cape_s = torch.where(out_s < 0, sum_s, cape_s)
    out_a = torch.where(out_a < 0, L - 1, out_a)
    out_s = torch.where(out_s < 0, L - 1, out_s)
    # buoyant up to the top: no outflow correction, T_out undefined
    area_a = torch.where(out_a == L - 1, 0.0, area_a)
    area_s = torch.where(out_s == L - 1, 0.0, area_s)
    T_out_s = torch.where(out_s == L - 1, float('nan'), T_out_s)

    cape = torch.nan_to_num(torch.clamp_min(cape_a + area_a, 0.0))
    cape_diff = (cape_s + area_s) - cape
    pi = torch.sqrt(torch.clamp_min(cecd * sst / T_out_s * cape_diff, 0.0))
    return torch.nan_to_num(pi).reshape(shape), walk


@pytest.fixture(scope='module')
def table():
    return tpi.EntropyTable.create()


@pytest.mark.parametrize('cecd', [1.0, 0.9])
def test_cape_pi_hoisted_order_matches_the_twin(table, cecd):
    """The kernel's hoisted order gives the twin's PI bit for bit on every
    column, land, cold, buoyant-to-the-top and LCL-straddling columns
    included."""
    args = _columns()
    got, walk = cape_pi_hoisted(*args, table, cecd)
    want = tpi.cape_pi_plain(*args, table, cecd)
    assert got.dtype == want.dtype and got.shape == want.shape == SHAPE
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    flat = got.reshape(-1)
    assert float(flat.max()) > 30.0
    assert not flat[:24].any()                  # land: 0 m/s
    L = P_ENV.size
    assert bool((walk['out_s'] < 0).any())      # never buoyant
    assert bool((walk['out_s'][48:72] == L - 1).all())    # to the top


def test_cape_pi_grid_straddles_levels_with_the_lcl():
    """The humidity sweep puts the LCL within 1 hPa above and within 1 hPa
    below one level, the dry/moist switch the hoisted order must keep."""
    sst, p_surf, p_env, T_env, r_env = _columns()
    T_ns, r_ns = T_env[0].reshape(-1), r_env[0].reshape(-1)
    _, rs = thermo.sat_thermo(sst.reshape(-1), p_surf.reshape(-1))
    rh = r_ns / rs * (1 + true_div(rs, pr.eps)) / (1 + true_div(r_ns, pr.eps))
    pLCL = thermo.get_LCL(p_env[0], T_ns, r_ns, rh)[512:].double()
    d = pLCL[:, None] - p_env.double()[None]
    both = ((d > 0) & (d < 100.0)).any(0) & ((d < 0) & (d > -100.0)).any(0)
    assert int(both.sum()) >= 3
