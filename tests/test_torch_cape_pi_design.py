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
moves operations, it changes none.  The same holds for the kernel's other
instances: Newton inversion (s_sat and s_sat_der from one saturation
formula, T never below 40 K so s_sat's clamp is left out), the 3-D table
(the r_t slab and weight made once per column) and the reversible branch
(cp + r_t cl and 1 + r_t made once per column).

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
from tropical_cyclone_risk_tpu_torch.kernels.cape_pi import (NEWTON, TABLE2,
                                                             TABLE3)
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


def _sat(T, p):
    """thermo.sat_thermo's (es, rs), as the kernel's sat_es and sat_rs."""
    return thermo.sat_thermo(T, p)


def _newton(p, s_ref, r_t, a_rt, select_thermo):
    """The kernel's newton<THERMO>: s_sat and s_sat_der from one saturation
    formula, T unclamped at 1e-4 K (T stays in [40, 400] K), cp + r_t cl
    hoisted per column."""
    T = torch.full(s_ref.shape, thermo.NEWTON_T0)
    for _ in range(thermo.NEWTON_ITERS):
        es, rs = _sat(T, p)
        log_pd = torch.log(torch.clamp_min(p - es, 1e-4))
        moist = 1 - true_div(rs, pr.eps)
        if select_thermo == 1:
            s = (pr.cp * torch.log(T) - pr.Rd * log_pd) + pr.L0 * rs / T
            der = (1 / T) * (pr.cp + true_div(pr.L0 ** 2 * rs, pr.Rv)
                             / (T * T) * moist)
        else:
            lat = pr.Lv - (pr.cpv - pr.cl) * (273.15 - T)
            s = (a_rt * torch.log(T) - pr.Rd * log_pd) + lat * rs / T
            der = (1 / T) * (((pr.cp + pr.cpv * rs) + pr.cl * (r_t - rs))
                             + true_div((lat * lat) * rs, pr.Rv) / (T * T)
                             * moist)
        step = torch.clamp((s - s_ref) / der, -thermo.NEWTON_STEP,
                           thermo.NEWTON_STEP)
        T = torch.clamp(T - step, thermo.NEWTON_T_MIN, thermo.NEWTON_T_MAX)
    return T


def cape_pi_hoisted(sst, p_surf, p_env, T_env, r_env, table, cecd=1.0,
                    select_thermo=1, inv=TABLE2):
    """csrc/cape_pi.cu's order in torch for the instance (select_thermo,
    inv): (PI [...], {the walk's last buoyant levels before the
    never-buoyant fix, the LCL pressures})."""
    L = p_env.shape[0]
    shape = sst.shape
    sst, p_surf = sst.reshape(-1), p_surf.reshape(-1)
    T_env, r_env = T_env.reshape(L, -1), r_env.reshape(L, -1)
    if inv != NEWTON:
        g = table.grid
        ns = g.nlon
        nrt = table.T.shape[-1] if inv == TABLE3 else 1
        T_flat = table.T.reshape(-1)

    # the block prologue: once per level
    p_ns = p_env[0]
    lnp = torch.log(p_env)
    neg_dlnp = torch.stack([
        -((lnp[l + 1] - lnp[l]) if l + 1 < L
          else (2 * lnp[l] - lnp[L - 2]) - lnp[l]) for l in range(L)])
    dry = ((p_env.reshape(L, 1) / p_ns) ** (pr.Rd / pr.cp)).reshape(L)
    if inv != NEWTON:
        iy, wy = _cell_and_weight(p_env, g.lat0, g.dlat, g.nlat)
        omwy = 1 - wy
        iy_row = iy * (ns * nrt)

    # once per column: the lifted parcel's start, its LCL, both entropies
    # and each parcel's constants
    T_ns, r_ns = T_env[0], r_env[0]
    _, rs = thermo.sat_thermo(sst, p_surf)
    rh = r_ns / rs * (1 + true_div(rs, pr.eps)) / (1 + true_div(r_ns, pr.eps))
    if select_thermo == 1:
        s_ns = thermo.s_unsat(T_ns, p_ns, r_ns, r_ns)
        ss = thermo.s_sat(sst, p_surf, rs)
    else:
        # s_unsat and s_sat with cp + cl r_t made once per column
        a_ns, a_s = pr.cp + pr.cl * r_ns, pr.cp + rs * pr.cl
        es, rs_ns = _sat(T_ns, p_ns)
        rh_u = torch.clamp_min(r_ns / rs_ns * (1 + true_div(rs_ns, pr.eps))
                               / (1 + true_div(r_ns, pr.eps)), 0.0)
        lat_ns = pr.Lv - (pr.cpv - pr.cl) * (273.15 - T_ns)
        s_ns = ((a_ns * torch.log(T_ns) - pr.Rd * torch.log(p_ns - es * rh_u))
                + lat_ns * r_ns / T_ns) - r_ns * pr.Rv * torch.log(rh_u)
        es_s, rs_s = _sat(sst, p_surf)
        Tm = torch.clamp_min(sst, 1e-4)
        log_pd = torch.log(torch.clamp_min(p_surf - es_s, 1e-4))
        lat_s = pr.Lv - (pr.cpv - pr.cl) * (273.15 - Tm)
        ss = (a_s * torch.log(Tm) - pr.Rd * log_pd) + lat_s * rs_s / Tm
    pLCL = thermo.get_LCL(p_ns, T_ns, r_ns, rh)

    def parcel(s, rt):
        pc = {'s': s, 'rt': rt, 'a_rt': pr.cp + rt * pr.cl, 'opr': 1 + rt}
        if inv != NEWTON:
            pc['ix'], pc['wx'] = _cell_and_weight(s, g.lon0, g.dlon, ns)
            pc['omwx'] = 1 - pc['wx']
        if inv == TABLE3:
            k, pc['wk'] = _cell_and_weight(rt, table.rt0, table.drt, nrt)
            pc['off'] = pc['ix'] * nrt + k
        return pc

    par_a, par_s = parcel(s_ns, r_ns), parcel(ss, rs)

    def blend(base, dx, dy, l, pc):
        c00, c01 = T_flat[base], T_flat[base + dx]
        c10, c11 = T_flat[base + dy], T_flat[base + dy + dx]
        return omwy[l] * (pc['omwx'] * c00 + pc['wx'] * c01) + wy[l] * (
            pc['omwx'] * c10 + pc['wx'] * c11)

    def invert(l, pc):
        if inv == TABLE2:
            return blend(iy_row[l] + pc['ix'], 1, ns, l, pc)
        if inv == TABLE3:
            base = iy_row[l] + pc['off']
            lo = blend(base, nrt, ns * nrt, l, pc)
            hi = blend(base + 1, nrt, ns * nrt, l, pc)
            return lo + pc['wk'] * (hi - lo)
        return _newton(p_env[l], pc['s'], pc['rt'], pc['a_rt'],
                       select_thermo)

    def parcel_t_rho(T, rv, pc):
        if select_thermo == 1:
            return thermo.calc_T_rho(T, rv, rv)
        return T * (1 + true_div(rv, pr.eps)) / pc['opr']

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
        Ta_moist = invert(l, par_a)
        Ta = torch.where(condensed, Ta_moist, T_ns * dry[l])
        ra = torch.where(condensed, thermo.sat_thermo(Ta_moist, pl)[1], r_ns)
        Ts = invert(l, par_s)
        rsp = thermo.sat_thermo(Ts, pl)[1]
        Trho_a = parcel_t_rho(Ta, ra, par_a)
        Trho_s = parcel_t_rho(Ts, rsp, par_s)
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


@pytest.fixture(scope='module')
def mode_tables(table):
    """The table of each inversion: the reversible 3-D table; for the
    reversible branch on a 2-D table, the 3-D table's slab at r_t = 0.021
    (a tropical parcel's total water); and for the pseudoadiabatic branch
    on a 3-D table, the 2-D pseudoadiabatic table on 16 r_t slabs 0.05 K
    apart, so that the r_t lerp moves the result."""
    t3 = tpi.EntropyTable3.create()
    rt = t3.rt0 + t3.drt * np.arange(t3.T.shape[-1])
    shifted = (table.T.numpy()[..., None]
               - np.float32(0.05) * np.arange(rt.size, dtype=np.float32))
    pseudo3 = tpi.EntropyTable3.from_arrays(
        table.grid.lat_axis(), table.grid.lon_axis(), rt, shifted)
    return {(2, TABLE3): t3, (1, TABLE3): pseudo3,
            (2, TABLE2): tpi.EntropyTable.from_arrays(
                t3.grid.lat_axis(), t3.grid.lon_axis(), t3.T.numpy()[..., 9])}


# the five instances besides the default (select_thermo, inversion)
MODES = {'pseudo-newton': (1, NEWTON), 'reversible-newton': (2, NEWTON),
         'reversible-table3': (2, TABLE3), 'pseudo-table3': (1, TABLE3),
         'reversible-table2': (2, TABLE2)}


@pytest.mark.parametrize('name', sorted(MODES))
def test_cape_pi_mode_orders_match_the_twin(table, mode_tables, name):
    """Every other instance of the kernel (Newton with both branches, the
    3-D table with both, the 2-D table with the reversible branch): its
    order (Newton's shared saturation formula and unclamped T, the r_t
    slab and weight and cp + r_t cl made once per column, the lifted
    parcel inverted only above its LCL) gives the twin's PI bit for bit on
    every column."""
    select_thermo, inv = MODES[name]
    tab = mode_tables.get((select_thermo, inv), table)
    args = _columns()
    got, walk = cape_pi_hoisted(*args, tab, 1.0, select_thermo, inv)
    want = tpi.cape_pi_plain(*args, tab, 1.0, select_thermo,
                             1 if inv == NEWTON else 2)
    assert got.shape == want.shape == SHAPE
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    flat = got.reshape(-1)
    assert float(flat.max()) > 30.0
    assert not flat[:24].any()                  # land: 0 m/s
    assert bool((walk['out_s'] < 0).any())      # never buoyant
