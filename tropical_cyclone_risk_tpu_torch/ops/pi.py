"""Potential intensity (CAPE-PI) per column (twin of
tropical_cyclone_risk_tpu/ops/pi.py).

Reference equivalent: ``CAPE_PI_vectorized`` (thermo/thermo.py:266-412).
``cape_pi`` is the entry point: on CUDA tensors it launches the
hand-written kernel K6 (kernels/cape_pi.py, csrc/cape_pi.cu), on CPU
tensors it runs ``cape_pi_plain``, the JAX function step for step in plain
torch.  The plain twin keeps the JAX expressions' operation order, sums
CAPE level by level from the surface up and divides by constants with one
rounded division, so that the kernel reproduces it on the card.

Entropy inversion uses a (p, s) -> T table interpolated bilinearly (the
reference's RectBivariateSpline over entropy_table.npz,
thermo/thermo.py:315-317), regenerated by Newton inversion
(ops/thermo.generate_entropy_table).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import constants as pr
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import cape_pi as k6
from tropical_cyclone_risk_tpu_torch.ops import thermo
from tropical_cyclone_risk_tpu_torch.ops.interp import (UniformGrid,
                                                        bilinear_scalar,
                                                        true_div)


class EntropyTable(NamedTuple):
    grid: UniformGrid      # lon-axis = entropy s, lat-axis = pressure p
    T: torch.Tensor        # [nprs, ns] float32

    @staticmethod
    def create(select_thermo: int = 1, device='cpu') -> 'EntropyTable':
        """Generate the table (on the CPU, so every device gets the same
        bytes) and place it on ``device``."""
        p_look, s_look, T = thermo.generate_entropy_table(
            select_thermo=select_thermo)
        return EntropyTable.from_arrays(p_look.numpy(), s_look.numpy(), T,
                                        device)

    @staticmethod
    def from_arrays(p_look, s_look, T, device='cpu') -> 'EntropyTable':
        """A table from its axes and values, e.g. the JAX package's table
        as numpy arrays."""
        grid = UniformGrid.from_axes(np.asarray(s_look), np.asarray(p_look))
        return EntropyTable(grid, torch.tensor(
            np.array(T, np.float32), device=device))

    def to(self, device) -> 'EntropyTable':
        return self._replace(T=self.T.to(device))

    def lookup(self, p, s, r_t=None):
        """T(p, s), clamped to the table's edges (spline-equivalent)."""
        del r_t    # pseudoadiabatic table: no total-water dependence
        shape = torch.broadcast_shapes(p.shape, s.shape)
        p = p.expand(shape).reshape(-1)
        s = s.expand(shape).reshape(-1)
        return bilinear_scalar(self.T, self.grid, s, p).reshape(shape)


class EntropyTable3(NamedTuple):
    """3-D reversible-entropy inversion table (p, s, r_t) -> T (the
    reference's entropy_table_reversible.npz + interpn,
    thermo/thermo.py:159-163, 230)."""
    grid: UniformGrid          # lon-axis = entropy s, lat-axis = pressure p
    rt0: float
    drt: float
    T: torch.Tensor            # [nprs, ns, nrt]

    @staticmethod
    def create(device='cpu') -> 'EntropyTable3':
        p_look, s_look, rt_look, T = \
            thermo.generate_entropy_table_reversible()
        return EntropyTable3.from_arrays(p_look.numpy(), s_look.numpy(),
                                         rt_look.numpy(), T, device)

    @staticmethod
    def from_arrays(p_look, s_look, rt_look, T,
                    device='cpu') -> 'EntropyTable3':
        grid = UniformGrid.from_axes(np.asarray(s_look), np.asarray(p_look))
        rt = np.asarray(rt_look)
        return EntropyTable3(grid, float(rt[0]), float(rt[1] - rt[0]),
                             torch.tensor(np.array(T, np.float32),
                                          device=device))

    def to(self, device) -> 'EntropyTable3':
        return self._replace(T=self.T.to(device))

    def lookup(self, p, s, r_t):
        """Trilinear T(p, s, r_t), clamped to the table's edges: two
        bilinear (p, s) lookups on adjacent r_t slabs, then a lerp."""
        shape = torch.broadcast_shapes(p.shape, s.shape, r_t.shape)
        p = p.expand(shape).reshape(-1)
        s = s.expand(shape).reshape(-1)
        r = r_t.expand(shape).reshape(-1)
        nrt = self.T.shape[-1]
        u = torch.clamp(true_div(r - self.rt0, self.drt), 0.0, nrt - 1.0)
        k = torch.nan_to_num(torch.clamp(torch.floor(u), 0, nrt - 2)).to(
            torch.int64)
        w = u - k.to(u.dtype)
        T_pl = torch.movedim(self.T, -1, 0)     # [nrt, nprs, ns]
        lo = bilinear_scalar(T_pl, self.grid, s, p, plane_idx=k)
        hi = bilinear_scalar(T_pl, self.grid, s, p, plane_idx=k + 1)
        return (lo + w * (hi - lo)).reshape(shape)


def cape_pi_plain(sst, p_surf, p_env, T_env, r_env, table,
                  cecd: float = 1.0, select_thermo: int = 1,
                  select_interp: int = 2):
    """Potential intensity [m/s] over a grid of columns, in plain torch
    (ops/pi.py cape_pi of the JAX package, all three modes).

    sst, p_surf:  [...] surface fields (K, Pa)
    p_env:        [L] pressure sounding, surface level first (Pa)
    T_env, r_env: [L, ...] temperature (K) and mixing-ratio profiles
    select_interp: 2 = entropy-table lookup (an EntropyTable, or an
    EntropyTable3 for the reversible branch), 1 = direct Newton inversion.

    Dry adiabat below the LCL, entropy-inverted moist adiabat above, the
    level of neutral buoyancy with the sub-grid outflow correction, and
    CAPE/CAPEs as log-pressure sums (thermo/thermo.py:266-412).
    """
    if sst.is_cuda:
        kernels.PLAIN_ON_CUDA['cape_pi'] += 1
    L = p_env.shape[0]
    col = (L,) + (1,) * sst.dim()
    T_ns, r_ns, p_ns = T_env[0], r_env[0], p_env[0]

    _, rs = thermo.sat_thermo(sst, p_surf)
    rh = r_ns / rs * (1 + true_div(rs, pr.eps)) / (1 + true_div(r_ns, pr.eps))
    s_ns = thermo.s_unsat(T_ns, p_ns, r_ns, r_ns, select_thermo)
    ss = thermo.s_sat(sst, p_surf, rs, select_thermo)

    lnp = torch.log(p_env)
    dlnp = torch.diff(lnp, append=(2 * lnp[-1] - lnp[-2])[None])
    T_rho_env = thermo.calc_T_rho(T_env, r_env, r_env, select_thermo)
    pLCL = thermo.get_LCL(p_ns, T_ns, r_ns, rh)

    # first condensing level; the top level when none condenses
    # (thermo/thermo.py:320-325)
    lvl = torch.arange(L, device=sst.device).reshape(col)
    p_col = p_env.reshape(col)
    cond = pLCL[None] > p_col
    cond[-1] = True
    Icond = cond.to(torch.uint8).argmax(dim=0)

    if select_interp == 1:
        invert = lambda p, s_, r_t: thermo.invert_entropy_newton(
            p, s_, r_t, select_thermo, use_pog=False)
    else:
        invert = table.lookup
    full = (L,) + sst.shape
    p_full = p_col.expand(full)
    Ta_dry = T_ns[None] * (p_col / p_ns) ** (pr.Rd / pr.cp)
    Ta_moist = invert(p_full, s_ns[None].expand(full), r_ns[None])
    below = lvl < Icond[None]
    Ta_prof = torch.where(below, Ta_dry, Ta_moist)
    _, ra_moist = thermo.sat_thermo(Ta_prof, p_col)
    ra_prof = torch.where(below, r_ns[None], ra_moist)

    # the surface-saturated parcel: a moist adiabat from the surface
    Ts_prof = invert(p_full, ss[None].expand(full), rs[None])
    _, rs_prof = thermo.sat_thermo(Ts_prof, p_col)

    T_rho_a = thermo.calc_T_rho(Ta_prof, ra_prof, r_ns[None], select_thermo)
    T_rho_s = thermo.calc_T_rho(Ts_prof, rs_prof, rs[None], select_thermo)

    def last_true(mask):
        """The last level where mask holds; L-1 when it never does
        (thermo/thermo.py:360-361)."""
        idx = torch.where(mask, lvl, -1).amax(dim=0)
        return torch.where(idx < 0, L - 1, idx)

    a_out_I = last_true(T_rho_a >= T_rho_env)
    s_out_I = last_true(T_rho_s >= T_rho_env)

    def outflow(out_I, T_rho_p):
        """Sub-grid level-of-neutral-buoyancy correction
        (thermo/thermo.py:363-395): (T_out, added area), NaN and 0 when the
        parcel is buoyant up to the top level."""
        i = torch.clamp_max(out_I, L - 2)[None]
        take = lambda arr, k: arr.gather(0, k)[0]
        p1, p2 = p_env[i[0]], p_env[i[0] + 1]
        dT1 = take(T_rho_p, i) - take(T_rho_env, i)
        dT2 = take(T_rho_p, i + 1) - take(T_rho_env, i + 1)
        p_out = (p1 * dT2 - p2 * dT1) / (dT2 - dT1)
        Te1, Te2 = take(T_env, i), take(T_env, i + 1)
        T_out = (Te1 * (p_out - p2) + Te2 * (p1 - p_out)) / (p1 - p2)
        add_area = pr.Rd * dT1 * (p1 - p_out) / (p1 + p_out)
        valid = out_I < (L - 1)
        return (torch.where(valid, T_out, float('nan')),
                torch.where(valid, add_area, 0.0))

    T_out_s, add_area_s = outflow(s_out_I, T_rho_s)
    _, add_area_a = outflow(a_out_I, T_rho_a)

    contrib_a = pr.Rd * (T_rho_a - T_rho_env) * -dlnp.reshape(col)
    contrib_s = pr.Rd * (T_rho_s - T_rho_env) * -dlnp.reshape(col)
    # level by level from the surface, as the kernel sums
    CAPE = torch.zeros_like(sst)
    CAPEs = torch.zeros_like(sst)
    for l in range(L):
        CAPE = CAPE + torch.where(l <= a_out_I, contrib_a[l], 0.0)
        CAPEs = CAPEs + torch.where(l <= s_out_I, contrib_s[l], 0.0)
    CAPE = CAPE + add_area_a
    CAPEs = CAPEs + add_area_s

    CAPE = torch.nan_to_num(torch.clamp_min(CAPE, 0.0))
    cape_diff = CAPEs - CAPE
    PI = torch.sqrt(torch.clamp_min(cecd * sst / T_out_s * cape_diff, 0.0))
    return torch.nan_to_num(PI)


def cape_pi(sst, p_surf, p_env, T_env, r_env, table, cecd: float = 1.0,
            select_thermo: int = 1, select_interp: int = 2):
    """Potential intensity [m/s] per column (see cape_pi_plain).  CPU
    tensors take the plain twin; CUDA tensors launch K6, which computes the
    default configuration (select_thermo=1, select_interp=2, a 2-D
    EntropyTable) and raises NotImplementedError for the other modes."""
    if sst.device.type == 'cpu':
        return cape_pi_plain(sst, p_surf, p_env, T_env, r_env, table, cecd,
                             select_thermo, select_interp)
    if (select_thermo, select_interp) != (1, 2) or \
            not isinstance(table, EntropyTable):
        raise NotImplementedError(
            f'the CAPE-PI kernel computes select_thermo=1, select_interp=2 '
            f'with a 2-D entropy table; select_thermo={select_thermo}, '
            f'select_interp={select_interp} with {type(table).__name__} '
            f'is not ported yet')
    return k6.cape_pi_cuda(sst, p_surf, p_env, T_env, r_env, table, cecd)
