"""K6 wrapper: build csrc/cape_pi.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused ops/pi.py cape_pi in every
mode it takes: select_thermo 1 or 2, crossed with the inversion (a 2-D
EntropyTable, a 3-D EntropyTable3, or Newton for select_interp=1), six
template instances; see the note at the top of the source.  Its plain
twin is ops/pi.py cape_pi_plain, which also owns the dispatch (ops/pi.py
cape_pi).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import constants as pr
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
from tropical_cyclone_risk_tpu_torch.ops import thermo


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('cape_pi')


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build()['path'])).tc_cape_pi
    fn.argtypes = [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return fn


# the kernel's inversions (csrc/cape_pi.cu INV)
TABLE2, TABLE3, NEWTON = 0, 1, 2


def mode(table, select_thermo: int = 1, select_interp: int = 2):
    """(thermo, inversion) of the kernel instance for a cape_pi call, read
    as the JAX package reads its arguments: select_thermo 1 is the
    pseudoadiabatic branch and any other value the reversible one;
    select_interp 1 is Newton (the table unused), any other value the
    table's lookup, bilinear on a 2-D table and trilinear on a 3-D one."""
    branch = 1 if select_thermo == 1 else 2
    if select_interp == 1:
        return branch, NEWTON
    if table is None:
        raise ValueError(f'select_interp={select_interp} looks the moist '
                         f'adiabat up in an entropy table; none was given')
    return branch, TABLE3 if table.T.dim() == 3 else TABLE2


def params(table, L: int, n_col: int, cecd: float, select_thermo: int = 1,
           select_interp: int = 2):
    """The kernel's scalar parameters (csrc/cape_pi.cu Params), each float
    the float32 rounding of the constant ops/thermo.py and ops/pi.py use;
    the last two ints select the instance (mode).  A Newton call reads no
    table: its grid fields are zeros when none is given."""
    branch, inv = mode(table, select_thermo, select_interp)
    g = None if table is None else table.grid
    grid = [0.0] * 4 if g is None else [g.lon0, g.dlon, g.lat0, g.dlat]
    rt = [table.rt0, table.drt] if inv == TABLE3 else [0.0, 0.0]
    fp = [273.0, 610.94, 17.625, 243.04, 10.0, pr.Rd / pr.Rv,
          pr.eps, pr.cp, pr.Rd, pr.Rv, pr.L0, 1e-4,
          thermo.LCL_CPV, thermo.LCL_A0, thermo.LCL_B0,
          math.e, 11.0 / 72.0, 1e-30, -0.27,
          pr.Rd / pr.cp, cecd, *grid,
          pr.Lv, pr.cpv - pr.cl, 273.15, pr.cl, pr.cpv,
          pr.L0 ** 2, thermo.NEWTON_T0, -thermo.NEWTON_STEP,
          thermo.NEWTON_STEP, thermo.NEWTON_T_MIN, thermo.NEWTON_T_MAX, *rt]
    ip = [0 if g is None else g.nlon, 0 if g is None else g.nlat, L, n_col,
          table.T.shape[-1] if inv == TABLE3 else 1, thermo.NEWTON_ITERS,
          branch, inv]
    return np.array(fp, np.float32), np.array(ip, np.int32)


def cape_pi_cuda(sst, p_surf, p_env, T_env, r_env, table, cecd: float = 1.0,
                 select_thermo: int = 1, select_interp: int = 2):
    """Launch K6: potential intensity [m/s] of every column, as
    ops/pi.py cape_pi_plain with the same modes.  sst, p_surf [...]; p_env
    [L]; T_env, r_env [L, ...]; table an EntropyTable or EntropyTable3 on
    the same device (None, or unused, with select_interp=1)."""
    dev = sst.device
    if dev.type != 'cuda':
        raise ValueError(f'CAPE-PI kernel needs CUDA tensors, got {dev}')
    _, inv = mode(table, select_thermo, select_interp)
    L = p_env.shape[0]
    want = {'sst': (sst, sst.shape), 'p_surf': (p_surf, sst.shape),
            'p_env': (p_env, (L,)), 'T_env': (T_env, (L,) + sst.shape),
            'r_env': (r_env, (L,) + sst.shape)}
    if inv != NEWTON:
        g = table.grid
        want['table'] = (table.T, (g.nlat, g.nlon) + tuple(
            table.T.shape[2:] if inv == TABLE3 else ()))
        if min(g.nlon, g.nlat, *table.T.shape[2:]) < 2:
            raise ValueError('CAPE-PI needs a table of >= 2 points on '
                             'each axis')
    for name, (t, shape) in want.items():
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape)):
            raise ValueError(f'{name}: need a contiguous float32 tensor of '
                             f'shape {tuple(shape)} on {dev}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if L < 2:
        raise ValueError('CAPE-PI needs >= 2 levels')
    n_col = sst.numel()
    if n_col > 2 ** 31 - 256:
        raise ValueError(f'{n_col} columns do not fit the kernel\'s int32 '
                         f'column index')
    out = torch.empty_like(sst)
    if n_col == 0:
        return out
    fp, ip = params(table if inv != NEWTON else None, L, n_col, cecd,
                    select_thermo, select_interp)
    ptrs = [t.data_ptr() for t in (sst, p_surf, p_env, T_env, r_env)]
    ptrs += [0 if inv == NEWTON else table.T.data_ptr(), out.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(fp.ctypes.data, ip.ctypes.data, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f'CAPE-PI kernel launch failed: CUDA error {err}')
    kernels.LAUNCHES['cape_pi'] += 1
    return out
