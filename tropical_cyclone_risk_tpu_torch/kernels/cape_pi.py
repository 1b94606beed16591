"""K6 wrapper: build csrc/cape_pi.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused ops/pi.py cape_pi in its
default configuration (select_thermo=1, select_interp=2, the 2-D entropy
table); see the note at the top of the source.  Its plain twin is
ops/pi.py cape_pi_plain, which also owns the dispatch (ops/pi.py cape_pi).
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


def params(table, L: int, n_col: int, cecd: float):
    """The kernel's scalar parameters (csrc/cape_pi.cu Params), each float
    the float32 rounding of the constant ops/thermo.py and ops/pi.py use."""
    g = table.grid
    fp = [273.0, 610.94, 17.625, 243.04, 10.0, pr.Rd / pr.Rv,
          pr.eps, pr.cp, pr.Rd, pr.Rv, pr.L0, 1e-4,
          thermo.LCL_CPV, thermo.LCL_A0, thermo.LCL_B0,
          math.e, 11.0 / 72.0, 1e-30, -0.27,
          pr.Rd / pr.cp, cecd,
          g.lon0, g.dlon, g.lat0, g.dlat]
    ip = [g.nlon, g.nlat, L, n_col]
    return np.array(fp, np.float32), np.array(ip, np.int32)


def cape_pi_cuda(sst, p_surf, p_env, T_env, r_env, table, cecd: float = 1.0):
    """Launch K6: potential intensity [m/s] of every column, as
    ops/pi.py cape_pi_plain with select_thermo=1, select_interp=2.
    sst, p_surf [...]; p_env [L]; T_env, r_env [L, ...]; table an
    EntropyTable on the same device."""
    dev = sst.device
    if dev.type != 'cuda':
        raise ValueError(f'CAPE-PI kernel needs CUDA tensors, got {dev}')
    L = p_env.shape[0]
    want = {'sst': (sst, sst.shape), 'p_surf': (p_surf, sst.shape),
            'p_env': (p_env, (L,)), 'T_env': (T_env, (L,) + sst.shape),
            'r_env': (r_env, (L,) + sst.shape),
            'table': (table.T, (table.grid.nlat, table.grid.nlon))}
    for name, (t, shape) in want.items():
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape)):
            raise ValueError(f'{name}: need a contiguous float32 tensor of '
                             f'shape {tuple(shape)} on {dev}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if L < 2 or min(table.grid.nlon, table.grid.nlat) < 2:
        raise ValueError('CAPE-PI needs >= 2 levels and a >= 2 x 2 table')
    n_col = sst.numel()
    if n_col > 2 ** 31 - 256:
        raise ValueError(f'{n_col} columns do not fit the kernel\'s int32 '
                         f'column index')
    out = torch.empty_like(sst)
    if n_col == 0:
        return out
    fp, ip = params(table, L, n_col, cecd)
    ptrs = [t.data_ptr() for t in (sst, p_surf, p_env, T_env, r_env,
                                   table.T, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(fp.ctypes.data, ip.ctypes.data, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f'CAPE-PI kernel launch failed: CUDA error {err}')
    kernels.LAUNCHES['cape_pi'] += 1
    return out
