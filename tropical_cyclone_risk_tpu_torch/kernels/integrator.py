"""K1 wrapper: build csrc/integrator.cu with nvcc (kernels/build.py), bind
it with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused segment loop; see the note
at the top of the source.  Its plain twin is models/simulator.py
integrate_segment_plain.  The default path streams F(t) from the per-step
grid; under rk_exact_stage_fields or rk_substeps > 1 the kernel evaluates
F(t) from the storms' Fourier rows with w_n from ops/fourier._omega.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
from tropical_cyclone_risk_tpu_torch.models import fast
from tropical_cyclone_risk_tpu_torch.ops import fourier

N_POINTERS = 22          # device pointers of tc_integrate_segment
MAX_SUB = 8              # csrc/integrator.cu kMaxSub


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('integrator')


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build()['path'])).tc_integrate_segment
    fn.argtypes = [ctypes.c_void_p] * (2 + N_POINTERS + 1)
    fn.restype = ctypes.c_int
    return fn


def _f32(x) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=8)
def _omega(T_s: float, analytic: bool) -> tuple:
    """w_n of ops/fourier._omega where the kernel evaluates F(t), else
    zeros (the default path streams F(t) and never reads them)."""
    if not analytic:
        return (0.0,) * fourier.N_FOURIER
    return tuple(fourier._omega(T_s, 'cpu').tolist())


def _params(stacks, cfg: Namelist, bounds, m: int, n_steps: int,
            stride: int, n_blocks: int, k0: int, T_s: float,
            analytic: bool):
    """The kernel's scalar parameters, each float the float32 rounding of
    the constant the plain twin uses (see csrc/integrator.cu Params)."""
    g = stacks.grid
    dt_out = float(cfg.output_interval_s)
    sub = max(1, int(cfg.rk_substeps))
    dt = dt_out / sub
    lon_min, lat_min, lon_max, lat_max = bounds
    fp = [g.lon0, g.dlon, g.lat0, g.dlat,
          lon_min + 1.0, lat_min + 1.0, lon_max - 1.0, lat_max - 1.0,
          0.5 * cfg.Ck, cfg.u_beta, cfg.v_beta, fast.MS_TO_KTS,
          fast.DEG2RAD, fast.RAD_PER_M, 1.0 - 1e-5,
          fast.BETA, fast.EPSILON, fast.KAPPA, dt, dt / 2, dt / 6,
          *cfg.y_alpha, *cfg.m_alpha, *cfg.alpha_min, *cfg.alpha_max,
          *cfg.steering_coefs, *_omega(T_s, analytic),
          fast.SECONDS_PER_MONTH, dt_out]
    ip = [g.nlon, g.nlat, stacks.cell4.shape[0], int(cfg.coupled_track),
          *fast.deep_layer_indices(cfg), stride, n_blocks, n_steps, m,
          k0, sub, int(cfg.rk_exact_stage_fields),
          int(cfg.time_interp_fields), int(analytic)]
    return (np.array([_f32(x) for x in fp], np.float32),
            np.array(ip, np.int32))


def _check(stacks, cfg: Namelist, tensors: dict, m: int, n_steps: int):
    if cfg.debug_fixed_position:
        raise NotImplementedError('debug_fixed_position is not in the '
                                  'integrator kernel')
    if not stacks.geo_in_cell:
        raise NotImplementedError('the integrator kernel needs land/bathy '
                                  'on the atmospheric grid (geo_in_cell)')
    if (cfg.n_wind_levels != 4 or stacks.n_wind_ch != 14
            or stacks.cell4.shape[-1] != 84):
        raise NotImplementedError('the integrator kernel takes two '
                                  'steering levels (84-channel cell rows)')
    if not 1 <= int(cfg.rk_substeps) <= MAX_SUB:
        raise NotImplementedError(f'the integrator kernel takes 1 to '
                                  f'{MAX_SUB} RK4 substeps')
    dev = stacks.cell4.device
    if dev.type != 'cuda':
        raise ValueError(f'integrator kernel needs CUDA tensors, got {dev}')
    rows = (m, 4, fourier.N_FOURIER)
    shapes = {'cell4': None, 'f_all': (n_steps, m, 4), 'A': rows, 'B': rows}
    for name, t in tensors.items():
        if t is None or (name in ('A', 'B') and tensors['f_all'] is not None):
            continue
        want = torch.bool if name == 'alive0' else (
            torch.int32 if name == 'plane' else torch.float32)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {want} tensor on '
                             f'{dev}, got {t.dtype} on {t.device}')
        shape = shapes.get(name, (m,))
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f'{name}: shape {tuple(t.shape)} != {shape}')


def integrate_segment_cuda(stacks, cfg: Namelist, bounds, y0, alive0,
                           params: fast.SeedParams, k0: int, n_steps: int,
                           f_all, stride: int, n_blocks: int):
    """Launch K1 for samples k0 .. k0+n_steps-1.  f_all [n_steps, m, 4] is
    F(t) on the segment's sample times, or None where the mode evaluates
    F(t) in the kernel from params.fourier (rk_exact_stage_fields,
    rk_substeps > 1).  Returns ((lon, lat, v, m, wnds, alive) time-major,
    (y_end, alive_end)) as models/simulator.py integrate_segment_plain."""
    m = y0.lon.shape[0]
    fs = params.fourier
    ins = {'cell4': stacks.cell4, 'f_all': f_all, 'A': fs.A, 'B': fs.B,
           'lon0': y0.lon, 'lat0': y0.lat, 'v0': y0.v, 'm0': y0.m,
           'alive0': alive0,
           'plane': params.plane.to(torch.int32).contiguous(),
           'h_bl': params.h_bl}
    _check(stacks, cfg, ins, m, n_steps)
    dev = stacks.cell4.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty((n_steps, m), **f32) for _ in range(4)]
    out += [torch.empty((n_steps, m, 4), **f32),
            torch.empty((n_steps, m), dtype=torch.bool, device=dev)]
    end = [torch.empty((m,), **f32) for _ in range(4)]
    end += [torch.empty((m,), dtype=torch.bool, device=dev)]
    if m == 0:
        return tuple(out), (fast.State(*end[:4]), end[4])
    fp, ip = _params(stacks, cfg, bounds, m, n_steps, stride, n_blocks, k0,
                     fs.T_s, f_all is None)
    ptrs = [0 if t is None else t.data_ptr()
            for t in list(ins.values()) + out + end]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(fp.ctypes.data, ip.ctypes.data, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f'integrator kernel launch failed: CUDA error '
                           f'{err}')
    kernels.LAUNCHES['integrator'] += 1
    return tuple(out), (fast.State(*end[:4]), end[4])
