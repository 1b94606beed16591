"""K1 and K7 wrappers: build csrc/integrator.cu with nvcc
(kernels/build.py), bind it with ctypes and launch its kernels on
PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused segment loop; see the note
at the top of the source.  Its plain twin is models/simulator.py
integrate_segment_plain.  It takes the three stack layouts of
models/fields.py GatherStacks (geo_layout): land and bathymetry in the
cell row, on one grid of their own, or each on its own grid.  The
default path streams F(t) from the per-step grid; under
rk_exact_stage_fields or rk_substeps > 1 the kernel evaluates F(t) from
the storms' Fourier rows with w_n from ops/fourier._omega.  The launch's
shape follows the segment's width and the card's SM count
(launch_geometry).

The source builds into one library per unit: a steering-level count
(any count fast.deep_layer_indices takes), with or without the in-scan
vmax (Namelist.vmax_in_scan, the DiagState carry of models/simulator.py);
the launch takes the unit of its configuration, built the first time a
run asks for it (kernels/build.py keeps it for later runs).  UNITS lists
the units chip_smoke.py builds up front.  From GROUP_LEVELS levels on a
unit runs the group kernels, a group of group_lanes(levels) lanes per
storm with its vectors in a slice of shared memory (group_stride floats),
which launch_geometry sizes.

K7, the genesis gate (genesis_gate_cuda), is the file's second kernel:
the step-0 keep mask from K1's gather, Cholesky and coloring at t = 0.
Its plain twin is models/simulator.py genesis_alive_plain.  At two to
four levels it stages each seed's rows in a slot of shared memory
(gate_slot), the next batch's copies in flight while it computes;
gate_plan sizes its blocks.
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

N_POINTERS = 31          # device pointers of tc_integrate_segment
MAX_SUB = 8              # csrc/integrator.cu kMaxSub
MAX_THREADS = 64         # csrc/integrator.cu kMaxThreads (__launch_bounds__)
# K7 at two to four levels (csrc/integrator.cu genesis_gate_kernel): its
# threads per block (gate_plan) and their most (kGateThreads)
GATE_THREADS = 32
GATE_MAX_THREADS = 128
GATE_POINTERS = 9        # device pointers of tc_genesis_gate
# csrc/integrator.cu sincos_rad: CUDA's sinf/cosf fast path below this |x|
FAST_TRIG_LIMIT = 105615.0
WARP = 32
# the (levels, in-scan vmax) units chip_smoke.py builds before its phases
# (TC_K1_LEVELS, TC_K1_DIAG): two to four levels with and without the
# in-scan vmax, and the level sets of its [levels4] phase; any other unit is
# built at its first launch
UNITS = ((2, False), (2, True), (3, False), (3, True), (4, False),
         (4, True), (5, False), (5, True), (7, False), (15, False),
         (17, False))
# csrc/integrator.cu's group units: the level count from which a unit runs
# them (kGroupLevels), their threads per block (kGroupThreads), a block's
# shared memory (kMaxSharedBytes) and the analytic instances' static
# sin/cos tables (2 kMaxTimes kNF floats)
GROUP_LEVELS = 5
GROUP_THREADS = 128
MAX_SHARED_BYTES = 232448
TABLE_BYTES = 2 * 3 * MAX_SUB * fourier.N_FOURIER * 4
# csrc/integrator.cu's stack layouts (kInCell, kFusedGeo, kSeparateGeo)
IN_CELL, FUSED_GEO, SEPARATE_GEO = 0, 1, 2


def wind_channels(levels: int) -> int:
    """Wind-stat channels of `levels` steering levels: 2 L means and the
    2 L (2 L + 1) / 2 packed lower-triangle covariance entries."""
    W = 2 * levels
    return W + W * (W + 1) // 2


def cell_row(layout: int, levels: int) -> int:
    """Floats of a corner-packed cell row (csrc/integrator.cu Ch): the wind
    statistics, five env channels and, in the cell, land and bathymetry,
    times four corners (84 or 76 at two levels, 136 or 128 at three, 204
    or 196 at four)."""
    return 4 * (wind_channels(levels) + (7 if layout == IN_CELL else 5))


def build(levels: int = 2, diag: bool = False) -> dict:
    """Build (or find) the library of one unit; see kernels/build.py.  A
    unit of GROUP_LEVELS levels or more compiles the group kernels
    (csrc/integrator.cu), whose loops over the winds, the channels and the
    factor's columns stay rolled, so any count builds in about the time of
    the small ones."""
    return kbuild.library('integrator', (('TC_K1_LEVELS', int(levels)),
                                         ('TC_K1_DIAG', int(diag))))


@functools.cache
def _lib(levels: int = 2, diag: bool = False):
    lib = ctypes.CDLL(str(build(levels, diag)['path']))
    lib.tc_integrate_segment.argtypes = [ctypes.c_void_p] * (
        2 + N_POINTERS + 1)
    lib.tc_integrate_segment.restype = ctypes.c_int
    if diag:
        return lib
    lib.tc_k1_trig_check.argtypes = [ctypes.c_uint32, ctypes.c_uint32] + [
        ctypes.c_void_p] * 3
    lib.tc_k1_trig_check.restype = ctypes.c_int
    lib.tc_genesis_gate.argtypes = [ctypes.c_void_p] * (
        2 + GATE_POINTERS + 1)
    lib.tc_genesis_gate.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_lanes(levels: int) -> int:
    """Lanes per storm of a group unit (csrc/integrator.cu group_lanes):
    the smallest power of two of at least W / 6 winds (at most six rows a
    lane), from 4 to 32."""
    W, g = 2 * levels, 4
    while g < WARP and 6 * g < W:
        g *= 2
    return g


def group_stride(levels: int) -> int:
    """Floats of a storm's slice of shared memory in a group unit
    (csrc/integrator.cu Group::Stride): the cell row, F(t) and the winds,
    made odd."""
    W = 2 * levels
    return (wind_channels(levels) + 7 + 2 * W) | 1


def launch_geometry(width: int, n_sm: int, levels: int = 2):
    """(storms per block, threads per block, blocks) for a segment of
    `width` storms on a card of n_sm SMs: as many storms per block as
    leaves at least min(width, n_sm) blocks, so every segment spreads over
    every SM it can fill.  Below GROUP_LEVELS levels a thread per storm,
    in whole warps from one warp up, at most MAX_THREADS; below a warp,
    that many storms in one warp (40960 storms: 640 blocks of two warps,
    9.7 warps per SM; 128-thread blocks left 2 or 3 blocks).  From
    GROUP_LEVELS on group_lanes(levels) lanes per storm, at most
    GROUP_THREADS threads and as many slices (group_stride) as a block's
    shared memory holds beside the analytic tables, in whole warps once a
    block fills one."""
    if levels < GROUP_LEVELS:
        per = max(1, width // n_sm)
        if per >= WARP:
            per = min(MAX_THREADS, per // WARP * WARP)
        threads = -(-per // WARP) * WARP
        return per, threads, -(-width // per)
    lanes = group_lanes(levels)
    cap = min(GROUP_THREADS // lanes,
              (MAX_SHARED_BYTES - TABLE_BYTES) // (4 * group_stride(levels)))
    per = max(1, min(cap, width // n_sm))
    per_warp = WARP // lanes
    if per >= per_warp:
        per = per // per_warp * per_warp
    threads = -(-(per * lanes) // WARP) * WARP
    return per, threads, -(-width // per)


def levels(cfg: Namelist) -> int:
    """cfg's steering-level count, the unit its launches take; raises
    what fast.deep_layer_indices raises (ValueError: 250 or 850 hPa
    missing) and takes every other count."""
    fast.deep_layer_indices(cfg)
    return cfg.n_steering_levels


def trig_check(lo: int, count: int, device) -> tuple:
    """(mismatches, smallest mismatching bit pattern or None) of the
    kernel's sin and cos (sincos_rad) against CUDA's sinf and cosf on the
    float32 bit patterns lo .. lo + count - 1 (csrc/integrator.cu
    tc_k1_trig_check)."""
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    first = torch.full((1,), -1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().tc_k1_trig_check(lo, count, bad.data_ptr(),
                                     first.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'cos check launch failed: CUDA error {err}')
    n_bad = int(bad.item())
    return n_bad, (int(first.item()) & 0xffffffff) if n_bad else None


def geo_layout(stacks) -> int:
    """The kernels' stack layout of a GatherStacks: IN_CELL (land and
    bathymetry in the cell row), FUSED_GEO (both in land_geo4, on one grid
    that is not the wind grid) or SEPARATE_GEO (land_geo4 and bathy4 on
    two grids)."""
    if stacks.geo_in_cell:
        return IN_CELL
    return FUSED_GEO if stacks.fused_geo else SEPARATE_GEO


def geo_inputs(stacks) -> dict:
    """The land and bathymetry stacks the layout's kernels read (None
    where they read nothing): land_geo4 outside the cell row, bathy4 in
    the separate layout alone."""
    layout = geo_layout(stacks)
    return {'geo4': None if layout == IN_CELL else stacks.land_geo4,
            'bathy4': stacks.bathy4 if layout == SEPARATE_GEO else None}


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
            analytic: bool, geometry, diag: bool = False, t_last: int = -1):
    """The kernel's scalar parameters, each float the float32 rounding of
    the constant the plain twin uses (see csrc/integrator.cu Params and
    read_params): the per-level steering coefficients, the deep-layer
    shear's four channels, the unit (levels, diag), the run's last sample
    t_last of the in-scan vmax, and the float32 reciprocal of the output
    interval that vmax_at multiplies by; the land and bathymetry grids are
    the stacks' own (the cell grid's in the in-cell layout, which does not
    read them)."""
    from tropical_cyclone_risk_tpu_torch.models.diagnostics import KM2
    g, gl, gb = stacks.grid, stacks.land_grid, stacks.bathy_grid
    dt_out = float(cfg.output_interval_s)
    sub = max(1, int(cfg.rk_substeps))
    dt = dt_out / sub
    lon_min, lat_min, lon_max, lat_max = bounds
    omega = _omega(T_s, analytic)
    if max(omega) * (k0 + n_steps) * dt_out >= 0.999 * FAST_TRIG_LIMIT:
        raise NotImplementedError(f'the integrator kernel takes F(t) phases '
                                  f'below {FAST_TRIG_LIMIT} rad (T_days too '
                                  f'short for the track time)')
    fp = [g.lon0, g.dlon, g.lat0, g.dlat,
          lon_min + 1.0, lat_min + 1.0, lon_max - 1.0, lat_max - 1.0,
          0.5 * cfg.Ck, cfg.u_beta, cfg.v_beta, fast.MS_TO_KTS,
          fast.DEG2RAD, fast.RAD_PER_M, 1.0 - 1e-5,
          fast.BETA, fast.EPSILON, fast.KAPPA, dt, dt / 2, dt / 6,
          *cfg.y_alpha, *cfg.m_alpha, *cfg.alpha_min, *cfg.alpha_max,
          *cfg.steering_coefs, *omega,
          fast.SECONDS_PER_MONTH, dt_out,
          np.float32(1.0) / np.float32(dt_out), KM2,
          gl.lon0, gl.dlon, gl.lat0, gl.dlat,
          gb.lon0, gb.dlon, gb.lat0, gb.dlat]
    ip = [g.nlon, g.nlat, stacks.cell4.shape[0], int(cfg.coupled_track),
          *fast.deep_layer_indices(cfg), stride, n_blocks, n_steps, m,
          k0, sub, int(cfg.rk_exact_stage_fields), geo_layout(stacks),
          gl.nlon, gl.nlat, gb.nlon, gb.nlat,
          int(cfg.time_interp_fields), int(analytic), levels(cfg),
          int(diag), t_last, int(cfg.debug_fixed_position), *geometry]
    return (np.array([_f32(x) for x in fp], np.float32),
            np.array(ip, np.int32))


def _check(stacks, cfg: Namelist, tensors: dict, m: int, n_steps: int):
    """K1's (and K7's) checks: the options the kernels do not take raise
    NotImplementedError, tensors that are not on CUDA or not of the
    kernel's type, layout and shape raise ValueError."""
    layout = geo_layout(stacks)
    lv = levels(cfg)
    row = cell_row(layout, lv)
    if (stacks.n_wind_ch != wind_channels(lv)
            or stacks.cell4.shape[-1] != row):
        raise NotImplementedError(f'the integrator kernel takes {row}-'
                                  f'channel cell rows at {lv} steering '
                                  f'levels in this stack layout, got '
                                  f'{stacks.cell4.shape[-1]}')
    if not 1 <= int(cfg.rk_substeps) <= MAX_SUB:
        raise NotImplementedError(f'the integrator kernel takes 1 to '
                                  f'{MAX_SUB} RK4 substeps')
    dev = stacks.cell4.device
    if dev.type != 'cuda':
        raise ValueError(f'integrator kernel needs CUDA tensors, got {dev}')
    W = cfg.n_wind_levels
    rows = (m, W, fourier.N_FOURIER)
    shapes = {'cell4': None, 'f_all': (n_steps, m, W), 'A': rows, 'B': rows,
              'geo4': (stacks.land_grid.nlat, stacks.land_grid.nlon,
                       8 if layout == FUSED_GEO else 4),
              'bathy4': (stacks.bathy_grid.nlat, stacks.bathy_grid.nlon, 4)}
    for name, t in tensors.items():
        if t is None or (name in ('A', 'B') and tensors['f_all'] is not None):
            continue
        want = torch.bool if name in ('alive0', 'integrate') else (
            torch.int32 if name == 'plane' else torch.float32)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {want} tensor on '
                             f'{dev}, got {t.dtype} on {t.device}')
        shape = shapes.get(name, (m,))
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f'{name}: shape {tuple(t.shape)} != {shape}')


def integrate_segment_cuda(stacks, cfg: Namelist, bounds, y0, alive0,
                           params: fast.SeedParams, k0: int, n_steps: int,
                           f_all, stride: int, n_blocks: int, diag=None,
                           t_last: int = -1):
    """Launch K1 for samples k0 .. k0+n_steps-1.  f_all [n_steps, m, W] is
    F(t) on the segment's sample times, or None where the mode evaluates
    F(t) in the kernel from params.fourier (rk_exact_stage_fields,
    rk_substeps > 1).  Returns ((lon, lat, v, m, wnds, alive) time-major,
    (y_end, alive_end)) as models/simulator.py integrate_segment_plain;
    with a DiagState diag, (lon, lat, v, m, wnds, alive, vmax) and
    (y_end, alive_end, diag_end)."""
    launch, result = launcher(stacks, cfg, bounds, y0, alive0, params, k0,
                              n_steps, f_all, stride, n_blocks, diag, t_last)
    launch()
    return result


def launcher(stacks, cfg: Namelist, bounds, y0, alive0,
             params: fast.SeedParams, k0: int, n_steps: int, f_all,
             stride: int, n_blocks: int, diag=None, t_last: int = -1):
    """(launch, result): a function that launches K1 on these inputs (as
    integrate_segment_cuda), writing the tensors of ``result``.  The
    checks, the outputs, the launch shape and the parameter block are made
    here, once, so that repeated launches time the kernel alone."""
    m = y0.lon.shape[0]
    fs = params.fourier
    ins = {'cell4': stacks.cell4, **geo_inputs(stacks), 'f_all': f_all,
           'A': fs.A, 'B': fs.B,
           'lon0': y0.lon, 'lat0': y0.lat, 'v0': y0.v, 'm0': y0.m,
           'alive0': alive0,
           'plane': params.plane.to(torch.int32).contiguous(),
           'h_bl': params.h_bl}
    # the in-scan vmax carry, in the pointer list after the end state
    d_ins = dict(zip(('prev_lon', 'prev_lat', 'peak'),
                     diag if diag is not None else (None,) * 3))
    _check(stacks, cfg, {**ins, **d_ins}, m, n_steps)
    dev = stacks.cell4.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty((n_steps, m), **f32) for _ in range(4)]
    out += [torch.empty((n_steps, m, cfg.n_wind_levels), **f32),
            torch.empty((n_steps, m), dtype=torch.bool, device=dev)]
    end = [torch.empty((m,), **f32) for _ in range(4)]
    end += [torch.empty((m,), dtype=torch.bool, device=dev)]
    carry = (fast.State(*end[:4]), end[4])
    d_out = [None] * 4          # vmax and the DiagState at the end
    if diag is not None:
        d_out = [torch.empty((n_steps, m), **f32)]
        d_out += [torch.empty((m,), **f32) for _ in range(3)]
        carry += (type(diag)(*d_out[1:]),)
    result = tuple(out) + tuple(d_out[:1] if diag is not None else ()), carry
    if m == 0:
        return (lambda: None), result
    geometry = launch_geometry(m, _sm_count(dev.index), levels(cfg))
    fp, ip = _params(stacks, cfg, bounds, m, n_steps, stride, n_blocks, k0,
                     fs.T_s, f_all is None, geometry, diag is not None,
                     t_last)
    ptrs = [0 if t is None else t.data_ptr()
            for t in [*ins.values(), *out, *end, *d_ins.values(), *d_out]]
    entry = _lib(levels(cfg), diag is not None).tc_integrate_segment

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = entry(fp.ctypes.data, ip.ctypes.data, *ptrs, stream)
        if err != 0:
            raise RuntimeError(f'integrator kernel launch failed: CUDA error '
                               f'{err}')
        kernels.LAUNCHES['integrator'] += 1

    launch.inputs = ins      # the plane cast lives as long as the launch
    return launch, result


def gate_slot(levels: int, layout: int) -> dict:
    """A seed's slot of K7's shared memory at two to four levels
    (csrc/integrator.cu GateRows), in floats: the cell row at 'cell' (0),
    land_geo4's row (fused: 8 floats) or land_geo4's and bathy4's rows
    (separate: 4 each) at 'geo', the [W, 15] B row at 'b', and the slot's
    'stride', an odd count of 16-byte words (148 / 228 / 324 floats at
    two / three / four levels, in every layout)."""
    geo = cell_row(layout, levels)
    b = geo + (0 if layout == IN_CELL else 8)
    words = (b + 2 * levels * fourier.N_FOURIER + 3) // 4 | 1
    return {'cell': 0, 'geo': geo, 'b': b, 'stride': 4 * words}


def gate_plan(m: int, levels: int, threads: int = None):
    """(seeds per block, threads per block, blocks) of K7 at two to four
    levels for m seeds: `threads` (GATE_THREADS where None) in whole
    warps, a warp's slots holding
    one batch of 32 seeds at a time, and the blocks that give every batch
    a warp; the kernel's entry launches as many of them as the card keeps
    resident, each warp then taking every n-th batch (csrc/integrator.cu
    gate_launch).  One warp a block by default (18.9 / 29.2 / 41.5 KB of
    slots at two / three / four levels), so that blocks pack an SM's
    shared memory.  Raises ValueError for a shape the kernel refuses."""
    threads = threads or GATE_THREADS
    if not (WARP <= threads <= GATE_MAX_THREADS and threads % WARP == 0
            and gate_bytes(levels, threads) <= MAX_SHARED_BYTES):
        raise ValueError(f'K7 takes whole warps up to {GATE_MAX_THREADS} '
                         f'threads a block within {MAX_SHARED_BYTES} bytes '
                         f'of slots, got {threads} at {levels} levels')
    batches = max(1, -(-m // WARP))
    return threads, threads, -(-batches // (threads // WARP))


def gate_bytes(levels: int, per_block: int) -> int:
    """The dynamic shared memory of a K7 block of per_block seeds at two
    to four levels (csrc/integrator.cu gate_bytes)."""
    return 4 * per_block * gate_slot(levels, IN_CELL)['stride']


def gate_params(stacks, cfg: Namelist, m: int):
    """K7's parameter block: K1's layout (_params) for m seeds with no
    steps, basin bounds of zeros (the gate does not read them) and
    gate_plan's blocks, or from GROUP_LEVELS levels on a group per seed,
    as many as a block takes (launch_geometry)."""
    lv = levels(cfg)
    geometry = (launch_geometry(m, 1, lv) if lv >= GROUP_LEVELS else
                gate_plan(m, lv))
    return _params(stacks, cfg, (0.0,) * 4, m, 0, 1, 0, 0, 0.0, False,
                   geometry)


def genesis_gate_cuda(stacks, cfg: Namelist, y0, params: fast.SeedParams,
                      integrate_mask):
    """Launch K7: the step-0 keep mask [m] exactly as models/simulator.py
    genesis_alive_plain, integrate_mask & the ventilation gate."""
    launch, keep = gate_launcher(stacks, cfg, y0, params, integrate_mask)
    launch()
    return keep


def gate_launcher(stacks, cfg: Namelist, y0, params: fast.SeedParams,
                  integrate_mask):
    """(launch, keep): a function that launches K7 on these inputs (as
    genesis_gate_cuda), writing ``keep``; the checks, the output and the
    parameter block are made here, once.  Raises where K1's launcher
    raises, and takes the stack layouts K1 takes."""
    m = y0.lon.shape[0]
    ins = {'cell4': stacks.cell4, **geo_inputs(stacks), 'f_all': None,
           'B': params.fourier.B,
           'lon0': y0.lon, 'lat0': y0.lat,
           'plane': params.plane.to(torch.int32).contiguous(),
           'integrate': integrate_mask}
    _check(stacks, cfg, ins, m, 0)
    dev = stacks.cell4.device
    keep = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return (lambda: None), keep
    fp, ip = gate_params(stacks, cfg, m)
    ptrs = [0 if t is None else t.data_ptr()
            for name, t in ins.items() if name != 'f_all']
    ptrs.append(keep.data_ptr())
    entry = _lib(levels(cfg)).tc_genesis_gate

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = entry(fp.ctypes.data, ip.ctypes.data, *ptrs, stream)
        if err != 0:
            raise RuntimeError(f'genesis gate kernel launch failed: CUDA '
                               f'error {err}')
        kernels.LAUNCHES['genesis'] += 1

    launch.inputs = ins      # the plane cast lives as long as the launch
    return launch, keep
