"""K2 wrapper: build csrc/vmax.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused vmax pass
(models/diagnostics.py:193 axi_to_max_wind_raw); see the note at the top of
the source.  Its plain twin is models/diagnostics.py
axi_to_max_wind_raw_plain.  The launch is a 2-D grid of storm blocks by
chunks of rows whose shape follows the segment's length, width and the
card's SM count (launch_geometry).  The source's second entry, the in-scan
vmax's last-sample fix, takes every segment of a launch in one launch
(fix_in_scan_cuda: the fixed samples written in place and banked into the
peak, twin diagnostics.fix_in_scan_plain) or one segment
(fix_last_sample_cuda, twin diagnostics.fix_last_sample_plain).  Both
entries take any even count of winds from four (two or more steering
levels): four, six and eight have instances of their own, every other
count the run-time-stride instance.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild

N_POINTERS = 12          # device pointers of tc_vmax
MAX_SEGS = 16            # csrc/vmax.cu kMaxSegs (the last-sample entry)
THREADS = 128            # csrc/vmax.cu kThreads (__launch_bounds__)
MAX_CHUNKS = 65535       # csrc/vmax.cu kMaxChunks (gridDim.y)
WARP = 32
# blocks wanted per SM, and the shortest chunk (its two halo rows of
# lon / lat cost 16 bytes per storm against 33 per row)
BLOCKS_PER_SM = 8
MIN_CHUNK = 4


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('vmax')


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build()['path']))
    lib.tc_vmax.argtypes = [ctypes.c_void_p] * (2 + N_POINTERS + 1)
    lib.tc_vmax.restype = ctypes.c_int
    lib.tc_vmax_last.argtypes = [ctypes.c_void_p] * 3
    lib.tc_vmax_last.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_geometry(T: int, N: int, n_sm: int):
    """(threads per block, storm blocks, rows per chunk, chunks) for a
    [T, N] segment on a card of n_sm SMs: blocks of THREADS storms (one
    warp-rounded block below that), and T cut into as many chunks as gives
    about BLOCKS_PER_SM blocks per SM, no chunk shorter than MIN_CHUNK rows
    (nor than T).  40960 storms x 60 rows on 132 SMs: 320 x 4 blocks of
    15 rows; 4096 x 40: 32 x 10 of 4."""
    threads = min(THREADS, -(-N // WARP) * WARP)
    blocks = -(-N // threads)
    want = -(-BLOCKS_PER_SM * n_sm // blocks)
    chunk = max(min(MIN_CHUNK, T), -(-T // want), -(-T // MAX_CHUNKS))
    return threads, blocks, chunk, -(-T // chunk)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous {dtype} tensor on '
                         f'{device}, got {t.dtype} on {t.device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)} != {tuple(shape)}')


def _check_winds(env_wnds, T, N, shear_channels, dev):
    """The winds [T, N, W] the kernels read: W an even count from four
    (two or more steering levels; NotImplementedError otherwise), the shear
    channels the deep-layer (u, v) pairs among them, aligned for the
    kernels' loads (16 bytes for four winds, 8 for each pair)."""
    W = env_wnds.shape[-1] if env_wnds.dim() == 3 else -1
    if W < 4 or W % 2:
        raise NotImplementedError(f'the vmax kernels take an even count of '
                                  f'winds per sample from 4, got '
                                  f'{tuple(env_wnds.shape)}')
    _check('env_wnds', env_wnds, torch.float32, (T, N, W), dev)
    iu2, iv2, iu8, iv8 = shear_channels
    if not (all(0 <= i < W for i in shear_channels) and iu2 % 2 == 0
            and iu8 % 2 == 0 and iv2 == iu2 + 1 and iv8 == iu8 + 1
            and iu2 != iu8):
        raise ValueError(f'shear channels {shear_channels} are not two '
                         f'(u, v) pairs of the {W} winds')
    align = 16 if W == 4 else 8
    if env_wnds.data_ptr() % align:
        raise ValueError(f'env_wnds: the kernels read the shear winds as '
                         f'{align}-byte loads; need that alignment')
    return W


def _block(T, N, chunk, pos_before, pos_after, shear_channels, geometry,
           W, dt_track):
    """The parameter blocks (ip, fp) of csrc/vmax.cu read_params: fp holds
    the float32 reciprocal of the output interval, as torch multiplies by
    it where the twin divides by it."""
    from tropical_cyclone_risk_tpu_torch.models.diagnostics import (
        DEG2RAD, KM2)
    ip = np.array([T, N, chunk, pos_before is not None,
                   pos_after is not None, *shear_channels, *geometry, W],
                  np.int32)
    fp = np.array([np.float32(1.0) / np.float32(dt_track), KM2, DEG2RAD],
                  np.float32)
    return ip, fp


def axi_to_max_wind_raw_cuda(lon, lat, dt_track, tc_v, env_wnds, alive,
                             last_step, shear_channels, pos_before=None,
                             pos_after=None):
    """Launch K2: (vmax [T, N], peak [N]) exactly as
    models/diagnostics.py axi_to_max_wind_raw_plain."""
    launch, result = launcher(lon, lat, dt_track, tc_v, env_wnds, alive,
                              last_step, shear_channels, pos_before,
                              pos_after)
    launch()
    return result


def launcher(lon, lat, dt_track, tc_v, env_wnds, alive, last_step,
             shear_channels, pos_before=None, pos_after=None):
    """(launch, (vmax, peak)): a function that launches K2 on these inputs
    (as axi_to_max_wind_raw_cuda), writing vmax and peak.  The checks, the
    outputs, the scratch and the parameter block are made here, once, so
    that repeated launches time the kernel alone (the kernel leaves its
    counters at zero)."""
    dev = lon.device
    if dev.type != 'cuda':
        raise ValueError(f'vmax kernel needs CUDA tensors, got {dev}')
    T, N = lon.shape
    f32 = torch.float32
    for name, t in (('lon', lon), ('lat', lat), ('tc_v', tc_v)):
        _check(name, t, f32, (T, N), dev)
    W = _check_winds(env_wnds, T, N, shear_channels, dev)
    _check('alive', alive, torch.bool, (T, N), dev)
    last = last_step.to(torch.int64).contiguous()
    _check('last_step', last, torch.int64, (N,), dev)
    for name, p in (('pos_before', pos_before), ('pos_after', pos_after)):
        if p is not None:
            _check(name, p, f32, (2, N), dev)
    if T < 1 or (T < 2 and pos_before is None):
        raise ValueError('the start-edge extrapolation needs two rows')
    vmax = torch.empty((T, N), dtype=f32, device=dev)
    peak = torch.empty((N,), dtype=f32, device=dev)
    if N == 0:
        return (lambda: None), (vmax, peak)
    threads, blocks, chunk, chunks = launch_geometry(T, N,
                                                     _sm_count(dev.index))
    partial = torch.empty((chunks if chunks > 1 else 0, N), dtype=f32,
                          device=dev)
    count = torch.zeros((blocks if chunks > 1 else 0,), dtype=torch.int32,
                        device=dev)
    ip, fp = _block(T, N, chunk, pos_before, pos_after, shear_channels,
                    (threads, blocks, chunks), W, dt_track)
    ptrs = [t.data_ptr() if t is not None else 0
            for t in (lon, lat, tc_v, env_wnds, alive, last, pos_before,
                      pos_after, vmax, peak, partial, count)]
    entry = _lib().tc_vmax

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = entry(ip.ctypes.data, fp.ctypes.data, *ptrs, stream)
        if err != 0:
            raise RuntimeError(f'vmax kernel launch failed: CUDA error {err}')
        kernels.LAUNCHES['vmax'] += 1

    launch.inputs = (last, partial, count)   # alive as long as the launch
    return launch, (vmax, peak)


def last_plan(widths, threads: int = THREADS):
    """The last-sample entry's grid over segments of these widths: (first
    block of each segment, total blocks), each segment ceil(width /
    threads) blocks after the ones before it (a segment without columns
    has none)."""
    first, total = [], 0
    for w in widths:
        first.append(total)
        total += -(-int(w) // threads)
    return first, total


def _last_table(segs, last, peak, outs, shear_channels, W, dt_s, dev):
    """The last-sample entry's parameter blocks (ip int64, fp float32) of
    csrc/vmax.cu tc_vmax_last: the segment table with its first blocks
    (last_plan) and every pointer as an integer (0 for None)."""
    from tropical_cyclone_risk_tpu_torch.models.diagnostics import (
        DEG2RAD, KM2)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    widths = [g['lon'].shape[1] for g in segs]
    first, blocks = last_plan(widths)
    vmax_L, ok = outs if outs is not None else (None, None)
    ip = [len(segs), W, *shear_channels, THREADS, max(blocks, 1),
          ptr(last), ptr(peak), ptr(vmax_L), ptr(ok)]
    for g, f in zip(segs, first):
        ip += [int(g['edge']), g['lon'].shape[0], g['lon'].shape[1], f,
               *(ptr(g[k]) for k in ('lon', 'lat', 'v', 'wnds', 'alive',
                                     'vmax', 'a_idx', 'order', 'before_lon',
                                     'before_lat'))]
    fp = np.array([np.float32(1.0) / np.float32(dt_s), KM2, DEG2RAD],
                  np.float32)
    return np.array(ip, np.int64), fp, blocks


def last_launcher(segs, last_step, dt_s, shear_channels, peak=None,
                  outs=False):
    """(launch, result): a function that launches the last-sample entry
    once over the segments `segs` (at most MAX_SEGS), writing the tensors
    of ``result``; the checks, the outputs and the parameter blocks are
    made here, once.  Each segment is a dict of its time-major [T, w]
    buffers 'lon', 'lat', 'v', 'alive' (bool), 'wnds' [T, w, W] and
    'vmax' (fixed in place), its first step 'edge' on the launch's time
    axis, 'a_idx' ([w] int64 m slots, or None: the column itself),
    'before_lon' / 'before_lat' (float32 rows of the samples before its
    first row, or None) read at 'order' ([w] int64 columns, or None: the
    column itself).  last_step [m] int64 is each slot's last step on the
    launch's time axis; peak [m] float32 (or None) takes each ok fixed
    sample in place; with outs (one segment) the result is (vmax, vmax_L,
    ok), else (the vmax buffers, peak)."""
    if not 1 <= len(segs) <= MAX_SEGS:
        raise ValueError(f'the last-sample entry takes 1 to {MAX_SEGS} '
                         f'segments, got {len(segs)}')
    dev = segs[0]['lon'].device
    if outs and len(segs) != 1:
        raise ValueError('vmax_L and ok are written on one segment only')
    f32, i64 = torch.float32, torch.int64
    W = None
    for k, g in enumerate(segs):
        T, N = g['lon'].shape
        if T < 1:
            raise ValueError(f'segment {k}: no rows')
        for name in ('vmax', 'lon', 'lat', 'v'):
            _check(name, g[name], f32, (T, N), dev)
        w = _check_winds(g['wnds'], T, N, shear_channels, dev)
        if W is not None and w != W:
            raise ValueError(f'segment {k}: {w} winds, not {W}')
        W = w
        _check('alive', g['alive'], torch.bool, (T, N), dev)
        for name in ('a_idx', 'order'):
            if g.get(name) is not None:
                _check(name, g[name], i64, (N,), dev)
        rows = [g.get('before_lon'), g.get('before_lat')]
        if (rows[0] is None) != (rows[1] is None):
            raise ValueError(f'segment {k}: before_lon and before_lat '
                             f'go together')
        for name, r in zip(('before_lon', 'before_lat'), rows):
            if r is not None:
                _check(name, r, f32, (r.shape[0],), dev)
    if dev.type != 'cuda':
        raise ValueError(f'vmax kernel needs CUDA tensors, got {dev}')
    last = last_step.to(i64).contiguous()
    _check('last_step', last, i64, (last.shape[0],), dev)
    if peak is not None:
        _check('peak', peak, f32, tuple(last.shape), dev)
    N0 = segs[0]['lon'].shape[1]
    res_outs = None
    if outs:
        res_outs = (torch.empty((N0,), dtype=f32, device=dev),
                    torch.zeros((N0,), dtype=torch.bool, device=dev))
    table = [{'a_idx': None, 'order': None, 'before_lon': None,
              'before_lat': None, **g} for g in segs]
    ip, fp, blocks = _last_table(table, last, peak, res_outs,
                                 shear_channels, W, dt_s, dev)
    result = ((segs[0]['vmax'],) + res_outs if outs
              else (tuple(g['vmax'] for g in segs), peak))
    if blocks == 0:
        return (lambda: None), result
    entry = _lib().tc_vmax_last

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = entry(ip.ctypes.data, fp.ctypes.data, stream)
        if err != 0:
            raise RuntimeError(f'vmax last-sample kernel launch failed: CUDA '
                               f'error {err}')
        kernels.LAUNCHES['vmax_last'] += 1

    launch.inputs = (last, table)    # alive as long as the launch
    return launch, result


def fix_in_scan_cuda(segs, last_step, peak, dt_s, shear_channels):
    """Launch the last-sample entry once over every segment of an in-scan
    launch (last_launcher's segs): each segment's vmax fixed in place and
    peak [m] updated in place, as models/diagnostics.py
    fix_in_scan_plain.  Returns (the vmax buffers, peak)."""
    launch, result = last_launcher(segs, last_step, dt_s, shear_channels,
                                   peak)
    launch()
    return result


def fix_last_sample_cuda(vmax_tm, lon, lat, tc_v, env_wnds, alive,
                         last_step, dt_s, shear_channels, pos_before=None):
    """The last-sample entry on one segment: (vmax_tm fixed in place,
    vmax_L [N], ok [N]) as models/diagnostics.py fix_last_sample_plain
    (last_step segment-local, pos_before [2, N] or None)."""
    if lon.device.type != 'cuda':
        raise ValueError(f'vmax kernel needs CUDA tensors, got {lon.device}')
    seg = {'lon': lon, 'lat': lat, 'v': tc_v, 'wnds': env_wnds,
           'alive': alive, 'vmax': vmax_tm, 'edge': 0}
    if pos_before is not None:
        if tuple(pos_before.shape) != (2, lon.shape[1]):
            raise ValueError(f'pos_before: shape {tuple(pos_before.shape)} '
                             f'!= {(2, lon.shape[1])}')
        seg.update(before_lon=pos_before[0], before_lat=pos_before[1])
    launch, result = last_launcher([seg], last_step, dt_s, shear_channels,
                                   outs=True)
    launch()
    return result
