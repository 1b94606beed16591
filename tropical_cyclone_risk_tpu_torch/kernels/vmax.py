"""K2 wrapper: build csrc/vmax.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused vmax pass
(models/diagnostics.py:193 axi_to_max_wind_raw); see the note at the top of
the source.  Its plain twin is models/diagnostics.py
axi_to_max_wind_raw_plain.  The launch is a 2-D grid of storm blocks by
chunks of rows whose shape follows the segment's length, width and the
card's SM count (launch_geometry).  The source's second entry, the in-scan
vmax's last-sample fix (fix_last_sample_cuda), has the twin
diagnostics.fix_last_sample_plain.  Both take any even count of winds
from four (two or more steering levels): four, six and eight have
instances of their own, every other count the run-time-stride instance.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild

N_POINTERS = 12          # device pointers of tc_vmax
LAST_POINTERS = 10       # device pointers of tc_vmax_last
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
    lib.tc_vmax_last.argtypes = [ctypes.c_void_p] * (2 + LAST_POINTERS + 1)
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


def fix_last_sample_cuda(vmax_tm, lon, lat, tc_v, env_wnds, alive,
                         last_step, dt_s, shear_channels, pos_before=None):
    """Launch K2's last-sample entry: (vmax_tm fixed in place, vmax_L [N],
    ok [N]) as models/diagnostics.py fix_last_sample_plain."""
    launch, result = last_launcher(vmax_tm, lon, lat, tc_v, env_wnds, alive,
                                   last_step, dt_s, shear_channels,
                                   pos_before)
    launch()
    return result


def last_launcher(vmax_tm, lon, lat, tc_v, env_wnds, alive, last_step, dt_s,
                  shear_channels, pos_before=None):
    """(launch, (vmax_tm, vmax_L, ok)): a function that launches the
    last-sample entry on these inputs, one thread per storm in blocks of
    THREADS; the checks, the outputs and the parameter block are made
    here, once."""
    dev = lon.device
    if dev.type != 'cuda':
        raise ValueError(f'vmax kernel needs CUDA tensors, got {dev}')
    T, N = lon.shape
    f32 = torch.float32
    for name, t in (('vmax', vmax_tm), ('lon', lon), ('lat', lat),
                    ('tc_v', tc_v)):
        _check(name, t, f32, (T, N), dev)
    W = _check_winds(env_wnds, T, N, shear_channels, dev)
    _check('alive', alive, torch.bool, (T, N), dev)
    last = last_step.to(torch.int64).contiguous()
    _check('last_step', last, torch.int64, (N,), dev)
    if pos_before is not None:
        _check('pos_before', pos_before, f32, (2, N), dev)
    vmax_L = torch.empty((N,), dtype=f32, device=dev)
    ok = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0 or T == 0:
        ok.zero_()
        return (lambda: None), (vmax_tm, vmax_L, ok)
    threads = min(THREADS, -(-N // WARP) * WARP)
    ip, fp = _block(T, N, 1, pos_before, None, shear_channels,
                    (threads, -(-N // threads), 1), W, dt_s)
    ptrs = [t.data_ptr() if t is not None else 0
            for t in (lon, lat, tc_v, env_wnds, alive, last, pos_before,
                      vmax_tm, vmax_L, ok)]
    entry = _lib().tc_vmax_last

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = entry(ip.ctypes.data, fp.ctypes.data, *ptrs, stream)
        if err != 0:
            raise RuntimeError(f'vmax last-sample kernel launch failed: CUDA '
                               f'error {err}')
        kernels.LAUNCHES['vmax_last'] += 1

    launch.inputs = (last,)      # alive as long as the launch
    return launch, (vmax_tm, vmax_L, ok)
