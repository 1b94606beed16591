"""K2 wrapper: build csrc/vmax.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused vmax pass
(models/diagnostics.py:193 axi_to_max_wind_raw); see the note at the top of
the source.  Its plain twin is models/diagnostics.py
axi_to_max_wind_raw_plain.  The launch is a 2-D grid of storm blocks by
chunks of rows whose shape follows the segment's length, width and the
card's SM count (launch_geometry).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild

N_POINTERS = 12          # device pointers of tc_vmax
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
    from tropical_cyclone_risk_tpu_torch.models.diagnostics import (
        DEG2RAD, KM2)
    dev = lon.device
    if dev.type != 'cuda':
        raise ValueError(f'vmax kernel needs CUDA tensors, got {dev}')
    T, N = lon.shape
    f32 = torch.float32
    for name, t in (('lon', lon), ('lat', lat), ('tc_v', tc_v)):
        _check(name, t, f32, (T, N), dev)
    _check('env_wnds', env_wnds, f32, (T, N, 4), dev)
    if env_wnds.data_ptr() % 16:
        raise ValueError('env_wnds: the kernel reads each sample\'s four '
                         'winds as one 16-byte load; need 16-byte alignment')
    _check('alive', alive, torch.bool, (T, N), dev)
    last = last_step.to(torch.int64).contiguous()
    _check('last_step', last, torch.int64, (N,), dev)
    for name, p in (('pos_before', pos_before), ('pos_after', pos_after)):
        if p is not None:
            _check(name, p, f32, (2, N), dev)
    if T < 1 or (T < 2 and pos_before is None):
        raise ValueError('the start-edge extrapolation needs two rows')
    if sorted(shear_channels) != [0, 1, 2, 3]:
        raise ValueError(f'shear channels {shear_channels} are not the '
                         f'four winds')
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
    ip = np.array([T, N, chunk, pos_before is not None,
                   pos_after is not None, *shear_channels, threads, blocks,
                   chunks], np.int32)
    fp = np.array([dt_track, KM2, DEG2RAD], np.float32)
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
