"""K5 wrapper: build csrc/rng.cu with nvcc (kernels/build.py), bind it with
ctypes and launch it on PyTorch's current stream.

The kernel replaces the XLA-fused jax.random threefry2x32 stream and its
samplers; see the note at the top of the source.  The dispatch lives in
rng.py (bits / uniform / normal / randint) and ops/fourier.py
(draw_fourier), whose plain twins CPU tensors take.  This module takes
raw key words and the sampler constants rng.py computes, so it does not
import rng.py.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild

MODES = {'bits': (0, torch.int64), 'uniform': (1, torch.float32),
         'normal': (2, torch.float32), 'randint': (3, torch.int32)}
TWO_PI_F32 = float(np.float32(2 * math.pi))
N_FOURIER = 15          # csrc/rng.cu kNF
PHASES = 1 << 23        # uniforms on [0, 1): the float32 mantissas
INT32_MAX = 2 ** 31 - 1


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('rng')


@functools.cache
def _entries():
    lib = ctypes.CDLL(str(build()['path']))
    u32, i64, f64 = ctypes.c_uint32, ctypes.c_int64, ctypes.c_double
    fill = lib.tc_rng_fill
    fill.argtypes = [ctypes.c_int, u32, u32, u32, u32, i64, f64, f64, u32,
                     u32, i64, ctypes.c_void_p, ctypes.c_void_p]
    fill.restype = ctypes.c_int
    ptr, f32 = ctypes.c_void_p, ctypes.c_float
    four = lib.tc_rng_fourier
    four.argtypes = [u32, u32, i64, ptr, f32, ptr, ptr, ptr]
    four.restype = ctypes.c_int
    rows = lib.tc_rng_fourier_rows
    rows.argtypes = [u32, u32, i64, ctypes.c_int, ptr, ptr, f32, ptr, ptr,
                     ptr]
    rows.restype = ctypes.c_int
    table = lib.tc_rng_phase_table
    table.argtypes = [f32, ptr, ptr, ptr]
    table.restype = ctypes.c_int
    return fill, four, rows, table


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != 'cuda':
        raise ValueError(f'threefry kernel needs a CUDA device, got {dev}')
    return torch.device('cuda', torch.cuda.current_device()
                        if dev.index is None else dev.index)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'threefry kernel ({what}) launch failed: CUDA '
                           f'error {err}')
    kernels.LAUNCHES['threefry'] += 1


def fill_cuda(mode: str, key, shape, device, lo: float = 0.0,
              span: float = 0.0, key2=(0, 0), ispan: int = 1, mult: int = 0,
              minval: int = 0) -> torch.Tensor:
    """Launch K5's fill entry: a tensor of ``shape`` holding element i of
    the ``mode`` stream ('bits', 'uniform', 'normal', 'randint') of
    ``key`` (two uint32 words).  lo/span: the uniform's float32 bounds as
    rng.py computes them; key2/ispan/mult/minval: randint's second key,
    range, multiplier and lower bound."""
    dev = _cuda(device)
    code, dtype = MODES[mode]
    out = torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    fill = _entries()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fill(code, key[0], key[1], key2[0], key2[1], out.numel(), lo,
                   span, ispan, mult, minval, out.data_ptr(), stream)
    _check(err, mode)
    return out


def _amp(amp: torch.Tensor) -> torch.device:
    """The card of the N_FOURIER amplitudes the Fourier entries take."""
    dev = _cuda(amp.device)
    if amp.dtype != torch.float32 or tuple(amp.shape) != (N_FOURIER,) or \
            not amp.is_contiguous():
        raise ValueError(f'amp: need a contiguous float32 tensor of shape '
                         f'({N_FOURIER},), got {amp.dtype} '
                         f'{tuple(amp.shape)}')
    return dev


def fourier_cuda(key, shape, amp: torch.Tensor):
    """Launch K5's fused draw_fourier entry: (A, B) of ``shape`` + (15,)
    with A = amp * cos(2 pi phi), B = amp * sin(2 pi phi) and phi the
    uniform stream of ``key``; amp [15] float32 on the card."""
    dev = _amp(amp)
    full = tuple(int(s) for s in shape) + (N_FOURIER,)
    A = torch.empty(full, dtype=torch.float32, device=dev)
    B = torch.empty_like(A)
    if A.numel() == 0:
        return A, B
    if A.numel() > INT32_MAX:
        raise ValueError(f'the Fourier entry takes fewer than 2**31 '
                         f'elements, got {A.numel()}')
    four = _entries()[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = four(key[0], key[1], A.numel(), amp.data_ptr(), TWO_PI_F32,
                   A.data_ptr(), B.data_ptr(), stream)
    _check(err, 'fourier')
    return A, B


def fourier_rows_cuda(key, shape, rows: torch.Tensor, amp: torch.Tensor):
    """Launch K5's row entry: (A, B) [k, C, 15], row j the draw of
    ``fourier_cuda(key, shape, amp)`` at source row rows[j], without the
    full draw.  shape: (n, C), C the wind channels, an even count from 4
    (two or more steering levels; NotImplementedError otherwise: 4, 6 and
    8 have instances of their own, the others the run-time-count one);
    rows [k] int64 on the card, each in [0, n) (not checked on the card:
    the caller's partition order)."""
    n, C = (int(s) for s in shape)
    if C < 4 or C % 2:
        raise NotImplementedError(f'the Fourier row entry takes an even '
                                  f'count of wind channels from 4 (two or '
                                  f'more steering levels), got {C}')
    dev = _amp(amp)
    if rows.device != dev or rows.dtype != torch.int64 or rows.dim() != 1 \
            or not rows.is_contiguous():
        raise ValueError(f'rows: need a contiguous 1-D int64 tensor on '
                         f'{dev}, got {rows.dtype} {tuple(rows.shape)} on '
                         f'{rows.device}')
    k = rows.shape[0]
    A = torch.empty((k, C, N_FOURIER), dtype=torch.float32, device=dev)
    B = torch.empty_like(A)
    if k == 0:
        return A, B
    if A.numel() > INT32_MAX or n * C >= 2 ** 32:
        raise ValueError(f'the Fourier row entry takes fewer than 2**31 '
                         f'outputs from fewer than 2**32 / {C} rows, got '
                         f'{A.numel()} from {n}')
    entry = _entries()[2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(key[0], key[1], A.numel(), C, rows.data_ptr(),
                    amp.data_ptr(), TWO_PI_F32, A.data_ptr(), B.data_ptr(),
                    stream)
    _check(err, 'fourier rows')
    return A, B


def phase_table(device):
    """(cos, sin) [PHASES] of the Fourier entries' phase function at every
    phase they meet, float32(2 pi) * m * 2**-23 (csrc/rng.cu
    tc_rng_phase_table); not counted as a launch of the main path."""
    dev = _cuda(device)
    c = torch.empty((PHASES,), dtype=torch.float32, device=dev)
    s = torch.empty_like(c)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entries()[3](TWO_PI_F32, c.data_ptr(), s.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'phase table launch failed: CUDA error {err}')
    return c, s
