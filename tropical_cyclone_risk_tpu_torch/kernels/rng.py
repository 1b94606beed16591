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
    four = lib.tc_rng_fourier
    four.argtypes = [u32, u32, i64, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p]
    four.restype = ctypes.c_int
    return fill, four


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
    fill, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fill(code, key[0], key[1], key2[0], key2[1], out.numel(), lo,
                   span, ispan, mult, minval, out.data_ptr(), stream)
    _check(err, mode)
    return out


def fourier_cuda(key, shape, amp: torch.Tensor):
    """Launch K5's fused draw_fourier entry: (A, B) of ``shape`` + (nf,)
    with A = amp * cos(2 pi phi), B = amp * sin(2 pi phi) and phi the
    uniform stream of ``key``; amp [nf] float32 on the card."""
    dev = _cuda(amp.device)
    if amp.dtype != torch.float32 or amp.dim() != 1 or \
            not amp.is_contiguous():
        raise ValueError(f'amp: need a contiguous 1-D float32 tensor, got '
                         f'{amp.dtype} {tuple(amp.shape)}')
    nf = amp.shape[0]
    full = tuple(int(s) for s in shape) + (nf,)
    A = torch.empty(full, dtype=torch.float32, device=dev)
    B = torch.empty_like(A)
    if A.numel() == 0:
        return A, B
    _, four = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = four(key[0], key[1], A.numel(), nf, amp.data_ptr(), TWO_PI_F32,
                   A.data_ptr(), B.data_ptr(), stream)
    _check(err, 'fourier')
    return A, B
