"""The field stacks' kernel: build csrc/stacks.cu with nvcc
(kernels/build.py), bind it with ctypes and launch it on the current stream
of the sources' device.

``corner_stack(sources)`` writes, in one pass, the corner-packed rows that
models/fields.py build_stacks_plain makes with ``ops/interp.py
pack_corners(torch.cat(sources, -1))``: out[..., i, j, :] = [src(i, j) |
src(i, j+1) | src(i+1, j) | src(i+1, j+1)], edge-clamped, where src is the
channel concatenation of the sources, bit for bit.  A source is one plane
per output plane, [P, H, W, c], or one plane for all of them, [H, W, c] or
[H, W] (one channel): land and bathymetry are read from their one plane,
never expanded.  The output is [P, H, W, 4C], or [H, W, 4C] where no
source has a plane axis.  See the note at the top of the source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild

# csrc/stacks.cu: sources a launch takes, threads a block, staged rows
MAX_SOURCES = 4
THREADS = 256
BUFFERS = 3
# the shared memory of an SM (the H100's 227 KB a block may use), the
# blocks the tile is sized to share it (each SM keeps 1 KB a block): its
# 2048 threads' worth, the widest tile, and the rows a block walks (a row
# read once more a strip)
SM_SHARED_BYTES = 227 * 1024
BLOCKS_PER_SM = 2048 // THREADS
MAX_TILE = 64
STRIP = 4


class Plan(NamedTuple):
    tile: int              # cells of a row a block writes
    strip: int             # rows a block walks
    shared_bytes: int      # BUFFERS staged rows of tile + 1 cells


def plan(W: int, C: int) -> Plan:
    """The launch of corner_stack for an output row of W cells of 4C
    floats (the kernel's grid is the tiles of a row, the strips of the
    rows and the planes): a tile as wide as BLOCKS_PER_SM blocks' staged
    rows let an SM's shared memory hold (at most MAX_TILE cells, at most
    the row; a column read once more a tile), STRIP rows a block.  Timed
    on an H100 at the cells' shapes against tiles of 1 to 360 cells and
    strips of 1 to 64 rows, this plan was within 4% of the fastest
    (PERF.md)."""
    per_cell = BUFFERS * 4 * C
    budget = SM_SHARED_BYTES // BLOCKS_PER_SM - 1024
    tile = min(W, MAX_TILE, max(1, budget // per_cell - 1))
    if (tile + 1) * per_cell > SM_SHARED_BYTES:
        raise ValueError(f'{C} channels do not fit a block\'s shared memory '
                         f'(at most {SM_SHARED_BYTES // (2 * BUFFERS * 4)})')
    return Plan(tile, STRIP, (tile + 1) * per_cell)


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('stacks')


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build()['path'])).tc_stacks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _layout(sources):
    """(P or None, H, W, [(channels, plane stride)]) of the sources,
    required to be contiguous float32 tensors on one CUDA device with one
    [H, W] grid and, where they have planes, one plane count."""
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f'corner_stack takes 1 to {MAX_SOURCES} sources, '
                         f'got {len(sources)}')
    dev = sources[0].device
    if dev.type != 'cuda':
        raise ValueError(f'stacks kernel needs CUDA tensors, got {dev}')
    planes, grid, layout = set(), set(), []
    for k, s in enumerate(sources):
        if (s.device != dev or s.dtype != torch.float32
                or not s.is_contiguous() or s.dim() not in (2, 3, 4)):
            raise ValueError(f'source {k}: need a contiguous float32 tensor '
                             f'of 2 to 4 dimensions on {dev}, got {s.dtype} '
                             f'{tuple(s.shape)} on {s.device} (contiguous: '
                             f'{s.is_contiguous()})')
        ch = 1 if s.dim() == 2 else s.shape[-1]
        if s.dim() == 4:
            planes.add(s.shape[0])
        grid.add(tuple(s.shape[-3:-1] if s.dim() > 2 else s.shape))
        layout.append((ch, s[0].numel() if s.dim() == 4 else 0))
    if len(grid) != 1 or len(planes) > 1 or min(c for c, _ in layout) < 1:
        raise ValueError(f'sources on different grids or plane counts, or '
                         f'without channels: '
                         f'{[tuple(s.shape) for s in sources]}')
    (H, W), = grid
    P = planes.pop() if planes else None
    if min(H, W, P or 1) < 1:
        raise ValueError(f'empty grid {(P, H, W)}')
    return P, H, W, layout


def launcher(sources):
    """(launch, out): a function that launches the kernel on these
    sources, writing out.  The checks, the output and the parameter block
    are made here, once, so that repeated launches time the kernel
    alone."""
    P, H, W, layout = _layout(sources)
    dev = sources[0].device
    C = sum(c for c, _ in layout)
    if 4 * C * W >= 2 ** 31 or (P or 1) > 65535:
        raise ValueError(f'[{P}, {H}, {W}, 4 x {C}] is too large: rows of '
                         f'int32 indices, at most 65535 planes')
    out = torch.empty(((P,) if P else ()) + (H, W, 4 * C),
                      dtype=torch.float32, device=dev)
    pl = plan(W, C)
    ip = [len(sources), P or 1, H, W, C, pl.tile, pl.strip, out.data_ptr()]
    for s, (ch, stride) in zip(sources, layout):
        ip += [s.data_ptr(), ch, stride]
    ip = np.array(ip, np.int64)
    fn = _entry()

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ip.ctypes.data, stream)
        if err != 0:
            raise RuntimeError(f'stacks kernel launch failed: CUDA error '
                               f'{err}')
        kernels.LAUNCHES['stacks'] += 1
    return launch, out


def corner_stack(sources):
    """Launch the kernel once on the sources (see the module's note) and
    return its output; raises on what the kernel does not take."""
    launch, out = launcher(sources)
    launch()
    return out
