"""K4 wrapper: build csrc/compact.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernels replace the JAX package's XLA-fused compactions (the
stable-partition order and the row takes and scatters around it); see the
note at the top of the source.  The dispatch lives in ops/compact.py,
whose plain twins (partition_take_plain, stitch_survivors_plain) CPU
tensors take.  Nothing here reads a device value back to the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
from tropical_cyclone_risk_tpu_torch.ops.compact import (Partition,
                                                         TRACK_FIELDS as FIELDS)

TILE = 1024              # csrc/compact.cu kTile: slots per block
MAX_ROWS = 16            # csrc/compact.cu kMaxRows
MAX_SEGS = 16            # csrc/compact.cu kMaxSegs
# csrc/compact.cu kGatherThreads * kUnroll: words per gather block
GATHER_BLOCK_WORDS = 256 * 4
WORD_BYTES = (16, 8, 4, 2, 1)
# the stitch (csrc/compact.cu): survivors a tile (kStitchSurv), most steps
# a tile (kStitchSteps), threads a block (kStitchThreads), wind bytes a
# thread loads per round (kWindBytes), keep_full slots a tail block
# (kStitchThreads * kKeepPer)
STITCH_SURV = 32
STITCH_STEPS = 32
STITCH_THREADS = 256
STITCH_WIND_BYTES = 64
KEEP_BLOCK = STITCH_THREADS * 4
# its static shared memory: five staged fields and the live flags (4
# bytes a cell), each survivor's column (8) and selected flag (4)
STITCH_SHARED_BYTES = (6 * 4 * STITCH_STEPS + 12) * STITCH_SURV
# a tile's winds: at most four rounds of every thread's STITCH_WIND_BYTES
STITCH_TILE_WIND_BYTES = 4 * STITCH_THREADS * STITCH_WIND_BYTES
# tiles the plan keeps the grid at where it can (the H100's SMs), and the
# fewest steps a tile it shrinks to for that
STITCH_MIN_BLOCKS = 132
STITCH_MIN_STEPS = 4


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('compact')


@functools.cache
def _entries():
    lib = ctypes.CDLL(str(build()['path']))
    out = []
    for name in ('tc_k4_partition', 'tc_k4_stitch'):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out.append(fn)
    return out


def _need(name, t, dev, dtype, shape=None):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous {dtype} tensor on {dev}, '
                         f'got {t.dtype} on {t.device}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)} != {tuple(shape)}')


def _device(t):
    dev = t.device
    if dev.type != 'cuda':
        raise ValueError(f'compaction kernel needs CUDA tensors, got {dev}')
    return dev


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def partition_cuda(mask, w: int, rows, acc=None, slot_rank=False,
                   a_prev=None, inv_len=None):
    """Launch K4's count, partition and gather kernels for one compaction.
    Returns a Partition equal to partition_take_plain's bit for bit."""
    launch, part = launcher('partition', mask, w, rows, acc, slot_rank,
                            a_prev, inv_len)
    launch()
    return part


def stitch_cuda(order, tms, segs, keep, slot_rank):
    """Launch K4's survivor stitch.  Returns (tracks, keep_full) equal to
    ops.compact.stitch_survivors_plain's bit for bit."""
    launch, out = launcher('stitch', order, tms, segs, keep, slot_rank)
    launch()
    return out


def gather_plan(rows, k: int):
    """The gather kernel's plan for k gathered rows of each row tensor,
    given as (source pointer, destination pointer, bytes per row): per
    tensor (word bytes, words per row, words, first block), the widest
    word of WORD_BYTES that divides both pointers and the row size (the
    lowest set bit, capped), and the tensor's blocks of GATHER_BLOCK_WORDS
    words, numbered on from the tensor's before it; and the total number
    of blocks.  It runs on every partition_take, so it stays a few
    integer operations per tensor."""
    plan, first = [], 0
    for src, dst, row_bytes in rows:
        align = src | dst | row_bytes | WORD_BYTES[0]
        word = align & -align
        wpr = row_bytes // word
        words = k * wpr
        if words >= 1 << 31:
            raise ValueError(f'{words} gather words >= 2**31')
        plan.append((word, wpr, words, first))
        first += -(-words // GATHER_BLOCK_WORDS)
    return plan, first


class StitchPlan(NamedTuple):
    """The stitch's grid (stitch_plan): a block per tile of STITCH_SURV
    survivors x ``steps`` steps, each inside one segment, the blocks by
    survivor tile, step tiles fastest."""
    steps: int                  # TS, a power of two
    log_steps: int
    first_tiles: tuple          # each segment's first step tile
    step_tiles: int             # over every segment
    surv_tiles: int
    tile_blocks: int            # surv_tiles * step_tiles


def stitch_plan(seg_steps, k: int, W: int) -> StitchPlan:
    """The survivor stitch's tiles for segments of ``seg_steps`` steps, k
    survivors and W winds a sample: TS from STITCH_STEPS halved while a
    tile's winds pass STITCH_TILE_WIND_BYTES (W grows), then while the
    grid has fewer than STITCH_MIN_BLOCKS tiles (k is small), down to
    STITCH_MIN_STEPS; each segment's step tiles numbered on from the ones
    before it (as vmax.last_plan numbers K2's segments)."""
    ts = STITCH_STEPS
    while ts > 1 and STITCH_SURV * ts * W * 4 > STITCH_TILE_WIND_BYTES:
        ts //= 2
    surv = -(-k // STITCH_SURV)
    tiles = lambda ts: sum(-(-int(s) // ts) for s in seg_steps)
    while ts > STITCH_MIN_STEPS and surv * tiles(ts) < STITCH_MIN_BLOCKS:
        ts //= 2
    first, total = [], 0
    for s in seg_steps:
        first.append(total)
        total += -(-int(s) // ts)
    return StitchPlan(ts, ts.bit_length() - 1, tuple(first), total, surv,
                      surv * total)


def wind_word(W: int, ptrs) -> int:
    """The stitch's wind word: 16 bytes where a sample's W floats and every
    wind pointer (the segments' and the output's) are 16-byte aligned,
    else 8 (the lowest set bit, capped, as gather_plan finds its words)."""
    align = functools.reduce(lambda a, b: a | b, ptrs, W * 4 | 16)
    word = align & -align
    if word < 8:
        raise ValueError(f'winds: {W} a sample or a pointer not aligned for '
                         f'the stitch\'s 8-byte words')
    return word


def launcher(kind: str, *args):
    """(launch, result): a function that launches K4's ``kind``
    ('partition': the count, partition and gather kernels, the last only
    where there are rows to gather; or 'stitch') on these inputs, writing
    the tensors of ``result``, the Partition or the stitch's (tracks,
    keep_full).  The checks, the outputs, the gather plan and the
    parameter block are made here, once, so that repeated launches time
    the kernels alone."""
    prep, entry = {'partition': (_partition, 0), 'stitch': (_stitch, 1)}[kind]
    dev = _device(args[0])
    ip, result, n_kernels = prep(dev, *args)
    fn = _entries()[entry]

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ip.ctypes.data, stream)
        if err != 0:
            raise RuntimeError(f'compaction kernel ({kind}) launch failed: '
                               f'CUDA error {err}')
        kernels.LAUNCHES['compact'] += n_kernels
    return launch, result


def _partition(dev, mask, w, rows, acc, slot_rank, a_prev, inv_len):
    n = mask.shape[0]
    _need('mask', mask, dev, torch.bool, (n,))
    if len(rows) > MAX_ROWS:
        raise ValueError(f'{len(rows)} row tensors > {MAX_ROWS}')
    for i, r in enumerate(rows):
        _need(f'row {i}', r, dev, r.dtype)
        if r.dim() < 1 or r.shape[0] != n:
            raise ValueError(f'row {i}: leading size {tuple(r.shape)} != {n}')
    if acc is not None:
        _need('acc', acc, dev, torch.int64, (1,))
    if a_prev is not None:
        _need('a_prev', a_prev, dev, torch.int64, (n,))
    k = min(int(w), n)
    i64 = dict(dtype=torch.int64, device=dev)
    order = torch.empty((k,), **i64)
    overflow = torch.empty((1,), **i64)
    outs = tuple(torch.empty((k,) + tuple(r.shape[1:]), dtype=r.dtype,
                             device=dev) for r in rows)
    rank = torch.empty((n,), **i64) if slot_rank else None
    a_out = inv = sel = zero = None
    if inv_len is not None:
        a_out = torch.empty((k,), **i64)
        # inv and selected share one buffer, zeroed by the count kernel
        zero = torch.empty((9 * inv_len,), dtype=torch.uint8, device=dev)
        inv = zero[:8 * inv_len].view(torch.int64)
        sel = zero[8 * inv_len:].view(torch.bool)
    n_tiles = max(1, -(-n // TILE))
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    ptrs = [(r.data_ptr(), o.data_ptr(),
             math.prod(r.shape[1:]) * r.element_size())
            for r, o in zip(rows, outs)]
    plan, blocks = gather_plan(ptrs, k)
    ip = [n, int(w), n_tiles] + [_ptr(t) for t in (
        mask, counts, order, overflow, acc, rank, a_prev, a_out, inv, sel,
        zero)] + [0 if zero is None else zero.numel(), len(rows), blocks]
    for (src, dst, _), (word, wpr, words, first) in zip(ptrs, plan):
        ip += [src, dst, words, wpr, word, first]
    return (np.array(ip, np.int64),
            Partition(order, overflow, outs, rank, a_out, inv, sel),
            2 + (blocks > 0))


def _stitch(dev, order, tms, segs, keep, slot_rank):
    k = order.shape[0]
    _need('order', order, dev, torch.int64, (k,))
    if not 1 <= len(tms) <= MAX_SEGS or len(segs) != len(tms) - 1:
        raise ValueError(f'{len(tms)} segments and {len(segs)} maps')
    m = keep.shape[0]
    _need('keep', keep, dev, torch.bool, (m,))
    scalar, wnd = FIELDS[:-1], FIELDS[-1]
    T = sum(tm[scalar[0]].shape[0] for tm in tms)
    f32 = dict(dtype=torch.float32, device=dev)
    W = tms[0][wnd].shape[-1]
    if W < 2 or W % 2:
        raise ValueError(f'{W} winds per sample: the stitch copies (u, v) '
                         f'pairs')
    out = {f: torch.empty((k, T), **f32) for f in scalar}
    out[wnd] = torch.empty((k, T, W), **f32)
    keep_full = keep
    n = 0
    if slot_rank is not None:
        n = slot_rank.shape[0]
        _need('slot_rank', slot_rank, dev, torch.int64, (n,))
        keep_full = torch.empty((n,), dtype=torch.bool, device=dev)
    steps = [tm[scalar[0]].shape[0] for tm in tms]
    plan = stitch_plan(steps, k, W)
    word = wind_word(W, [tm[wnd].data_ptr() for tm in tms]
                     + [out[wnd].data_ptr()])
    keep_blocks = -(-n // KEEP_BLOCK)
    if plan.tile_blocks + keep_blocks >= 1 << 31:
        raise ValueError(f'{plan.tile_blocks} + {keep_blocks} stitch blocks '
                         f'>= 2**31')
    ip = [k, T, n, len(tms), W, word, plan.log_steps, plan.step_tiles,
          plan.tile_blocks, keep_blocks,
          order.data_ptr(), *(out[f].data_ptr() for f in FIELDS),
          _ptr(slot_rank), keep.data_ptr(),
          0 if slot_rank is None else keep_full.data_ptr()]
    edge = 0
    for i, (tm, first) in enumerate(zip(tms, plan.first_tiles)):
        T_s, w_s = tm[scalar[0]].shape
        for f in scalar:
            _need(f'segment {i} {f}', tm[f], dev, torch.float32, (T_s, w_s))
        _need(f'segment {i} {wnd}', tm[wnd], dev, torch.float32,
              (T_s, w_s, W))
        _need(f'segment {i} alive', tm['alive'], dev, torch.bool, (T_s, w_s))
        inv = sel = None
        if i > 0:
            inv, sel = segs[i - 1]['inv'], segs[i - 1]['selected']
            _need(f'segment {i} inv', inv, dev, torch.int64, (m,))
            _need(f'segment {i} selected', sel, dev, torch.bool, (m,))
        ip += [edge, T_s, w_s, first, *(tm[f].data_ptr() for f in scalar),
               tm[wnd].data_ptr(), tm['alive'].data_ptr(), _ptr(inv),
               _ptr(sel)]
        edge += T_s
    return np.array(ip, np.int64), (out, keep_full), 1
