"""K2's chunked design (csrc/vmax.cu), emulated in torch on the CPU and held
against the plain twin, models/diagnostics.py axi_to_max_wind_raw_plain,
bit for bit.

The emulation follows the kernel's index math: the rows cut into chunks,
each storm carried through a chunk with a one-row halo on each side (the
row before the chunk, or at the segment's start pos_before or the
start-edge extrapolation; the row after, or at its end pos_after or the
last row itself), the extrapolation at each track's last sample L from the
chunk's own rows or its halo, and the alive-masked partial peaks of the
chunks reduced in chunk order.  Its arithmetic is the twin's own
(_translation_tm, vmax_step), so any difference is one of indexing: the
tolerance is zero.  The kernel itself is held against the twin on the card
by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
from tropical_cyclone_risk_tpu_torch.models import diagnostics

CFG = Namelist()
T, N = 20, 96
DT = 3600.0


def _rows(x, t, T_, edge):
    """Row t of [T, N] pairs x, or `edge` where t lies outside 0..T-1."""
    return edge if not 0 <= t < T_ else (x[0][t], x[1][t])


def emulate(lon, lat, dt, v, wnds, alive, last, cfg, before, after, chunk):
    """(vmax, peak) as csrc/vmax.cu computes them with chunks of `chunk`
    rows: the neighbour rows b / a of every sample built chunk by chunk as
    the kernel's threads carry them, then the twin's arithmetic on them."""
    T_, _ = lon.shape
    pos = (lon, lat)
    b = [torch.empty_like(lon), torch.empty_like(lat)]
    a = [torch.empty_like(lon), torch.empty_like(lat)]
    for t0 in range(0, T_, chunk):
        t1 = min(t0 + chunk, T_)
        cur = (lon[t0], lat[t0])
        if t0 > 0:
            prev = (lon[t0 - 1], lat[t0 - 1])
        elif before is not None:
            prev = (before[0], before[1])
        else:
            prev = (2 * lon[0] - lon[1], 2 * lat[0] - lat[1])
        base = (before[0], before[1]) if t0 == 0 and before is not None \
            else cur
        end = None if after is None else (after[0], after[1])
        nxt = _rows(pos, t0 + 1, T_, end if end is not None else cur)
        for t in range(t0, t1):
            at_L = last == t
            P = base if t == 0 else prev
            for c in range(2):
                b[c][t] = torch.where(at_L, P[c], prev[c])
                a[c][t] = torch.where(at_L, cur[c] + (cur[c] - P[c]),
                                      nxt[c])
            prev, cur = cur, nxt
            # past the end: pos_after, or the last row (now cur) itself
            nxt = _rows(pos, t + 2, T_, end if end is not None else cur)
    ut, vt = diagnostics._translation_tm(lon, lat, b[0], b[1], a[0], a[1],
                                         dt)
    vmax = diagnostics.vmax_step(cfg, lat, v, wnds, ut, vt)
    masked = torch.where(alive, vmax, -math.inf)
    partial = []
    for t0 in range(0, T_, chunk):
        acc = torch.full_like(masked[0], -math.inf)
        for t in range(t0, min(t0 + chunk, T_)):
            acc = torch.maximum(acc, masked[t])
        partial.append(acc)
    peak = partial[0]
    for p in partial[1:]:
        peak = torch.maximum(peak, p)
    return vmax, peak


def _segment(seed):
    """Random-walk tracks with frozen tails, each storm's last sample L set
    to every case the kernel distinguishes: row 0, T-1, a chunk edge of
    chunk 7 (6, 7, 13, 14), before and past the segment (-1, -5, T, T+3);
    storms dead throughout; a NaN row of v for a few alive storms, and of
    lat for a dead one."""
    r = np.random.default_rng(seed)
    step = r.normal(0.0, 0.3, (T, N, 2)).astype(np.float32)
    pos = np.cumsum(step, axis=0) + np.array([150.0, 18.0], np.float32)
    last = r.integers(0, T, N)
    cases = [0, T - 1, 6, 7, 13, 14, -1, -5, T, T + 3]
    last[:2 * len(cases)] = cases * 2
    alive = (np.arange(T)[:, None] <= last[None, :])
    alive[:, 20:26] = False                        # dead throughout
    idx = np.clip(np.minimum(np.arange(T)[:, None], last[None, :]), 0,
                  T - 1)
    pos = np.take_along_axis(pos, idx[..., None], axis=0)
    v = r.uniform(5.0, 70.0, (T, N)).astype(np.float32)
    wnds = r.normal(0.0, 8.0, (T, N, 4)).astype(np.float32)
    lon, lat = pos[..., 0].copy(), pos[..., 1].copy()
    v[9, 30:33] = np.nan                           # alive: peak NaN
    lat[4, 21] = np.nan                            # dead: masked
    alive[:, 30:33] = alive[:, 30:33] | (np.arange(T)[:, None] <= 12)
    edges = (r.normal(0.0, 0.3, (2, 2, N)).astype(np.float32)
             + pos[[0, -1]].transpose(0, 2, 1))
    t = torch.from_numpy
    return (t(lon), t(lat), t(v), t(wnds), t(alive), t(last),
            t(edges[0].copy()), t(edges[1].copy()))


def same(x, y):
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


@pytest.mark.parametrize('edges', ['none', 'both', 'before', 'after'])
@pytest.mark.parametrize('chunk', [1, 7, T - 1, T])
def test_chunked_design_is_the_twin(chunk, edges):
    lon, lat, v, wnds, alive, last, before, after = _segment(3)
    before = before if edges in ('both', 'before') else None
    after = after if edges in ('both', 'after') else None
    vm, pk = diagnostics.axi_to_max_wind_raw_plain(
        lon, lat, DT, v, wnds, alive, last, CFG, pos_before=before,
        pos_after=after)
    em_vm, em_pk = emulate(lon, lat, DT, v, wnds, alive, last, CFG, before,
                           after, chunk)
    assert same(em_vm, vm)
    assert same(em_pk, pk)
    # the cases the data must reach
    assert torch.isnan(pk[30:33]).all()
    assert torch.isinf(pk[20:26]).all() and (pk[20:26] < 0).all()
    assert torch.isfinite(pk[:20][last[:20] >= 0]).all()


@pytest.mark.parametrize('shape', [(60, 40960), (40, 4096), (361, 131072),
                                   (25, 300), (1, 256), (3, 1),
                                   (200000, 64)])
def test_launch_geometry_covers_the_segment(shape):
    """Every row in exactly one chunk (the last one ragged), every storm in
    a block, no chunk shorter than MIN_CHUNK rows unless T is, within the
    grid's limit; and the launch's own segments spread over every SM."""
    T_, N_ = shape
    n_sm = 132
    threads, blocks, chunk, chunks = k2.launch_geometry(T_, N_, n_sm)
    assert threads % 32 == 0 and 32 <= threads <= k2.THREADS
    assert blocks * threads >= N_ > (blocks - 1) * threads
    assert (chunks - 1) * chunk < T_ <= chunks * chunk
    assert chunk >= min(k2.MIN_CHUNK, T_) and chunks <= k2.MAX_CHUNKS
    if T_ >= 40 and N_ >= 4096:
        assert blocks * chunks >= 2 * n_sm


def test_cuda_wrapper_refuses_cpu_tensors():
    lon, lat, v, wnds, alive, last, before, after = _segment(3)
    with pytest.raises(ValueError, match='CUDA'):
        k2.axi_to_max_wind_raw_cuda(lon, lat, DT, v, wnds, alive, last,
                                    (0, 1, 2, 3), before, after)
    with pytest.raises(ValueError, match='CUDA'):
        k2.launcher(lon, lat, DT, v, wnds, alive, last, (0, 1, 2, 3))
