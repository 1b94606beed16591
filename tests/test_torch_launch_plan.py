"""The host side of K1's and K4's launches, which runs on the CPU: K4's
gather plan (word sizes, words per row, block offsets, and a grid that
writes every output byte exactly once from the row the order picks), K1's
launch geometry (every segment width spread over the SMs, blocks within
the kernel's __launch_bounds__) and its deep-layer shear channels against
fast.deep_layer_indices.  The constants the wrappers share with the CUDA
sources are read back from csrc/.  The kernels themselves run only on the
card (chip_smoke.py holds them against their twins)."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import fast

CSRC = Path(k4.__file__).resolve().parents[1] / 'csrc'
H100_SMS = 132


def _constant(source, name):
    found = re.search(rf'constexpr int {name} = (\d+);',
                      (CSRC / source).read_text())
    return int(found.group(1))


def test_wrapper_constants_match_the_sources():
    assert integrator.MAX_THREADS == _constant('integrator.cu', 'kMaxThreads')
    assert integrator.MAX_SUB == _constant('integrator.cu', 'kMaxSub')
    assert k4.GATHER_BLOCK_WORDS == (_constant('compact.cu', 'kGatherThreads')
                                     * _constant('compact.cu', 'kUnroll'))
    assert k4.MAX_ROWS == _constant('compact.cu', 'kMaxRows')
    assert k4.TILE == (_constant('compact.cu', 'kThreads')
                       * _constant('compact.cu', 'kPer'))


def _launch_rows(n):
    """The integrate compaction's 11 row tensors (plane, h_bl, lon, lat,
    v, m, integrate, month, basin_idx, A, B) on the CPU."""
    f32 = [torch.zeros(n) for _ in range(5)]
    return ([torch.zeros(n, dtype=torch.int64)] + f32
            + [torch.zeros(n, dtype=torch.bool),
               torch.zeros(n, dtype=torch.int32),
               torch.zeros(n, dtype=torch.int64),
               torch.zeros(n, 4, 15), torch.zeros(n, 4, 15)])


def _simulate_gather(plan, n_blocks, rows, k, seed):
    """The gather kernel's grid on byte arrays: each block finds its
    tensor as csrc/compact.cu gather_kernel does, each of its threads
    copies its kUnroll words of the picked source rows.  Returns, per
    tensor, the destination bytes and how often each was written, with the
    source bytes and the order used."""
    threads = 256
    unroll = k4.GATHER_BLOCK_WORDS // threads
    firsts = np.array([p[3] for p in plan])
    owner = np.array([max(i for i in range(len(plan)) if firsts[i] <= b)
                      for b in range(n_blocks)], dtype=np.int64)
    r = np.random.default_rng(seed)
    out = []
    for t, ((word, wpr, words, first), (_, _, row_bytes)) in enumerate(
            zip(plan, rows)):
        n = k + 3
        src = r.integers(0, 256, n * row_bytes, dtype=np.uint8)
        order = r.permutation(n)[:k]
        dst = np.zeros(k * row_bytes, np.uint8)
        hits = np.zeros(k * row_bytes, np.int64)
        blocks = np.nonzero(owner == t)[0]
        e = ((blocks[:, None, None] - first) * k4.GATHER_BLOCK_WORDS
             + np.arange(unroll)[None, :, None] * threads
             + np.arange(threads)[None, None, :]).reshape(-1)
        e = e[e < words]
        row, col = e // wpr, e % wpr
        for b in range(word):
            d = e * word + b
            dst[d] = src[order[row] * row_bytes + col * word + b]
            np.add.at(hits, d, 1)
        out.append((dst, hits, src, order))
    return out


@pytest.mark.parametrize('k', [1, 777, 40960])
def test_gather_plan_covers_the_launch_rows(k):
    """The launch's rows at their real pointers: 16-byte words for the
    Fourier rows, 8 and 4 for the scalars, 1 for the mask; blocks numbered
    on tensor after tensor; every output byte written once, from its row."""
    n = k + 3
    rows = _launch_rows(n)
    outs = [torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype) for x in rows]
    ptrs = [(x.data_ptr(), o.data_ptr(),
             int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size())
            for x, o in zip(rows, outs)]
    plan, n_blocks = k4.gather_plan(ptrs, k)
    assert [p[0] for p in plan] == [8, 4, 4, 4, 4, 4, 1, 4, 8, 16, 16]
    assert [p[1] for p in plan] == [1] * 9 + [15, 15]
    first = 0
    for (word, wpr, words, f), (_, _, row_bytes) in zip(plan, ptrs):
        assert f == first and words == k * wpr and wpr * word == row_bytes
        first += -(-words // k4.GATHER_BLOCK_WORDS)
    assert n_blocks == first
    if k == 40960:
        assert n_blocks >= 4 * H100_SMS       # the grid fills the card
    for dst, hits, src, order in _simulate_gather(plan, n_blocks, ptrs, k,
                                                  seed=k):
        row_bytes = dst.size // k
        want = src.reshape(-1, row_bytes)[order].reshape(-1)
        np.testing.assert_array_equal(hits, 1)
        np.testing.assert_array_equal(dst, want)


@pytest.mark.parametrize('row_bytes', [1, 3, 240])
@pytest.mark.parametrize('misalign', [0, 1, 2, 4, 8])
def test_gather_plan_odd_sizes_and_alignments(row_bytes, misalign):
    """Odd row sizes and pointers off the 16-byte grid: the word is the
    widest that divides both pointers and the row size; a tensor with no
    rows to gather takes no block; every byte is written once."""
    k = 1500
    base = 1 << 20
    rows = [(base + misalign, base + 4096, row_bytes),
            (base, base + 8192 + misalign, 240),
            (base, base, 0)]
    plan, n_blocks = k4.gather_plan(rows, k)
    for (word, wpr, words, _), (src, dst, nb) in zip(plan, rows):
        widest = max(b for b in k4.WORD_BYTES if (src | dst | nb) % b == 0)
        assert word == widest and wpr == nb // word and words == k * wpr
    assert plan[2][2] == 0 and plan[2][3] == n_blocks
    sims = _simulate_gather(plan, n_blocks, rows, k, seed=row_bytes)
    for dst, hits, src, order in sims[:2]:
        rb = dst.size // k
        np.testing.assert_array_equal(hits, 1)
        np.testing.assert_array_equal(dst,
                                      src.reshape(-1, rb)[order].reshape(-1))


def test_gather_plan_refuses_too_many_words():
    with pytest.raises(ValueError, match='2\\*\\*31'):
        k4.gather_plan([(0, 0, (1 << 16) + 1)], 1 << 15)


@pytest.mark.parametrize('n_sm', [H100_SMS, 114])
def test_k1_launch_geometry_fills_the_sms(n_sm):
    """Every width from 1 to 131072: at least min(width, SMs) blocks (so
    as many busy SMs), whole warps of at most kMaxThreads threads, each
    block's storms within its threads, no empty block."""
    for width in range(1, 131073):
        per, threads, blocks = integrator.launch_geometry(width, n_sm)
        assert blocks >= min(width, n_sm), width
        assert threads % 32 == 0 and 32 <= threads <= integrator.MAX_THREADS
        assert 1 <= per <= threads
        assert blocks * per >= width > (blocks - 1) * per, width
        if per >= 32:
            assert per % 32 == 0, width
    assert integrator.launch_geometry(40960, H100_SMS) == (64, 64, 640)
    assert integrator.launch_geometry(100, H100_SMS) == (1, 32, 100)


def _stacks():
    """In-cell stacks as the parameter block reads them: the cell grid and
    stack, the layout, and the land and bathymetry grids (the cell grid's
    in this layout)."""
    grid = SimpleNamespace(lon0=0.0, dlon=1.0, lat0=-90.0, dlat=1.0,
                           nlon=360, nlat=181)
    return SimpleNamespace(grid=grid, cell4=torch.zeros(12, 1, 1, 84),
                           geo_in_cell=True, land_grid=grid, bathy_grid=grid)


def _read_order(var='ip'):
    """The targets of csrc/integrator.cu read_params' `X = *{var}++;`
    reads, in order."""
    src = (CSRC / 'integrator.cu').read_text()
    body = src[src.index('void read_params('):]
    body = body[:body.index('\n}\n')]
    return re.findall(rf'([\w.\[\]]+) = \*{var}\+\+;', body)


@pytest.mark.parametrize('levels', [(250, 850), (850, 250)])
def test_k1_steering_order(levels):
    """The deep-layer shear's four channels of fast.deep_layer_indices go
    into the parameter block where read_params reads them, beside the
    launch geometry; with two levels read_params derives the kernel's flag
    from them, and csrc/integrator.cu deep_shear's flag selects the same
    components, for both orders of steering_levels."""
    cfg = Namelist(steering_levels=levels)
    idx = fast.deep_layer_indices(cfg)
    swap = idx[0] == 2       # read_params: p.swap = p.iu2 == 2
    assert swap == (levels[0] == 850)
    w = np.random.default_rng(3).standard_normal((5, 4)).astype(np.float32)
    iu2, iv2, iu8, iv8 = idx
    # csrc/integrator.cu deep_shear: (u2, v2, u8, v8) by the flag
    u2, v2 = (w[:, 2], w[:, 3]) if swap else (w[:, 0], w[:, 1])
    u8, v8 = (w[:, 0], w[:, 1]) if swap else (w[:, 2], w[:, 3])
    np.testing.assert_array_equal(u2 - u8, w[:, iu2] - w[:, iu8])
    np.testing.assert_array_equal(v2 - v8, w[:, iv2] - w[:, iv8])
    geometry = integrator.launch_geometry(4097, H100_SMS)
    fp, ip = integrator._params(_stacks(), cfg, (0.0, -60.0, 360.0, 60.0),
                                4097, 60, 3, 20, 0, 1.0, False, geometry)
    order = _read_order()
    at = order.index('p.iu2')
    assert order[at:at + 4] == ['p.iu2', 'p.iv2', 'p.iu8', 'p.iv8']
    assert tuple(ip[at:at + 4]) == idx and tuple(ip[-3:]) == geometry
    assert ip[order.index('l.levels')] == 2
    assert fp.dtype == np.float32 and ip.dtype == np.int32


@pytest.mark.parametrize('fixed', [False, True])
def test_k1_fixed_position_flag(fixed):
    """debug_fixed_position goes into K1's (and K7's) parameter block at
    the place csrc/integrator.cu read_params reads p.fixed (the wrappers
    take the flag: tests/test_torch_genesis.py)."""
    cfg = Namelist(debug_fixed_position=fixed)
    geometry = integrator.launch_geometry(4097, H100_SMS)
    fp, ip = integrator._params(_stacks(), cfg, (0.0, -60.0, 360.0, 60.0),
                                4097, 60, 3, 20, 0, 1.0, False, geometry)
    order = _read_order()
    assert len(order) == ip.size and order.index('p.fixed') == ip.size - 4
    assert ip[-4] == int(fixed) and tuple(ip[-3:]) == geometry
    _, gate_ip = integrator.gate_params(_stacks(), cfg, 1000)
    assert gate_ip[-4] == int(fixed)


def test_k1_steering_order_refuses_other_levels():
    """Every count fast.deep_layer_indices takes is a unit of the
    kernels (four, five, fifteen; a unit is built at its first launch);
    what it refuses, levels without 250 or 850 hPa (one level among them),
    raises its ValueError."""
    assert integrator.levels(Namelist(
        steering_levels=(250, 500, 700, 850))) == 4
    assert integrator.levels(Namelist(steering_levels=(250, 400, 500, 700,
                                                       850))) == 5
    era5 = (250, 300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775,
            800, 825, 850)      # the ERA5 request's levels in the layer
    assert integrator.levels(Namelist(steering_levels=era5)) == 15
    for lv in ((500, 850), (250,), (250, 500, 700)):
        with pytest.raises(ValueError, match='250 and 850'):
            integrator.levels(Namelist(steering_levels=lv))


def test_k1_fourier_phases_within_the_fast_trig_range():
    """The kernel evaluates F(t)'s sin and cos on CUDA's fast path, which
    is sinf and cosf only below FAST_TRIG_LIMIT rad: the namelist's period
    keeps a launch's phases far below it; a period too short for the
    track time is refused."""
    cfg = Namelist()
    geometry = integrator.launch_geometry(4096, H100_SMS)
    args = (_stacks(), cfg, (0.0, -60.0, 360.0, 60.0), 4096, 61, 3, 0, 300)
    integrator._params(*args, cfg.T_fourier_s, True, geometry)
    with pytest.raises(NotImplementedError, match='phases'):
        integrator._params(*args, 60.0, True, geometry)
    integrator._params(*args, 60.0, False, geometry)   # F(t) streamed


def test_group_constants_match_the_source():
    """The group units' constants the wrapper shares with
    csrc/integrator.cu: the level count from which a unit runs the group
    kernels, their threads per block and a block's shared memory."""
    assert integrator.GROUP_LEVELS == _constant('integrator.cu',
                                                'kGroupLevels')
    assert integrator.GROUP_THREADS == _constant('integrator.cu',
                                                 'kGroupThreads')
    assert integrator.MAX_SHARED_BYTES == _constant('integrator.cu',
                                                    'kMaxSharedBytes')
    assert integrator.MAX_SHARED_BYTES <= 227 * 1024


# per level count: lanes per storm, the slice's floats, and the geometry
# of the widest segment (40960 storms) on an H100
GROUP_CASES = {5: (4, 93, (32, 128, 1280)), 7: (4, 155, (32, 128, 1280)),
               15: (8, 563, (16, 128, 2560)), 17: (8, 705, (16, 128, 2560)),
               37: (16, 3005, (8, 128, 5120))}


@pytest.mark.parametrize('levels', sorted(GROUP_CASES))
def test_k1_group_geometry(levels):
    """The group units' launch shape at 5, 7, 15, 17 and 37 levels: a
    power-of-two group of at least W / 6 lanes per storm (two to six wind
    rows a lane, also past 32 winds), whole warps
    holding whole groups with no warp empty, blocks covering every storm
    of every segment width on at least min(width, SMs) blocks, and the
    slices with the analytic tables within a block's 227 KB; K7 takes as
    many seeds as a block holds."""
    lanes, stride, widest = GROUP_CASES[levels]
    W = 2 * levels
    assert integrator.group_lanes(levels) == lanes
    assert lanes & (lanes - 1) == 0 and 6 * lanes >= W and lanes <= 32
    assert lanes == 4 or 3 * lanes < W        # the smallest such count
    assert 2 <= -(-W // lanes) <= 6           # rows a lane
    cell = W + W * (W + 1) // 2 + 7
    assert integrator.group_stride(levels) == stride == (cell + 2 * W) | 1
    assert integrator.launch_geometry(40960, H100_SMS, levels) == widest
    for n_sm in (H100_SMS, 114):
        for width in (1, 7, 31, 100, 133, 4097, 7168, 38912, 40960, 131072):
            per, threads, blocks = integrator.launch_geometry(width, n_sm,
                                                              levels)
            assert threads % 32 == 0
            assert 32 <= threads <= integrator.GROUP_THREADS
            assert per * lanes <= threads < per * lanes + 32, width
            assert blocks * per >= width > (blocks - 1) * per, width
            assert blocks >= min(width, n_sm), width
            # csrc/integrator.cu group_bytes: a slice per storm
            assert (4 * per * stride + integrator.TABLE_BYTES
                    <= integrator.MAX_SHARED_BYTES <= 227 * 1024)
    cfg = Namelist(steering_levels=tuple(
        int(x) for x in np.linspace(250, 850, levels)))
    _, gate_ip = integrator.gate_params(_stacks(), cfg, 38912)
    assert tuple(gate_ip[-3:]) == integrator.launch_geometry(38912, 1,
                                                             levels)
    assert gate_ip[-3] == min(integrator.GROUP_THREADS // lanes,
                              (integrator.MAX_SHARED_BYTES
                               - integrator.TABLE_BYTES) // (4 * stride))


def test_gate_constants_match_the_source():
    """K7's most threads a block at two to four levels
    (__launch_bounds__), shared by the wrapper and csrc/integrator.cu."""
    assert integrator.GATE_MAX_THREADS == _constant('integrator.cu',
                                                    'kGateThreads')
    assert integrator.GATE_THREADS % 32 == 0
    assert integrator.GATE_THREADS <= integrator.GATE_MAX_THREADS


# per level count: a seed's slot in floats (cell row, geo rows, B row)
GATE_SLOTS = {2: 148, 3: 228, 4: 324}


@pytest.mark.parametrize('levels', sorted(GATE_SLOTS))
@pytest.mark.parametrize('layout', [integrator.IN_CELL, integrator.FUSED_GEO,
                                    integrator.SEPARATE_GEO])
def test_gate_slot_and_plan(levels, layout):
    """K7's slot (csrc/integrator.cu GateRows) and blocks (gate_plan) at
    every level count and stack layout: the cell row at 0, the geo rows
    after it, the B row after those, 16-byte aligned, in an odd count of
    16-byte words (the same in every layout); whole warps of a batch of
    32 seeds each within a block's 227 KB, one warp for every batch of the
    seeds (the entry keeps as many blocks as stay resident); blocks of
    other than whole warps up to GATE_MAX_THREADS refused."""
    W = 2 * levels
    slot = integrator.gate_slot(levels, layout)
    row = integrator.cell_row(layout, levels)
    geo = 0 if layout == integrator.IN_CELL else 8
    assert slot == {'cell': 0, 'geo': row, 'b': row + geo,
                    'stride': GATE_SLOTS[levels]}
    assert slot['b'] % 4 == 0 and slot['stride'] % 8 == 4
    assert slot['b'] + W * 15 <= slot['stride'] < slot['b'] + W * 15 + 8
    for threads in (32, 64, 96, 128):
        nbytes = 4 * threads * slot['stride']
        assert integrator.gate_bytes(levels, threads) == nbytes
        assert nbytes <= integrator.MAX_SHARED_BYTES <= 227 * 1024
        for m in (1, 31, 33, 150, 38912, 40960):
            per, t, blocks = integrator.gate_plan(m, levels, threads)
            assert per == t == threads
            warps, batches = threads // 32, -(-m // 32)
            assert blocks * warps >= batches > (blocks - 1) * warps
    assert integrator.gate_plan(40960, levels) == (
        integrator.GATE_THREADS, integrator.GATE_THREADS,
        -(-1280 // (integrator.GATE_THREADS // 32)))
    for threads in (16, 160, 48):
        with pytest.raises(ValueError, match='K7 takes'):
            integrator.gate_plan(100, levels, threads)


def _vmax_seg(T, N, W=4, edge=0, a_idx=None, before=None, order=None):
    f = lambda: torch.zeros(T, N)
    seg = {'lon': f(), 'lat': f(), 'v': f(), 'vmax': f(),
           'wnds': torch.zeros(T, N, W),
           'alive': torch.zeros(T, N, dtype=torch.bool), 'edge': edge,
           'a_idx': a_idx, 'order': order}
    if before is not None:
        seg.update(before_lon=before[0], before_lat=before[1])
    return seg


def _last_segment_reads():
    """The reads of csrc/vmax.cu tc_vmax_last's segment loop, in order."""
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
    src = (CSRC / 'vmax.cu').read_text()
    body = src[src.index('extern "C" int tc_vmax_last('):]
    loop = body[body.index('for (int k = 0; k < lp.n_segs; ++k) {'):]
    loop = loop[:loop.index('if (T < 1')]
    return re.findall(r'([\w.]+) = (?:reinterpret_cast<[^>]*>\()?ip\[q\+\+\]',
                      loop), k2


def test_last_sample_segment_table():
    """K2's last-sample entry over a launch's segments: the table as
    csrc/vmax.cu tc_vmax_last reads it (twelve header entries, fourteen a
    segment in its order), the first block of each segment after the
    blocks of the ones before it (last_plan, as K4's gather numbers its
    tensors), null pointers where a segment has no slot map, order or row
    before it."""
    reads, k2 = _last_segment_reads()
    assert reads == ['g.edge', 'T', 'width', 'first', 'g.lon', 'g.lat',
                     'g.v', 'g.wnds', 'g.alive', 'g.vmax', 'g.a_idx',
                     'g.order', 'g.before_lon', 'g.before_lat']
    assert k2.MAX_SEGS == _constant('vmax.cu', 'kMaxSegs')
    widths = [40960, 38912, 0, 7168, 1]
    first, blocks = k2.last_plan(widths)
    assert first == [0, 320, 624, 624, 680] and blocks == 681
    m = widths[0]
    segs = [_vmax_seg(60, m)]
    prev = segs[0]
    for k, w in enumerate(widths[1:], 1):
        ai = torch.arange(w, dtype=torch.int64)
        segs.append(_vmax_seg(40, w, edge=20 + 40 * k, a_idx=ai,
                              before=(prev['lon'][-1], prev['lat'][-1]),
                              order=ai))
        prev = segs[-1]
    last = torch.zeros(m, dtype=torch.int64)
    peak = torch.zeros(m)
    full = [{'a_idx': None, 'order': None, 'before_lon': None,
             'before_lat': None, **g} for g in segs]
    ip, fp, n_blocks = k2._last_table(full, last, peak, None, (0, 1, 2, 3),
                                      4, 3600.0, torch.device('cpu'))
    assert n_blocks == blocks and ip.dtype == np.int64
    assert ip.size == 12 + 14 * len(segs)
    assert ip[:8].tolist() == [len(segs), 4, 0, 1, 2, 3, k2.THREADS, blocks]
    assert ip[8:12].tolist() == [last.data_ptr(), peak.data_ptr(), 0, 0]
    assert fp[0] == np.float32(1.0) / np.float32(3600.0)
    for k, (g, f) in enumerate(zip(segs, first)):
        row = ip[12 + 14 * k:26 + 14 * k].tolist()
        T, N = g['lon'].shape
        assert row[:4] == [g['edge'], T, N, f]
        assert row[4:10] == [g[n].data_ptr() for n in ('lon', 'lat', 'v',
                                                       'wnds', 'alive',
                                                       'vmax')]
        if k == 0:
            assert row[10:] == [0, 0, 0, 0]
        else:
            assert row[10:12] == [g['a_idx'].data_ptr(),
                                  g['order'].data_ptr()]
            assert row[12:] == [segs[k - 1]['lon'][-1].data_ptr(),
                                segs[k - 1]['lat'][-1].data_ptr()]


def test_last_sample_entry_refusals():
    """The last-sample entry refuses more than MAX_SEGS segments, an odd
    or too small wind count, winds that differ between segments, vmax_L
    and ok beyond one segment, and CPU tensors, before it launches."""
    from tropical_cyclone_risk_tpu_torch import kernels
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
    last = torch.zeros(8, dtype=torch.int64)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='1 to 16 segments'):
        k2.last_launcher([_vmax_seg(5, 8)] * 17, last, 3600.0, (0, 1, 2, 3))
    with pytest.raises(ValueError, match='1 to 16 segments'):
        k2.last_launcher([], last, 3600.0, (0, 1, 2, 3))
    for W in (3, 5, 2):
        with pytest.raises(NotImplementedError, match='even count'):
            k2.last_launcher([_vmax_seg(5, 8, W=W)], last, 3600.0,
                             (0, 1, 2, 3))
    with pytest.raises(ValueError, match='winds, not'):
        k2.last_launcher([_vmax_seg(5, 8), _vmax_seg(5, 8, W=6)], last,
                         3600.0, (0, 1, 2, 3))
    with pytest.raises(ValueError, match='one segment'):
        k2.last_launcher([_vmax_seg(5, 8)] * 2, last, 3600.0, (0, 1, 2, 3),
                         outs=True)
    with pytest.raises(ValueError, match='CUDA'):
        k2.last_launcher([_vmax_seg(5, 8)] * 16, last, 3600.0, (0, 1, 2, 3))
    assert not any(kernels.LAUNCHES.values())
