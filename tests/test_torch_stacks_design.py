"""The field stacks' kernel (csrc/stacks.cu stack_corners_kernel), emulated
in numpy on the CPU and held against the plain twin, models/fields.py
build_stacks_plain, bit for bit; its launch plan; and build_stacks on CPU
tensors, which takes the twin.

The emulation follows the kernel's index math block by block: each
thread's running (row, column) walk over a source's staged cells (the
column past the edge clamped to the last), the three row buffers in turn
down the block's strip, and the output words (16, 8 or 4 bytes, as C
allows) walked over the tile row's cells, the upper corners from row i's
buffer and the lower from row i+1's.  Shared memory and the output start
as NaN, so a word read before it is staged, or never written, shows.  The
kernel itself is held against the twin on the card by
tests/test_torch_stacks_card.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import stacks as kstacks
from tropical_cyclone_risk_tpu_torch.models import fields
from tropical_cyclone_risk_tpu_torch.ops.interp import (UniformGrid,
                                                        pack_corners)

SOURCE = (Path(kstacks.__file__).resolve().parents[1] / 'csrc'
          / 'stacks.cu').read_text()
T = kstacks.THREADS


def _constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SOURCE).group(1))


def _walk(width):
    """Every thread's Walk(t, width): (row, col, drow, dcol)."""
    t = np.arange(T)
    return t // width, t % width, T // width, T % width


def _next(row, col, drow, dcol, width):
    row, col = row + drow, col + dcol
    wrap = col >= width
    return row + wrap, col - width * wrap


def emulate(sources, tile, strip):
    """stack_corners_kernel's output on numpy copies of the sources, with
    the launch's tile and strip."""
    planes = {s.shape[0] for s in sources if s.dim() == 4}
    lead = tuple(planes)
    P = lead[0] if lead else 1
    H, W = (sources[0].shape[-3:-1] if sources[0].dim() > 2
            else sources[0].shape)
    layout = [(1 if s.dim() == 2 else s.shape[-1],
               s[0].numel() if s.dim() == 4 else 0) for s in sources]
    flat = [s.numpy().reshape(-1) for s in sources]
    C = sum(ch for ch, _ in layout)
    word = 4 if C % 4 == 0 else 2 if C % 2 == 0 else 1
    c = C // word
    out = np.full((P * H * W * 4 * C // word, word), np.nan, np.float32)
    stage = (tile + 1) * C
    for pl in range(P):
        for i0 in range(0, H, strip):
            for j0 in range(0, W, tile):
                n, rows = min(tile, W - j0), min(strip, H - i0)
                smem = np.full(kstacks.BUFFERS * stage, np.nan, np.float32)

                def stage_row(r, buf):
                    off = 0
                    for src, (ch, plane) in zip(flat, layout):
                        row, col, drow, dcol = _walk(ch)
                        base = pl * plane + r * W * ch
                        while (on := row <= n).any():
                            jc = np.minimum(j0 + row[on], W - 1)
                            smem[buf * stage + row[on] * C + off
                                 + col[on]] = src[base + jc * ch + col[on]]
                            row, col = _next(row, col, drow, dcol, ch)
                        off += ch

                src_row = lambda k: min(i0 + k, H - 1)   # noqa: E731
                stage_row(src_row(0), 0)
                stage_row(src_row(1), 1)
                words = smem.reshape(-1, word)
                for k in range(rows):
                    if k + 2 <= rows:
                        stage_row(src_row(k + 2), (k + 2) % 3)
                    top = (k % 3) * stage // word
                    bot = ((k + 1) % 3) * stage // word
                    dst = ((pl * H + i0 + k) * W + j0) * 4 * C // word
                    row, col, drow, dcol = _walk(4 * c)
                    o = np.arange(T)
                    while (on := o < n * 4 * c).any():
                        lower = col[on] >= 2 * c
                        idx = (np.where(lower, bot, top) + row[on] * c
                               + col[on] - np.where(lower, 2 * c, 0))
                        out[dst + o[on]] = words[idx]
                        row, col = _next(row, col, drow, dcol, 4 * c)
                        o = o + T
    return torch.from_numpy(out.reshape(lead + (H, W, 4 * C)))


def _pack(nlat, nlon, n_planes=3, levels=(250, 850), seed=0):
    cfg = Namelist()
    if len(levels) != 2:
        k = len(levels)
        cfg = cfg.replace(steering_levels=levels,
                          steering_coefs=(1.0 / k,) * k,
                          y_alpha=(0.0,) * k, m_alpha=(0.0,) * k,
                          alpha_max=(1.0 / k,) * k,
                          alpha_min=(1.0 / k,) * k)
    return fields.synthetic_pack(cfg, n_planes, nlat, nlon, seed=seed,
                                 device='cpu')


def _own_grids(pack, fused):
    """The pack with land on a grid of its own (5 degrees) and bathymetry
    on that grid (fused) or on its own (2.5 degrees)."""
    rng = np.random.default_rng(1)
    land_grid = UniformGrid(0.0, 5.0, 72, -90.0, 5.0, 37)
    bathy_grid = land_grid if fused else UniformGrid(0.0, 2.5, 144, -90.0,
                                                     2.5, 73)
    grid_field = lambda g: torch.from_numpy(                 # noqa: E731
        rng.standard_normal((g.nlat, g.nlon)).astype(np.float32))
    return pack._replace(land_grid=land_grid, land=grid_field(land_grid),
                         bathy_grid=bathy_grid, bathy=grid_field(bathy_grid))


def test_constants_match_source():
    assert _constant('kThreads') == kstacks.THREADS
    assert _constant('kBuffers') == kstacks.BUFFERS
    assert _constant('kMaxSources') == kstacks.MAX_SOURCES


@pytest.mark.parametrize('levels,tile,strip', [
    ((250, 850), 3, 2),            # C = 21: 4-byte words, geo in the cell
    ((250, 500, 850), 4, 3),       # C = 34: 8-byte words
    ((250, 500, 700, 850), 5, 1),  # C = 51
    ((250, 300, 500, 700, 850), 7, 4),   # C = 72: 16-byte words
])
def test_emulated_kernel_equals_twin(levels, tile, strip):
    """Every output of build_stacks, on tiles and strips that leave a
    ragged last tile and strip, equals the twin's bits."""
    pack = _pack(7, 11, levels=levels)
    ref = fields.build_stacks_plain(pack)
    for sources, want in zip(fields.stack_sources(pack),
                             (ref.cell4, ref.land_geo4, ref.bathy4)):
        got = emulate(sources, min(tile, 11), strip)
        assert got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize('fused', [True, False])
def test_emulated_kernel_own_grids(fused):
    """Land and bathymetry on grids of their own: the cell row without
    them, land_geo4 with one or two channels, each at the plan's own tile
    and strip."""
    pack = _own_grids(_pack(6, 9, n_planes=2), fused)
    ref = fields.build_stacks_plain(pack)
    assert not ref.geo_in_cell and ref.fused_geo == fused
    for sources, want in zip(fields.stack_sources(pack),
                             (ref.cell4, ref.land_geo4, ref.bathy4)):
        pl = kstacks.plan(want.shape[-2], want.shape[-1] // 4)
        got = emulate(sources, pl.tile, pl.strip)
        assert torch.equal(got, want)


def test_plan_at_the_cells_shapes():
    """At 17 levels (C = 636) eight blocks' staged rows share the SM's
    shared memory with 2-cell tiles; at two levels (C = 21) the tile is
    MAX_TILE; every plan fits a block's shared memory."""
    pl = kstacks.plan(360, 636)
    assert (pl.tile, pl.strip) == (2, 4)
    assert pl.shared_bytes == 3 * 3 * 636 * 4
    assert kstacks.BLOCKS_PER_SM * (pl.shared_bytes + 1024) <= \
        kstacks.SM_SHARED_BYTES
    assert kstacks.plan(360, 21)[:2] == (64, 4)
    for C in (1, 2, 21, 636, 2000, 9685):
        assert kstacks.plan(360, C).shared_bytes <= kstacks.SM_SHARED_BYTES
    assert kstacks.plan(3, 21).tile == 3
    with pytest.raises(ValueError, match='shared memory'):
        kstacks.plan(360, 9686)


@pytest.mark.parametrize('own', [None, True, False])
def test_build_stacks_on_cpu_takes_the_twin(own):
    """On CPU tensors build_stacks is the twin, pack_corners of the
    concatenated sources, and counts neither a launch nor a twin call on
    CUDA."""
    pack = _pack(6, 9, n_planes=2)
    if own is not None:
        pack = _own_grids(pack, own)
    kernels.reset_counts()
    got = fields.build_stacks(pack)
    assert kernels.LAUNCHES['stacks'] == 0
    assert kernels.PLAIN_ON_CUDA['stacks'] == 0
    cell = torch.cat([pack.wind, pack.env], -1)
    if own is None:
        geo = torch.stack([pack.land, pack.bathy], -1)
        cell = torch.cat([cell, geo.expand((2,) + geo.shape)], -1)
        land_geo = geo
    else:
        land_geo = (torch.stack([pack.land, pack.bathy], -1) if own
                    else pack.land[..., None])
    assert got.geo_in_cell == (own is None)
    assert torch.equal(got.cell4, pack_corners(cell))
    assert torch.equal(got.land_geo4, pack_corners(land_geo))
    assert torch.equal(got.bathy4, pack_corners(pack.bathy[..., None]))
    assert got.n_wind_ch == pack.wind.shape[-1]


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        kstacks.corner_stack([torch.zeros(2, 3, 4, 5)])
