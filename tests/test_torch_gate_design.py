"""K7's staged design at two to four steering levels (csrc/integrator.cu
genesis_gate_kernel), emulated in torch on the CPU and held against the
plain twin, models/simulator.py genesis_alive_plain, bit for bit.

The emulation follows the kernel's index math: a warp's slots for one
batch of 32 seeds (gate_slot), the resident warps each taking every n-th
batch into those slots, and the warp's copy rounds: the cell rows back to
back over the lanes (round r, lane l copies word e = 32 r + l, word e mod
kCh of seed e div kCh, from the row address of that seed's lane), the
fused geo row (two words a seed) or the separate land and bathymetry rows
(a word each, from the seed's own lane), and the batch's B rows as one
run of b_word-byte words (16, or 8 where B's pointer or row size is not
16-byte aligned).  Each lane reads its slot once the batch has landed,
before the warp stages its next batch into the same slots.  It checks
that every word of every seed's rows lands in the warp's slots once a
batch, at its offset in the seed's slot, that nothing else is written,
and that the gate computed from the slots as read (the twin's own blend,
colouring and compare on the staged rows) equals genesis_alive_plain.
The arithmetic is the twin's float32 torch operations, so the tolerance
is zero.  The kernel itself is held against the twin on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import fast, fields, simulator
from tropical_cyclone_risk_tpu_torch.models import fields as F
from tropical_cyclone_risk_tpu_torch.ops import fourier, interp
from tropical_cyclone_risk_tpu_torch.utils import synthetic_era5

LEVELS = {2: (250, 850), 3: (250, 500, 850), 4: (250, 500, 700, 850)}
LAYOUTS = ('in-cell', 'fused', 'separate')
M = 150          # seeds: four batches of 32 and a ragged fifth


def _cfg(levels):
    lv = LEVELS[levels]
    n = len(lv)
    share = (0.5 / (n - 1),) * (n - 1) + (0.5,)
    return Namelist(steering_levels=lv, steering_coefs=share, y_alpha=share,
                    m_alpha=(0.001,) + (0.0,) * (n - 2) + (-0.001,),
                    alpha_max=(0.4,) * (n - 1) + (0.9,),
                    alpha_min=(0.05,) * (n - 1) + (0.5,))


def _stacks(levels, layout):
    """A small synthetic pack's stacks at `levels`, with land on 2 degrees
    and bathymetry on that grid (fused) or on 1 degree (separate)."""
    cfg = _cfg(levels)
    pk = fields.synthetic_pack_numpy(cfg, 12, 46, 90, seed=0)
    g = pk['grid']

    def onto(a, res):
        lon, lat = synthetic_era5.res_axes(res)
        return (interp.UniformGrid.from_axes(lon, lat),
                interp.regrid(a, g.lon_axis(), g.lat_axis(), lon,
                              lat).numpy())

    if layout != 'in-cell':
        pk['land_grid'], pk['land'] = onto(pk['land'], 2.0)
        if layout == 'fused':
            pk['bathy_grid'] = pk['land_grid']
            pk['bathy'] = np.where(pk['land'] >= 0.5, 100.0,
                                   -4500.0).astype(np.float32)
        else:
            pk['bathy_grid'], pk['bathy'] = onto(pk['bathy'], 1.0)
    stacks = fields.build_stacks(fields.pack_from_numpy(pk, 'cpu'))
    assert integrator.geo_layout(stacks) == LAYOUTS.index(layout)
    return cfg, stacks


def _seeds(levels, seed, b_offset):
    """M seeds over the globe, planes, B rows (a view b_offset floats into
    its buffer, so that its pointer is 16- or only 8-byte aligned) with A
    zero, and an integrate mask."""
    r = np.random.default_rng(seed)
    W = 2 * levels
    lon = torch.from_numpy(r.uniform(0.0, 360.0, M).astype(np.float32))
    lat = torch.from_numpy(r.uniform(-70.0, 70.0, M).astype(np.float32))
    y0 = fast.State(lon, lat, torch.full((M,), 20.0), torch.full((M,), 0.5))
    plane = torch.from_numpy(r.integers(0, 12, M).astype(np.int32))
    buf = torch.from_numpy(
        r.normal(0.0, 0.4, M * W * 15 + 4).astype(np.float32))
    B = buf[b_offset:b_offset + M * W * 15].view(M, W, 15)
    params = fast.SeedParams(plane, torch.full((M,), 1500.0),
                             fourier.FourierSeries(torch.zeros_like(B), B,
                                                   3e6))
    return y0, params, torch.from_numpy(r.random(M) < 0.8)


def _rows(stack, grid, lon, lat, plane=None):
    """Each seed's row of a corner-packed stack as an element offset into
    the flat stack (csrc/integrator.cu row_addr), and its weights."""
    flat, base, wx, wy = interp._flat_base(stack, grid, lon, lat, plane)
    return base * flat.shape[-1], wx, wy


def _stage(stacks, levels, y0, params, n_warps):
    """The kernel's copies with n_warps resident warps, each taking
    batches w, w + n_warps, ... into its 32 slots: (each seed's slot [M,
    stride] as its lane reads it, b_word).  Raises on a copy outside the
    warp's slots, a word written twice in one batch, or padding
    written."""
    layout = integrator.geo_layout(stacks)
    slot = integrator.gate_slot(levels, layout)
    S, W = slot['stride'], 2 * levels
    kch = stacks.cell4.shape[-1] // 4
    plane = params.plane.clamp(0, stacks.cell4.shape[0] - 1)
    srcs = {'cell': (stacks.cell4.reshape(-1),
                     _rows(stacks.cell4, stacks.grid, y0.lon, y0.lat,
                           plane)[0])}
    if layout != integrator.IN_CELL:
        srcs['geo'] = (stacks.land_geo4.reshape(-1),
                       _rows(stacks.land_geo4, stacks.land_grid, y0.lon,
                             y0.lat)[0])
    if layout == integrator.SEPARATE_GEO:
        srcs['bathy'] = (stacks.bathy4.reshape(-1),
                         _rows(stacks.bathy4, stacks.bathy_grid, y0.lon,
                               y0.lat)[0])
    B = params.fourier.B
    row_bytes = W * 15 * 4
    a = B.data_ptr() | row_bytes
    b_word = 16 if a % 16 == 0 else (8 if a % 8 == 0 else 4)
    per_b = row_bytes // b_word
    B_flat = B.reshape(-1)
    used = slot['b'] + W * 15
    lanes = torch.arange(32)
    read = torch.full((M, S), float('nan'))
    for w in range(n_warps):
        smem = torch.full((32 * S,), float('nan'))   # the warp's slots
        for b in range(w, -(-M // 32), n_warps):
            writes = torch.zeros(32 * S, dtype=torch.int64)

            def copy(dst, src, src_off, n_floats):
                # one round of the warp: lane l's word, n_floats floats
                assert bool(((dst >= 0) & (dst < 32 * S)).all())
                for j in range(n_floats):
                    smem[dst + j] = src[src_off + j]
                    writes[dst + j] += 1

            i0 = 32 * b
            n = min(32, M - i0)
            own = torch.clamp(i0 + lanes, max=M - 1)   # a lane's seed
            flat, off = srcs['cell']
            for rnd in range(kch):
                e = rnd * 32 + lanes
                k, wd = e // kch, e % kch
                ok = k < n
                copy((k * S + 4 * wd)[ok], flat, (off[own[k]] + 4 * wd)[ok],
                     4)
            if layout == integrator.FUSED_GEO:
                flat, off = srcs['geo']
                for rnd in range(2):
                    e = rnd * 32 + lanes
                    k, wd = e // 2, e % 2
                    ok = k < n
                    copy((k * S + slot['geo'] + 4 * wd)[ok], flat,
                         (off[own[k]] + 4 * wd)[ok], 4)
            elif layout == integrator.SEPARATE_GEO:
                ok = lanes < n
                for name, at in (('geo', 0), ('bathy', 4)):
                    flat, off = srcs[name]
                    copy((lanes * S + slot['geo'] + at)[ok], flat,
                         off[own][ok], 4)
            q = b_word // 4
            for e0 in range(0, n * per_b, 32):
                e = e0 + lanes
                ok = e < n * per_b
                k, wd = e // per_b, e % per_b
                copy((k * S + slot['b'] + q * wd)[ok], B_flat,
                     (i0 * W * 15 + q * e)[ok], q)
            # the rows' floats once each this batch, the padding never
            wr = writes.view(32, S)
            assert bool((wr[:n, :used] == 1).all())
            assert bool((wr[:, used:] == 0).all()) and not wr[n:].any()
            read[i0:i0 + n] = smem.view(32, S)[:n]
    return read, b_word


def _gate_from_slots(stacks, cfg, y0, params, integrate, slots):
    """fast.ventilation_index_reject on the staged rows: the blends of
    interp.bilinear_packed with the stacks' own weights, F(0) from the
    staged B rows, the colouring and the compare."""
    levels = cfg.n_steering_levels
    layout = integrator.geo_layout(stacks)
    slot = integrator.gate_slot(levels, layout)
    plane = params.plane.clamp(0, stacks.cell4.shape[0] - 1)

    def blend(row, stack, grid, pl=None):
        C = row.shape[1] // 4
        _, wx, wy = _rows(stack, grid, y0.lon, y0.lat, pl)
        return interp._blend(row[:, :C], row[:, C:2 * C], row[:, 2 * C:3 * C],
                             row[:, 3 * C:], wx, wy)

    cell = blend(slots[:, :slot['geo']], stacks.cell4, stacks.grid, plane)
    nw = stacks.n_wind_ch
    if layout == integrator.IN_CELL:
        smp = fast.FieldSample(cell[:, :nw], cell[:, nw:-2], cell[:, -2],
                               cell[:, -1])
    elif layout == integrator.FUSED_GEO:
        geo = blend(slots[:, slot['geo']:slot['geo'] + 8],
                    stacks.land_geo4, stacks.land_grid)
        smp = fast.FieldSample(cell[:, :nw], cell[:, nw:], geo[:, 0],
                               geo[:, 1])
    else:
        land = blend(slots[:, slot['geo']:slot['geo'] + 4],
                     stacks.land_geo4, stacks.land_grid)
        bathy = blend(slots[:, slot['geo'] + 4:slot['geo'] + 8],
                      stacks.bathy4, stacks.bathy_grid)
        smp = fast.FieldSample(cell[:, :nw], cell[:, nw:], land[:, 0],
                               bathy[:, 0])
    W = 2 * levels
    B = slots[:, slot['b']:slot['b'] + W * 15].reshape(-1, W, 15)
    f0 = fourier.FourierSeries(torch.zeros_like(B), B, 3e6).evaluate_at_zero()
    wnds = fast.color_winds_given_f(cfg, smp.wind_stats, f0)
    v_pot = torch.where(fast._is_land(smp.land), 0.0, smp.env[:, F.VPOT])
    vent = fast.shear_magnitude(cfg, wnds) * smp.env[:, F.CHI] / v_pot
    return integrate & ~((v_pot > 0) & (vent >= 1.0))


@pytest.mark.parametrize('levels', sorted(LEVELS))
@pytest.mark.parametrize('layout', LAYOUTS)
def test_staged_gate_matches_the_twin(levels, layout):
    """Every word of every seed's rows staged once a batch at its slot
    offset, and the gate from the slots as read bit for bit the twin's,
    with three resident warps (two and one batch each; a warp's slots
    reused) and with two; B 16-byte aligned, and with its pointer 8 bytes
    off."""
    cfg, stacks = _stacks(levels, layout)
    slot = integrator.gate_slot(levels, integrator.geo_layout(stacks))
    W = 2 * levels
    for b_offset, n_warps in ((0, 3), (2, 2)):
        y0, params, integrate = _seeds(levels, 10 * levels + b_offset,
                                       b_offset)
        slots, b_word = _stage(stacks, levels, y0, params, n_warps)
        assert b_word == (16 if b_offset == 0 and W % 4 == 0 else 8)
        # the staged rows are the rows the twin gathers
        B = params.fourier.B.reshape(M, -1)
        assert torch.equal(slots[:, slot['b']:slot['b'] + W * 15], B)
        keep = _gate_from_slots(stacks, cfg, y0, params, integrate, slots)
        ref = simulator.genesis_alive_plain(stacks, cfg, y0, params,
                                            integrate)
        assert torch.equal(keep, ref)
        assert 0 < int((integrate & ~ref).sum()) < M   # the gate rejects some
