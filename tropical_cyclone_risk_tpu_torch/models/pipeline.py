"""Downscaling pipeline: seeding -> integration -> filtering -> compaction
(twin of tropical_cyclone_risk_tpu/models/pipeline.py).

One launch proposes a batch of seeds, integrates the integrable ones
(compacted to the front, slot-stably), re-compacts the still-alive storms at
each boundary of the tuned schedule, filters, and compacts the survivors;
the host year loop repeats launches until the year's track quota fills,
counting seeds up to the final survivor's slot (the reference's stopping
rule, util/compute.py:134-175).

Two host drivers run a multi-year job, as in the JAX package: the
per-year loop (run_tracks_year, with the year's first launch issued ahead
by prefetch_year_batch0) and the default fused driver
(run_tracks_years_fused: batch 0 of years_per_program years issued back to
back by _simulate_years, the next group issued before the current one is
read, one host transfer per group).  Launches issue asynchronously on the
current stream, so what keeps the card busy across a year boundary is
issuing the next launch before the host reads the current one; both
drivers do, and both give the same tracks bit for bit.  Every driver takes
an optional seed mesh (parallel.sharding), over which each launch runs
shard by shard.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.utils import obs
from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fast,
                                                    seeding, simulator)
from tropical_cyclone_risk_tpu_torch.models import fields as fields_mod
from tropical_cyclone_risk_tpu_torch.models.fields import FieldPack
from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins as basins_mod


@dataclasses.dataclass
class YearTracks:
    """Survivor tracks of one simulated year (util/compute.py:210)."""
    lon: np.ndarray          # [n_tracks, n_steps]
    lat: np.ndarray
    v: np.ndarray
    m: np.ndarray
    vmax: np.ndarray
    wnds: np.ndarray         # [n_tracks, n_steps, W]
    month: np.ndarray        # [n_tracks]
    basin_idx: np.ndarray    # [n_tracks] index into basin_ids_sorted()
    n_seeds: np.ndarray      # [n_basins, 12]
    n_dropped: int = 0       # slots whose every seeding round missed
    n_proposed: int = 0      # total proposal slots drawn


def _round256(w: float, lo: int, hi: int) -> int:
    """ceil to a multiple of 256, clamped to [lo, hi]."""
    w = int(-(-int(w) // 256) * 256)
    return min(hi, max(lo, w))


def launch_width(cfg: Namelist, n: int) -> int:
    """Width m of the integration for an n-seed batch: ceil(n *
    integrate_cap) rounded up to 256 (None or >= 1: uncapped), further
    capped by integrate_width (the quota prefix's mechanism)."""
    if cfg.integrate_cap is None or cfg.integrate_cap >= 1.0:
        m = n
    else:
        m = _round256(n * cfg.integrate_cap, 256, n)
    if cfg.integrate_width is not None:
        m = min(m, _round256(cfg.integrate_width, 256, n))
    return m


# auto_integrate_cap and bump_caps choose among these (1/64 granularity)
INTEGRATE_CAP_BUCKETS = tuple(i / 64.0 for i in range(2, 65))

# quota-prefix headroom: the prefix expects E survivors where
# E = quota + QUOTA_Z * sqrt(E)
QUOTA_Z = 5.0


def quota_cfg(cfg: Namelist, n_tracks: int, n: int,
              n_dev: int = 1) -> Optional[Namelist]:
    """Speculative quota-prefix launch config, or None when not applicable:
    integrate only the prefix of the integrable slots that holds the year's
    first n_tracks survivors with QUOTA_Z-sigma headroom (sized from the
    probed survivors_per_slot).  compact_survivors' scalars[4] proves a
    prefix launch valid; a miss relaunches at the tuned width with the same
    key, so outputs are those of never having speculated.

    n is the global batch, n_dev the mesh's shard count: the width is per
    shard and sized for the full quota, not quota / n_dev, because only
    the shards up to the first truncated one hold provably leading
    survivors (scalars[4]), so a smaller prefix would miss almost every
    batch."""
    if (not cfg.quota_prefix or cfg.integrate_width is not None
            or not cfg.survivors_per_slot or cfg.survivors_per_slot <= 0.0):
        return None
    sqrt_e = (QUOTA_Z + math.sqrt(QUOTA_Z * QUOTA_Z + 4.0 * n_tracks)) / 2.0
    n_local = max(1, n // max(1, n_dev))
    w = _round256(sqrt_e * sqrt_e / cfg.survivors_per_slot, 256, n_local)
    if w >= launch_width(cfg, n_local):
        return None                     # the prefix would not shrink the scan
    return cfg.replace(integrate_width=int(w), recompact_schedule=None,
                       recompact_step=None, recompact_cap=None)


def auto_seed_retry_caps(key: rng.Key, pack: FieldPack, cfg: Namelist,
                         basin_id: str, margin: float = 1.25) -> Namelist:
    """Resolve seed_retry_caps=None from one probe of the retry decay curve:
    each retry round's width is the probed unresolved fraction entering it
    with `margin` x + 1/128 headroom, snapped up to 1/64 buckets (floor
    1/64), non-increasing; used only when it removes >= 10% of the rows."""
    if cfg.seed_retry_caps is not None:
        return cfg
    n_p = min(cfg.seed_batch, 8192)
    counts = seeding.retry_unresolved_curve(rng.fold_in(key, 0x5eed), pack,
                                            cfg, basin_id, n_p)
    R = seeding.N_RETRY_ROUNDS
    caps = []
    prev = 1.0
    for r in range(1, R):
        frac = float(counts[r - 1]) / n_p      # unresolved entering round r
        cap = -(-(frac * margin + 1.0 / 128) * 64 // 1) / 64.0   # ceil 1/64
        caps.append(min(prev, max(1.0 / 64, cap)))
        prev = caps[-1]
    if sum(caps) <= 0.9 * (R - 1):
        cfg = cfg.replace(seed_retry_caps=tuple(caps))
    return cfg


def auto_integrate_cap(key: rng.Key, pack: FieldPack, cfg: Namelist,
                       basin_id: str, margin: float = 1.08) -> Namelist:
    """Resolve integrate_cap=None by measuring the environment: the
    integrable fraction of batch 0 of the first and last simulated years
    sets the cap bucket; a small full-length probe launch per endpoint year
    measures the alive-decay curve (the re-compaction schedule) and the
    survivor rate (the quota prefix's survivors_per_slot)."""
    if cfg.integrate_cap is not None:
        return cfg
    cfg = auto_seed_retry_caps(
        key, fields_mod.slice_pack_year(pack, cfg, 0), cfg, basin_id)
    n_years = max(1, min(cfg.n_months, pack.n_planes) // 12)
    fracs = []
    for yi in sorted({0, n_years - 1}):
        pack_y = fields_mod.slice_pack_year(pack, cfg, yi)
        k_seed, _ = rng.split(rng.fold_in(key, yi))
        prop = seeding.propose_seeds(k_seed, pack_y, cfg, basin_id,
                                     cfg.seed_batch, cfg.start_month - 1)
        fracs.append(float(prop.integrate.to(torch.float32).mean()))
    target = min(1.0, max(fracs) * margin + 1.0 / 64.0)
    cap = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target)
    cfg = cfg.replace(integrate_cap=cap)

    if (cfg.recompact_step is None and cfg.recompact_cap is None
            and cfg.recompact_schedule is None):
        n_p = min(cfg.seed_batch, 8192)
        m_p = float(launch_width(cfg, n_p))
        counts = np.zeros((cfg.n_steps_output,), np.int64)
        keep_rates = []
        for yi in sorted({0, n_years - 1}):
            curve_y, keeps_y = _alive_curve_probe(
                rng.fold_in(key, 0x9e3779 + yi),
                fields_mod.slice_pack_year(pack, cfg, yi), cfg, basin_id,
                n_p)
            counts = np.maximum(counts, curve_y)
            # 3-sigma binomial headroom against probe sampling noise
            keep_rates.append(
                max(0.0, keeps_y - 3.0 * np.sqrt(keeps_y + 1.0)) / m_p)
        if cfg.quota_prefix and cfg.survivors_per_slot is None \
                and min(keep_rates) > 0.0:
            cfg = cfg.replace(survivors_per_slot=min(keep_rates))
        curve = counts / m_p
        T = cfg.n_steps_output
        steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
        # boundary candidates every 30 output steps, above the 2-day window;
        # a boundary joins when its cap bucket shrinks the width by >= 0.5%
        # of an uncapped launch's rows
        sched = []
        prev_cap = 1.0
        for T1 in range(30, T - 1, 30):
            if not (steps_2d < T1 < T - 1):
                continue
            frac2 = min(1.0, float(curve[T1]) * 1.08 + 1.0 / 64.0)
            cap2 = next(b for b in INTEGRATE_CAP_BUCKETS if b >= frac2)
            if cap2 < prev_cap and (prev_cap - cap2) * (T - T1) >= 0.005 * T:
                sched.append((T1, cap2))
                prev_cap = cap2
        if sched:
            edges = [0] + [s for s, _ in sched] + [T]
            caps = [1.0] + [c for _, c in sched]
            rows = sum(c * (edges[i + 1] - edges[i])
                       for i, c in enumerate(caps))
            if rows <= 0.95 * T:               # only split if >=5% saved
                cfg = cfg.replace(recompact_schedule=tuple(sched))
    return cfg


def _alive_curve_probe(key: rng.Key, pack: FieldPack, cfg: Namelist,
                       basin_id: str, n: int):
    """(alive count per output step [T], survivor count) of one small
    launch."""
    body = launch_body(key, pack, cfg, basin_id, n, cfg.start_month - 1)
    return (body['tm']['alive'].sum(dim=1).cpu().numpy(),
            float(body['trk']['keep'].sum()))


def recompact_width(cfg: Namelist, m: int) -> int:
    """Width of the post-recompaction segment (single-boundary form)."""
    if cfg.recompact_cap is None or cfg.recompact_cap >= 1.0:
        return m
    return _round256(m * cfg.recompact_cap, 256, m)


def seg_schedule(cfg: Namelist, m: int) -> tuple:
    """Active re-compaction boundaries ((step, width), ...) for an m-wide
    launch: ascending steps strictly inside (2-day window, T-1), snapped to
    multiples of the field-sample stride, strictly decreasing widths."""
    steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
    T = cfg.n_steps_output
    if cfg.recompact_schedule is not None:
        pairs = cfg.recompact_schedule
    elif cfg.recompact_step is not None and cfg.recompact_cap is not None:
        pairs = ((int(cfg.recompact_step), float(cfg.recompact_cap)),)
    else:
        return ()
    stride = 1
    if not cfg.rk_exact_stage_fields and max(1, int(cfg.rk_substeps)) == 1:
        stride = max(1, int(cfg.field_sample_stride))
    out = []
    prev_w = m
    prev_step = 0
    for step, cap in sorted(pairs):
        step = int(round(step / stride)) * stride
        if not (steps_2d < step < T - 1) or cap is None or cap >= 1.0 \
                or step <= prev_step:
            continue
        w = _round256(m * cap, 256, m)
        if w < prev_w:
            out.append((int(step), w))
            prev_w = w
            prev_step = step
    return tuple(out)


def seg_edges_widths(sched, m: int, T: int):
    """(edges [K+1], widths [K]) of the segment decomposition."""
    return ([0] + [s for s, _ in sched] + [T],
            [m] + [w for _, w in sched])


class LaunchInputs(NamedTuple):
    """The integration inputs of one launch, on the compacted m axis."""
    prop: seeding.SeedProposal      # full-width [n] proposals
    slot_rank: Optional[torch.Tensor]   # [n] rank on the m axis, -1 if cut
    overflow: torch.Tensor          # [1] integrable slots beyond m
    stacks: fields_mod.GatherStacks
    state: fast.State
    params: fast.SeedParams
    alive0: torch.Tensor            # [m] step-0 alive mask
    month: torch.Tensor             # [m] the proposals' months
    basin_idx: torch.Tensor         # [m]


def launch_inputs(key: rng.Key, pack: FieldPack, cfg: Namelist,
                  basin_id: str, n: int, plane_offset: int) -> LaunchInputs:
    """Propose n seeds and compact the integrable ones slot-stably to the
    first m = launch_width(cfg, n) positions (one partition_take with every
    per-seed row).  The Fourier flow is drawn at the compacted slots alone
    (the draw of a slot does not depend on the others), so survivor tracks
    are identical to an uncapped launch's."""
    dev = pack.device
    k_seed, k_fourier = rng.split(key)
    with obs.span('tc.launch.propose'):
        prop = seeding.propose_seeds(k_seed, pack, cfg, basin_id, n,
                                     plane_offset)
    m = launch_width(cfg, n)
    rows = (prop.plane, prop.h_bl, prop.lon, prop.lat, prop.v_init,
            prop.m_init, prop.integrate, prop.month, prop.basin_idx)
    shape = (n, cfg.n_wind_levels)
    slot_rank = order = None
    overflow = torch.zeros((1,), dtype=torch.int64, device=dev)
    if m < n:
        with obs.span('tc.launch.partition'):
            part = compact_ops.partition_take(prop.integrate, m, rows,
                                              slot_rank=True)
        rows, overflow, slot_rank = part.rows, part.overflow, part.slot_rank
        order = part.order
    with obs.span('tc.launch.draw'):
        fs = fourier.draw_fourier(k_fourier, shape, cfg.T_fourier_s, dev,
                                  rows=order)
    plane, h_bl, lon, lat, v, m_init, integrate, month, basin_idx = rows
    params = fast.SeedParams(plane=plane, h_bl=h_bl, fourier=fs)
    state = fast.State(lon, lat, v, m_init)
    if cfg.m_init_mode == 'dvdt0':
        state = state._replace(m=fast.init_m_dvdt0(
            pack, cfg, state.lon, state.lat, state.v, params))
    stacks = fields_mod.build_stacks(pack)
    with obs.span('tc.launch.gate'):
        alive0 = simulator.genesis_alive(stacks, cfg, state, params,
                                         integrate)
    return LaunchInputs(prop, slot_rank, overflow, stacks, state, params,
                        alive0, month, basin_idx)


def launch_body(key: rng.Key, pack: FieldPack, cfg: Namelist, basin_id: str,
                n: int, plane_offset: int, shard_index: int = 0) -> dict:
    """Propose n seeds, integrate, filter: the per-seed work of one launch,
    or of one shard of a launch over a seed mesh (parallel.sharding).

    The integration (launch_inputs' compacted m axis) runs as one segment
    per boundary of seg_schedule, re-compacting the still-alive storms at
    each boundary (frozen-state segments compose exactly); with no schedule
    it is one segment.

    vmax is the post-pass diagnostics.axi_to_max_wind_raw per segment, or
    with cfg.vmax_in_scan the integrator's in-scan value: its DiagState
    carry rides the boundary compactions, each segment's running peak is
    banked on the m axis (a storm dropped at a boundary keeps its peak), and
    diagnostics.fix_in_scan re-derives each track's final sample, over
    every segment at once, and banks it.

    Returns {'seed': full-width [n] metadata, 'slot_rank': the integrate
    compaction's [n] ranks (None when m == n), 'trk': compacted [m] track
    metadata, 'tm': segment 0's time-major buffers, 'overflow': [2]
    (integrate cap, boundaries)}, plus 'tms'/'segs' for the later segments
    of a segmented launch.

    shard_index d places the maps on the mesh's shard-major axes, where
    shard d's m axis and each later segment's w axis come d-th: slot_rank
    is offset by d * m where it is >= 0, and each later segment's 'inv' by
    d * w where the slot is on that segment (0 elsewhere, as on one
    device)."""
    li = launch_inputs(key, pack, cfg, basin_id, n, plane_offset)
    prop, stacks = li.prop, li.stacks
    m = li.alive0.shape[0]
    dt_out = float(cfg.output_interval_s)
    edges, widths = seg_edges_widths(seg_schedule(cfg, m), m,
                                     cfg.n_steps_output)
    bounds = basins_mod.basin_bounds(cfg, basin_id)

    raws = []        # per segment: time-major dict on its own axis
    orders = []      # per boundary: gather map axis k-1 -> axis k
    a_idxs = []      # per later segment: composed map seg axis -> m axis
    segs = []        # per later segment: its inverse map and selection
    bnd_states = []  # per segment: carry state AT its end boundary
    over2 = torch.zeros_like(li.overflow)   # alive storms beyond a boundary
    state_k, params_k, alive_k, a_idx = li.state, li.params, li.alive0, None
    dstate = peak_acc = None
    if cfg.vmax_in_scan:
        f32 = dict(dtype=torch.float32, device=li.alive0.device)
        dstate = simulator.DiagState(torch.zeros((m,), **f32),
                                     torch.zeros((m,), **f32),
                                     torch.full((m,), -math.inf, **f32))
        peak_acc = dstate.peak
    for k, w in enumerate(widths):
        # one span a segment: its boundary partition and its integration
        with obs.span('tc.launch.segment'):
            if k > 0:
                fs = params_k.fourier
                part = compact_ops.partition_take(
                    alive_k, w, (params_k.plane, params_k.h_bl, fs.A, fs.B,
                                 *state_k, alive_k, *(dstate or ())),
                    acc=over2, a_prev=a_idx, inv_len=m)
                plane, h_bl, A, B, lon, lat, v, m_k, alive_k = part.rows[:9]
                params_k = fast.SeedParams(plane, h_bl, fs._replace(A=A, B=B))
                state_k = fast.State(lon, lat, v, m_k)
                if dstate is not None:
                    dstate = simulator.DiagState(*part.rows[9:])
                over2, a_idx = part.overflow, part.a_idx
                orders.append(part.order)
                a_idxs.append(a_idx)
                segs.append({'inv': part.inv, 'selected': part.selected})
            outs_k, carry = simulator.integrate_segment(
                stacks, cfg, bounds, state_k, alive_k, params_k, edges[k],
                edges[k + 1] - edges[k], dstate,
                edges[-1] - 1 if k + 1 == len(widths) else -1)
            raws.append(dict(zip(('lon', 'lat', 'v', 'm', 'wnds', 'alive',
                                  'vmax'), outs_k)))
            state_k, alive_k = carry[:2]
            if dstate is not None:
                # bank the segment's running peak on the m axis: a storm
                # dropped at the next boundary keeps its lifetime maximum
                dstate = carry[2]
                peak_acc = diagnostics.bank_peak(peak_acc, dstate.peak,
                                                 a_idx)
            bnd_states.append(state_k)

    # stitched per-slot reductions on the m axis
    last_step = raws[0]['alive'].sum(dim=0)
    for ai, r in zip(a_idxs, raws[1:]):
        last_step = last_step.index_add(0, ai, r['alive'].sum(dim=0))
    last_step = torch.clamp_min(last_step - 1, 0)
    steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
    idx_2d = torch.clamp_max(last_step, steps_2d)      # < edges[1] always
    v_2d = torch.gather(raws[0]['v'], 0, idx_2d[None, :])[0]
    reach = lambda r: (torch.where(r['alive'], r['v'], 0.0)
                       >= cfg.seed_v_threshold_ms).any(dim=0)
    reached = reach(raws[0])
    for ai, r in zip(a_idxs, raws[1:]):
        reached = reached | compact_ops.scatter_fill(m, ai, reach(r),
                                                     False)
    is_tc = reached & (v_2d >= cfg.seed_v_2d_threshold_ms) \
        & raws[0]['alive'][0]

    with obs.span('tc.launch.vmax'):
        if peak_acc is not None:
            # in-scan: only each track's final valid sample is re-derived
            # (edge extrapolation) and joins the banked running peaks, over
            # every segment at once
            vmaxs, peak = diagnostics.fix_in_scan(raws, edges, a_idxs,
                                                  orders, last_step,
                                                  peak_acc, dt_out, cfg)
            for r, v in zip(raws, vmaxs):
                r['vmax'] = v
        else:
            # vmax per segment with exact boundary neighbours; tracks that
            # end in another segment never trigger this segment's end fix-up
            for k, r in enumerate(raws):
                if k == 0:
                    ls_k, pos_before = last_step, None
                else:
                    ls_k = last_step[a_idxs[k - 1]] - edges[k]
                    prev = raws[k - 1]
                    o = orders[k - 1]
                    pos_before = torch.stack([prev['lon'][-1][o],
                                              prev['lat'][-1][o]])
                # the carry at this segment's end is the sample after its
                # last row
                pos_after = (torch.stack([bnd_states[k].lon,
                                          bnd_states[k].lat])
                             if k + 1 < len(raws) else None)
                r['vmax'], peak_k = diagnostics.axi_to_max_wind_raw(
                    r['lon'], r['lat'], dt_out, r['v'], r['wnds'],
                    r['alive'], ls_k, cfg, pos_before=pos_before,
                    pos_after=pos_after)
                peak = (peak_k if k == 0 else
                        diagnostics.bank_peak(peak, peak_k, a_idxs[k - 1]))
    keep = is_tc & (peak >= cfg.seed_vmax_threshold_ms)

    slot_rank = li.slot_rank
    if shard_index:
        if slot_rank is not None:
            slot_rank = torch.where(slot_rank >= 0,
                                    slot_rank + shard_index * m, slot_rank)
        for seg, w in zip(segs, widths[1:]):
            seg['inv'] = torch.where(seg['selected'],
                                     seg['inv'] + shard_index * w, seg['inv'])
    body = {
        'seed': {'counted': prop.counted, 'month': prop.month,
                 'basin_idx': prop.basin_idx, 'dropped': prop.dropped},
        'slot_rank': slot_rank,
        'trk': {'keep': keep, 'month': li.month,
                'basin_idx': li.basin_idx},
        'tm': raws[0],
        'overflow': torch.cat([li.overflow, over2]),
    }
    if len(raws) > 1:
        body['tms'] = tuple(raws[1:])
        # per later segment: column of each m-axis slot in that segment
        body['segs'] = tuple(segs)
    return body


def _count_all_body(counted, basin_idx, month, n_basins: int):
    """seeds_per_month [n_basins, 12] of a whole batch."""
    idx = basin_idx.to(torch.int64) * 12 + (month.to(torch.int64) - 1)
    out = torch.zeros((n_basins * 12,), dtype=torch.int64,
                      device=counted.device)
    return out.index_add_(0, idx, counted.to(torch.int64)).reshape(
        n_basins, 12)


def _count_upto_body(keep, counted, basin_idx, month, j: int,
                     n_basins: int):
    """seeds_per_month over slots up to (and including) the (j+1)-th
    survivor's slot (the reference's stopping rule)."""
    cs = torch.cumsum(keep.to(torch.int64), 0)
    cutoff = torch.argmax((cs == (j + 1)).to(torch.uint8))
    in_prefix = torch.arange(keep.shape[0], device=keep.device) <= cutoff
    return _count_all_body(counted & in_prefix, basin_idx, month, n_basins)


def compact_survivors(body: dict, m: int, k_max: int, n_basins: int = 0,
                      n_shards: int = 1):
    """Survivors first in slot order, truncated to k_max; returns (tracks,
    meta) with [k_max, T] NaN-masked track buffers.  m is the integration
    width (summed over the mesh's n_shards shards, whose bodies are laid
    out shard-major; parallel.sharding).  n_basins > 0 adds the per-batch
    host decisions: 'scalars' [5] (survivors, integrate-cap overflow,
    boundary overflow, dropped slots, and the provably usable survivors in
    shard-major slot order: the counts of the shards up to and including
    the first whose integrate compaction cut integrable slots, since that
    shard may hide survivors that precede every later shard's; on one
    shard the survivor count), 'spm_upto' (seeds counted up to the
    k_max-th survivor's slot) and 'spm_all' (the whole batch)."""
    seed, trk = body['seed'], body['trk']
    keep = trk['keep']
    part = compact_ops.partition_take(keep, k_max, (trk['month'],
                                                    trk['basin_idx'], keep))
    tracks, keep_full = compact_ops.stitch_survivors(
        part.order, (body['tm'],) + body.get('tms', ()), body.get('segs', ()),
        keep, body['slot_rank'])
    tracks.update(zip(('month', 'basin_idx', 'valid'), part.rows))
    meta = {'keep': keep_full}
    meta.update((k, seed[k]) for k in ('counted', 'basin_idx', 'month',
                                       'dropped'))
    meta['overflow'] = body['overflow']
    if n_basins:
        n_keep = meta['keep'].sum()
        over = body['overflow'].reshape(n_shards, 2)
        q_usable = n_keep
        if n_shards > 1:
            trunc = (over[:, 0] > 0).to(torch.int64)
            q_shard = meta['keep'].reshape(n_shards, -1).sum(dim=1)
            q_usable = torch.where(torch.cumsum(trunc, 0) - trunc == 0,
                                   q_shard, 0).sum()
        over = over.sum(dim=0)
        meta['scalars'] = torch.stack(
            [n_keep, over[0], over[1], meta['dropped'].sum(), q_usable])
        meta['spm_upto'] = _count_upto_body(
            meta['keep'], meta['counted'], meta['basin_idx'], meta['month'],
            k_max - 1, n_basins)
        meta['spm_all'] = _count_all_body(
            meta['counted'], meta['basin_idx'], meta['month'], n_basins)
    return tracks, meta


def _simulate_batch(key: rng.Key, pack: FieldPack, cfg: Namelist,
                    basin_id: str, n: int, k_max: int, plane_offset: int):
    """One launch: propose n seeds, integrate, filter, compact.  Returns
    per-slot metadata plus the first k_max surviving tracks; the
    throughput benchmark unit."""
    with obs.span('tc.launch'):
        body = launch_body(key, pack, cfg, basin_id, n, plane_offset)
        with obs.span('tc.launch.compact'):
            return compact_survivors(body, launch_width(cfg, n), k_max,
                                     n_basins=len(cfg.basin_ids_sorted()))


def _simulate_batches(keys, pack: FieldPack, cfg: Namelist, basin_id: str,
                      n: int, k_max: int, plane_offset: int) -> list:
    """K launches of one pack, one per key, issued back to back on the
    current stream (the JAX package's _simulate_batches_jit, a scan over
    the keys in one program).  Returns the K (tracks, meta) pairs of
    _simulate_batch, as _simulate_years returns its years."""
    return [_simulate_batch(k, pack, cfg, basin_id, n, k_max, plane_offset)
            for k in keys]


def _dispatch_batch(key: rng.Key, pack_y: FieldPack, cfg: Namelist,
                    basin_id: str, n: int, k_max: int, plane_offset: int,
                    mesh=None):
    """One launch on the year's pack: over the seed mesh
    (parallel.sharding.simulate_batch_sharded) or on the pack's device."""
    if mesh is not None:
        from tropical_cyclone_risk_tpu_torch.parallel import sharding
        return sharding.simulate_batch_sharded(mesh, key, pack_y, cfg,
                                               basin_id, n, k_max,
                                               plane_offset)
    return _simulate_batch(key, pack_y, cfg, basin_id, n, k_max,
                           plane_offset)


def _n_dev(mesh) -> int:
    return 1 if mesh is None else mesh.size


def bump_caps(cfg: Namelist, n_over1: int, n_over2: int, n: int,
              margin: float = 1.08) -> Namelist:
    """Re-tune the compaction caps after an overflow: the smallest bucket
    covering the overflowed batch's measured demand, with the headroom
    auto_integrate_cap uses."""
    m = launch_width(cfg, n)
    if n_over1 > 0:
        target = min(1.0, (m + n_over1) / n * margin + 1.0 / 64.0)
        cfg = cfg.replace(integrate_cap=next(
            b for b in INTEGRATE_CAP_BUCKETS if b >= target))
        m = launch_width(cfg, n)
    if n_over2 > 0 and cfg.recompact_schedule is not None:
        # which boundary overflowed is unknown: widen every boundary by the
        # measured total demand
        new = []
        for step, cap in cfg.recompact_schedule:
            w = _round256(m * cap, 256, m)
            target2 = min(1.0, (w + n_over2) / m * margin + 1.0 / 64.0)
            cap2 = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target2)
            if cap2 < 1.0:
                new.append((step, cap2))
        # clearing the schedule must disable recompaction, not unmask a
        # stale recompact_step/recompact_cap pair underneath it
        cfg = cfg.replace(recompact_schedule=tuple(new)) if new else \
            cfg.replace(recompact_schedule=None, recompact_step=None,
                        recompact_cap=None)
    elif n_over2 > 0 and cfg.recompact_cap is not None:
        target2 = min(1.0, (recompact_width(cfg, m) + n_over2) / m * margin
                      + 1.0 / 64.0)
        cap2 = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target2)
        cfg = (cfg.replace(recompact_step=None, recompact_cap=None)
               if cap2 >= 1.0 else cfg.replace(recompact_cap=cap2))
    return cfg


class Transfer:
    """numpy copies of tensors through one device-to-host transfer, issued
    at construction on the current stream behind the work that makes
    them: their bytes concatenated on the device and copied without
    blocking (into pinned host memory).  get() waits for that copy alone,
    so work issued after it (the next launch) runs on meanwhile."""

    def __init__(self, tensors):
        ts = [t.contiguous() for t in tensors]
        self._layout = [(t.dtype, tuple(t.shape), t.numel()) for t in ts]
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in ts])
        self._host = flat.to('cpu', non_blocking=True)
        self._event = None
        if flat.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(flat.device))

    def get(self) -> list:
        # the read is a wait span on every device (none blocks on the CPU)
        with obs.span('tc.driver.wait'):
            if self._event is not None:
                self._event.synchronize()
        with obs.span('tc.driver.copy'):
            buf = self._host.numpy()
            out, o = [], 0
            for dtype, shape, n in self._layout:
                dt = torch.empty((), dtype=dtype).numpy().dtype
                out.append(np.frombuffer(buf, dt, n, o).reshape(shape).copy())
                o += n * dt.itemsize
        return out


def _issue(tracks: dict, meta: dict) -> tuple:
    """(tracks, meta, the batch's host transfer of its decisions and every
    track row), the transfer issued right behind the launch."""
    return tracks, meta, Transfer((meta['scalars'], meta['spm_upto'],
                                   meta['spm_all'], *tracks.values()))


def _read(batch: tuple) -> tuple:
    """(scalars as ints, spm_upto, spm_all), {track field: host rows} of
    an issued batch."""
    tracks, _, xfer = batch
    sc, upto, all_, *rows = xfer.get()
    return ([int(x) for x in sc], upto, all_), dict(zip(tracks, rows))


def _simulate_years(key: rng.Key, years, plane_idx, vpot_valid,
                    pack: FieldPack, cfg: Namelist, basin_id: str, n: int,
                    k_max: int, mesh=None) -> list:
    """Batch 0 of k simulated years, issued back to back on the current
    stream (the JAX package's years_scan and _simulate_years_jit).

    years [k] calendar years; plane_idx [k, 12] and vpot_valid [k, 12] the
    rows of fields.year_plane_indices of each year, gathered as
    slice_pack_year gathers them (fields.gather_year, the clamped planes'
    vpot zeroed); each year's key is fold_in(fold_in(key, year), 0), its
    run_tracks_year batch 0.  Returns the k (tracks, meta) pairs of
    _simulate_batch, one per year, from which the driver reads every
    year's decisions and track rows in one transfer.

    A short tail group is not padded to k years by repeating the last one:
    the JAX package pads it only to keep one compiled program shape, and
    here a padded year would be one launch thrown away.  With a mesh each
    year's launch runs over it (_dispatch_batch)."""
    plane_off = cfg.start_month - 1
    return [_dispatch_batch(rng.fold_in(rng.fold_in(key, int(year)), 0),
                            fields_mod.gather_year(pack, idx, valid), cfg,
                            basin_id, n, k_max, plane_off, mesh)
            for year, idx, valid in zip(years, plane_idx, vpot_valid)]


def prefetch_year_batch0(key: rng.Key, pack: FieldPack, cfg: Namelist,
                         basin_id: str, year_idx: int,
                         n_tracks: Optional[int] = None, mesh=None):
    """Issue a year's first seed batch without reading anything back; pass
    the result to run_tracks_year(first_batch=...).  The per-year loop uses
    it to keep one launch in flight across year boundaries (in the common
    case one batch fills the whole quota).  The launch takes the
    quota-prefix derivation run_tracks_year applies to its own batches,
    and its host transfer is issued right behind it (_issue).  mesh: the
    seed mesh the launch runs over (None: the pack's device)."""
    n_tracks = n_tracks or cfg.tracks_per_year
    N = cfg.seed_batch
    cfg_d = quota_cfg(cfg, n_tracks, N, _n_dev(mesh)) or cfg
    with obs.span('tc.driver.dispatch'):
        return _issue(*_dispatch_batch(
            rng.fold_in(key, 0),
            fields_mod.slice_pack_year(pack, cfg, year_idx), cfg_d, basin_id,
            N, min(n_tracks, launch_width(cfg_d, N)), cfg.start_month - 1,
            mesh))


def run_tracks_year(key: rng.Key, pack: FieldPack, cfg: Namelist,
                    basin_id: str, year_idx: int,
                    n_tracks: Optional[int] = None, max_batches: int = 200,
                    first_batch=None, adapt: Optional[dict] = None,
                    mesh=None) -> YearTracks:
    """Generate the year's track quota (reference run_tracks,
    util/compute.py:64-210).  first_batch: an already issued batch 0
    with the same key and caps: prefetch_year_batch0's (tracks, meta,
    transfer), or a fused launch's (tracks, meta).  Every batch is read
    through one host transfer issued right behind it.  adapt: optional
    mutable {'cfg': Namelist} shared across years, where cap re-tuning
    after an overflow is kept.  mesh: the seed mesh every launch runs over
    (parallel.sharding; None: the pack's device)."""
    n_tracks = n_tracks or cfg.tracks_per_year
    if adapt is not None:
        cfg = adapt.get('cfg', cfg)
    n_basins = len(cfg.basin_ids_sorted())
    N = cfg.seed_batch
    k_max = min(n_tracks, launch_width(cfg, N))
    # speculative quota prefix (quota_cfg); a batch whose prefix cannot
    # settle the quota relaunches at the tuned width with the same key
    n_dev = _n_dev(mesh)
    cfg_q = quota_cfg(cfg, n_tracks, N, n_dev)
    k_max_q = (min(n_tracks, launch_width(cfg_q, N))
               if cfg_q is not None else k_max)
    # the year's planes are gathered lazily: a year its given batch 0
    # settles never needs them
    pack_y = []
    plane_off = cfg.start_month - 1

    def launch(b_i, c, k):
        with obs.span('tc.driver.dispatch'):
            if not pack_y:
                pack_y.append(fields_mod.slice_pack_year(pack, cfg,
                                                         year_idx))
            return _issue(*_dispatch_batch(rng.fold_in(key, b_i), pack_y[0],
                                           c, basin_id, N, k, plane_off,
                                           mesh))

    rows: List[dict] = []
    n_seeds = np.zeros((n_basins, 12))
    n_dropped = 0
    n_proposed = 0
    got = 0
    for b_i in range(max_batches):
        q_mode = cfg_q is not None
        if b_i == 0 and first_batch is not None:
            if len(first_batch) > 2:
                batch = first_batch
            else:
                with obs.span('tc.driver.dispatch'):
                    batch = _issue(*first_batch)
        else:
            batch = launch(b_i, cfg_q if q_mode else cfg,
                           k_max_q if q_mode else k_max)
        dec, host = _read(batch)
        n_new, n_over1, n_over2, n_drop = dec[0][:4]
        n_proposed += N
        n_dropped += n_drop
        if q_mode:
            if dec[0][4] >= n_tracks - got and n_over2 == 0:
                n_over1 = n_over2 = 0       # the prefix settles this batch
            elif n_over1 == 0 and n_over2 == 0:
                # quota missed but nothing was truncated: the prefix launch
                # already is the tuned full launch, its survivors stand
                pass
            else:
                # prefix miss: relaunch at the tuned width with the same key
                obs.log.warning(
                    'quota prefix missed (%d of %d tracks provable, batch '
                    '%d, integrate_width=%s); relaunching at the tuned '
                    'width', dec[0][4], n_tracks - got, b_i,
                    cfg_q.integrate_width)
                with obs.span('tc.driver.prefix_relaunch'):
                    batch = launch(b_i, cfg, k_max)
                    dec, host = _read(batch)
                n_new, n_over1, n_over2, relaunch_drop = dec[0][:4]
                assert relaunch_drop == n_drop, (
                    'seeding drops must not depend on the integrate width')
        if n_over1 + n_over2 > 0:
            # more integrable (or boundary-alive) seeds than a cap: redo
            # this batch uncapped (same key, nothing clipped), then re-tune
            # the caps so later batches run compacted again
            obs.log.warning(
                'compaction cap overflowed by %d/%d seeds (batch %d, '
                'integrate_cap=%s recompact %s); falling back to an '
                'uncapped launch', n_over1, n_over2, b_i, cfg.integrate_cap,
                cfg.recompact_schedule)
            cfg_full = cfg.replace(integrate_cap=1.0, recompact_step=None,
                                   recompact_cap=None,
                                   recompact_schedule=None)
            with obs.span('tc.driver.uncapped_relaunch'):
                batch = launch(b_i, cfg_full, min(n_tracks, N))
                dec, host = _read(batch)
            n_new = dec[0][0]
            cfg = bump_caps(cfg, n_over1, n_over2, N)
            k_max = min(n_tracks, launch_width(cfg, N))
            cfg_q = quota_cfg(cfg, n_tracks, N, n_dev)
            k_max_q = (min(n_tracks, launch_width(cfg_q, N))
                       if cfg_q is not None else k_max)
            if adapt is not None:
                adapt['cfg'] = cfg
            obs.log.warning('caps re-tuned: integrate_cap=%s recompact %s',
                            cfg.integrate_cap, cfg.recompact_schedule)
        # this batch's track rows: a batch issued before a cap re-tuning
        # can hold fewer than the re-tuned k_max (and a sharded launch can
        # keep more survivors than its k_max rows: the extras are drawn
        # again from the next batch)
        tracks, meta, _ = batch
        bk_max = int(tracks['lon'].shape[0])
        take = min(n_new, n_tracks - got, k_max, bk_max)

        def spm_upto(j):
            # precomputed inside the launch for the full-quota batch
            if j == bk_max - 1:
                return dec[1]
            upto = _count_upto_body(meta['keep'], meta['counted'],
                                    meta['basin_idx'], meta['month'], j,
                                    n_basins)
            with obs.span('tc.driver.wait'):
                return upto.cpu().numpy()

        if take > 0:
            rows.append({k: v[:take] for k, v in host.items()})
            got += take
        if got >= n_tracks:
            n_seeds += spm_upto(take - 1)
            break
        if 0 < take < n_new:
            # capped by k_max with quota still open: seeds after the last
            # accepted survivor's slot are re-drawn by the next batch
            n_seeds += spm_upto(take - 1)
        else:
            n_seeds += dec[2]
    else:
        raise RuntimeError(
            f'track quota not reached after {max_batches} batches '
            f'({got}/{n_tracks}); environment may not support genesis')

    cat = lambda k: np.concatenate([r[k] for r in rows], axis=0)[:n_tracks]
    with obs.span('tc.driver.copy'):
        return YearTracks(lon=cat('lon'), lat=cat('lat'), v=cat('v'),
                          m=cat('m'), vmax=cat('vmax'), wnds=cat('wnds'),
                          month=cat('month'), basin_idx=cat('basin_idx'),
                          n_seeds=n_seeds, n_dropped=n_dropped,
                          n_proposed=n_proposed)


YEAR_FIELDS = ('lon', 'lat', 'v', 'm', 'vmax', 'wnds', 'month', 'basin_idx')


def run_tracks_years_fused(key: rng.Key, pack: FieldPack, cfg: Namelist,
                           basin_id: str, years: List[int],
                           n_tracks: Optional[int] = None,
                           adapt: Optional[dict] = None,
                           k_fuse: Optional[int] = None,
                           mesh=None) -> List[YearTracks]:
    """Multi-year driver: batch 0 of k_fuse years issued as one group
    (_simulate_years) with one host transfer of every year's decisions and
    track rows right behind it, and the next group issued before the
    current one is read.

    A year settles here when its batch 0 fills the whole quota with no
    compaction-cap overflow (the steady state).  Any other year finishes on
    run_tracks_year with the same per-year key and this launch as its batch
    0, so results equal the per-year loop's in every case.  `years` are
    calendar years (cfg.years() order); year_idx for field slicing is the
    position.  `adapt` carries cap re-tuning across fallbacks as in
    run_tracks_year.  `mesh`: the seed mesh every launch runs over
    (parallel.sharding.simulate_years_sharded), whose results are those of
    the per-year loop on the same mesh, not of one device (each shard
    folds its index into the key)."""
    n_tracks = n_tracks or cfg.tracks_per_year
    if k_fuse is None:
        k_fuse = max(1, cfg.years_per_program)
    N = cfg.seed_batch
    cfg0 = adapt.get('cfg', cfg) if adapt is not None else cfg
    if min(n_tracks, launch_width(cfg0, N)) < n_tracks:
        # a batch holds fewer track rows than the quota, so every year
        # needs the multi-batch loop: run it directly, one launch in flight
        results = []
        pending = prefetch_year_batch0(
            rng.fold_in(key, years[0]), pack, cfg0, basin_id, 0,
            n_tracks=n_tracks, mesh=mesh) if years else None
        for yi, year in enumerate(years):
            nxt = prefetch_year_batch0(
                rng.fold_in(key, years[yi + 1]), pack,
                adapt.get('cfg', cfg0) if adapt is not None else cfg0,
                basin_id, yi + 1, n_tracks=n_tracks, mesh=mesh) \
                if yi + 1 < len(years) else None
            with obs.span('tc.driver.fallback'):
                results.append(run_tracks_year(
                    rng.fold_in(key, year), pack, cfg, basin_id, yi,
                    n_tracks=n_tracks, first_batch=pending, adapt=adapt,
                    mesh=mesh))
            pending = nxt
        return results
    groups = [list(range(i, min(i + k_fuse, len(years))))
              for i in range(0, len(years), k_fuse)]
    t0 = time.time()

    def dispatch(g):
        with obs.span('tc.driver.dispatch'):
            cfg_g = adapt.get('cfg', cfg) if adapt is not None else cfg
            # the quota-prefix derivation of run_tracks_year: a fallback
            # year reuses this launch as its batch 0
            cfg_q = quota_cfg(cfg_g, n_tracks, N, _n_dev(mesh))
            cfg_d = cfg_q if cfg_q is not None else cfg_g
            k_max = min(n_tracks, launch_width(cfg_d, N))
            iv = [fields_mod.year_plane_indices(cfg_g, pack.n_planes, yi)
                  for yi in g]
            outs = _simulate_years(key, [years[yi] for yi in g],
                                   [x[0] for x in iv], [x[1] for x in iv],
                                   pack, cfg_d, basin_id, N, k_max, mesh)
            # one host transfer per group, issued right behind its launches:
            # every year's decisions and rows
            xfer = Transfer([t for tracks, meta in outs
                             for t in (meta['scalars'], meta['spm_upto'],
                                       *(tracks[k] for k in YEAR_FIELDS))])
            return outs, xfer, cfg_g, k_max, cfg_q is not None

    results: List[Optional[YearTracks]] = [None] * len(years)
    pending = dispatch(groups[0]) if groups else None
    for gi, g in enumerate(groups):
        outs, xfer, cfg_g, k_max, q_mode = pending
        pending = dispatch(groups[gi + 1]) if gi + 1 < len(groups) else None
        host = xfer.get()
        per = 2 + len(YEAR_FIELDS)
        for j, yi in enumerate(g):
            scalars, spm_upto, *rows = host[j * per:(j + 1) * per]
            n_new, n_over1, n_over2, n_drop = (int(x) for x in scalars[:4])
            if q_mode:
                # the integrate-cap overflow is the prefix truncation itself
                settled = (n_over2 == 0 and int(scalars[4]) >= n_tracks
                           and k_max >= n_tracks)
            else:
                settled = (n_over1 + n_over2 == 0 and n_new >= n_tracks
                           and k_max >= n_tracks)
            if settled:
                # the stopping-rule seed counts for take == k_max were
                # computed inside the launch (compact_survivors)
                results[yi] = YearTracks(
                    **{k: r[:n_tracks] for k, r in zip(YEAR_FIELDS, rows)},
                    n_seeds=np.asarray(spm_upto, np.float64),
                    n_dropped=n_drop, n_proposed=N)
            else:
                # overflow or unfilled quota: finish the year on the
                # general path with this launch as its batch 0
                with obs.span('tc.driver.fallback'):
                    results[yi] = run_tracks_year(
                        rng.fold_in(key, years[yi]), pack, cfg_g, basin_id,
                        yi, n_tracks=n_tracks, adapt=adapt,
                        first_batch=outs[j], mesh=mesh)
        done = sum(r is not None for r in results)
        obs.log.info('years %d-%d: %d tracks, %.1f s elapsed (%d/%d years)',
                     years[g[0]], years[g[-1]],
                     sum(results[yi].lon.shape[0] for yi in g),
                     time.time() - t0, done, len(years))
    return results


def concat_years(years: List[YearTracks], cfg: Namelist) -> dict:
    """The multi-year output arrays (util/compute.py:233-247)."""
    cat = lambda k: np.concatenate([getattr(y, k) for y in years])
    out = {k: cat(k) for k in ('lon', 'lat', 'v', 'm', 'vmax', 'wnds',
                               'month', 'basin_idx')}
    out['n_seeds'] = np.stack([y.n_seeds for y in years])
    out['year'] = np.concatenate([np.full(y.lon.shape[0], cfg.start_year + i)
                                  for i, y in enumerate(years)])
    return out
