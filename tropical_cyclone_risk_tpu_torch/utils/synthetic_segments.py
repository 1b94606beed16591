"""Synthetic inputs of K4's survivor stitch (ops/compact.py
stitch_survivors), made from a seed: time-major segment buffers and their
maps as a launch makes them, and the named cases at which the stitch is
held against its plain twin, by tests/test_torch_stitch_design.py on the
CPU and by chip_smoke.py on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.ops import compact

# the bench launch's nine segments: 60 steps, seven of 30 and 91
BENCH_STEPS = (60,) + (30,) * 7 + (91,)
SIXTEEN = ((20, 7, 5, 9, 3, 6, 1, 8, 4, 11, 2, 5, 3, 7, 2, 4),
           (200, 180, 160, 140, 120, 100, 90, 80, 64, 50, 40, 30, 20, 10, 4,
            1))
NINE = (512, 480, 448, 416, 384, 352, 320, 288, 256)
# name: (m slots, the integrate axis n (None: no slot_rank), segment
# steps, segment widths, k, W)
STITCH_CASES = {
    'one_segment': (96, None, (23,), (96,), 64, 4),
    'two_segments_k1_W2': (64, 90, (9, 14), (64, 33), 1, 2),
    'nine_segments_W4': (256, 300, BENCH_STEPS,
                         (256, 224, 192, 160, 128, 96, 64, 48, 32), 64, 4),
    'sixteen_segments_k77_W6': (200, 260, *SIXTEEN, 77, 6),
    'sixteen_segments_W10': (200, 260, *SIXTEEN, 96, 10),
    'k_above_count_W34': (120, 150, (17, 10, 6), (120, 60, 24), 120, 34),
    'full_tiles_W4': (512, 600, BENCH_STEPS, NINE, 384, 4),
    'full_tiles_W34': (512, None, BENCH_STEPS, NINE, 384, 34),
}


def segments(r: np.random.Generator, m: int, steps, widths, W: int):
    """Time-major segment buffers (the five track fields [T_s, w_s], winds
    [T_s, w_s, W], alive) and the maps of each boundary, on the CPU: each
    storm dies at a random step or lives on, and each boundary keeps the
    alive storms of the segment before first, so storms that died are
    absent from later segments or ride them dead.  Returns (tms, segs)."""
    tms, segs, a_idx, alive = [], [], None, r.random(m) < 0.8
    for s, (T_s, w) in enumerate(zip(steps, widths)):
        if s > 0:
            part = compact.partition_take_plain(
                torch.from_numpy(alive), w, a_prev=a_idx, inv_len=m)
            a_idx = part.a_idx
            segs.append({'inv': part.inv, 'selected': part.selected})
            alive = alive[part.order.numpy()]
        death = r.integers(0, 2 * T_s, w)
        al = (np.arange(T_s)[:, None] < death[None]) & alive[None]
        tm = {f: torch.from_numpy(r.standard_normal((T_s, w)).astype(
            np.float32)) for f in compact.TRACK_FIELDS[:-1]}
        tm['wnds'] = torch.from_numpy(
            r.standard_normal((T_s, w, W)).astype(np.float32))
        tm['alive'] = torch.from_numpy(al)
        tms.append(tm)
        alive = al[-1]
    return tms, segs


def stitch_case(name: str):
    """The arguments of stitch_survivors at STITCH_CASES[name], on the CPU,
    seeded by the name: (order, tms, segs, keep, slot_rank), order the
    first k of a keep mask of m slots, slot_rank an integrate
    compaction's of n slots onto m (or None)."""
    m, n, steps, widths, k, W = STITCH_CASES[name]
    r = np.random.default_rng(sum(map(ord, name)))
    tms, segs = segments(r, m, steps, widths, W)
    keep = torch.from_numpy(r.random(m) < 0.3)
    slot_rank = None
    if n is not None:
        integrate = torch.from_numpy(r.random(n) < 0.7)
        slot_rank = compact.partition_take_plain(integrate, m,
                                                 slot_rank=True).slot_rank
    order = compact.stable_partition_order(keep, k)
    return order, tms, segs, keep, slot_rank
