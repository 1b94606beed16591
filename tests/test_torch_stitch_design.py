"""K4's tiled survivor stitch (csrc/compact.cu stitch_kernel), emulated in
numpy on the CPU and held against the plain twin, ops/compact.py
stitch_survivors_plain, bit for bit.

The emulation follows the kernel's index math block by block: the tiles
of kernels/compact.py stitch_plan (step tiles fastest), each block's
segment as the count of later segments whose first tile is at or before
its own, its survivors' columns and selected flags, the read phase with
lanes over survivors at one step into the swizzled staging (cell
tt * 32 + (i ^ tt << (5 - log TS))), the winds' rounds of words over
(survivor, step, word) with the kernel's running quotient and remainder,
the write phase with lanes over the steps of one survivor's row, and the
keep_full tail.  It checks that every (survivor, step) and every wind
word is written once, by a tile inside its segment, that no staging cell
is written twice in a tile or read without being written in it, and that
every output equals the twin's bits.  The kernel itself is held against
the twin on the card by chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
from tropical_cyclone_risk_tpu_torch.ops import compact
from tropical_cyclone_risk_tpu_torch.utils.synthetic_segments import (
    BENCH_STEPS, STITCH_CASES, stitch_case)

SOURCE = (Path(k4.__file__).resolve().parents[1] / 'csrc'
          / 'compact.cu').read_text()
FIELDS = compact.TRACK_FIELDS
NAN = 0x7fc00000
UNSET = 0x7f800001               # a value no output or staging cell holds


def _constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SOURCE).group(1))


def test_stitch_constants_match_the_source():
    assert k4.STITCH_SURV == 1 << _constant('kLogSurv')
    assert re.search(r'constexpr int kStitchSurv = 1 << kLogSurv;', SOURCE)
    assert k4.STITCH_STEPS == _constant('kStitchSteps')
    assert k4.STITCH_THREADS == _constant('kStitchThreads')
    assert k4.STITCH_WIND_BYTES == _constant('kWindBytes')
    assert k4.KEEP_BLOCK == k4.STITCH_THREADS * _constant('kKeepPer')
    assert k4.MAX_SEGS == _constant('kMaxSegs')
    # the static staging: kFields fields and the live flags a cell, the
    # column and flag a survivor
    fields = _constant('kFields')
    assert k4.STITCH_SHARED_BYTES == (
        (fields + 1) * 4 * k4.STITCH_STEPS + 8 + 4) * k4.STITCH_SURV


@pytest.mark.parametrize('W', range(2, 76, 2))
def test_stitch_plan_limits(W):
    """At every even W from 2 to 74 (ERA5's 37 levels): TS a power of two
    up to STITCH_STEPS, a tile's winds within four rounds, the staging
    within 48 KB of static shared memory, the bench's [64, 361] at one
    tile or more per SM, and the large k at full tiles where W allows."""
    assert k4.STITCH_SHARED_BYTES <= 48 * 1024
    for k in (1, 64, 4096, 40960):
        plan = k4.stitch_plan(BENCH_STEPS, k, W)
        ts = plan.steps
        assert ts == 1 << plan.log_steps and 1 <= ts <= k4.STITCH_STEPS
        assert k4.STITCH_SURV * ts * W * 4 <= k4.STITCH_TILE_WIND_BYTES
        assert plan.first_tiles[0] == 0
        assert plan.step_tiles == sum(-(-s // ts) for s in BENCH_STEPS)
        assert plan.surv_tiles == -(-k // k4.STITCH_SURV)
        assert plan.tile_blocks == plan.surv_tiles * plan.step_tiles
        if k == 64:
            assert plan.tile_blocks >= k4.STITCH_MIN_BLOCKS
        if k >= 4096 and W <= 16:
            assert ts == k4.STITCH_STEPS
    for k, W_, ts in ((64, 4, 4), (64, 34, 4), (4096, 4, 32), (4096, 34, 8),
                      (40960, 4, 32)):
        assert k4.stitch_plan(BENCH_STEPS, k, W_).steps == ts


def test_wind_word():
    """16-byte words where W and every pointer allow them, else 8; a
    pointer off 8 bytes is refused."""
    assert k4.wind_word(4, [0, 512, 1024]) == 16
    assert k4.wind_word(4, [0, 520]) == 8
    assert k4.wind_word(8, [0]) == 16
    for W in (2, 6, 10, 34, 74):
        assert k4.wind_word(W, [0, 512]) == 8
    with pytest.raises(ValueError, match='8-byte'):
        k4.wind_word(4, [0, 4])


def _bits(t):
    return t.contiguous().view(torch.int32).numpy().reshape(-1)


def _emulate(order, tms, segs, keep, slot_rank):
    """stitch_kernel's grid over numpy copies of the inputs: returns the
    five fields and the winds as int32 bits, keep_full, and the times each
    output element and word was written."""
    ks, threads = k4.STITCH_SURV, k4.STITCH_THREADS
    k = order.shape[0]
    steps = [tm['lon'].shape[0] for tm in tms]
    T, W = sum(steps), tms[0]['wnds'].shape[-1]
    plan = k4.stitch_plan(steps, k, W)
    word = k4.wind_word(W, [tm['wnds'].data_ptr() for tm in tms])
    wv, per = W * 4 // word, word // 4         # words a sample, int32 a word
    n_u = k4.STITCH_WIND_BYTES // word          # words a thread a round
    rounds = ks * k4.STITCH_STEPS // threads    # cells a thread
    lts, ts = plan.log_steps, plan.steps
    swz = 5 - lts
    order = order.numpy()
    edges = np.concatenate([[0], np.cumsum(steps)])
    seg = [{'f': [_bits(tm[f]) for f in FIELDS[:-1]],
            'wnds': _bits(tm['wnds']).reshape(-1, per),
            'alive': tm['alive'].numpy().reshape(-1).astype(np.uint8),
            'width': tm['lon'].shape[1]} for tm in tms]
    for g, mp in zip(seg[1:], segs):
        g['inv'], g['sel'] = mp['inv'].numpy(), mp['selected'].numpy()
    out = np.full((5, k * T), UNSET, np.int32)
    out_w = np.full((k * T * wv, per), UNSET, np.int32)
    hits = np.zeros((5, k * T), np.int64)
    hits_w = np.zeros(k * T * wv, np.int64)
    tid = np.arange(threads)
    assert plan.tile_blocks == plan.surv_tiles * plan.step_tiles
    stage = np.full((5, ks * k4.STITCH_STEPS), UNSET, np.int32)
    live_cell = np.zeros(ks * k4.STITCH_STEPS, np.int64)
    for b in range(plan.tile_blocks):
        # the block's tile, step tiles fastest, and its segment
        sv, st = divmod(b, plan.step_tiles)
        s = sum(1 for i in range(1, len(tms)) if plan.first_tiles[i] <= st)
        g = seg[s]
        tt0 = (st - plan.first_tiles[s]) << lts
        n_steps = min(ts, steps[s] - tt0)
        assert 0 <= tt0 < steps[s] and n_steps >= 1
        t_out = edges[s] + tt0
        assert edges[s] <= t_out and t_out + n_steps <= edges[s + 1]
        j0 = sv * ks
        n_surv = min(ks, k - j0)
        # its survivors' columns and selected flags in the segment
        slot = order[j0:j0 + n_surv]
        col = np.zeros(ks, np.int64)
        on = np.zeros(ks, np.int64)
        col[:n_surv] = slot if s == 0 else g['inv'][slot]
        on[:n_surv] = 1 if s == 0 else g['sel'][slot]
        written = np.zeros(ks * k4.STITCH_STEPS, bool)     # this tile's

        def load_round(e0, live_of):
            """A round of wind words from e0 (per thread): each word's
            (in, i, tt, c) and the loaded words, where live_of(i, tt)."""
            q, c = e0 // wv, e0 % wv
            dq, dc = threads // wv, threads - threads // wv * wv
            res = []
            for u in range(n_u):
                i, tt = q >> lts, q & (ts - 1)
                inn = (e0 + u * threads < ks * ts * wv) & (i < n_surv) & (
                    tt < n_steps)
                i_c, tt_c = np.minimum(i, ks - 1), np.minimum(tt, ts - 1)
                ld = inn & live_of(i_c, tt_c)
                src = ((tt0 + tt_c) * g['width'] + col[i_c]) * wv + c
                w = np.full((threads, per), 0x12345678, np.int32)
                w[ld] = g['wnds'][src[ld]]
                res.append((inn, i_c, tt_c, c.copy(), w))
                q, c = q + dq, c + dc
                wrap = c >= wv
                c, q = np.where(wrap, c - wv, c), np.where(wrap, q + 1, q)
            return res

        def store_round(res):
            for inn, i, tt, c, w in res:
                cell = tt * ks + (i ^ (tt << swz))
                assert written[cell[inn]].all()
                live = live_cell[cell] != 0
                dst = ((j0 + i) * T + t_out + tt) * wv + c
                val = np.where(live[:, None], w, NAN)
                out_w[dst[inn]] = val[inn]
                np.add.at(hits_w, dst[inn], 1)

        # read: lanes over survivors at one step, then the staging
        cells = n_steps << 5
        got = []
        for r in range(rounds):
            c = tid + r * threads
            tt, i = c >> 5, c & (ks - 1)
            ld = (c < cells) & (on[i] != 0)
            o = (tt0 + tt) * g['width'] + col[i]
            a = np.zeros(threads, np.uint8)
            a[ld] = g['alive'][o[ld]]
            v = np.full((5, threads), 0x12345678, np.int32)
            for f in range(5):
                v[f, ld] = g['f'][f][o[ld]]
            got.append((c, tt, i, a, v))
        res0 = load_round(tid, lambda i, tt: on[i] != 0)
        for c, tt, i, a, v in got:
            m = c < cells
            cell = (tt * ks + (i ^ (tt << swz)))[m]
            assert not written[cell].any() and len(set(cell)) == len(cell)
            written[cell] = True
            live_cell[cell] = a[m] != 0
            stage[:, cell] = np.where(a[m] != 0, v[:, m], NAN)

        # write: the scalars with lanes over one row's steps, the winds
        for r in range(rounds):
            c = tid + r * threads
            i, tt = c >> lts, c & (ts - 1)
            m = (c < ks << lts) & (i < n_surv) & (tt < n_steps)
            cell = (tt * ks + (i ^ (tt << swz)))[m]
            assert written[cell].all()
            o = ((j0 + i) * T + t_out + tt)[m]
            out[:, o] = stage[:, cell]
            np.add.at(hits, (slice(None), o), 1)
        store_round(res0)
        e0 = tid + n_u * threads
        while (e0 < ks * ts * wv).any():
            store_round(load_round(e0, lambda i, tt: live_cell[
                tt * ks + (i ^ (tt << swz))] == 1))
            e0 = e0 + n_u * threads

    keep_full = None
    if slot_rank is not None:
        n = slot_rank.shape[0]
        rank, kp = slot_rank.numpy(), keep.numpy()
        keep_full = np.full(n, 2, np.uint8)
        for b in range(-(-n // k4.KEEP_BLOCK)):
            for u in range(k4.KEEP_BLOCK // threads):
                q = b * k4.KEEP_BLOCK + tid + u * threads
                q = q[q < n]
                rr = rank[q]
                keep_full[q] = np.where(rr >= 0, kp[np.maximum(rr, 0)], 0)
        assert (keep_full < 2).all()
    return out, out_w, keep_full, hits, hits_w


@pytest.mark.parametrize('case', list(STITCH_CASES))
def test_stitch_design_matches_the_twin(case):
    _, _, steps, _, k, W = STITCH_CASES[case]
    order, tms, segs, keep, slot_rank = stitch_case(case)
    assert order.shape[0] == k
    tracks, keep_full = compact.stitch_survivors_plain(order, tms, segs,
                                                       keep, slot_rank)
    out, out_w, kf, hits, hits_w = _emulate(order, tms, segs, keep,
                                            slot_rank)
    T = sum(steps)
    assert (hits == 1).all() and (hits_w == 1).all()
    for f in range(5):
        np.testing.assert_array_equal(out[f], _bits(tracks[FIELDS[f]]),
                                      err_msg=FIELDS[f])
    np.testing.assert_array_equal(out_w.reshape(-1), _bits(tracks['wnds']))
    assert tracks['wnds'].shape == (k, T, W)
    if slot_rank is None:
        assert keep_full is keep and kf is None
    else:
        np.testing.assert_array_equal(kf, keep_full.numpy())
    # the cases reach what they are named for
    plan = k4.stitch_plan(steps, k, W)
    if case.startswith('full_tiles'):
        assert plan.steps == (32 if W == 4 else 8)
    if case == 'k_above_count_W34':
        assert int(keep.sum()) < k
    if len(steps) > 1 and k > 1:
        absent = ~segs[-1]['selected'][order]
        assert absent.any()
