"""The comparison that decides ``correct``: the delivered year outputs of
the system under test against the reference's, for the (member, year)
pairs a run checks.

A delivered track agrees with a reference track when it starts at the
same genesis point (within MATCH_DEG, same month and basin), dies at the
same step and every sample of every field lies within TOLERANCE of the
reference's.  The numbers:

- ``track_gap``: one minus the longest run of agreeing tracks in the same
  order on both sides, over the larger of the two track counts.  A track
  that is missing, extra, altered or out of order costs about 1/Q; a
  wrong set costs up to 1.
- ``count_gap``: the delivered track counts' absolute differences from
  the year's quota, over the quota: 0 when every year delivers exactly
  its quota.
- ``seed_count_gap``: the seed counts' absolute differences (per basin and
  month) over their total.

Each is held to the limit that the cell's workload file gives it.
"""

from __future__ import annotations

import bisect

import numpy as np

# a sample of a shared track differs where a field moves by more than this
TOLERANCE = {'lon': 1e-3, 'lat': 1e-3, 'v': 1e-2, 'm': 1e-4, 'vmax': 1e-2,
             'wnds': 1e-2}
MATCH_DEG = 1e-3     # a delivered track starts at a reference track within


def _key(lon, lat, month, basin):
    return (np.float32(lon).tobytes(), np.float32(lat).tobytes(), int(month),
            int(basin))


def _start(tracks: dict, i: int):
    return (tracks['lon'][i, 0], tracks['lat'][i, 0], tracks['month'][i],
            tracks['basin_idx'][i])


def counterpart(ref: dict, got: dict) -> np.ndarray:
    """For each delivered track, the reference track that starts at its
    genesis point, or -1."""
    table = {}
    n_ref = ref['lon'].shape[0]
    for i in range(n_ref):
        table.setdefault(_key(*_start(ref, i)), i)
    lon0, lat0 = ref['lon'][:, 0], ref['lat'][:, 0]
    out = np.full(got['lon'].shape[0], -1, np.int64)
    for j in range(got['lon'].shape[0]):
        lo, la, mo, ba = _start(got, j)
        i = table.get(_key(lo, la, mo, ba))
        if i is None and n_ref:
            d = np.abs(lon0 - lo) + np.abs(lat0 - la)
            d = np.where((ref['month'] == mo) & (ref['basin_idx'] == ba), d,
                         np.inf)
            k = int(np.argmin(d))
            i = k if d[k] <= MATCH_DEG else None
        if i is not None:
            out[j] = i
    return out


def agrees(ref: dict, got: dict, i: int, j: int) -> bool:
    a = ~np.isnan(ref['lon'][i])
    if not np.array_equal(a, ~np.isnan(got['lon'][j])):
        return False
    return all(np.all(np.abs(ref[f][i][a] - got[f][j][a]) <= tol)
               for f, tol in TOLERANCE.items())


def longest_increasing(seq) -> int:
    """The length of the longest strictly increasing subsequence."""
    tails = []
    for x in seq:
        k = bisect.bisect_left(tails, x)
        if k == len(tails):
            tails.append(x)
        else:
            tails[k] = x
    return len(tails)


def compare_year(ref: dict, ref_counts, got: dict, got_counts) -> dict:
    """The raw counts of one year.  ref and got: the delivered fields (lon,
    lat, v, m, vmax [Q, T], wnds [Q, T, W], month, basin_idx [Q]); the
    counts: seeds per basin and month."""
    idx = counterpart(ref, got)
    agree = [int(i) for j, i in enumerate(idx)
             if i >= 0 and agrees(ref, got, int(i), j)]
    ref_counts = np.asarray(ref_counts, np.float64)
    got_counts = np.asarray(got_counts, np.float64)
    return {
        'quota': int(ref['lon'].shape[0]),
        'delivered': int(got['lon'].shape[0]),
        'agree_in_order': longest_increasing(agree),
        'seed_abs': float(np.abs(got_counts - ref_counts).sum()),
        'seed_total': float(ref_counts.sum()),
    }


def numbers(years: list) -> dict:
    """The compared numbers over the checked years' raw counts."""
    s = lambda k: sum(y[k] for y in years)
    return {
        'track_gap': 1.0 - s('agree_in_order') / max(
            1, sum(max(y['quota'], y['delivered']) for y in years)),
        'count_gap': (sum(abs(y['delivered'] - y['quota']) for y in years)
                      / max(1, s('quota'))),
        'seed_count_gap': s('seed_abs') / max(1.0, s('seed_total')),
    }


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {'value', 'limit'}}) for the numbers that have a
    limit; a missing number fails."""
    out = {k: {'value': nums.get(k, float('nan')), 'limit': lim}
           for k, lim in limits.items()}
    ok = all(v['value'] <= v['limit'] for v in out.values())
    return ok, out
