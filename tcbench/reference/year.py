"""The reference's simulated year: the quota of tracks and the seed counts
of one (member, year), by the reference model's stopping rule.

Batch b of a year proposes ``seed_batch`` seeds from the key
fold_in(year_key, b); its survivors, in slot order, join the year's tracks
until the quota is met.  The seed counts (per basin and month) take every
counted seed of a batch the year used up, and of the batch that met the
quota the counted seeds up to the slot of the quota's last track.

A batch's integrable slots are integrated in chunks of slot order, and
only until the chunk that holds the survivor the year still needs: the
work the delivered tracks need, whatever the program integrated besides.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tcbench.reference import model as M
from tcbench.reference import rng

CHUNK = 65536


class Year(NamedTuple):
    """The delivered tracks of one year (host numpy): lon, lat, v, m, vmax
    [Q, T] and wnds [Q, T, W], NaN past each storm's death; month,
    basin_idx [Q]; n_seeds [n_basins, 12]; work: K1's counted work (alive
    storm-steps, gathers, distinct cells a batch) over the tracks the year
    needed."""
    tracks: dict
    n_seeds: np.ndarray
    work: dict


def year_view(pk: dict, year_idx: int, dtype) -> dict:
    """The year's twelve planes and the static fields at `dtype`."""
    sl = slice(12 * year_idx, 12 * year_idx + 12)
    return dict(grid=pk['grid'], wind=pk['wind'][sl].to(dtype),
                env=pk['env'][sl].to(dtype),
                geo=torch.stack([pk['land'], pk['bathy']], -1).to(dtype),
                basin_masks=pk['basin_masks'], run_mask=pk['run_mask'])


def _counts(n_basins: int, seeds: M.Seeds, upto=None):
    counted = seeds.counted
    if upto is not None:
        counted = counted & (torch.arange(counted.shape[0],
                                          device=counted.device) <= upto)
    idx = seeds.basin_idx * 12 + (seeds.month.to(torch.int64) - 1)
    out = torch.zeros(n_basins * 12, dtype=torch.int64, device=idx.device)
    out.index_add_(0, idx, counted.to(torch.int64))
    return out.reshape(n_basins, 12).cpu().numpy()


def _masked(x, alive):
    a = alive if x.dim() == alive.dim() else alive[..., None]
    return torch.where(a, x, math.nan)


def simulate_year(md: M.Model, pk: dict, year_key: rng.Key, year_idx: int,
                  quota: int, seed_batch: int, max_batches: int = 200
                  ) -> Year:
    pv = year_view(pk, year_idx, md.dtype)
    n_basins = len(md.basins)
    got = 0
    fields = {k: [] for k in ('lon', 'lat', 'v', 'm', 'vmax', 'wnds',
                              'month', 'basin_idx')}
    last_slot = -1     # the slot of the latest delivered track
    work = {'storm_steps': 0, 'gathers': 0, 'storms': 0, 'cells': 0}
    n_seeds = np.zeros((n_basins, 12), np.int64)
    for b in range(max_batches):
        k_seed, k_four = rng.split(rng.fold_in(year_key, b))
        seeds = M.propose(md, pv, k_seed, seed_batch)
        integ = torch.nonzero(seeds.integrate)[:, 0]
        need = quota - got
        cells = []
        for c0 in range(0, integ.shape[0], CHUNK):
            rows = integ[c0:c0 + CHUNK]
            A, B = M.fourier_rows(md, k_four, seed_batch, rows)
            alive0 = M.gate(md, pv, seeds, rows, B)
            tr = M.integrate(md, pv, seeds, rows, A, B, alive0)
            vm, peak = M.vmax(md, tr)
            kp = M.keep(md, tr, peak)
            kept = torch.nonzero(kp)[:, 0][:need]
            use = torch.ones_like(kp)
            if kept.shape[0] == need and need > 0:
                use = torch.arange(kp.shape[0], device=kp.device) <= kept[-1]
            alive = tr.alive & use[None, :]
            work['storm_steps'] += int(alive.sum())
            work['storms'] += int(use.sum())
            cl = tr.cells[:, use]
            cells.append(cl[cl >= 0])
            work['gathers'] += int((cl >= 0).sum())
            sel = lambda x: x[:, kept].transpose(0, 1)
            a = sel(tr.alive)
            for name, x in (('lon', tr.lon), ('lat', tr.lat), ('v', tr.v),
                            ('m', tr.m), ('vmax', vm), ('wnds', tr.wnds)):
                fields[name].append(_masked(sel(x), a).float().cpu().numpy())
            fields['month'].append(seeds.month[rows[kept]].cpu().numpy())
            fields['basin_idx'].append(
                seeds.basin_idx[rows[kept]].cpu().numpy())
            if kept.shape[0]:
                last_slot = int(rows[kept[-1]])
            need -= kept.shape[0]
            got += kept.shape[0]
            if need == 0:
                break
        if cells:
            work['cells'] += int(torch.unique(torch.cat(cells)).numel())
        if got >= quota:
            n_seeds += _counts(n_basins, seeds, last_slot)
            break
        n_seeds += _counts(n_basins, seeds)
    else:
        raise RuntimeError(f'reference: quota not reached after '
                           f'{max_batches} batches ({got}/{quota})')
    tracks = {k: np.concatenate(v) for k, v in fields.items()}
    return Year(tracks, n_seeds, work)
