"""A cell cut to a size the CPU runs in seconds: a 4-degree grid, a small
seed batch and quota, one or two years."""

from tcbench import run as run_mod

TINY_GRID = dict(lon0=0.0, dlon=4.0, nlon=90, lat0=-90.0, dlat=4.0, nlat=46)


def tiny_cell(name: str, seed_batch: int, quota: int, n_years: int,
              limits=None) -> dict:
    cell = run_mod.load_cell(name)
    cell['cfg']['grid'] = dict(TINY_GRID)
    t = cell['traffic']
    t.update(seed_batch=seed_batch, tracks_per_year=quota,
             end_year=t['start_year'] + n_years - 1)
    cell['cell']['check'].update(members=1, years=n_years)
    if limits is not None:
        cell['cell']['check']['limits'] = limits
    return cell


def run_cpu(cell, seed=12345, seconds=0.5, fault=None):
    return run_mod.run(cell, seed, seconds, False, 'cpu', [], fault=fault,
                       log=lambda m: None)
