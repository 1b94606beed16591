"""Run orchestration and the track-output contract (twin of
tropical_cyclone_risk_tpu/runtime.py, single device).

The output schema is the JAX package's, field for field (itself the
reference's, util/compute.py:250-264), written through the port's copy of
the NetCDF writer (io/netcdf.py).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.utils import obs
from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.models import pipeline, seeding
from tropical_cyclone_risk_tpu_torch.models.fields import FieldPack
from tropical_cyclone_risk_tpu_torch.utils import basins as basins_mod


def get_fn_tracks(cfg: Namelist, basin_id: str) -> str:
    """Track filename contract (util/compute.py:40-46)."""
    return ('%s/%s/tracks_%s_%s_%d%02d_%d%02d.nc' %
            (cfg.output_directory, cfg.exp_name, basin_id, cfg.exp_prefix,
             cfg.start_year, cfg.start_month, cfg.end_year, cfg.end_month))


def fn_tracks_duplicates(fn_trk: str) -> str:
    """Ensemble-member suffixing _eN (util/compute.py:52-58).  The chosen
    name is claimed atomically (O_CREAT|O_EXCL placeholder, overwritten by
    the writer's atomic publish), so concurrent members never collide."""
    f_int = 0
    fn_out = fn_trk
    while True:
        try:
            os.close(os.open(fn_out, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return fn_out
        except FileExistsError:
            fn_out = fn_trk[:-3] + '_e%d.nc' % f_int
            f_int += 1


def write_tracks_nc(path: str, out: dict, cfg: Namelist) -> None:
    """Write the track dataset (schema: util/compute.py:250-264)."""
    basin_ids = list(cfg.basin_ids_sorted())
    ts_output = np.linspace(0, cfg.total_track_time_s, cfg.n_steps_output)
    basin_strs = np.array([basin_ids[i] for i in out['basin_idx']],
                          dtype='U2')
    f32 = lambda k: (('n_trk', 'time'), out[k].astype(np.float32))
    data_vars = {
        'lon_trks': f32('lon'), 'lat_trks': f32('lat'), 'v_trks': f32('v'),
        'm_trks': f32('m'), 'vmax_trks': f32('vmax'),
        'tc_month': (('n_trk',), out['month'].astype(np.float64)),
        'tc_basins': (('n_trk',), basin_strs),
        'tc_years': (('n_trk',), out['year'].astype(np.int32)),
        'seeds_per_month': (('year', 'basin', 'month'),
                            out['n_seeds'].astype(np.float64)),
    }
    # per-steering-level wind channels (u250_trks, v250_trks, ...)
    for i, lvl in enumerate(cfg.steering_levels):
        for j, comp in enumerate('uv'):
            data_vars[f'{comp}{lvl}_trks'] = (
                ('n_trk', 'time'), out['wnds'][:, :, 2 * i + j]
                .astype(np.float32))
    coords = {
        'n_trk': np.arange(out['lon'].shape[0], dtype=np.int32),
        'time': ts_output,
        'year': np.unique(out['year']).astype(np.int32),
        'month': np.arange(1, 13, dtype=np.int32),
    }
    # classic NetCDF coordinates must be numeric: basin is a data variable
    data_vars['basin'] = (('basin',), np.array(basin_ids, dtype='U2'))
    netcdf.write(path, data_vars, coords=coords,
                 attrs={'source': 'tropical_cyclone_risk_tpu'},
                 var_attrs={'time': {'units': 'seconds since genesis'}})


def run_downscaling(cfg: Namelist, basin_id: str, pack: FieldPack,
                    seed: Optional[int] = None,
                    n_years: Optional[int] = None,
                    device=None, key: Optional[rng.Key] = None,
                    trace_dir: Optional[str] = None) -> str:
    """Simulate every configured year on ``device`` (default: the pack's)
    and write the tracks file (util/compute.py:216-270).  Returns the
    written path.  ``seed`` draws the same streams as the JAX package's
    ``key=jax.random.key(seed)``; ``key`` (an ``rng.Key``, e.g.
    ``rng.fold_in(rng.key(s), e)`` per ensemble member) those of the same
    JAX key; with neither, a seed is taken from the clock.  ``trace_dir``
    writes a torch.profiler trace of the simulation there."""
    basin_id = basins_mod.validate_basin_id(cfg, basin_id)
    if device is not None and pack.device != torch.device(device):
        pack = FieldPack(*(x.to(device) if isinstance(x, torch.Tensor)
                           else x for x in pack))
    if key is not None and seed is not None:
        raise ValueError('pass seed or key, not both')
    if key is None:
        if seed is None:
            seed = int(time.time_ns() % (2 ** 31))
        key = rng.key(seed)
    if n_years is not None and n_years < 1:
        raise ValueError(f'n_years must be >= 1, got {n_years}')
    years = cfg.years()[:n_years] if n_years is not None else cfg.years()
    if years and cfg.integrate_cap is None:
        cfg = pipeline.auto_integrate_cap(rng.fold_in(key, years[0]), pack,
                                          cfg, basin_id)
        obs.log.info('integrate_cap auto-tuned to %.4f (scan width %d of '
                     '%d seeds); recompact schedule %s', cfg.integrate_cap,
                     pipeline.launch_width(cfg, cfg.seed_batch),
                     cfg.seed_batch, cfg.recompact_schedule)
    t0 = time.time()
    metrics = obs.Metrics()
    results = []
    adapt = {'cfg': cfg}     # cap-overflow re-tuning persists across years
    with obs.maybe_profile(trace_dir):
        for yi, year in enumerate(years):
            with obs.phase(f'year {year}', metrics):
                results.append(pipeline.run_tracks_year(
                    rng.fold_in(key, year), pack, cfg, basin_id, yi,
                    adapt=adapt))
            metrics.count('tracks', results[-1].lon.shape[0])
            metrics.count('seeds', float(results[-1].n_seeds.sum()))
            metrics.count('seeds_dropped', results[-1].n_dropped)
            metrics.count('seeds_proposed', results[-1].n_proposed)
            metrics.time('simulate', metrics.timings.pop(f'year {year}'))
    obs.log.info('throughput: %.0f seeds/s, %.2f tracks/s',
                 metrics.rate('seeds', 'simulate'),
                 metrics.rate('tracks', 'simulate'))
    n_prop = metrics.counters.get('seeds_proposed', 0.0)
    n_drop = metrics.counters.get('seeds_dropped', 0.0)
    if n_prop and n_drop / n_prop > 1e-3:
        obs.log.warning(
            'seeding drop rate %.2e (%d of %d slots exhausted all %d retry '
            'rounds)', n_drop / n_prop, int(n_drop), int(n_prop),
            seeding.N_RETRY_ROUNDS)
    out = pipeline.concat_years(results, cfg)

    os.makedirs('%s/%s' % (cfg.output_directory, cfg.exp_name), exist_ok=True)
    fn = fn_tracks_duplicates(get_fn_tracks(cfg, basin_id))
    write_tracks_nc(fn, out, cfg)
    # provenance snapshot (the reference copies namelist.py, run.py:12)
    with open(fn[:-3] + '.config.json', 'w') as f:
        json.dump({k: v for k, v in cfg.__dict__.items()
                   if isinstance(v, (int, float, str, bool, tuple, list))},
                  f, indent=1, default=str)
    obs.log.info('Saved %s (%.1f s)', fn, time.time() - t0)
    return fn
