"""The system under test, as the benchmark drives it: the PyTorch port's
production year driver (``pipeline.run_tracks_years_fused``, what
``runtime.run_downscaling`` runs for each ensemble member), without the
NetCDF write.  This is the only module of the benchmark that imports the
port, and it imports it inside its functions.
"""

from __future__ import annotations

import contextlib

import torch


def namelist(cfg: dict, traffic: dict):
    """The port's Namelist of a configuration file and a traffic mix."""
    from tropical_cyclone_risk_tpu_torch.config import Namelist
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg['namelist'].items()}
    kw['basin_bounds'] = {k: tuple(v) for k, v in cfg['basin_bounds'].items()}
    kw.update(tracks_per_year=int(traffic['tracks_per_year']),
              seed_batch=int(traffic['seed_batch']),
              start_year=int(traffic['start_year']),
              end_year=int(traffic['end_year']), end_month=12)
    return Namelist().replace(**kw)


def field_pack(pk: dict):
    """The port's FieldPack over the benchmark's environment tensors (no
    copy): every field on the atmospheric grid."""
    from tropical_cyclone_risk_tpu_torch.models.fields import FieldPack
    from tropical_cyclone_risk_tpu_torch.ops.interp import UniformGrid
    g = UniformGrid(*pk['grid'])
    return FieldPack(grid=g, wind=pk['wind'], env=pk['env'], land_grid=g,
                     land=pk['land'], bathy_grid=g, bathy=pk['bathy'],
                     mask_grid=g, basin_masks=pk['basin_masks'],
                     run_mask=pk['run_mask'])


class Ensemble:
    """One closed-loop client: ensemble members run one after another, the
    compaction caps tuned once at the start and carried across members,
    as run_downscaling carries them across years."""

    def __init__(self, cfg: dict, traffic: dict, pk: dict, base_key):
        from tropical_cyclone_risk_tpu_torch import rng
        self.rng = rng
        self.basin = cfg['basin']
        self.nl = namelist(cfg, traffic)
        self.pack = field_pack(pk)
        self.base = rng.Key(*base_key)
        self.years = list(self.nl.years())
        self.adapt = None

    def member_key(self, member: int):
        return self.rng.fold_in(self.base, member)

    def tune(self, key):
        """pipeline.auto_integrate_cap from `key` (k0, k1), as
        run_downscaling tunes the caps at the start of a run."""
        from tropical_cyclone_risk_tpu_torch.models import pipeline
        k = self.rng.fold_in(self.rng.Key(*key), self.years[0])
        nl = pipeline.auto_integrate_cap(k, self.pack, self.nl, self.basin)
        self.adapt = {'cfg': nl}

    def run_member(self, member: int) -> list:
        """One member's years (pipeline.YearTracks, on the host)."""
        from tropical_cyclone_risk_tpu_torch.models import pipeline
        return pipeline.run_tracks_years_fused(
            self.member_key(member), self.pack, self.adapt['cfg'],
            self.basin, self.years, adapt=self.adapt)

    def tuned(self) -> dict:
        c = self.adapt['cfg']
        return {'integrate_cap': c.integrate_cap,
                'recompact_schedule': c.recompact_schedule,
                'survivors_per_slot': c.survivors_per_slot,
                'seed_retry_caps': c.seed_retry_caps}


def launch_counts() -> dict:
    from tropical_cyclone_risk_tpu_torch import kernels
    return dict(kernels.LAUNCHES)


@contextlib.contextmanager
def spans():
    """Profiler ranges around the launch (pipeline._simulate_batch) and
    the field stacks (fields.build_stacks), by wrapping the module
    attributes the year driver calls through; restored on exit."""
    from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
    saved = [(pipeline, '_simulate_batch'), (fields, 'build_stacks')]
    names = {'_simulate_batch': 'tcbench.launch',
             'build_stacks': 'tcbench.build_stacks'}
    originals = [getattr(mod, att) for mod, att in saved]

    def wrap(fn, name):
        def inner(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return inner

    try:
        for (mod, att), fn in zip(saved, originals):
            setattr(mod, att, wrap(fn, names[att]))
        yield
    finally:
        for (mod, att), fn in zip(saved, originals):
            setattr(mod, att, fn)


def year_fields(y) -> dict:
    """The delivered fields of a YearTracks."""
    return {k: getattr(y, k) for k in ('lon', 'lat', 'v', 'm', 'vmax',
                                       'wnds', 'month', 'basin_idx')}
