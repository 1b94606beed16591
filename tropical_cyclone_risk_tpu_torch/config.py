"""Run configuration (copy of tropical_cyclone_risk_tpu/config.py):
``Namelist`` and ``load_namelist_py`` with the same fields and defaults.

The typed, immutable equivalent of the reference's ``namelist.py``
(reference: namelist.py:9-119).  Field names and semantics match the
reference one-to-one so existing namelists port directly; the reference's
``f_mInit`` lambda (namelist.py:94) is replaced by the fixed sigmoid
parameters ``m_init_*``.  Per-basin dictionaries are exposed both as dicts
and as index-aligned tuples over ``basin_ids_sorted()``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

# Basin bounds use the reference's string format '<deg><E|W|N|S>'
# (reference: namelist.py:112-119).
DEFAULT_BASIN_BOUNDS: Dict[str, Tuple[str, str, str, str]] = {
    'EP': ('180E', '0N', '290E', '60N'),
    'NA': ('260E', '0N', '360E', '60N'),
    'NI': ('30E', '0N', '100E', '50N'),
    'SI': ('20E', '45S', '100E', '0S'),
    'AU': ('100E', '45S', '180E', '0S'),
    'SP': ('180E', '45S', '250E', '0S'),
    'WP': ('100E', '0N', '180E', '60N'),
    'GL': ('0E', '90S', '360E', '90N'),
}

# Variable-name mapping per dataset type (reference: namelist.py:26-31).
DEFAULT_VAR_KEYS: Dict[str, Dict[str, str]] = {
    'ERA5': {'sst': 'sst', 'mslp': 'sp', 'temp': 't', 'sp_hum': 'q',
             'u': 'u', 'v': 'v', 'w': 'w', 'lvl': 'level',
             'lon': 'longitude', 'lat': 'latitude'},
    'GCM': {'sst': 'tos', 'mslp': 'psl', 'temp': 'ta', 'sp_hum': 'hus',
            'u': 'ua', 'v': 'va', 'w': 'wap', 'lvl': 'plev',
            'lon': 'lon', 'lat': 'lat'},
}


def _freeze(d: Mapping) -> Tuple:
    """Dict -> sorted tuple of items, so the dataclass stays hashable."""
    return tuple(sorted(d.items()))


def _thaw(t: Tuple) -> Dict:
    return dict(t)


@dataclasses.dataclass(frozen=True)
class Namelist:
    # ---- file system (reference: namelist.py:9-17) ----
    base_directory: str = 'data/era5'
    output_directory: str = 'data/era5'
    exp_name: str = 'test'
    dataset_type: str = 'ERA5'            # 'ERA5' or 'GCM'
    exp_prefix: str = 'era5'

    # ---- parallelism (reference: namelist.py:34) ----
    n_procs: int = 16                     # host-side IO parallelism only

    # ---- dates (reference: namelist.py:40-43) ----
    start_year: int = 2016
    start_month: int = 1
    end_year: int = 2021
    end_month: int = 12

    # ---- output (reference: namelist.py:48-50) ----
    output_interval_s: int = 3600
    total_track_time_days: int = 15
    tracks_per_year: int = 20

    # ---- thermodynamics (reference: namelist.py:55-60) ----
    p_midlevel: float = 60000.0           # Pa
    PI_reduc: float = 0.80
    Ck: float = 1.2e-3
    Cd: float = 1.2e-3
    select_thermo: int = 1                # 1 pseudoadiabatic, 2 reversible
    select_interp: int = 2                # 1 optimization, 2 table lookup

    # ---- track / intensity (reference: namelist.py:70-94) ----
    steering_levels: Tuple[int, ...] = (250, 850)
    steering_coefs: Tuple[float, ...] = (0.2, 0.8)
    coupled_track: bool = True
    y_alpha: Tuple[float, ...] = (0.17, 0.83)
    m_alpha: Tuple[float, ...] = (0.0025, -0.0025)
    alpha_max: Tuple[float, ...] = (0.41, 0.78)
    alpha_min: Tuple[float, ...] = (0.22, 0.59)
    u_beta: float = -1.0                  # zonal beta drift, m/s
    v_beta: float = 2.5                   # meridional beta drift, m/s
    T_days: float = 20.0                  # Fourier series period, days
    seed_v_init_ms: float = 5.0
    seed_v_2d_threshold_ms: float = 6.5
    seed_v_threshold_ms: float = 15.0
    seed_vmax_threshold_ms: float = 18.0
    atm_bl_depth: Tuple = _freeze({'NA': 1400.0, 'EP': 1400.0, 'WP': 1800.0,
                                   'AU': 1800.0, 'SI': 1600.0, 'SP': 2000.0,
                                   'NI': 1500.0})
    log_chi_fac: float = 0.5
    chi_fac: float = 1.3
    lat_vort_fac: float = 2.0
    lat_vort_power: Tuple = _freeze({'NA': 6.0, 'EP': 6.0, 'WP': 3.5,
                                     'AU': 6.0, 'SI': 3.0, 'SP': 7.0,
                                     'NI': 2.5})
    # m_init = m_init_amp / (1 + exp(-(rh - m_init_mid) * m_init_slope)) + m_init_base
    # (replaces the reference's f_mInit lambda, namelist.py:94)
    m_init_amp: float = 0.20
    m_init_mid: float = 0.55
    m_init_slope: float = 10.0
    m_init_base: float = 0.125

    # ---- basins (reference: namelist.py:112-119) ----
    basin_bounds: Tuple = _freeze(DEFAULT_BASIN_BOUNDS)
    var_keys_frozen: Tuple = _freeze({k: _freeze(v)
                                      for k, v in DEFAULT_VAR_KEYS.items()})

    # ---- static data files (reference paths: intensity/geo.py:9-34,
    # intensity/ocean.py:11-64, scripts/generate_land_masks.py) ----
    fn_land: str = 'intensity/data/land.nc'
    fn_bathy: str = 'intensity/data/bathymetry.nc'
    fn_mld: str = 'intensity/data/mld_climatology.nc'
    fn_strat: str = 'intensity/data/strat_climatology.nc'
    mask_dir: str = 'land'

    # ---- run-time knobs of the downscaling launch (no reference
    # equivalent; semantics as in the JAX package's config.py) ----
    seed_batch: int = 8192            # seeds proposed per device launch
    # fraction of a seed batch carried through the 361-step integration;
    # None: auto-tuned at run start (pipeline.auto_integrate_cap)
    integrate_cap: Optional[float] = None
    # mid-track re-compaction of the still-alive storms: one boundary
    # (recompact_step, recompact_cap) or ascending (step, cap) pairs, each
    # cap a fraction of the initial integration width; auto-tuned with
    # integrate_cap when that is None
    recompact_step: Optional[int] = None
    recompact_cap: Optional[float] = None
    recompact_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    # per-retry-round seeding gather widths (fractions of the batch);
    # None: full width every round
    seed_retry_caps: Optional[Tuple[float, ...]] = None
    # speculative quota prefix: integrate only as many integrable slots as
    # the measured survivor rate says the year's quota needs (identical
    # outputs; a miss relaunches at full width with the same key)
    quota_prefix: bool = True
    survivors_per_slot: Optional[float] = None
    integrate_width: Optional[int] = None
    rk_substeps: int = 1              # RK4 substeps per output interval
    scan_unroll: int = 1              # read by the JAX package only
    sim_dtype: str = 'float32'
    # interpolate monthly field planes in track time (off: the reference
    # freezes the seed month's plane)
    time_interp_fields: bool = False
    # re-gather fields at every RK stage instead of once per output step
    rk_exact_stage_fields: bool = False
    # gather fields once per S output steps (the integrator's stride)
    field_sample_stride: int = 3
    # vmax diagnostic inside the integration instead of the post-pass
    vmax_in_scan: bool = False
    # years fused into one device program (the port runs the per-year loop)
    years_per_program: int = 2
    # freeze storm positions (the reference's Coupled_FAST.debug flag)
    debug_fixed_position: bool = False
    # seed moisture initialization: 'rh' (the RH sigmoid) or 'dvdt0'
    m_init_mode: str = 'rh'

    # -------------------- derived helpers --------------------
    @property
    def var_keys(self) -> Dict[str, Dict[str, str]]:
        return {k: _thaw(v) for k, v in self.var_keys_frozen}

    @property
    def basin_bounds_dict(self) -> Dict[str, Tuple[str, str, str, str]]:
        return _thaw(self.basin_bounds)

    @property
    def atm_bl_depth_dict(self) -> Dict[str, float]:
        return _thaw(self.atm_bl_depth)

    @property
    def lat_vort_power_dict(self) -> Dict[str, float]:
        return _thaw(self.lat_vort_power)

    @property
    def n_steering_levels(self) -> int:
        return len(self.steering_levels)

    @property
    def n_wind_levels(self) -> int:
        """Number of wind components (u,v per steering level)."""
        return 2 * len(self.steering_levels)

    @property
    def total_track_time_s(self) -> int:
        return self.total_track_time_days * 24 * 60 * 60

    @property
    def n_steps_output(self) -> int:
        """Number of output samples per track, incl. t=0
        (reference: track/bam_track.py:54-55)."""
        return int(self.total_track_time_s / self.output_interval_s) + 1

    @property
    def T_fourier_s(self) -> float:
        return self.T_days * 24 * 60 * 60

    @property
    def n_months(self) -> int:
        return ((self.end_year - self.start_year) * 12
                + (self.end_month - self.start_month) + 1)

    def basin_ids_sorted(self) -> Tuple[str, ...]:
        """Sorted non-global basin IDs; index order used for all per-basin
        arrays and for ``seeds_per_month`` (reference: util/compute.py:87)."""
        return tuple(sorted(k for k, _ in self.basin_bounds if k != 'GL'))

    def h_bl_by_basin(self) -> Tuple[float, ...]:
        d = self.atm_bl_depth_dict
        return tuple(float(d[b]) for b in self.basin_ids_sorted())

    def lat_vort_power_by_basin(self) -> Tuple[float, ...]:
        d = self.lat_vort_power_dict
        return tuple(float(d[b]) for b in self.basin_ids_sorted())

    def years(self) -> Tuple[int, ...]:
        return tuple(range(self.start_year, self.end_year + 1))

    def replace(self, **kw) -> 'Namelist':
        if 'basin_bounds' in kw and isinstance(kw['basin_bounds'], dict):
            kw['basin_bounds'] = _freeze(kw['basin_bounds'])
        if 'atm_bl_depth' in kw and isinstance(kw['atm_bl_depth'], dict):
            kw['atm_bl_depth'] = _freeze(kw['atm_bl_depth'])
        if 'lat_vort_power' in kw and isinstance(kw['lat_vort_power'], dict):
            kw['lat_vort_power'] = _freeze(kw['lat_vort_power'])
        for key in ('steering_levels', 'steering_coefs', 'y_alpha', 'm_alpha',
                    'alpha_max', 'alpha_min'):
            if key in kw and isinstance(kw[key], list):
                kw[key] = tuple(kw[key])
        return dataclasses.replace(self, **kw)


def load_namelist_py(path: str) -> Namelist:
    """Load a reference-style ``namelist.py`` and map it onto :class:`Namelist`.

    Allows users of the reference to reuse their configuration files verbatim
    (reference: namelist.py is a plain Python module).
    """
    ns: Dict = {}
    with open(path) as f:
        src = f.read()
    exec(compile(src, path, 'exec'), {'os': os, 'np': __import__('numpy'),
                                      'numpy': __import__('numpy'),
                                      '__file__': path}, ns)
    fields = {f.name for f in dataclasses.fields(Namelist)}
    kw = {}
    for k, v in ns.items():
        if k in fields:
            kw[k] = v
    if 'f_mInit' in ns:
        import warnings
        warnings.warn(
            'namelist defines f_mInit (a lambda); this framework uses the '
            'fixed sigmoid m_init_amp/(1+exp(-(rh-m_init_mid)*m_init_slope))'
            '+m_init_base instead — set those fields to match your lambda '
            '(defaults replicate the reference, namelist.py:94)',
            stacklevel=2)
    if 'basin_bounds' in ns:
        kw['basin_bounds'] = _freeze({k: tuple(v)
                                      for k, v in ns['basin_bounds'].items()})
    if 'var_keys' in ns:
        kw['var_keys_frozen'] = _freeze({k: _freeze(v)
                                         for k, v in ns['var_keys'].items()})
    return Namelist().replace(**kw)
