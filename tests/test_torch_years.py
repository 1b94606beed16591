"""The port's production year drivers: the fused multi-year driver
(run_tracks_years_fused) against the port's per-year loop, run_downscaling
through both routes, and the fused driver against the JAX package's.
Small size: synthetic 91x180 packs, 2048 seeds per launch, 2-3 years.

Tolerances, with their reasons:
- the fused driver and the per-year loop (with or without a prefetched
  batch 0) issue the same launches with the same keys and caps on the same
  planes, so every YearTracks field is equal bit for bit (NaN where NaN),
  in the steady state, the fallback and the short circuit;
- run_downscaling with years_per_program 2 and 1: every variable of the
  two tracks files equal bit for bit;
- the host arrays: a settled fused year's are views of its group's
  transfer, a fallback year takes its group's read as batch 0 (no second
  transfer), and a year of two batches owns exactly its quota's rows,
  equal bit for bit to each batch's taken rows concatenated;
- the port's fused driver against the JAX package's from the same seed,
  at two levels and at the benchmark's deep layer (17 levels, uncoupled;
  46x90, 256 seeds, five-day tracks): seeds_per_month, months, basins,
  track counts, n_dropped and n_proposed equal; tracks within
  tests/test_torch_pipeline.py's TRACK_TOL (XLA on the CPU contracts
  multiply-adds and rounds transcendentals otherwise than torch; found
  ~2e-5 deg, ~2e-4 m/s in vmax; at 17 levels ~4e-6 deg, ~1e-4 m/s).
"""

import jax
import numpy as np
import pytest

from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import pipeline as jpipeline
from tropical_cyclone_risk_tpu.ops import chol as jchol
from tropical_cyclone_risk_tpu_torch import rng, runtime
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
from test_torch_deep_layer import NL as NL17, STEERING, cholesky_rolled
from test_torch_pipeline import TRACK_KEYS, TRACK_TOL

SEG = dict(integrate_cap=0.375, recompact_schedule=((90, 0.75), (180, 0.5)))
YEAR_KEYS = pipeline.YEAR_FIELDS + ('n_seeds',)


def _pack(cfg, n_planes):
    return fields.synthetic_pack(cfg, n_planes, 91, 180, seed=0,
                                 device='cpu')


def _loop(key, pack, cfg, years):
    return [pipeline.run_tracks_year(rng.fold_in(key, yr), pack, cfg, 'GL',
                                     yi) for yi, yr in enumerate(years)]


def _assert_years_equal(ref, got):
    assert len(ref) == len(got)
    for r, f in zip(ref, got):
        for k in YEAR_KEYS:
            a, b = getattr(r, k), getattr(f, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert (r.n_dropped, r.n_proposed) == (f.n_dropped, f.n_proposed)


def _count_calls(monkeypatch, name):
    calls = []
    orig = getattr(pipeline, name)
    monkeypatch.setattr(pipeline, name,
                        lambda *a, **k: (calls.append(k), orig(*a, **k))[1])
    return calls


@pytest.mark.parametrize('mode', ['tuned', 'quota'])
def test_fused_years_equal_loop(monkeypatch, mode):
    """Steady state: every year settles on the fused path (no call of
    run_tracks_year) and equals the per-year loop, including year 1 whose
    months 7-12 lie outside the 18-plane pack (clamped planes, vpot
    zeroed).  'quota': the speculative quota prefix, settled by
    scalars[4]."""
    cfg = Namelist(seed_batch=2048, end_year=2017, end_month=6,
                   tracks_per_year=5).replace(**SEG)
    if mode == 'quota':
        cfg = cfg.replace(survivors_per_slot=0.1)
        assert pipeline.quota_cfg(cfg, 5, 2048) is not None
    pack = _pack(cfg, 18)
    key = rng.key(42)
    years = list(cfg.years())
    ref = _loop(key, pack, cfg, years)
    calls = _count_calls(monkeypatch, 'run_tracks_year')
    fused = pipeline.run_tracks_years_fused(key, pack, cfg, 'GL', years,
                                            k_fuse=2)
    assert not calls, 'steady-state years must settle on the fused path'
    _assert_years_equal(ref, fused)


def test_fused_years_fallback_equal_loop(monkeypatch):
    """Batch 0 overflows its compaction cap in every year: each year
    finishes on run_tracks_year with the fused launch as its batch 0, and
    the results still equal the plain per-year loop's."""
    cfg = Namelist(seed_batch=2048, end_year=2017, tracks_per_year=4
                   ).replace(integrate_cap=1.0 / 16.0)
    pack = _pack(cfg, 24)
    key = rng.key(7)
    years = list(cfg.years())
    ref = _loop(key, pack, cfg, years)
    calls = _count_calls(monkeypatch, 'run_tracks_year')
    fused = pipeline.run_tracks_years_fused(key, pack, cfg, 'GL', years,
                                            k_fuse=2)
    assert len(calls) == len(years)
    assert all(k.get('first_batch') is not None for k in calls)
    _assert_years_equal(ref, fused)


def test_fused_years_short_circuit(monkeypatch):
    """A launch holds fewer track rows than the quota (launch_width <
    n_tracks): no fused group is issued; every year runs on the per-year
    loop with a prefetched batch 0."""
    cfg = Namelist(seed_batch=256, tracks_per_year=300, end_year=2017)
    pack = _pack(cfg, 24)

    def boom(*a, **k):
        raise AssertionError('fused group issued')

    monkeypatch.setattr(pipeline, '_simulate_years', boom)
    prefetched = []
    monkeypatch.setattr(pipeline, 'prefetch_year_batch0',
                        lambda *a, **k: (prefetched.append(a[4]),
                                         ('batch', a[4]))[1])
    sentinel = object()
    seen = []
    monkeypatch.setattr(pipeline, 'run_tracks_year',
                        lambda *a, **k: (seen.append(k), sentinel)[1])
    out = pipeline.run_tracks_years_fused(rng.key(1), pack, cfg, 'GL',
                                          list(cfg.years()), k_fuse=2)
    assert out == [sentinel, sentinel]
    assert prefetched == [0, 1]
    assert [k['first_batch'] for k in seen] == [('batch', 0), ('batch', 1)]


def test_prefetched_batch0_settles_without_slicing(monkeypatch):
    """run_tracks_year given its prefetched batch 0 equals the year run
    alone, and a year that batch settles gathers no planes of its own."""
    cfg = Namelist(seed_batch=2048, end_year=2016, tracks_per_year=5
                   ).replace(**SEG)
    pack = _pack(cfg, 12)
    ykey = rng.fold_in(rng.key(3), 2016)
    ref = pipeline.run_tracks_year(ykey, pack, cfg, 'GL', 0)
    first = pipeline.prefetch_year_batch0(ykey, pack, cfg, 'GL', 0)
    sliced = []
    orig = fields.slice_pack_year
    monkeypatch.setattr(fields, 'slice_pack_year',
                        lambda *a: (sliced.append(a[2]), orig(*a))[1])
    got = pipeline.run_tracks_year(ykey, pack, cfg, 'GL', 0,
                                   first_batch=first)
    assert not sliced
    _assert_years_equal([ref], [got])


@pytest.fixture(scope='module')
def multi_batch_run():
    """The fused driver where no batch 0 fills the quota (60 tracks from
    2048 seeds, as the ablation quota): each year falls back on
    run_tracks_year and finishes on a second batch.  Returns the
    namelist, the years, the Transfers built, the number of launches
    dispatched, and each batch's read in order (the decisions, the host
    rows and a copy of them taken as read)."""
    cfg = Namelist(seed_batch=2048, end_year=2017, tracks_per_year=60
                   ).replace(**SEG)
    pack = _pack(cfg, 24)
    made, dispatched, reads = [], [], []

    class Recorded(pipeline.Transfer):
        def __init__(self, tensors):
            super().__init__(tensors)
            made.append(self)

    read, dispatch = pipeline._read, pipeline._dispatch_batch

    def recorded_read(batch):
        dec, host = read(batch)
        reads.append((dec, host, {k: v.copy() for k, v in host.items()}))
        return dec, host

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, 'Transfer', Recorded)
        mp.setattr(pipeline, '_read', recorded_read)
        mp.setattr(pipeline, '_dispatch_batch',
                   lambda *a: (dispatched.append(a[0]), dispatch(*a))[1])
        out = pipeline.run_tracks_years_fused(rng.key(5), pack, cfg, 'GL',
                                              list(cfg.years()), k_fuse=2)
    return cfg, out, made, len(dispatched), reads


def test_fused_fallback_transfers_batch0_once(multi_batch_run):
    """A fallback year takes its fused batch 0 with the group's read: one
    Transfer for the group and one per later batch, none re-issuing a
    fused batch 0."""
    cfg, out, made, n_dispatched, reads = multi_batch_run
    n_years = len(out)
    assert n_dispatched == 2 * n_years      # batch 0 and batch 1 a year
    assert len(reads) == 2 * n_years
    assert len(made) == 1 + n_dispatched - n_years


def test_multi_batch_year_owns_its_rows(multi_batch_run):
    """A year of two batches returns arrays of exactly n_tracks rows that
    it owns, equal bit for bit to the concatenation of each batch's
    taken rows (the stopping rule's take, no batch overflowing here)."""
    cfg, out, made, _, reads = multi_batch_run
    q = cfg.tracks_per_year
    k_max = min(q, pipeline.launch_width(cfg, cfg.seed_batch))
    it = iter(reads)
    for y in out:
        parts, got = [], 0
        while got < q:
            dec, host, copied = next(it)
            assert dec[0][1:3] == [0, 0]
            take = min(dec[0][0], q - got, k_max, host['lon'].shape[0])
            parts.append({k: v[:take] for k, v in copied.items()})
            got += take
        assert len(parts) == 2
        for k in pipeline.YEAR_FIELDS:
            a = getattr(y, k)
            ref = np.concatenate([p[k] for p in parts])
            assert a.shape[0] == q and a.base is None, k
            assert a.dtype == ref.dtype, k
            np.testing.assert_array_equal(a, ref, err_msg=k)
            assert not any(np.shares_memory(a, r[1][k]) for r in reads)


def test_settled_years_view_the_group_transfer(monkeypatch):
    """A settled fused year's tracks are writeable views of its group's
    transfer buffer (no host copy), and keep their values through a later
    run of the driver."""
    cfg = Namelist(seed_batch=2048, end_year=2017, end_month=6,
                   tracks_per_year=5).replace(**SEG)
    pack = _pack(cfg, 18)
    years = list(cfg.years())
    made = []

    class Recorded(pipeline.Transfer):
        def __init__(self, tensors):
            super().__init__(tensors)
            made.append(self)

    monkeypatch.setattr(pipeline, 'Transfer', Recorded)
    out = pipeline.run_tracks_years_fused(rng.key(42), pack, cfg, 'GL',
                                          years, k_fuse=2)
    assert len(made) == 1
    buf = made[0]._host.numpy()
    kept = []
    for y in out:
        for k in pipeline.YEAR_FIELDS:
            a = getattr(y, k)
            assert np.shares_memory(a, buf) and a.flags.writeable, k
        kept.append({k: getattr(y, k).copy() for k in YEAR_KEYS})
    again = pipeline.run_tracks_years_fused(rng.key(43), pack, cfg, 'GL',
                                            years, k_fuse=2)
    assert len(made) == 2
    assert not np.shares_memory(again[0].lon, out[0].lon)
    for y, ref in zip(out, kept):
        for k in YEAR_KEYS:
            np.testing.assert_array_equal(getattr(y, k), ref[k], err_msg=k)


def test_run_downscaling_fused_equals_per_year(tmp_path, monkeypatch):
    """run_downscaling takes the fused route at years_per_program=2 (three
    years: one group of two and a tail of one) and the per-year loop at 1;
    the two tracks files are equal bit for bit."""
    base = Namelist(seed_batch=2048, end_year=2018, tracks_per_year=3,
                    output_directory=str(tmp_path)).replace(**SEG)
    pack = _pack(base, 36)
    groups = _count_calls(monkeypatch, 'run_tracks_years_fused')
    fn_f = runtime.run_downscaling(
        base.replace(years_per_program=2, exp_name='fused'), 'GL', pack,
        seed=11)
    fn_p = runtime.run_downscaling(
        base.replace(years_per_program=1, exp_name='plain'), 'GL', pack,
        seed=11)
    assert len(groups) == 1
    df, dp = netcdf.read(fn_f), netcdf.read(fn_p)
    assert set(df.variables) == set(dp.variables)
    for k, v in dp.variables.items():
        np.testing.assert_array_equal(df.variables[k].data, v.data,
                                      err_msg=k)
    assert df.variables['lon_trks'].data.shape[0] == 3 * 3


# case -> (namelist fields, pack planes, latitudes, longitudes): the
# default two levels, compacted in three segments; the deep-layer
# configuration of the benchmark (tcbench/configs/era5_gl_dlm17.json: 17
# levels, weights constant in intensity), one uncapped segment, five-day
# tracks, with the JAX package's Cholesky rolled (cholesky_rolled)
JAX_CASES = {
    'L2': (dict(seed_batch=2048, end_year=2017, tracks_per_year=4,
                integrate_cap=0.5, recompact_schedule=((90, 0.375),
                                                       (180, 0.25))),
           24, 91, 180),
    'L17-uncoupled': (dict(seed_batch=256, end_year=2017, tracks_per_year=3,
                           integrate_cap=1.0, total_track_time_days=5,
                           **{k: tuple(NL17[k]) for k in STEERING},
                           coupled_track=False),
                      24, 46, 90),
}


@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_fused_years_match_jax(case, monkeypatch):
    """The port's fused driver against the JAX package's from the same
    seed (module docstring's tolerances)."""
    kw, n_planes, nlat, nlon = JAX_CASES[case]
    if case.startswith('L17'):
        monkeypatch.setattr(jchol, 'cholesky_unrolled', cholesky_rolled)
    cfg, jcfg = Namelist(**kw), JNamelist(**kw)
    jpack = jfields.synthetic_pack(jcfg, n_planes, nlat, nlon, seed=0)
    pack = fields.pack_from_numpy(jpack, device='cpu')
    years = list(cfg.years())
    ours = pipeline.run_tracks_years_fused(rng.key(3), pack, cfg, 'GL',
                                           years, k_fuse=2)
    theirs = jpipeline.run_tracks_years_fused(jax.random.key(3), jpack, jcfg,
                                              'GL', years, k_fuse=2)
    assert len(ours) == len(theirs) == 2
    for t, j in zip(ours, theirs):
        np.testing.assert_array_equal(t.n_seeds, j.n_seeds)
        for k in ('month', 'basin_idx'):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        assert (t.n_dropped, t.n_proposed) == (j.n_dropped, j.n_proposed)
        assert t.lon.shape == j.lon.shape == (cfg.tracks_per_year,
                                              cfg.n_steps_output)
        for k in TRACK_KEYS:
            a, b = getattr(t, k), np.asarray(getattr(j, k))
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                          err_msg=k)
            fin = np.isfinite(a)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                       atol=TRACK_TOL[k], err_msg=k)
