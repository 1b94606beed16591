"""The port's launch and year loop against the JAX package's, and the
port's integrate compaction against its own uncapped launch.  Small size:
synthetic 91x180 pack, 2048 seeds per launch.

Tolerances, with their reasons:
- (a) one multi-segment launch, port vs JAX: the survivor verdicts (keep)
  must agree on >= 99.5% of slots (a rounding-level difference can flip a
  borderline storm; all 2048 agree at this seed) and scalars/spm_all are
  equal when the verdicts are; matched survivor tracks within 1e-3 deg in
  lon/lat, 1e-2 m/s in v, vmax and winds and 1e-3 in m over 361 steps
  (found: ~2e-5 deg, ~4e-4 m/s in vmax): XLA on the CPU contracts
  multiply-adds and rounds transcendentals differently from torch, and
  361 RK4 steps grow those seeds;
- (b) the port's compacted, segmented launch equals its uncapped launch
  bit for bit, as test_integrate_compaction_bit_identical pins for JAX;
- (c) run_downscaling for one year from the same seed in both packages:
  the same variables, dims and dtypes, the same seeds_per_month and the
  same track count;
- (d) m_init_mode='dvdt0' launches: as (a);
- (e) launch_inputs, which draws the Fourier flow at the integrate
  compaction's rows alone, against the JAX package's full-width draw
  gathered at its order: the compacted proposal rows bit-exact, A and B
  within 1e-6 (tests/test_torch_ops.py's Fourier tolerance: torch's and
  XLA's float32 cos and sin round apart by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tropical_cyclone_risk_tpu import runtime as jruntime
from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.io import netcdf
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import pipeline as jpipeline
from tropical_cyclone_risk_tpu.models import seeding as jseeding
from tropical_cyclone_risk_tpu.ops import compact as jcompact
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu_torch import rng, runtime
from tropical_cyclone_risk_tpu_torch.models import fields, pipeline

CFG = Namelist(seed_batch=2048)
SEG = dict(integrate_cap=0.5, recompact_schedule=((90, 0.375), (180, 0.25)))
TRACK_KEYS = ('lon', 'lat', 'v', 'm', 'vmax', 'wnds')
TRACK_TOL = {'lon': 1e-3, 'lat': 1e-3, 'v': 1e-2, 'm': 1e-3, 'vmax': 1e-2,
             'wnds': 1e-2}


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(CFG, 12, 91, 180, seed=0)
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope='module')
def port_segmented(packs):
    cfg = CFG.replace(**SEG)
    m = pipeline.launch_width(cfg, CFG.seed_batch)
    assert len(pipeline.seg_schedule(cfg, m)) == 2     # three segments
    tr, meta = pipeline._simulate_batch(rng.key(5), packs[1], cfg, 'GL',
                                        CFG.seed_batch, 256, 0)
    return _np(tr), _np(meta)


def _assert_launches_match(port, jax_out):
    """Tolerance (a) between the port's launch and the JAX package's."""
    (tt, mt), (tj, mj) = port, jax_out
    assert (mt['keep'] == mj['keep']).mean() >= 0.995
    np.testing.assert_array_equal(mt['counted'], mj['counted'])
    if (mt['keep'] == mj['keep']).all():
        np.testing.assert_array_equal(mt['scalars'], mj['scalars'])
        np.testing.assert_array_equal(mt['spm_all'], mj['spm_all'])
        np.testing.assert_array_equal(mt['spm_upto'], mj['spm_upto'])
    both = mt['keep'] & mj['keep']
    assert both.sum() > 20
    rt = (np.cumsum(mt['keep']) - 1)[both]
    rj = (np.cumsum(mj['keep']) - 1)[both]
    for k in TRACK_KEYS:
        a, b = tt[k][rt], tj[k][rj]
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=TRACK_TOL[k], err_msg=k)
    for k in ('month', 'basin_idx'):
        np.testing.assert_array_equal(tt[k][rt], tj[k][rj], err_msg=k)


def _jax_launch(packs, cfg, seed):
    return tuple(map(_np, jpipeline._simulate_batch(
        jax.random.key(seed), packs[0], cfg, 'GL', CFG.seed_batch, 256,
        jnp.int32(0))))


def test_multi_segment_launch_matches_jax(packs, port_segmented):
    _assert_launches_match(port_segmented,
                           _jax_launch(packs, CFG.replace(**SEG), 5))


def test_dvdt0_launch_matches_jax(packs, port_segmented):
    """(d) m_init_mode='dvdt0' (m from the dv/dt = 0 inversion instead of
    the RH sigmoid): the same multi-segment launch in both packages agrees
    under tolerance (a), and its survivors start from other m than the
    'rh' launch of the same key."""
    cfg = CFG.replace(m_init_mode='dvdt0', **SEG)
    port = tuple(map(_np, pipeline._simulate_batch(
        rng.key(5), packs[1], cfg, 'GL', CFG.seed_batch, 256, 0)))
    _assert_launches_match(port, _jax_launch(packs, cfg, 5))
    (tt, mt), (tr, mr) = port, port_segmented
    m0 = tt['m'][tt['valid'], 0]
    assert np.all((m0 >= 0) & (m0 <= 1))
    assert not np.allclose(m0[:10], tr['m'][:10, 0], atol=1e-3)


@pytest.mark.parametrize('cap', [0.5, 1.0])
def test_launch_inputs_match_jax(packs, cap):
    """(e) the integrate compaction of launch_inputs, m < n (cap 0.5) and
    m == n (cap 1.0, the full draw): the JAX package's route is
    propose_seeds, the full-width Fourier draw, the stable partition order
    and the gathers (models/pipeline.py launch_body)."""
    cfg = CFG.replace(integrate_cap=cap)
    n = CFG.seed_batch
    m = pipeline.launch_width(cfg, n)
    assert (m < n) == (cap < 1.0)
    li = pipeline.launch_inputs(rng.key(5), packs[1], cfg, 'GL', n, 0)
    k_seed, k_fourier = jax.random.split(jax.random.key(5))
    prop = jseeding.propose_seeds(k_seed, packs[0], cfg, 'GL', n,
                                  jnp.int32(0))
    fs = jfourier.draw_fourier(k_fourier, (n, cfg.n_wind_levels),
                               cfg.T_fourier_s)
    if m < n:
        order = jcompact.stable_partition_order(prop.integrate, m)
        fs = jfourier.take_leading(fs, order)
        g = lambda a: np.asarray(a)[np.asarray(order)]
    else:
        g = np.asarray
    assert li.params.fourier.A.shape == (m, cfg.n_wind_levels, 15)
    for a, b in ((li.params.fourier.A, fs.A), (li.params.fourier.B, fs.B)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(li.params.plane.numpy(), g(prop.plane))
    np.testing.assert_array_equal(li.month.numpy(), g(prop.month))
    np.testing.assert_array_equal(li.state.lon.numpy(), g(prop.lon))


def test_compaction_bit_identical_to_uncapped(packs, port_segmented):
    tt, mt = port_segmented
    tf, mf = map(_np, pipeline._simulate_batch(
        rng.key(5), packs[1], CFG.replace(integrate_cap=1.0), 'GL',
        CFG.seed_batch, 256, 0))
    assert mt['overflow'].sum() == 0
    np.testing.assert_array_equal(mt['keep'], mf['keep'])
    kv = int(tf['valid'].sum())
    assert kv > 10
    np.testing.assert_array_equal(tt['valid'], tf['valid'])
    for k in TRACK_KEYS + ('month', 'basin_idx'):
        np.testing.assert_array_equal(tt[k][:kv], tf[k][:kv], err_msg=k)


def test_run_downscaling_one_year_matches_jax(packs, tmp_path):
    cfg = Namelist(seed_batch=2048, tracks_per_year=4, start_year=2016,
                   end_year=2016, exp_name='cmp')
    files = {}
    for name, run, pack, kw in (
            ('jax', jruntime.run_downscaling, packs[0],
             {'key': jax.random.key(7)}),
            ('torch', runtime.run_downscaling, packs[1], {'seed': 7})):
        c = cfg.replace(output_directory=str(tmp_path / name))
        files[name] = netcdf.read(run(c, 'GL', pack, **kw))
    dj, dt = files['jax'], files['torch']
    assert set(dt.variables) == set(dj.variables)
    for k, vj in dj.variables.items():
        vt = dt.variables[k]
        assert vt.dims == vj.dims, k
        assert vt.data.dtype == vj.data.dtype, k
        assert vt.data.shape == vj.data.shape, k
    assert dt.variables['lon_trks'].data.shape[0] == cfg.tracks_per_year
    np.testing.assert_array_equal(dt.variables['seeds_per_month'].data,
                                  dj.variables['seeds_per_month'].data)
    np.testing.assert_array_equal(dt.variables['tc_month'].data,
                                  dj.variables['tc_month'].data)
    np.testing.assert_allclose(dt.variables['lat_trks'].data,
                               dj.variables['lat_trks'].data, rtol=0,
                               atol=1e-3)
