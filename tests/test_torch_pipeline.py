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
  same track count.
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


def test_multi_segment_launch_matches_jax(packs, port_segmented):
    cfg = CFG.replace(**SEG)
    tj, mj = jpipeline._simulate_batch(jax.random.key(5), packs[0], cfg,
                                       'GL', CFG.seed_batch, 256,
                                       jnp.int32(0))
    tj, mj = _np(tj), _np(mj)
    tt, mt = port_segmented
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
