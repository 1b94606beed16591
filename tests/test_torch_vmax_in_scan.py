"""The in-scan vmax (Namelist.vmax_in_scan) in the port's twin: the
integrator's DiagState carry, diagnostics.fix_last_sample and the launch's
in-scan branch, against the JAX package and against the port's own
post-pass launch.  Small size: the 46x90 synthetic pack, 2048 seeds per
launch.

Tolerances, with their reasons:
- in-scan against post-pass in the port: the two read the same neighbour
  positions (the post-pass re-reads from the frozen buffers what the scan
  carries), so trajectories, scalars, keep and valid are bit-identical
  and vmax agrees within 1e-4 m/s (JAX tests/test_pipeline_stats.py
  test_vmax_in_scan_identity's bound: the two compute sample L in other
  orders);
- port against JAX (integrate_segment with a DiagState, the in-scan
  launch): tests/test_torch_pipeline.py's tolerance (a) and its 1e-2 m/s
  on vmax: XLA on the CPU contracts multiply-adds and rounds
  transcendentals otherwise, and 361 RK4 steps grow those seeds;
- fix_last_sample on the same inputs: 1e-4 m/s (the JAX package's own
  vmax noise), the ok mask equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import diagnostics as jdiag
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import pipeline as jpipeline
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fast,
                                                    fields, pipeline,
                                                    simulator)
from tropical_cyclone_risk_tpu_torch.ops.fourier import FourierSeries
from tropical_cyclone_risk_tpu_torch.utils import basins

CFG = Namelist(seed_batch=2048)
VMAX_TOL = 1e-4
TRACK_TOL = {'lon': 1e-3, 'lat': 1e-3, 'v': 1e-2, 'm': 1e-3, 'vmax': 1e-2}


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(CFG, 12, 46, 90, seed=0)
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _port_launch(pack, cfg, seed=7):
    return tuple(map(_np, pipeline._simulate_batch(
        rng.key(seed), pack, cfg, 'GL', CFG.seed_batch, 64, 0)))


# the five parametrisations of JAX test_vmax_in_scan_identity
IDENTITY = [
    (None, 3, 1),                       # unsegmented, strided (defaults)
    (((60, 0.75), (180, 0.5)), 3, 1),   # multi-segment + stride
    (None, 1, 1),                       # per-step steps
    (((90, 0.5),), 1, 1),               # one boundary, per-step
    (None, 1, 2),                       # RK substeps
]


@pytest.mark.parametrize('sched,stride,sub', IDENTITY)
def test_vmax_in_scan_identity(packs, sched, stride, sub):
    cfg0 = CFG.replace(recompact_schedule=sched, field_sample_stride=stride,
                       rk_substeps=sub, integrate_cap=0.75)
    (ta, ma), (tb, mb) = (_port_launch(packs[1],
                                       cfg0.replace(vmax_in_scan=flag))
                          for flag in (False, True))
    for k in ('scalars', 'keep', 'spm_all', 'spm_upto'):
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)
    valid = ta['valid']
    np.testing.assert_array_equal(tb['valid'], valid)
    kv = int(valid.sum())
    assert kv > 5
    for k in ('lon', 'lat', 'v', 'm', 'wnds', 'month', 'basin_idx'):
        np.testing.assert_array_equal(np.nan_to_num(ta[k][:kv], nan=-9e9),
                                      np.nan_to_num(tb[k][:kv], nan=-9e9),
                                      err_msg=k)
    a, b = ta['vmax'][:kv], tb['vmax'][:kv]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=VMAX_TOL)


def test_in_scan_launch_matches_jax(packs):
    """The twin's in-scan launch against JAX's in-scan launch on the same
    key, multi-segment and strided: the verdicts and the matched survivor
    tracks, vmax among them."""
    cfg = CFG.replace(recompact_schedule=((60, 0.75), (180, 0.5)),
                      integrate_cap=0.75, vmax_in_scan=True)
    tt, mt = _port_launch(packs[1], cfg)
    tj, mj = map(_np, jpipeline._simulate_batch(
        jax.random.key(7), packs[0], cfg, 'GL', CFG.seed_batch, 64,
        jnp.int32(0)))
    assert (mt['keep'] == mj['keep']).mean() >= 0.995
    np.testing.assert_array_equal(mt['counted'], mj['counted'])
    both = mt['keep'] & mj['keep']
    assert both.sum() > 5
    rt = (np.cumsum(mt['keep']) - 1)[both]
    rj = (np.cumsum(mj['keep']) - 1)[both]
    rt, rj = rt[rt < 64], rj[rt < 64]
    for k, tol in TRACK_TOL.items():
        a, b = tt[k][rt], tj[k][rj]
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol,
                                   err_msg=k)


def _segment_inputs(packs, n=96, seed=5):
    """The same storms (numpy-seeded positions, intensities, planes and
    Fourier rows) for both packages' integrate_segment."""
    r = np.random.default_rng(seed)
    lon = r.uniform(120, 300, n).astype(np.float32)
    lat = (r.choice([-1, 1], n) * r.uniform(8, 30, n)).astype(np.float32)
    v = r.uniform(12, 30, n).astype(np.float32)
    m = r.uniform(0.3, 0.9, n).astype(np.float32)
    plane = r.integers(0, 12, n).astype(np.int32)
    h_bl = np.full(n, 1400.0, np.float32)
    W = CFG.n_wind_levels
    A = (r.standard_normal((n, W, 15)) * 0.3).astype(np.float32)
    B = (r.standard_normal((n, W, 15)) * 0.3).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::7] = False
    prev = (lon + r.uniform(-0.3, 0.3, n).astype(np.float32),
            lat + r.uniform(-0.3, 0.3, n).astype(np.float32))
    peak = np.where(r.uniform(size=n) < 0.5, -np.inf,
                    r.uniform(10, 40, n)).astype(np.float32)
    jpack, tpack = packs
    T_s = CFG.T_fourier_s
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl),
                          jfourier.FourierSeries(jnp.asarray(A),
                                                 jnp.asarray(B), T_s))
    tp = fast.SeedParams(torch.from_numpy(plane), torch.from_numpy(h_bl),
                         FourierSeries(torch.from_numpy(A),
                                       torch.from_numpy(B), T_s))
    jy = jfast.State(*map(jnp.asarray, (lon, lat, v, m)))
    ty = fast.State(*map(torch.from_numpy, (lon, lat, v, m)))
    jd = jsim.DiagState(*map(jnp.asarray, (*prev, peak)))
    td = simulator.DiagState(*map(torch.from_numpy, (*prev, peak)))
    return ((jfields.build_stacks(jpack), jy, jnp.asarray(alive), jp, jd),
            (fields.build_stacks(tpack), ty, torch.from_numpy(alive), tp,
             td))


@pytest.mark.parametrize('k0,n_steps,t_last', [(0, 20, -1), (40, 13, 52),
                                               (40, 13, -1)])
def test_integrate_segment_with_diag_matches_jax(packs, k0, n_steps,
                                                 t_last):
    """integrate_segment with a DiagState carry: the outputs' 7th leaf
    (vmax) and the carry's DiagState against the JAX package's, from the
    global first sample (k0 = 0, the start-edge extrapolation) and from
    inside the track, with the run's last row in the segment (t_last set;
    13 steps are four strided blocks and one per-step step) and without."""
    (js, jy, ja, jp, jd), (ts, ty, ta, tp, td) = _segment_inputs(packs)
    bounds = jbasins.basin_bounds(CFG, 'GL')
    jo, jc = jsim.integrate_segment(js, CFG, bounds, jy, ja, jp, k0,
                                    n_steps, diag=jd, t_last=t_last)
    to, tc = simulator.integrate_segment(ts, CFG, basins.basin_bounds(
        CFG, 'GL'), ty, ta, tp, k0, n_steps, td, t_last)
    assert len(to) == 7 and len(tc) == 3
    np.testing.assert_array_equal(np.asarray(jo[5]), to[5].numpy())
    alive = to[5].numpy()
    for i, nm in enumerate(('lon', 'lat', 'v', 'm')):
        np.testing.assert_allclose(to[i].numpy(), np.asarray(jo[i]), rtol=0,
                                   atol=TRACK_TOL[nm], err_msg=nm)
    np.testing.assert_allclose(to[6].numpy()[alive],
                               np.asarray(jo[6])[alive], rtol=0,
                               atol=TRACK_TOL['vmax'])
    for a, b in zip(tc[2], jc[2]):
        b = np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a.numpy()),
                                      np.isfinite(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a.numpy()[fin], b[fin], rtol=0,
                                   atol=TRACK_TOL['vmax'])


@pytest.mark.parametrize('before', [False, True])
def test_fix_last_sample_matches_jax(before):
    """fix_last_sample_plain against the JAX fix_last_sample on random
    buffers, last steps inside, below and past the segment, with and
    without pos_before (a track ending at row 0 reaches across the
    boundary)."""
    r = np.random.default_rng(11)
    T, N, W = 9, 64, CFG.n_wind_levels
    lon = np.cumsum(r.uniform(-0.4, 0.4, (T, N)), 0).astype(np.float32) + 200
    lat = np.cumsum(r.uniform(-0.4, 0.4, (T, N)), 0).astype(np.float32) + 15
    v = r.uniform(10, 50, (T, N)).astype(np.float32)
    wnds = r.standard_normal((T, N, W)).astype(np.float32) * 5
    alive = r.uniform(size=(T, N)) < 0.8
    last = r.integers(-2, T + 3, N).astype(np.int64)
    last[:8] = 0
    vmax = r.uniform(10, 60, (T, N)).astype(np.float32)
    pos = (np.stack([lon[0] - 0.3, lat[0] + 0.2]).astype(np.float32)
           if before else None)
    jf, jL, jok = jdiag.fix_last_sample(
        jnp.asarray(vmax), jnp.asarray(lon), jnp.asarray(lat),
        jnp.asarray(v), jnp.asarray(wnds), jnp.asarray(alive),
        jnp.asarray(last), 3600.0, CFG,
        pos_before=None if pos is None else jnp.asarray(pos))
    t = torch.from_numpy
    tf, tL, tok = diagnostics.fix_last_sample(
        t(vmax), t(lon), t(lat), t(v), t(wnds), t(alive), t(last), 3600.0,
        CFG, pos_before=None if pos is None else t(pos))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.any() and not tok.all()
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=0,
                               atol=VMAX_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=VMAX_TOL)
    # only the ok tracks' final samples moved
    moved = tf.numpy() != vmax
    assert moved.sum() <= int(tok.sum())
