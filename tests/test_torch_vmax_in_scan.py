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


def _captured_fix(pack, cfg, seed=7):
    """The arguments of diagnostics.fix_in_scan in one in-scan launch of
    the twin (raws, edges, a_idxs, orders, last_step, peak, dt_s, cfg),
    copied as the call received them."""
    calls = []
    fn = diagnostics.fix_in_scan

    def capture(raws, *args):
        calls.append(([{k: v.clone() for k, v in r.items()} for r in raws],)
                     + tuple(a.clone() if isinstance(a, torch.Tensor)
                             else a for a in args))
        return fn(raws, *args)

    diagnostics.fix_in_scan = capture
    try:
        pipeline._simulate_batch(rng.key(seed), pack, cfg, 'GL',
                                 CFG.seed_batch, 64, 0)
    finally:
        diagnostics.fix_in_scan = fn
    (call,) = calls
    return call


SEGMENTED = CFG.replace(recompact_schedule=((60, 0.75), (120, 0.6),
                                            (180, 0.5)),
                        integrate_cap=0.75, vmax_in_scan=True)


def test_fix_in_scan_twin_matches_jax_loop(packs):
    """The whole-launch fix twin (diagnostics.fix_in_scan_plain, the loop
    the one-launch entry replaces) against the JAX package's in-scan
    branch (models/pipeline.py:515-535: per segment fix_last_sample at
    last_step[a_idx] - edge with the previous segment's last row gathered
    by the boundary order, banked with jnp.maximum on segment 0 and
    .at[a_idx].max after) on the inputs of a four-segment launch of the
    twin: the ok masks and every written sample position equal, the
    fixed buffers and the banked peak within VMAX_TOL (the JAX package's
    own vmax noise: its XLA kernels round the translation's sines
    otherwise, and a few samples differ in the last bits), and JAX's
    banking of the twin's own fixed samples bit for bit the twin's
    peak."""
    raws, edges, a_idxs, orders, last_step, peak0, dt_s, cfg = \
        _captured_fix(packs[1], SEGMENTED)
    assert len(raws) == 4
    fixed, peak = diagnostics.fix_in_scan_plain(
        raws, edges, a_idxs, orders, last_step, peak0, dt_s, cfg)
    j = lambda x: jnp.asarray(x.numpy())
    last = last_step.numpy()
    jpeak = bank = j(peak0)
    for k, r in enumerate(raws):
        if k == 0:
            ls_k, pos = last, None
        else:
            ai = a_idxs[k - 1].numpy()
            ls_k = last[ai] - edges[k]
            o = orders[k - 1].numpy()
            pos = jnp.stack([j(raws[k - 1]['lon'][-1])[o],
                             j(raws[k - 1]['lat'][-1])[o]])
        jf, jL, jok = jdiag.fix_last_sample(
            j(r['vmax']), j(r['lon']), j(r['lat']), j(r['v']), j(r['wnds']),
            j(r['alive']), jnp.asarray(ls_k), dt_s, cfg, pos_before=pos)
        contrib = jnp.where(jok, jL, -jnp.inf)
        jpeak = (jnp.maximum(jpeak, contrib) if k == 0
                 else jpeak.at[a_idxs[k - 1].numpy()].max(contrib))
        _, tL, tok = diagnostics.fix_last_sample_plain(
            r['vmax'], r['lon'], r['lat'], r['v'], r['wnds'], r['alive'],
            torch.from_numpy(ls_k), dt_s, cfg,
            None if pos is None else torch.from_numpy(np.array(pos)))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        mine = jnp.where(j(tok), j(tL), -jnp.inf)
        bank = (jnp.maximum(bank, mine) if k == 0
                else bank.at[a_idxs[k - 1].numpy()].max(mine))
        moved_t = fixed[k].numpy() != r['vmax'].numpy()
        moved_j = np.asarray(jf) != r['vmax'].numpy()
        np.testing.assert_array_equal(moved_t, moved_j)
        np.testing.assert_allclose(fixed[k].numpy(), np.asarray(jf), rtol=0,
                                   atol=VMAX_TOL)
    np.testing.assert_array_equal(peak.numpy(), np.asarray(bank))
    jpeak = np.asarray(jpeak)
    np.testing.assert_array_equal(np.isfinite(peak.numpy()),
                                  np.isfinite(jpeak))
    fin = np.isfinite(jpeak)
    np.testing.assert_allclose(peak.numpy()[fin], jpeak[fin], rtol=0,
                               atol=VMAX_TOL)
    assert (peak.numpy() != peak0.numpy()).any()


def test_each_slot_is_fixed_in_one_segment_at_most(packs):
    """The one-launch entry writes each m slot's peak without atomics: on a
    four-segment launch a slot's last step lies in at most one segment
    (last_step - edge_k in [0, T_k)), so at most one segment's ok flags
    it; and the fix banks into the peak exactly the slots some segment
    flags."""
    raws, edges, a_idxs, orders, last_step, peak0, dt_s, cfg = \
        _captured_fix(packs[1], SEGMENTED)
    m = last_step.shape[0]
    hits = torch.zeros(m, dtype=torch.int64)
    in_range = torch.zeros(m, dtype=torch.int64)
    for k, r in enumerate(raws):
        a = (a_idxs[k - 1] if k else torch.arange(m))
        ls_k = last_step[a] - edges[k]
        T = r['lon'].shape[0]
        _, _, ok = diagnostics.fix_last_sample_plain(
            r['vmax'], r['lon'], r['lat'], r['v'], r['wnds'], r['alive'],
            ls_k, dt_s, cfg)
        hits.index_add_(0, a, ok.to(torch.int64))
        in_range.index_add_(0, a, ((ls_k >= 0) & (ls_k < T)).to(torch.int64))
    assert int(in_range.max()) <= 1 and int(hits.max()) <= 1
    assert int(hits.sum()) > 0
    _, peak = diagnostics.fix_in_scan_plain(raws, edges, a_idxs, orders,
                                            last_step, peak0, dt_s, cfg)
    moved = peak != peak0
    assert bool((moved <= (hits == 1)).all())
