"""The port's one-shot API leaves and pipeline._simulate_batches against the
JAX package's, with the same numpy inputs and the same keys (the port's
plain twins run here).

Tolerances, with their reasons:
- simulator.integrate over 15 days (361 samples): alive masks, last_step
  and the NaN pattern exact; values within tests/test_torch_pipeline.py's
  TRACK_TOL (XLA on the CPU contracts multiply-adds and rounds
  transcendentals otherwise than torch, and 361 RK4 steps grow those
  seeds); tc_filters, initial_state, roll_field_to_0360 and take_leading
  exact (selections and comparisons of the same values);
- chol.nearest_psd: within 1e-5 of the largest entry (LAPACK's eigh and
  XLA's round apart in float32), gpi and gpi_en04 within rtol 1e-5 (pow);
- _simulate_batches against JAX's: every per-slot and per-batch decision
  bit for bit, tracks within TRACK_TOL; against three _simulate_batch
  calls of the port: every leaf bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import pipeline as jpipeline
from tropical_cyclone_risk_tpu.models import seeding as jseeding
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import chol as jchol
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.ops import thermo as jthermo
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.models import (fast, fields, pipeline,
                                                    seeding, simulator)
from tropical_cyclone_risk_tpu_torch.ops import chol, fourier, thermo
from tropical_cyclone_risk_tpu_torch.utils import basins
from test_torch_pipeline import TRACK_KEYS, TRACK_TOL

CFG = Namelist(rk_substeps=1)


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(CFG, 12, 91, 180, seed=0)
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


def _batch(n, lat, v0=12.0, m0=0.4):
    """tests/test_simulator.py's _setup_batch on both sides: four storms in
    August, the Fourier flow drawn from one key."""
    fj = jfourier.draw_fourier(jax.random.key(42), (n, CFG.n_wind_levels),
                               CFG.T_fourier_s)
    lon = np.linspace(150.0, 210.0, n).astype(np.float32)
    lat = np.asarray(lat, np.float32)
    cols = (lon, lat, np.full(n, v0, np.float32), np.full(n, m0, np.float32))
    jp = jfast.SeedParams(jnp.full((n,), 7, jnp.int32),
                          jnp.full((n,), 1400.0, jnp.float32), fj)
    tp = fast.SeedParams(
        torch.full((n,), 7, dtype=torch.int64),
        torch.full((n,), 1400.0),
        fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                              torch.from_numpy(np.array(fj.B)),
                              CFG.T_fourier_s))
    return (jfast.State(*map(jnp.asarray, cols)), jp,
            fast.State(*map(torch.from_numpy, cols)), tp)


CASES = {   # tests/test_simulator.py:96-164, 236-253
    'warm': (np.linspace(10.0, 18.0, 4), [True] * 4),
    'masked': (np.linspace(10.0, 18.0, 4), [True, False, True, False]),
    'cold': (np.full(4, 48.0), [True] * 4),
}


@pytest.mark.parametrize('case', list(CASES))
def test_integrate_matches_jax(packs, case):
    lat, mask = CASES[case]
    jy, jp, ty, tp = _batch(4, lat)
    if case == 'cold':          # high latitude: v decays below 4 m/s
        jy = jy._replace(v=jnp.full((4,), 8.0), m=jnp.full((4,), 0.3))
        ty = ty._replace(v=torch.full((4,), 8.0), m=torch.full((4,), 0.3))
    out_j = jsim.integrate(packs[0], CFG, 'GL', jy, jp, jnp.asarray(mask))
    out = simulator.integrate(packs[1], CFG, 'GL', ty, tp,
                              torch.tensor(mask))
    assert isinstance(out, simulator.TrackOutput)
    assert out._fields == out_j._fields
    assert out.v.shape == (4, CFG.n_steps_output)
    assert out.wnds.shape == (4, CFG.n_steps_output, 4)
    alive = out.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(out_j.alive))
    np.testing.assert_array_equal(out.last_step.numpy(),
                                  np.asarray(out_j.last_step))
    for k in TRACK_KEYS[:4] + ('wnds',):
        a, b = getattr(out, k).numpy(), np.asarray(getattr(out_j, k))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=TRACK_TOL[k], err_msg=k)
    v = out.v.numpy()
    assert np.all(np.isfinite(v[alive])) and np.all(np.isnan(v[~alive]))
    if case == 'warm':
        assert alive[:, 0].all() and np.nanmax(v) > 25.0
    elif case == 'masked':
        assert not alive[1, 0] and not alive[3, 0]
    else:
        assert np.all(out.last_step.numpy() < CFG.n_steps_output - 1)
    is_tc, v2d = simulator.tc_filters(CFG, out)
    is_tc_j, v2d_j = jsim.tc_filters(CFG, out_j)
    np.testing.assert_array_equal(is_tc.numpy(), np.asarray(is_tc_j))
    np.testing.assert_allclose(v2d.numpy(), np.asarray(v2d_j), rtol=0,
                               atol=TRACK_TOL['v'])


def test_tc_filters_cases():
    """tests/test_simulator.py:243-262 on both packages: a TC alive
    throughout, one dying below 6.5 m/s before two days, one never
    reaching 15 m/s."""
    n_steps = CFG.n_steps_output
    v = np.full((3, n_steps), np.nan, np.float32)
    alive = np.zeros((3, n_steps), bool)
    v[0], alive[0] = 20.0, True
    v[1, :30], alive[1, :30] = np.linspace(16, 5, 30), True
    v[2], alive[2] = 10.0, True
    last = np.array([n_steps - 1, 29, n_steps - 1])
    z = np.zeros_like(v)
    out_j = jsim.TrackOutput(*map(jnp.asarray, (
        z, z, v, z, np.zeros((3, n_steps, 4), np.float32), alive, last)))
    out = simulator.TrackOutput(*map(torch.from_numpy, (
        z, z, v, z, np.zeros((3, n_steps, 4), np.float32), alive, last)))
    is_tc, v2d = simulator.tc_filters(CFG, out)
    assert is_tc.tolist() == [True, False, False]
    np.testing.assert_array_equal(is_tc.numpy(),
                                  np.asarray(jsim.tc_filters(CFG, out_j)[0]))
    np.testing.assert_array_equal(v2d.numpy(),
                                  np.asarray(jsim.tc_filters(CFG, out_j)[1]))


def test_initial_state():
    r = np.random.default_rng(4)
    cols = {f: r.random(16).astype(np.float32)
            for f in jseeding.SeedProposal._fields}
    assert jseeding.SeedProposal._fields == seeding.SeedProposal._fields
    y_j = jseeding.initial_state(jseeding.SeedProposal(
        **{k: jnp.asarray(v) for k, v in cols.items()}))
    y = seeding.initial_state(seeding.SeedProposal(
        **{k: torch.from_numpy(v) for k, v in cols.items()}))
    assert isinstance(y, fast.State) and y._fields == y_j._fields
    for a, b in zip(y, y_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_nearest_psd():
    """tests/test_ops_basic.py:126 on the port, and against JAX."""
    r = np.random.default_rng(2)
    M = r.normal(size=(5, 4, 4))
    sym = (0.5 * (M + np.swapaxes(M, -1, -2))).astype(np.float32)
    fixed = chol.nearest_psd(torch.from_numpy(sym)).numpy()
    w = np.linalg.eigvalsh(fixed)
    assert np.all(w >= -1e-5 * np.abs(w).max())
    ref = np.asarray(jchol.nearest_psd(jnp.asarray(sym)))
    np.testing.assert_allclose(fixed, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    psd = (M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(4)).astype(np.float32)
    np.testing.assert_allclose(chol.nearest_psd(torch.from_numpy(psd)).numpy(),
                               psd, rtol=1e-4, atol=1e-5)


def test_gpi():
    r = np.random.default_rng(5)
    n = 1000
    PI = r.uniform(0.0, 90.0, n).astype(np.float32)
    chi = r.uniform(0.1, 3.0, n).astype(np.float32)
    vort = r.uniform(-1e-4, 1e-4, n).astype(np.float32)
    S = r.uniform(0.0, 30.0, n).astype(np.float32)
    rh = r.uniform(10.0, 90.0, n).astype(np.float32)
    t = lambda *a: [torch.from_numpy(x) for x in a]
    j = lambda *a: [jnp.asarray(x) for x in a]
    got = thermo.gpi(*t(PI, chi, vort, S)).numpy()
    np.testing.assert_allclose(got, np.asarray(jthermo.gpi(*j(PI, chi, vort,
                                                               S))),
                               rtol=1e-5, atol=0)
    assert np.all(got[PI <= 35.0] == 0.0) and np.all(got[PI > 36.0] > 0.0)
    np.testing.assert_allclose(
        thermo.gpi_en04(*t(PI, rh, vort, S)).numpy(),
        np.asarray(jthermo.gpi_en04(*j(PI, rh, vort, S))), rtol=1e-5, atol=0)


def test_roll_field_to_0360():
    """tests/test_ops_basic.py:70, and a random grid against JAX."""
    lon = np.array([-180., -90., 0., 90.])
    field = np.arange(8, dtype=float).reshape(2, 4)
    lon2, f2 = basins.roll_field_to_0360(lon, field)
    np.testing.assert_array_equal(lon2, [0., 90., 180., 270.])
    np.testing.assert_array_equal(f2, field[:, [2, 3, 0, 1]])
    lon = np.arange(-180.0, 180.0, 2.5)
    field = np.random.default_rng(6).normal(size=(3, 5, lon.size))
    for a, b in zip(basins.roll_field_to_0360(lon, field),
                    jbasins.roll_field_to_0360(lon, field)):
        np.testing.assert_array_equal(a, b)


def test_take_leading():
    fj = jfourier.draw_fourier(jax.random.key(9), (64, 4), CFG.T_fourier_s)
    fs = fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                               torch.from_numpy(np.array(fj.B)),
                               CFG.T_fourier_s)
    order = np.random.default_rng(7).permutation(64)[:20]
    got = fourier.take_leading(fs, torch.from_numpy(order))
    ref = jfourier.take_leading(fj, jnp.asarray(order))
    assert got.A.shape == (20, 4, fourier.N_FOURIER)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(ref.A))
    np.testing.assert_array_equal(got.B.numpy(), np.asarray(ref.B))
    assert got.T_s == fs.T_s


def test_simulate_batches(packs):
    """Three launches of one pack: against the JAX package's fused
    _simulate_batches leaf by leaf (batch i its leading index i), and
    against three _simulate_batch calls of the port bit for bit."""
    n, k_max, K = 256, 32, 3
    cfg = CFG.replace(seed_batch=n)
    keys = [rng.fold_in(rng.key(21), i) for i in range(K)]
    ours = pipeline._simulate_batches(keys, packs[1], cfg, 'GL', n, k_max, 0)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(21), i))(
        jnp.arange(K))
    theirs = jpipeline._simulate_batches(jkeys, packs[0], cfg, 'GL', n,
                                         k_max, jnp.int32(0))
    assert len(ours) == K
    n_surv = 0
    for i, (tr, meta) in enumerate(ours):
        jt = {k: np.asarray(v[i]) for k, v in theirs[0].items()}
        jm = {k: np.asarray(v[i]) for k, v in theirs[1].items()}
        assert set(meta) == set(jm) and set(tr) == set(jt)
        for k in meta:
            np.testing.assert_array_equal(
                meta[k].numpy().astype(np.int64), jm[k].astype(np.int64),
                err_msg=k)
        for k in ('valid', 'month', 'basin_idx'):
            np.testing.assert_array_equal(tr[k].numpy().astype(np.int64),
                                          jt[k].astype(np.int64), err_msg=k)
        for k in TRACK_KEYS:
            a, b = tr[k].numpy(), jt[k]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=k)
            fin = np.isfinite(a)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                       atol=TRACK_TOL[k], err_msg=k)
        n_surv += int(meta['scalars'][0])
        one = pipeline._simulate_batch(keys[i], packs[1], cfg, 'GL', n,
                                       k_max, 0)
        for got, ref in zip((tr, meta), one):
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k].numpy(),
                                              ref[k].numpy(), err_msg=k)
    assert n_surv > 0
    # three keys, three different launches
    assert not torch.equal(ours[0][1]['month'], ours[1][1]['month'])
