"""The port's models (fast, simulator, diagnostics, seeding) against the JAX
package's on one synthetic pack (91x180, 12 planes), with the same numpy
inputs and the same PRNG key; the port runs its plain PyTorch twins here.

Tolerances, with their reasons:
- tendencies and one-step quantities: rtol 1e-5 plus an atol of 1e-6 of
  the largest magnitude: XLA on the CPU contracts a*b+c into fused
  multiply-adds and rounds pow/exp/sin differently, torch does neither;
- a <= 30-step integration: 1e-4 deg in lon/lat and 1e-3 m/s in v, the
  same rounding seeds grown by 4 RK stages per step; alive masks exact;
- vmax: atol 1e-4, the JAX package's own width-dependent noise
  (tests/test_pipeline_stats.py);
- seeding: masks, months, basins, planes and lon bit-exact; lat within
  1e-5 deg (arcsin rounds up to 2 ulps apart); v_init within 1e-6 (the
  normal draw, tests/test_torch_rng.py) and m_init within 1e-6 (its
  environment lookup sits on that latitude).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import diagnostics as jdiag
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import seeding as jseed
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import kernels, rng
from tropical_cyclone_risk_tpu_torch.models import diagnostics, fast, fields
from tropical_cyclone_risk_tpu_torch.models import seeding, simulator
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins

CFG = Namelist(seed_batch=2048)
N = 1500


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(CFG, 12, 91, 180, seed=0)
    tpack = fields.pack_from_numpy(jpack, device='cpu')
    np.testing.assert_array_equal(
        tpack.env.numpy(), fields.synthetic_pack(CFG, 12, 91, 180, seed=0,
                                                 device='cpu').env.numpy())
    return jpack, tpack


@pytest.fixture(scope='module')
def storms():
    """Same seeds on both sides: ocean positions, intensities, planes and
    Fourier draws from one key."""
    r = np.random.default_rng(42)
    lon = r.uniform(120.0, 260.0, N).astype(np.float32)
    lat = (r.choice([-1.0, 1.0], N) * r.uniform(5.0, 40.0, N)
           ).astype(np.float32)
    v = r.uniform(8.0, 60.0, N).astype(np.float32)
    m = r.uniform(0.2, 0.9, N).astype(np.float32)
    plane = r.integers(0, 12, N).astype(np.int32)
    h_bl = r.choice(CFG.h_bl_by_basin(), N).astype(np.float32)
    kj = jax.random.key(3)
    fj = jfourier.draw_fourier(kj, (N, 4), CFG.T_fourier_s)
    jy = jfast.State(*(jnp.asarray(x) for x in (lon, lat, v, m)))
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl), fj)
    ty = fast.State(*(torch.from_numpy(x) for x in (lon, lat, v, m)))
    tp = fast.SeedParams(
        torch.from_numpy(plane), torch.from_numpy(h_bl),
        fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                              torch.from_numpy(np.array(fj.B)),
                              CFG.T_fourier_s))
    return jy, jp, ty, tp


def _close(got, ref, rtol=1e-5, rel_atol=1e-6, err_msg=''):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rel_atol * np.abs(ref).max() + 1e-30,
                               err_msg=err_msg)


def test_rhs_given_winds_tendencies(packs, storms):
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    f0 = np.asarray(jp.fourier.evaluate(3600.0))

    @jax.jit
    def ref(pack, y, params, f):
        stacks = jfields.build_stacks(pack)
        smp = jfast.sample_fields(stacks, y.lon, y.lat, params.plane)
        drv = jfast.derive_sample(CFG, smp)
        wnds = jfast.color_winds_given_f(CFG, smp.wind_stats, f)
        dy, w = jfast.rhs_given_winds(CFG, 0.0, y, params, smp, wnds, drv)
        alpha, _ = jfast.ocean_alpha(CFG, smp.env, smp.land, smp.bathy,
                                     y.v * 0.3, y.v)
        return smp, wnds, dy, w, alpha, jfast.steering_coefs(CFG, y.v)

    smp_j, wnds_j, dy_j, w_j, alpha_j, coefs_j = ref(jpack, jy, jp, f0)
    stacks = fields.build_stacks(tpack)
    smp = fast.sample_fields(stacks, ty.lon, ty.lat, tp.plane)
    drv = fast.derive_sample(CFG, smp)
    wnds = fast.color_winds_given_f(CFG, smp.wind_stats, torch.from_numpy(f0))
    dy, w = fast.rhs_given_winds(CFG, ty, tp, smp, wnds, drv)
    alpha, _ = fast.ocean_alpha(CFG, smp.env, smp.land, smp.bathy,
                                ty.v * 0.3, ty.v)
    for a, b in zip(smp, smp_j):
        _close(a, b)
    _close(wnds, wnds_j)
    _close(w, w_j)
    for name, a, b in zip(jfast.State._fields, dy, dy_j):
        _close(a, b, err_msg=name)
    _close(alpha, alpha_j)
    _close(fast.steering_coefs(CFG, ty.v), coefs_j)
    keep_j = jax.jit(lambda pack, y, p: jfast.ventilation_index_reject(
        jfields.build_stacks(pack), CFG, y, p))(jpack, jy, jp)
    np.testing.assert_array_equal(
        fast.ventilation_index_reject(stacks, CFG, ty, tp).numpy(),
        np.asarray(keep_j))


GOLDEN = {   # the scenarios of tests/test_fast_golden.py
    'deep_ocean': (CFG, 150.0, 18.0, 25.0, 0.6, (-8.0, 2.0, -4.0, 1.0),
                   (0.5, -0.3, 0.2, 0.8), 0.8, 60.0, 40.0, 5.0, 0.0, -4000.0),
    'land': (CFG, 260.0, 30.0, 30.0, 0.7, (-5.0, 1.0, -2.0, 0.5),
             (-0.2, 0.4, 0.1, -0.6), 1.5, 55.0, 0.0, 0.0, 1.0, 100.0),
    'shallow': (CFG, 100.0, -15.0, 20.0, 0.5, (-6.0, -1.0, -3.0, 0.0),
                (0.1, 0.1, -0.2, 0.3), 0.9, 65.0, 30.0, 4.0, 0.0, -20.0),
    'southern': (CFG, 60.0, -12.0, 18.0, 0.45, (-7.0, 0.5, -3.5, -0.5),
                 (-0.4, 0.2, 0.6, -0.1), 1.1, 58.0, 50.0, 6.0, 0.0, -3500.0),
    'uncoupled': (CFG.replace(coupled_track=False), 140.0, 20.0, 40.0, 0.8,
                  (-9.0, 3.0, -5.0, 2.0), (0.7, -0.5, 0.3, 0.2), 0.7, 70.0,
                  45.0, 5.0, 0.0, -5000.0),
    'clip_low': (CFG, 150.0, 22.0, 5.0, 0.6, (-8.0, 2.0, -4.0, 1.0),
                 (0.5, -0.3, 0.2, 0.8), 0.8, 75.0, 40.0, 5.0, 0.0, -4000.0),
    'clip_high': (CFG, 150.0, 22.0, 90.0, 0.6, (-8.0, 2.0, -4.0, 1.0),
                  (0.5, -0.3, 0.2, 0.8), 0.8, 75.0, 40.0, 5.0, 0.0, -4000.0),
}


@pytest.mark.parametrize('case', sorted(GOLDEN))
def test_rhs_against_float64_golden(case):
    """The port's tendency against test_fast_golden's float64 scalar
    re-derivation of the physics, with that file's tolerances (rtol 2e-4,
    atol 5e-7; 1e-3 / 1e-6 at the steering clip bounds)."""
    from test_fast_golden import _cov, scalar_rhs
    cfg, lon, lat, v, m, mean4, F4, chi, vpot, mld, strat, land, bathy = \
        GOLDEN[case]
    cov = _cov()
    tri = [cov[i, j] for i in range(4) for j in range(i + 1)]
    smp = fast.FieldSample(
        torch.tensor([list(mean4) + tri], dtype=torch.float32),
        torch.tensor([[chi, vpot, mld, strat, 0.6]], dtype=torch.float32),
        torch.tensor([land]), torch.tensor([bathy]))
    B = torch.zeros(1, 4, fourier.N_FOURIER)
    B[0, :, 0] = torch.tensor(F4)        # F(0) = F4 exactly
    params = fast.SeedParams(torch.zeros(1, dtype=torch.int64),
                             torch.tensor([1400.0]),
                             fourier.FourierSeries(torch.zeros_like(B), B,
                                                   cfg.T_fourier_s))
    y = fast.State(*(torch.tensor([x]) for x in (lon, lat, v, m)))
    wnds_raw = fast.color_winds(cfg, smp.wind_stats, params.fourier, 0.0)
    d, wnds = fast.rhs_given_winds(cfg, y, params, smp, wnds_raw)
    want = scalar_rhs(cfg, 0.0, lon, lat, v, m, np.asarray(mean4), cov,
                      np.asarray(F4), chi, vpot, mld, strat, land, bathy,
                      1400.0)
    clip = case.startswith('clip')
    np.testing.assert_allclose([float(x[0]) for x in d], want[:4],
                               rtol=1e-3 if clip else 2e-4,
                               atol=1e-6 if clip else 5e-7)
    np.testing.assert_allclose(wnds[0].numpy(), want[4], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('k0, n_steps', [(0, 20), (7, 30), (0, 2)])
def test_integrate_segment(packs, storms, k0, n_steps):
    """Strided blocks plus per-step remainder steps (20 = 6x3 + 2), an
    offset start, and a segment shorter than the stride."""
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    bounds = jbasins.basin_bounds(CFG, 'GL')
    alive0 = np.random.default_rng(1).random(N) < 0.9

    @functools.partial(jax.jit, static_argnums=(4, 5))
    def ref(pack, y, a0, params, k0, n):
        return jsim.integrate_segment(jfields.build_stacks(pack), CFG,
                                      bounds, y, a0, params, k0, n)

    (outs_j, (yend_j, aend_j)) = ref(jpack, jy, jnp.asarray(alive0), jp,
                                     k0, n_steps)
    kernels.reset_counts()
    outs, (yend, aend) = simulator.integrate_segment(
        fields.build_stacks(tpack), CFG, basins.basin_bounds(CFG, 'GL'), ty,
        torch.from_numpy(alive0), tp, k0, n_steps)
    assert kernels.LAUNCHES == {'integrator': 0, 'vmax': 0, 'cape_pi': 0}
    names = ('lon', 'lat', 'v', 'm', 'wnds', 'alive')
    tol = {'lon': 1e-4, 'lat': 1e-4, 'v': 1e-3, 'm': 1e-4, 'wnds': 1e-3}
    np.testing.assert_array_equal(outs[5].numpy(), np.asarray(outs_j[5]))
    np.testing.assert_array_equal(aend.numpy(), np.asarray(aend_j))
    assert outs[0].shape == (n_steps, N) and outs[4].shape == (n_steps, N, 4)
    for name, a, b in zip(names[:5], outs, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol[name], err_msg=name)
    for name, a, b in zip(names, yend, yend_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol[name], err_msg=name)


def test_genesis_alive_and_tc_filters(packs, storms):
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    mask = np.random.default_rng(2).random(N) < 0.7
    ga_j = jax.jit(lambda pack, y, p, msk: jsim.genesis_alive(
        pack, CFG, y, p, msk))(jpack, jy, jp, jnp.asarray(mask))
    ga = simulator.genesis_alive(fields.build_stacks(tpack), CFG, ty, tp,
                                 torch.from_numpy(mask))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ga_j))

    # the same raw buffers through both filters
    r = np.random.default_rng(4)
    T = CFG.n_steps_output
    life = r.integers(0, T + 1, 400)
    alive = np.arange(T)[:, None] < life[None, :]
    v = (r.uniform(0.0, 30.0, (T, 400)) * alive).astype(np.float32)
    last = np.maximum(alive.sum(0) - 1, 0)
    raw = dict(lon=v, lat=v, v=v, m=v, wnds=v[..., None], alive=alive)
    is_tc_j, v2d_j = jsim.tc_filters_raw(CFG, jsim.RawTracks(
        **{k: jnp.asarray(x) for k, x in raw.items()},
        last_step=jnp.asarray(last)))
    is_tc, v2d = simulator.tc_filters_raw(CFG, simulator.RawTracks(
        **{k: torch.from_numpy(x) for k, x in raw.items()},
        last_step=torch.from_numpy(last)))
    np.testing.assert_array_equal(is_tc.numpy(), np.asarray(is_tc_j))
    np.testing.assert_array_equal(v2d.numpy(), np.asarray(v2d_j))
    assert 0 < is_tc.sum() < 400


def test_integrate_raw_one_day(packs, storms):
    """integrate_raw (genesis gates, one segment, last_step) and the TC
    filters on it, over a 1-day track (25 samples)."""
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    cfg = CFG.replace(total_track_time_days=1)
    mask = np.random.default_rng(8).random(N) < 0.8
    raw_j = jax.jit(lambda pack, y, p, msk: jsim.integrate_raw(
        pack, cfg, 'GL', y, p, msk))(jpack, jy, jp, jnp.asarray(mask))
    raw = simulator.integrate_raw(fields.build_stacks(tpack), cfg, 'GL', ty,
                                  tp, torch.from_numpy(mask))
    assert raw.lon.shape == (cfg.n_steps_output, N)
    np.testing.assert_array_equal(raw.alive.numpy(), np.asarray(raw_j.alive))
    np.testing.assert_array_equal(raw.last_step.numpy(),
                                  np.asarray(raw_j.last_step))
    for name, tol in (('lon', 1e-4), ('lat', 1e-4), ('v', 1e-3)):
        np.testing.assert_allclose(getattr(raw, name).numpy(),
                                   np.asarray(getattr(raw_j, name)), rtol=0,
                                   atol=tol, err_msg=name)
    is_tc_j, _ = jsim.tc_filters_raw(cfg, raw_j)
    np.testing.assert_array_equal(
        simulator.tc_filters_raw(cfg, raw)[0].numpy(), np.asarray(is_tc_j))


def _tracks(T, n, seed):
    """Random-walk time-major tracks with frozen tails past each death."""
    r = np.random.default_rng(seed)
    step = r.normal(0.0, 0.2, (T, n, 2)).astype(np.float32)
    pos = np.cumsum(step, axis=0) + np.array([180.0, 15.0], np.float32)
    life = r.integers(1, T + 1, n)
    alive = np.arange(T)[:, None] < life[None, :]
    idx = np.minimum(np.arange(T)[:, None], life[None, :] - 1)
    pos = np.take_along_axis(pos, idx[..., None], axis=0)
    v = r.uniform(5.0, 70.0, (T, n)).astype(np.float32)
    wnds = r.normal(0.0, 8.0, (T, n, 4)).astype(np.float32)
    return (pos[..., 0].copy(), pos[..., 1].copy(), v, wnds, alive,
            np.maximum(alive.sum(0) - 1, 0))


@pytest.mark.parametrize('boundaries', [False, True])
def test_axi_to_max_wind_raw(boundaries):
    T, n = 40, 700
    lon, lat, v, wnds, alive, last = _tracks(T, n, 5)
    kw_j, kw_t = {}, {}
    if boundaries:
        # a middle segment: out-of-segment last steps on both sides, and
        # neighbour rows across both boundaries
        last = last + np.random.default_rng(6).integers(-3, 3, n)
        r = np.random.default_rng(7)
        for name in ('pos_before', 'pos_after'):
            row = (np.stack([lon[0], lat[0]]) +
                   r.normal(0, 0.2, (2, n))).astype(np.float32)
            kw_j[name] = jnp.asarray(row)
            kw_t[name] = torch.from_numpy(row)
    vmax_j, peak_j = jax.jit(
        lambda *a, **k: jdiag.axi_to_max_wind_raw(*a, cfg=CFG, **k),
        static_argnums=2)(lon, lat, 3600.0, v, wnds, alive, last, **kw_j)
    kernels.reset_counts()
    vmax, peak = diagnostics.axi_to_max_wind_raw(
        *(torch.from_numpy(x) for x in (lon, lat)), 3600.0,
        torch.from_numpy(v), torch.from_numpy(wnds), torch.from_numpy(alive),
        torch.from_numpy(last), CFG, **kw_t)
    assert kernels.LAUNCHES == {'integrator': 0, 'vmax': 0, 'cape_pi': 0}
    np.testing.assert_allclose(vmax.numpy(), np.asarray(vmax_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(peak.numpy(), np.asarray(peak_j), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize('caps', [None, (0.5, 0.25, 0.125) + (1 / 64,) * 12])
def test_propose_seeds_seed_by_seed(packs, caps):
    """Both the argmax path and the retry-compaction path, against JAX and
    against each other (the compaction is bit-identical when every
    unresolved slot fits its round, test_seeding_parity)."""
    jpack, tpack = packs
    cfg = CFG.replace(seed_retry_caps=caps)
    kj = jax.random.key(21)
    kt = rng.key_from_jax(jax.random.key_data(kj))
    pj = jseed.propose_seeds(kj, jpack, cfg, 'GL', 2048, jnp.int32(0))
    pt = seeding.propose_seeds(kt, tpack, cfg, 'GL', 2048, 0)
    tol = {'lat': 1e-5, 'v_init': 1e-6, 'm_init': 1e-6}
    for name in jseed.SeedProposal._fields:
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        if name in tol:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol[name],
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert pt.integrate.sum() > 100
    if caps is not None:
        full = seeding.propose_seeds(kt, tpack, CFG, 'GL', 2048, 0)
        for a, b in zip(pt, full):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    curve_j = jseed.retry_unresolved_curve(kj, jpack, cfg, 'GL', 2048)
    np.testing.assert_array_equal(
        seeding.retry_unresolved_curve(kt, tpack, cfg, 'GL', 2048),
        np.asarray(curve_j))
    spm = seeding.count_seeds_per_month(pt.basin_idx.numpy(),
                                        pt.month.numpy(), pt.counted.numpy(),
                                        len(cfg.basin_ids_sorted()), 1000)
    np.testing.assert_array_equal(spm, jseed.count_seeds_per_month(
        pj.basin_idx, pj.month, pj.counted, len(cfg.basin_ids_sorted()),
        1000))
