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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
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


def test_integrate_fixed_position_matches_jax(packs, storms):
    """debug_fixed_position (the reference's Coupled_FAST.debug,
    intensity-only integration) over a 1-day track: positions frozen at
    the genesis point bit for bit in both packages, alive masks equal, v
    and m within test_integrate_segment's tolerances."""
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    cfg = CFG.replace(total_track_time_days=1, debug_fixed_position=True)
    mask = np.random.default_rng(9).random(N) < 0.8
    out_j = jsim.integrate(jpack, cfg, 'GL', jy, jp, jnp.asarray(mask))
    raw = simulator.integrate_raw(fields.build_stacks(tpack), cfg, 'GL', ty,
                                  tp, torch.from_numpy(mask))
    alive = raw.alive.numpy()
    np.testing.assert_array_equal(alive.T, np.asarray(out_j.alive))
    assert alive[0].sum() > 100 and alive[-1].sum() > 100
    for name, start in (('lon', ty.lon), ('lat', ty.lat)):
        got = getattr(raw, name).numpy()
        want = np.asarray(getattr(out_j, name)).T
        frozen = np.broadcast_to(start.numpy(), got.shape)
        np.testing.assert_array_equal(got[alive], frozen[alive])
        np.testing.assert_array_equal(want[alive], frozen[alive])
    for name, tol in (('v', 1e-3), ('m', 1e-4)):
        np.testing.assert_allclose(
            getattr(raw, name).numpy()[alive],
            np.asarray(getattr(out_j, name)).T[alive], rtol=0, atol=tol,
            err_msg=name)
    # the intensity still evolves
    assert float(np.abs(raw.v.numpy()[-1] - raw.v.numpy()[0])[
        alive[-1]].max()) > 1.0


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
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_allclose(vmax.numpy(), np.asarray(vmax_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(peak.numpy(), np.asarray(peak_j), rtol=0,
                               atol=1e-4)


# 256-wide retry rounds: at 8192 slots, ~830 unresolved slots enter round 1
OVERFLOW_CAPS = (1 / 64,) * 15


@pytest.mark.parametrize('caps', [None, (0.5, 0.25, 0.125) + (1 / 64,) * 12,
                                  OVERFLOW_CAPS])
def test_propose_seeds_seed_by_seed(packs, caps):
    """The argmax path, the retry-compaction path and a compaction whose
    rounds overflow (unresolved slots beyond a round's width are dropped),
    against JAX; the non-overflowing compaction also against the argmax
    path (bit-identical when every unresolved slot fits its round,
    test_seeding_parity)."""
    jpack, tpack = packs
    cfg = CFG.replace(seed_retry_caps=caps)
    n = 8192 if caps == OVERFLOW_CAPS else 2048
    kj = jax.random.key(21)
    kt = rng.key_from_jax(jax.random.key_data(kj))
    pj = jseed.propose_seeds(kj, jpack, cfg, 'GL', n, jnp.int32(0))
    kernels.reset_counts()
    pt = seeding.propose_seeds(kt, tpack, cfg, 'GL', n, 0)
    assert kernels.LAUNCHES['seeding'] == kernels.LAUNCHES['threefry'] == 0
    tol = {'lat': 1e-5, 'v_init': 1e-6, 'm_init': 1e-6}
    for name in jseed.SeedProposal._fields:
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        if name in tol:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol[name],
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert pt.integrate.sum() > 100
    if caps == OVERFLOW_CAPS:
        full = seeding.propose_seeds(kt, tpack, CFG, 'GL', n, 0)
        assert int(pt.dropped.sum()) > int(full.dropped.sum()) + 100
    elif caps is not None:
        full = seeding.propose_seeds(kt, tpack, CFG, 'GL', n, 0)
        for a, b in zip(pt, full):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    curve_j = jseed.retry_unresolved_curve(kj, jpack, cfg, 'GL', n)
    np.testing.assert_array_equal(
        seeding.retry_unresolved_curve(kt, tpack, cfg, 'GL', n),
        np.asarray(curve_j))
    spm = seeding.count_seeds_per_month(pt.basin_idx.numpy(),
                                        pt.month.numpy(), pt.counted.numpy(),
                                        len(cfg.basin_ids_sorted()), 1000)
    np.testing.assert_array_equal(spm, jseed.count_seeds_per_month(
        pj.basin_idx, pj.month, pj.counted, len(cfg.basin_ids_sorted()),
        1000))


def _k3_first_rounds(passes, n, R):
    """K3's warp-cooperative first rounds (csrc/seeding.cu first_round) on
    the twin's mask verdicts passes [R, n]: per group of 32 slots, each
    lane tests round 0 of its slot; then, while slots are unresolved, the
    u unresolved slots' next k = min(32 // u, rounds left) rounds go to the
    lanes (lane i: unresolved slot i // k, round base + i % k) and each
    slot takes its lowest passing round by lane order.  Returns (first
    round per slot, R for none; the (slot, round) pairs tested; the
    passes over the lanes of each group)."""
    first = np.full(n, R, np.int64)
    tested, passes_per_warp = [], []
    for w0 in range(0, n, 32):
        slots = np.arange(w0, min(w0 + 32, n))
        tested += [(s, 0) for s in slots]
        first[slots[passes[0, slots]]] = 0
        unres = [s for s in slots if not passes[0, s]]
        base = 1
        passes_per_warp.append(1)
        while unres and base < R:
            passes_per_warp[-1] += 1
            u = len(unres)
            k = min(32 // u, R - base)
            hits = np.zeros(32, bool)
            for lane in range(32):
                j = lane // k
                if j < u:
                    r = base + lane - j * k
                    tested.append((unres[j], r))
                    hits[lane] = passes[r, unres[j]]
            left = []
            for j, s in enumerate(unres):
                group = hits[j * k:(j + 1) * k]
                if group.any():
                    first[s] = base + int(group.argmax())
                else:
                    left.append(s)
            unres, base = left, base + k
    return first, tested, np.array(passes_per_warp)


def _k3_overflow_drops(first, widths, R, threads=256):
    """The last block's rewrite set (csrc/seeding.cu drop_overflow): the
    blocks' lists of slots that missed round 0 (each block of `threads`
    slots, in slot order), each of the last block's threads a run of
    consecutive blocks; from the first retry round r0 whose unresolved
    slots #{first >= r} exceed its width on, a run's counts of entries
    with first >= r, exclusively scanned over the runs, start each run's
    walk, which counts on and drops an entry when for some round r in
    [r0, min(first, R - 1)] the entries with first >= r up to and
    including it outnumber widths[r].  Returns the dropped slots' mask and
    the histogram's #{first >= r}."""
    n = first.size
    ge = np.cumsum(np.bincount(first, minlength=R + 1)[::-1])[::-1]
    over = [r for r in range(1, R) if ge[r] > widths[r]]
    r0 = over[0] if over else R
    nb = -(-n // threads)
    lists = [[(s, int(first[s])) for s in range(b * threads,
                                               min(n, (b + 1) * threads))
              if first[s] >= 1] for b in range(nb)]
    per = -(-nb // threads)
    runs = [sum(lists[t * per:(t + 1) * per], []) for t in range(threads)]
    counts = np.array([[sum(f >= r for _, f in run) for r in range(R)]
                       for run in runs])
    before = np.cumsum(counts, axis=0) - counts
    dropped = np.zeros(n, bool)
    for run, c in zip(runs, before):
        c = c.copy()
        for s, f in run:
            for r in range(r0, min(f, R - 1) + 1):
                c[r] += 1
                dropped[s] |= c[r] > widths[r]
    return dropped, ge


@pytest.mark.parametrize('caps', [None, (0.5, 0.25, 0.125) + (1 / 64,) * 12,
                                  OVERFLOW_CAPS])
def test_seeding_kernel_design_matches_the_twin(packs, caps):
    """K3's design emulated on the host, held bit for bit against the
    twin: the warp-cooperative rounds give each slot the sequential walk's
    first passing round and position (testing each round of a slot at most
    once, and ~1.1 rounds per slot); the speculative finish is the twin's
    full-width result; the last block's counts over the blocks' lists,
    applied only where a retry round overflows, select exactly the slots
    the twin's successive stable ranks drop, and rewriting them as slots
    with no passing round (round 0's position) gives all 11 fields of
    propose_seeds_plain; the histogram gives retry_unresolved_curve."""
    _, tpack = packs
    cfg = CFG.replace(seed_retry_caps=caps)
    n = 8192 if caps == OVERFLOW_CAPS else 2048
    R = seeding.N_RETRY_ROUNDS
    kt = rng.key(21)
    k_lon, k_lat0, k_latr, *_ = rng.split(kt, 6)
    b = basins.basin_bounds(cfg, 'GL')
    lon_r, lat_r = seeding._position_rounds(k_lon, k_lat0, k_latr, b, n,
                                            'cpu')
    passes = (seeding._mask_lookup(tpack)(lon_r.reshape(-1),
                                          lat_r.reshape(-1))
              .reshape(R, n) >= seeding.MASK_PASS).numpy()
    first, tested, warp_passes = _k3_first_rounds(passes, n, R)
    assert len(set(tested)) == len(tested)
    # a group of 32 slots walked one slot per lane waits for its slowest
    # lane: min(first, R - 1) + 1 rounds (found: 3.9 walked, 2.0 shared)
    walk = np.minimum(first, R - 1).reshape(-1, 32).max(1) + 1
    assert warp_passes.mean() < 0.6 * walk.mean()
    pick = torch.from_numpy(np.where(first < R, first, 0))[None]
    lon = torch.gather(lon_r, 0, pick)[0]
    lat = torch.gather(lat_r, 0, pick)[0]

    full = seeding.propose_seeds_plain(kt, tpack, CFG, 'GL', n, 0)
    np.testing.assert_array_equal(first == R, full.dropped.numpy())
    assert torch.equal(lon, full.lon) and torch.equal(lat, full.lat)
    widths = ([n] + seeding.retry_widths(cfg, n) if caps is not None
              else [n] * R)
    drop, ge = _k3_overflow_drops(first, widths, R)
    # the runs' partition does not change the set (16-slot blocks: runs of
    # many blocks, as the kernel has past 65536 slots)
    np.testing.assert_array_equal(
        _k3_overflow_drops(first, widths, R, threads=16)[0], drop)
    no_pass = seeding.propose_seeds_plain(
        kt, tpack._replace(run_mask=torch.zeros_like(tpack.run_mask)), CFG,
        'GL', n, 0)
    got = [torch.where(torch.from_numpy(drop), b_, a) for a, b_ in
           zip(full, no_pass)]
    want = seeding.propose_seeds_plain(kt, tpack, cfg, 'GL', n, 0)
    for name, a, b_ in zip(want._fields, got, want):
        assert a.dtype == b_.dtype and torch.equal(a, b_), name
    np.testing.assert_array_equal(
        ge[1:], seeding.retry_unresolved_curve_plain(kt, tpack, cfg, 'GL',
                                                     n))
    if caps == OVERFLOW_CAPS:
        assert drop.sum() > 100
    else:
        assert not drop.any()


def _k3_keys(parent):
    """The stream keys csrc/seeding.cu derive_keys computes, thread t of
    seven: the threefry block at counter (0, j) of the parent key for
    split stream j (streams 0-2 and 4-5 by threads 0-2 and 5-6), and for
    threads 3 and 4 the block at (0, t - 3) of split stream 3."""
    keys = []
    for t in range(7):
        j = t if t < 3 else (3 if t <= 4 else t - 1)
        k = rng.Key(*rng.threefry2x32(parent, 0, j))
        if t in (3, 4):
            k = rng.Key(*rng.threefry2x32(k, 0, t - 3))
        keys.append(k)
    return keys


def test_seeding_kernel_params_are_the_twins_constants(packs):
    """K3's parameter block: the uniform bounds and the float32 constants
    of propose_seeds_plain, in csrc/seeding.cu's order; and the stream
    keys that the kernel derives from the call's key (no key is in the
    block) are rng.split's and rng.randint_params'."""
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
    _, tpack = packs
    cfg = CFG.replace(seed_retry_caps=OVERFLOW_CAPS)
    for seed in (21, 0, 2 ** 32 - 1):
        kt = rng.key(seed)
        k_lon, k_lat0, k_latr, k_month, k_reject, k_vinit = rng.split(kt, 6)
        assert _k3_keys(kt) == [k_lon, k_lat0, k_latr,
                                *rng.randint_params(k_month, 1, 13)[0],
                                k_reject, k_vinit]
    dp, fp, ip = k3.params(tpack, cfg, 'GL', 2048, 3)
    b = basins.basin_bounds(cfg, 'GL')
    assert dp[:2].tolist() == list(rng.uniform_params(b[0], b[2]))
    assert dp[8:].tolist() == list(rng.uniform_params(rng.NORMAL_LO, 1.0))
    nb = len(cfg.basin_ids_sorted())
    assert fp.dtype == np.float32 and fp.size == 19 + 2 * k3.MAX_BASINS
    np.testing.assert_array_equal(fp[19:19 + nb],
                                  np.float32(cfg.lat_vort_power_by_basin()))
    np.testing.assert_array_equal(fp[35:35 + nb],
                                  np.float32(cfg.h_bl_by_basin()))
    assert fp[13] == np.float32(12.0) and fp[3] == np.float32(35.0)
    assert ip[:2].tolist() == [2048, seeding.N_RETRY_ROUNDS]
    assert ip[11] == 3 - cfg.start_month
    assert ip[12:14].tolist() == list(rng.randint_params(kt, 1, 13)[1:])
    R = seeding.N_RETRY_ROUNDS
    assert ip[15:15 + R].tolist() == [2048] + seeding.retry_widths(cfg, 2048)


@pytest.mark.parametrize('n', [1, 1000, 2048])
def test_seeding_kernel_arena_holds_the_twins_fields(packs, n):
    """K3's 11 outputs as views of one arena: the twin's dtypes and
    shapes, each view aligned to its type, disjoint and covering the
    arena, and the byte offsets the kernel is given are the views'."""
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
    _, tpack = packs
    sizes, offsets = k3.arena_layout(n)
    arena = torch.empty((sum(sizes),), dtype=torch.uint8)
    views = k3.arena_views(arena, n)
    want = seeding.propose_seeds_plain(rng.key(3), tpack, CFG, 'GL', n, 0)
    spans = []
    for name, v, w in zip(want._fields, views, want):
        assert v.dtype == w.dtype and v.shape == w.shape, name
        at = v.data_ptr() - arena.data_ptr()
        assert at == offsets[name] and at % v.element_size() == 0, name
        spans.append((at, at + v.numel() * v.element_size()))
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == arena.numel()
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_seeding_launchers_go_with_their_pack(packs, monkeypatch):
    """K3's kept launchers: one for each (pack's fields, cfg, basin, n,
    plane_offset, stream), reused while those fields live, holding none of
    the pack's own tensors, dropped when one of them is freed; and a
    launcher refuses a call on another stream than its own, whose scratch
    would race.  The card (device, current stream, library) is stood in
    for on the CPU."""
    import weakref
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
    _, tpack = packs
    stream = [5]
    monkeypatch.setattr(k3, '_LAUNCHERS', {})
    monkeypatch.setattr(k3, '_device', lambda pack: pack.env.device)
    monkeypatch.setattr(k3, '_entry', lambda: None)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: type('S', (), {'cuda_stream':
                                                   stream[0]})())
    cfg = CFG.replace(seed_retry_caps=OVERFLOW_CAPS)
    year0 = fields.slice_pack_year(tpack, cfg, 0)
    a = k3.launcher(year0, cfg, 'GL', 1024, 3)
    assert k3.launcher(year0._replace(wind=year0.wind), cfg, 'GL', 1024,
                       3) is a
    assert a.copies == [] and a.stream == 5
    assert k3.launcher(year0, cfg, 'GL', 1024, 4) is not a
    assert k3.launcher(year0, CFG, 'GL', 1024, 3) is not a
    assert len(k3._LAUNCHERS) == 3
    stream[0] = 6
    with pytest.raises(RuntimeError, match='stream'):
        a(rng.key(1), None)
    b = k3.launcher(year0, cfg, 'GL', 1024, 3)
    assert b is not a and b.stream == 6 and len(k3._LAUNCHERS) == 4
    gone = weakref.ref(a)
    del a, b
    again = fields.slice_pack_year(tpack, cfg, 0)
    k3.launcher(again, cfg, 'GL', 1024, 3)
    del year0
    assert len(k3._LAUNCHERS) == 1 and gone() is None
    del again
    assert k3._LAUNCHERS == {}


def test_seeding_wrappers_refuse_cpu_tensors(packs):
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
    _, tpack = packs
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        k3.propose_seeds_cuda(rng.key(1), tpack, CFG, 'GL', 256)
    with pytest.raises(ValueError, match='CUDA'):
        k3.retry_unresolved_curve_cuda(rng.key(1), tpack, CFG, 'GL', 256)
    with pytest.raises(ValueError, match='CUDA'):
        k5.fill_cuda('uniform', rng.key(1), (8,), 'cpu', 0.0, 1.0)
    with pytest.raises(ValueError, match='CUDA'):
        k5.fourier_cuda(rng.key(1), (8, 4), torch.ones(15))
    assert not any(kernels.LAUNCHES.values())


def _dvdt0_storms(storms, case):
    """(JAX, port) State/SeedParams pairs: the six storms of
    tests/test_fast_golden.py's dvdt0 test (zero Fourier flow), or the
    module's 1500 storms with random Fourier phases."""
    if case == 'storms':
        return storms
    n, W = 6, CFG.n_wind_levels
    arrs = [np.linspace(a, b, n).astype(np.float32)
            for a, b in ((150.0, 210.0), (8.0, 30.0), (4.0, 9.0),
                         (0.5, 0.5))]
    plane = np.full(n, 7, np.int32)
    h_bl = np.full(n, 1600.0, np.float32)
    z = np.zeros((n, W, fourier.N_FOURIER), np.float32)
    jy = jfast.State(*(jnp.asarray(x) for x in arrs))
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl),
                          jfourier.FourierSeries(jnp.asarray(z),
                                                 jnp.asarray(z),
                                                 jnp.asarray(CFG.T_fourier_s)))
    ty = fast.State(*(torch.from_numpy(x) for x in arrs))
    tp = fast.SeedParams(torch.from_numpy(plane), torch.from_numpy(h_bl),
                         fourier.FourierSeries(torch.from_numpy(z),
                                               torch.from_numpy(z),
                                               CFG.T_fourier_s))
    return jy, jp, ty, tp


@pytest.mark.parametrize('case', ['golden', 'storms'])
def test_init_m_dvdt0_matches_jax(packs, storms, case):
    """m_init_mode='dvdt0' against the JAX package's init_m_dvdt0: within
    1e-6 absolute, about 1e-6 relative (m lies in [0, 1]; found: 6e-8,
    one ulp).  The ratio under the cube root carries the rounding of the
    bilinear lookups, the wind coloring and alpha's exp, which the cube
    root divides by three; torch has no cbrt, and |x|^(1/3) in float64
    rounds within an ulp of jnp.cbrt."""
    jpack, tpack = packs
    jy, jp, ty, tp = _dvdt0_storms(storms, case)
    want = np.asarray(jfast.init_m_dvdt0(jpack, CFG, jy.lon, jy.lat, jy.v,
                                         jp))
    got = fast.init_m_dvdt0(tpack, CFG, ty.lon, ty.lat, ty.v, tp).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
