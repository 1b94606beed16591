"""The integration modes (time_interp_fields, rk_exact_stage_fields,
rk_substeps > 1) of the port's plain twins against the JAX package's, on
one synthetic pack (91x180, 12 planes) with the same numpy inputs and the
same Fourier draws.

Tolerances, with their reasons:
- sample_fields_at_time: rtol 1e-6 plus an atol of 1e-6 of each field's
  largest magnitude (a few float32 ulps: XLA on the CPU may contract the
  lerp's multiply-add into one rounding, torch rounds twice);
- a 361-step segment: test_torch_pipeline.TRACK_TOL on the samples alive
  in both, with >= 99.5% of storms on the same alive history: the same
  rounding seeds, grown by 4 RK stages per (sub)step, can flip a
  borderline termination;
- a 2048-seed multi-segment launch with rk_substeps=2: tolerance (a) of
  tests/test_torch_pipeline.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import (CFG, SEG, TRACK_TOL, _assert_launches_match,
                                 _jax_launch)
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import kernels, rng
from tropical_cyclone_risk_tpu_torch.models import (fast, fields, pipeline,
                                                    simulator)
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins

N = 64
N_STEPS = 361
MODES = {
    'time_interp': dict(time_interp_fields=True),
    'exact_stage': dict(rk_exact_stage_fields=True),
    'substeps2': dict(rk_substeps=2),
    'time_interp_substeps2': dict(time_interp_fields=True, rk_substeps=2),
}
ALIVE_AGREE = 0.995


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(CFG, 12, 91, 180, seed=0)
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


@pytest.fixture(scope='module')
def storms():
    """Ocean genesis positions in the western Pacific, intensities, planes
    (the last one among them) and Fourier draws from one key."""
    r = np.random.default_rng(11)
    lon = r.uniform(130.0, 170.0, N).astype(np.float32)
    lat = r.uniform(8.0, 25.0, N).astype(np.float32)
    v = r.uniform(15.0, 30.0, N).astype(np.float32)
    m = r.uniform(0.4, 0.8, N).astype(np.float32)
    plane = r.integers(0, 12, N).astype(np.int32)
    plane[:4] = 11
    h_bl = np.full(N, 1400.0, np.float32)
    fj = jfourier.draw_fourier(jax.random.key(5), (N, 4), CFG.T_fourier_s)
    jy = jfast.State(*(jnp.asarray(x) for x in (lon, lat, v, m)))
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl), fj)
    ty = fast.State(*(torch.from_numpy(x) for x in (lon, lat, v, m)))
    tp = fast.SeedParams(
        torch.from_numpy(plane.astype(np.int64)), torch.from_numpy(h_bl),
        fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                              torch.from_numpy(np.array(fj.B)),
                              CFG.T_fourier_s))
    return jy, jp, ty, tp


@pytest.mark.parametrize('t_days, last_plane', [
    (0.0, False), (15.0, False), (40.0, False), (15.0, True)],
    ids=['t0', 'mid_month', 'past_month', 'last_plane'])
def test_sample_fields_at_time(packs, storms, t_days, last_plane):
    """t = 0 (tau 0), mid-month, past one month (tau clamped to 1) and
    every storm on the last plane (p1 clamped)."""
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    cfg = CFG.replace(time_interp_fields=True)
    t = np.float32(t_days * 86400.0)
    plane = np.full(N, 11, np.int32) if last_plane else np.asarray(jp.plane)
    ref = jax.jit(lambda pack, lon, lat, pl, tt: jfast.sample_fields_at_time(
        jfields.build_stacks(pack), cfg, lon, lat, pl, tt))(
            jpack, jy.lon, jy.lat, jnp.asarray(plane), jnp.asarray(t))
    got = fast.sample_fields_at_time(
        fields.build_stacks(tpack), cfg, ty.lon, ty.lat,
        torch.from_numpy(plane.astype(np.int64)), float(t))
    for name, a, b in zip(fast.FieldSample._fields, got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max() + 1e-30,
                                   err_msg=name)


@pytest.mark.parametrize('mode, blocks', [
    ('exact_stage', False), ('substeps2', False), ('time_interp', True)])
def test_segment_plan_under_modes(mode, blocks):
    """No strided blocks when F(t) is evaluated per stage or substep; time
    interpolation alone keeps them."""
    stride, n_blocks = simulator.segment_plan(CFG.replace(**MODES[mode]), 60)
    assert stride == CFG.field_sample_stride
    assert n_blocks == (60 // stride if blocks else 0)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_integrate_segment_modes(packs, storms, mode):
    """361 steps of 64 storms from one carry in each mode, against the JAX
    package's integrate_segment (found: every alive history equal in every
    mode; at most 4.6e-5 deg, 1.9e-5 m/s in v, 6.7e-6 m/s in the winds,
    2.4e-7 in m)."""
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    cfg = CFG.replace(**MODES[mode])
    bounds = jbasins.basin_bounds(cfg, 'GL')
    alive0 = np.ones(N, bool)

    @functools.partial(jax.jit, static_argnums=(4,))
    def ref(pack, y, a0, params, n):
        return jsim.integrate_segment(jfields.build_stacks(pack), cfg, bounds,
                                      y, a0, params, 0, n)

    outs_j, (yend_j, aend_j) = ref(jpack, jy, jnp.asarray(alive0), jp,
                                   N_STEPS)
    kernels.reset_counts()
    outs, (yend, aend) = simulator.integrate_segment(
        fields.build_stacks(tpack), cfg, basins.basin_bounds(cfg, 'GL'), ty,
        torch.from_numpy(alive0), tp, 0, N_STEPS)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    al, al_j = outs[5].numpy(), np.asarray(outs_j[5])
    assert al.shape == (N_STEPS, N) and outs[4].shape == (N_STEPS, N, 4)
    same = (al == al_j).all(axis=0) & (aend.numpy() == np.asarray(aend_j))
    assert same.mean() >= ALIVE_AGREE
    assert al[:, same].sum() > 20 * N      # storms live for days
    both = al & al_j
    for name, a, b in zip(('lon', 'lat', 'v', 'm', 'wnds'), outs, outs_j):
        a, b = a.numpy(), np.asarray(b)
        msk = both if a.ndim == 2 else both[..., None].repeat(4, -1)
        np.testing.assert_allclose(a[msk], b[msk], rtol=0,
                                   atol=TRACK_TOL[name], err_msg=name)
    end = aend.numpy() & np.asarray(aend_j)
    for name, a, b in zip(('lon', 'lat', 'v', 'm'), yend, yend_j):
        np.testing.assert_allclose(a.numpy()[end], np.asarray(b)[end],
                                   rtol=0, atol=TRACK_TOL[name],
                                   err_msg=name)


def test_substeps_launch_matches_jax(packs):
    """A 2048-seed launch with three segments and rk_substeps=2 in both
    packages agrees under tolerance (a)."""
    cfg = CFG.replace(rk_substeps=2, **SEG)
    m = pipeline.launch_width(cfg, CFG.seed_batch)
    assert len(pipeline.seg_schedule(cfg, m)) == 2
    port = tuple({k: np.asarray(v) for k, v in d.items()}
                 for d in pipeline._simulate_batch(
                     rng.key(5), packs[1], cfg, 'GL', CFG.seed_batch, 256, 0))
    _assert_launches_match(port, _jax_launch(packs, cfg, 5))
