"""Four and five steering levels, (250, 500, 700, 850) hPa (the levels
of CMIP6's plev8 from 250 to 850 hPa) and (250, 300, 500, 700, 850), in
the port: its twin against the JAX package on the CPU (integrate_segment
in every mode of tests/test_torch_levels.py's MODES at four levels, in the
default and time_interp_fields modes at five; genesis_alive;
run_downscaling's file; the coloring at 7 and 15 levels), and the host
side of the kernels' instances: K1's and K7's parameter blocks read back
against csrc/integrator.cu read_params (the units TC_K1_LEVELS=4, 5, 7
and 15), K2's block at 8, 10 and 30 winds, K5's row entry at 8, 10 and 30
channels, K4's stitch at 8 and 10 winds.  The kernels themselves run only
on the card (chip_smoke.py [levels4] and [levels]).  Small size: the
46x90 synthetic pack, 512 seeds per launch, 64 storms for the segments.

Tolerances are tests/test_torch_levels.py's, with its reasons: the tracks
file within 1e-3 deg in lat/lon and TRACK_TOL in the winds,
seeds_per_month and months equal; a segment on the samples alive in both
within TRACK_TOL with >= 99.5% of storms on the same alive history; the
genesis gate's keep mask exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_levels import (MODES, N, k1_params_match,
                               row_entry_matches,
                               run_downscaling_matches_jax,
                               segment_matches_jax, stitch_matches, storms_of)
from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
from tropical_cyclone_risk_tpu_torch.models import fast, fields, simulator

LEVELS4 = dict(steering_levels=(250, 500, 700, 850),
               steering_coefs=(0.1, 0.2, 0.2, 0.5),
               y_alpha=(0.1, 0.2, 0.2, 0.5), m_alpha=(0.001, 0.0, 0.0, -0.001),
               alpha_max=(0.4, 0.4, 0.4, 0.9),
               alpha_min=(0.05, 0.05, 0.05, 0.5))
CFG = Namelist(seed_batch=512, **LEVELS4)
JCFG = JNamelist(seed_batch=512, **LEVELS4)
SHEAR = (0, 1, 6, 7)
# five levels, and the level sets of chip_smoke.py's [levels4] phase: seven
# (plev19 from 250 to 850 hPa) and fifteen (the ERA5 request's levels
# there), with coefficients that sum to one as the namelist's do
LEVELS = {4: LEVELS4}
for _lv in ((250, 300, 500, 700, 850), (250, 300, 400, 500, 600, 700, 850),
            (250, 300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775,
             800, 825, 850)):
    _n = len(_lv)
    LEVELS[_n] = dict(steering_levels=_lv,
                      steering_coefs=(0.5 / (_n - 1),) * (_n - 1) + (0.5,),
                      y_alpha=(0.5 / (_n - 1),) * (_n - 1) + (0.5,),
                      m_alpha=(0.001,) + (0.0,) * (_n - 2) + (-0.001,),
                      alpha_max=(0.4,) * (_n - 1) + (0.9,),
                      alpha_min=(0.05,) * (_n - 1) + (0.5,))


def cfgs(levels):
    """(port, JAX) namelists at `levels` steering levels."""
    return (Namelist(seed_batch=512, **LEVELS[levels]),
            JNamelist(seed_batch=512, **LEVELS[levels]))


@functools.cache
def packs_of(levels):
    """The JAX package's 12-plane 46x90 synthetic pack at `levels` steering
    levels and the port's copy of it (once per module and count)."""
    jpack = jfields.synthetic_pack(cfgs(levels)[1], 12, 46, 90, seed=0)
    W = 2 * levels
    assert jpack.wind.shape[-1] == W + W * (W + 1) // 2
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


@pytest.fixture(scope='module')
def packs():
    return packs_of(4)


storms = functools.cache(storms_of)


def shear_of(levels):
    """The deep-layer shear's channels: 250 hPa first, 850 hPa last."""
    return (0, 1, 2 * levels - 2, 2 * levels - 1)


@pytest.mark.parametrize('levels, mode', [
    *(pytest.param(4, m, id=m) for m in MODES),
    *(pytest.param(5, m, id=f'L5-{m}') for m in ('default', 'time_interp'))])
def test_integrate_segment_four_levels_matches_jax(levels, mode):
    """test_torch_levels.segment_matches_jax at four levels in each of
    MODES, and at five in the default and time_interp_fields modes; the
    winds [T, N, 2 L], the shear on 250 and 850 hPa ((0, 1, 6, 7) at four
    levels)."""
    cfg, jcfg = (c.replace(**MODES[mode]) for c in cfgs(levels))
    assert fast.deep_layer_indices(cfg) == shear_of(levels)
    assert jfast.deep_layer_indices(jcfg) == shear_of(levels)
    segment_matches_jax(*packs_of(levels), storms(2 * levels), cfg, jcfg)


@pytest.mark.parametrize('levels', [4, 5], ids=['L4', 'L5'])
def test_genesis_alive_four_levels_matches_jax(levels):
    """The step-0 gate at four and five levels: the twin's keep mask is
    the JAX package's, and no kernel is launched."""
    jpack, tpack = packs_of(levels)
    jy, jp, ty, tp = storms(2 * levels)
    cfg, jcfg = cfgs(levels)
    mask = np.random.default_rng(2).random(N) < 0.9
    keep_j = jax.jit(lambda pack, y, p, msk: jsim.genesis_alive(
        pack, jcfg, y, p, msk))(jpack, jy, jp, jnp.asarray(mask))
    kernels.reset_counts()
    keep = simulator.genesis_alive(fields.build_stacks(tpack), cfg, ty, tp,
                                   torch.from_numpy(mask))
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert keep.any() and not keep.all()


@pytest.mark.parametrize('levels', [4, 5], ids=['L4', 'L5'])
def test_run_downscaling_four_levels_matches_jax(levels, tmp_path):
    """test_torch_levels.run_downscaling_matches_jax at four and five
    levels, every u/v{level}_trks finite at genesis.  The launch is not
    compacted (integrate_cap 1.0): the JAX package then compiles one
    segment, not the auto-tuned schedule's ten, which keeps the test to a
    few seconds; the compacted launches at four and five levels are held
    against the twins on the card (chip_smoke.py [levels4], [levels]), the
    twins' compaction at three levels against JAX in
    tests/test_torch_levels.py."""
    run_kw = dict(tracks_per_year=2, start_year=2016, end_year=2016,
                  exp_name=f'w{levels}', integrate_cap=1.0)
    cfg, jcfg = (c.replace(**run_kw) for c in cfgs(levels))
    dt = run_downscaling_matches_jax(*packs_of(levels), cfg, jcfg, tmp_path)
    for lv in cfg.steering_levels:
        assert np.isfinite(dt.variables[f'u{lv}_trks'].data[:, 0]).all()


@pytest.mark.parametrize('W', [14, 30])
def test_color_winds_many_levels_matches_jax(W):
    """The twin's coloring (fast.color_winds_given_f: the unrolled Cholesky
    of ops/chol.py and the j = 0..W-1 sum, the one K1 keeps rolled from five
    levels) against the JAX package's at 7 and 15 levels, on 400 samples of
    the synthetic pack's covariance (off-diagonals 0.2 base cos(lon),
    diagonals 1 to 1 + 0.1 (W - 1) times base: positive definite at some
    longitudes only) and perturbed ones: zero winds at the same samples,
    the others within TRACK_TOL's winds.  JAX runs op by op, as its
    compile of the unrolled factor would take minutes at W = 30."""
    from test_torch_pipeline import TRACK_TOL
    cfg, jcfg = cfgs(W // 2)
    r = np.random.default_rng(W)
    n = 400
    base = r.uniform(5.0, 40.0, n)
    cos_lon = np.cos(np.deg2rad(r.uniform(0.0, 360.0, n)))
    i, j = np.tril_indices(W)
    tri = np.where(i == j, base[:, None] * (1.0 + 0.1 * i),
                   0.2 * base[:, None] * cos_lon[:, None])
    tri += r.normal(0.0, 0.05, tri.shape) * base[:, None]
    stats = np.concatenate([r.normal(0.0, 5.0, (n, W)), tri], axis=1)
    stats = stats.astype(np.float32)
    f = r.normal(0.0, 1.0, (n, W)).astype(np.float32)
    got = fast.color_winds_given_f(cfg, torch.from_numpy(stats),
                                   torch.from_numpy(f)).numpy()
    with jax.disable_jit():     # op by op: XLA would compile W^3/6 steps
        want = np.asarray(jfast.color_winds_given_f(jcfg, jnp.asarray(stats),
                                                    jnp.asarray(f)))
    zero, zero_j = (got == 0).all(axis=1), (want == 0).all(axis=1)
    np.testing.assert_array_equal(zero, zero_j)
    assert 0.2 < zero.mean() < 0.8
    np.testing.assert_allclose(got[~zero], want[~zero], rtol=0,
                               atol=TRACK_TOL['wnds'])


@pytest.mark.parametrize('levels, diag', [
    pytest.param(4, False, id='False'), pytest.param(4, True, id='True'),
    *(pytest.param(lv, d, id=f'L{lv}-{d}') for lv in (5, 7, 15)
      for d in (False, True))])
def test_k1_params_four_levels(packs, levels, diag):
    """test_torch_levels.k1_params_match at 4, 5, 7 and 15 levels: the
    shear on 250 and 850 hPa ((0, 1, 6, 7) at four levels), the wind-stat
    channels (44 at four levels) in the in-cell row (204 floats at four
    levels, 196 with land and bathymetry on a grid of their own; 2008 and
    2000 at fifteen)."""
    if levels == 4:
        stacks, cfg = fields.build_stacks(packs[1]), CFG
        assert stacks.cell4.shape[-1] == integrator.cell_row(
            integrator.IN_CELL, 4) == 204
        assert integrator.cell_row(integrator.FUSED_GEO, 4) == 196
    else:
        cfg = cfgs(levels)[0]
        stacks = fields.build_stacks(fields.synthetic_pack(cfg, 2, 10, 20,
                                                           device='cpu'))
    W = 2 * levels
    assert stacks.n_wind_ch == integrator.wind_channels(levels) == (
        W + W * (W + 1) // 2)
    assert stacks.cell4.shape[-1] == integrator.cell_row(
        integrator.IN_CELL, levels)
    assert integrator.cell_row(integrator.IN_CELL, 15) == 2008
    assert integrator.cell_row(integrator.FUSED_GEO, 15) == 2000
    assert integrator.levels(cfg) == levels
    k1_params_match(stacks, cfg, shear_of(levels), diag)


@pytest.mark.parametrize('W', [8, 10, 30])
def test_k2_block_eight_winds(W):
    """K2's block at W = 8, 10 and 30 (four, five and fifteen levels; the
    last two take the run-time-stride instance): the winds per sample at
    ip[12] and the shear channels; the wrappers take these winds (CPU
    tensors: ValueError for the device) and check that each shear pair is
    an aligned (u, v)."""
    shear = shear_of(W // 2)
    ip, _ = k2._block(60, 4096, 15, None, None, shear, (128, 32, 4), W,
                      3600.0)
    assert ip.tolist() == [60, 4096, 15, 0, 0, *shear, 128, 32, 4, W]
    T, n = 5, 8
    assert k2._check_winds(torch.zeros(T, n, W), T, n, shear,
                           torch.device('cpu')) == W
    with pytest.raises(ValueError, match='pairs'):
        k2._check_winds(torch.zeros(T, n, W), T, n, (1, 2, W - 2, W - 1),
                        torch.device('cpu'))
    t = torch.zeros(T, n)
    alive = torch.ones(T, n, dtype=torch.bool)
    last = torch.zeros(n, dtype=torch.int64)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        k2.axi_to_max_wind_raw_cuda(t, t, 3600.0, t, torch.zeros(T, n, W),
                                    alive, last, shear)
    with pytest.raises(ValueError, match='CUDA'):
        k2.fix_last_sample_cuda(t.clone(), t, t, t, torch.zeros(T, n, W),
                                alive, last, 3600.0, shear)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize('C', [8, 10, 30])
def test_k5_row_entry_eight_channels(C):
    """test_torch_levels.row_entry_matches at the 8, 10 and 30 wind
    channels of four, five and fifteen levels (the last two through the
    run-time-count instance on the card)."""
    row_entry_matches(C)


@pytest.mark.parametrize('W', [8, 10])
def test_k4_stitch_block_eight_winds(W):
    """test_torch_levels.stitch_matches at W = 8 and 10."""
    stitch_matches(W)
