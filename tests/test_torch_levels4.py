"""Four steering levels, (250, 500, 700, 850) hPa (the levels of CMIP6's
plev8 from 250 to 850 hPa), in the port: its twin against the JAX package
on the CPU (integrate_segment in every mode of tests/test_torch_levels.py's
MODES, genesis_alive, run_downscaling's file), and the host side of the
kernels' four-level instances: K1's and K7's parameter blocks read back
against csrc/integrator.cu read_params (the unit TC_K1_LEVELS=4), K2's
block at eight winds, K5's row entry at eight channels, K4's stitch at
eight winds.  The kernels themselves run only on the card (chip_smoke.py
[levels4]).  Small size: the 46x90 synthetic pack, 512 seeds per launch,
64 storms for the segments.

Tolerances are tests/test_torch_levels.py's, with its reasons: the tracks
file within 1e-3 deg in lat/lon and TRACK_TOL in the winds,
seeds_per_month and months equal; a segment on the samples alive in both
within TRACK_TOL with >= 99.5% of storms on the same alive history; the
genesis gate's keep mask exact.
"""

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


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(JCFG, 12, 46, 90, seed=0)
    assert jpack.wind.shape[-1] == 8 + 36
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


@pytest.fixture(scope='module')
def storms():
    return storms_of(8)


@pytest.mark.parametrize('mode', list(MODES))
def test_integrate_segment_four_levels_matches_jax(packs, storms, mode):
    """test_torch_levels.segment_matches_jax at four levels in each of
    MODES; the winds [T, N, 8], the shear on channels (0, 1, 6, 7)."""
    cfg = CFG.replace(**MODES[mode])
    assert fast.deep_layer_indices(cfg) == SHEAR
    assert jfast.deep_layer_indices(JCFG) == SHEAR
    segment_matches_jax(*packs, storms, cfg, JCFG.replace(**MODES[mode]))


def test_genesis_alive_four_levels_matches_jax(packs, storms):
    """The step-0 gate at four levels: the twin's keep mask is the JAX
    package's, and no kernel is launched."""
    jpack, tpack = packs
    jy, jp, ty, tp = storms
    mask = np.random.default_rng(2).random(N) < 0.9
    keep_j = jax.jit(lambda pack, y, p, msk: jsim.genesis_alive(
        pack, JCFG, y, p, msk))(jpack, jy, jp, jnp.asarray(mask))
    kernels.reset_counts()
    keep = simulator.genesis_alive(fields.build_stacks(tpack), CFG, ty, tp,
                                   torch.from_numpy(mask))
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert keep.any() and not keep.all()


def test_run_downscaling_four_levels_matches_jax(packs, tmp_path):
    """test_torch_levels.run_downscaling_matches_jax at four levels, every
    u/v{level}_trks finite at genesis.  The launch is not compacted
    (integrate_cap 1.0): the JAX package then compiles one segment, not
    the auto-tuned schedule's ten, which keeps the test to a few seconds;
    the compacted four-level launch is held against the twins on the card
    (chip_smoke.py [levels4]), the twins' compaction at three levels
    against JAX in tests/test_torch_levels.py."""
    run_kw = dict(tracks_per_year=2, start_year=2016, end_year=2016,
                  exp_name='w4', integrate_cap=1.0)
    cfg = CFG.replace(**run_kw)
    dt = run_downscaling_matches_jax(*packs, cfg, JCFG.replace(**run_kw),
                                     tmp_path)
    for lv in cfg.steering_levels:
        assert np.isfinite(dt.variables[f'u{lv}_trks'].data[:, 0]).all()


@pytest.mark.parametrize('diag', [False, True])
def test_k1_params_four_levels(packs, diag):
    """test_torch_levels.k1_params_match at four levels: the shear on
    channels (0, 1, 6, 7), the 44 wind-stat channels in a 204-float
    in-cell row (196 with land and bathymetry on a grid of their own)."""
    _, tpack = packs
    stacks = fields.build_stacks(tpack)
    assert stacks.n_wind_ch == integrator.wind_channels(4) == 44
    assert stacks.cell4.shape[-1] == integrator.cell_row(
        integrator.IN_CELL, 4) == 204
    assert integrator.cell_row(integrator.FUSED_GEO, 4) == 196
    assert integrator.levels(CFG) == 4
    k1_params_match(stacks, CFG, SHEAR, diag)


def test_k2_block_eight_winds():
    """K2's block at W = 8: the winds per sample at ip[12] and the shear
    channels; the wrappers take eight winds (CPU tensors: ValueError for
    the device) and check that each shear pair is an aligned (u, v)."""
    assert 8 in k2.W_TAKEN
    ip, _ = k2._block(60, 4096, 15, None, None, SHEAR, (128, 32, 4), 8,
                      3600.0)
    assert ip.tolist() == [60, 4096, 15, 0, 0, *SHEAR, 128, 32, 4, 8]
    T, n = 5, 8
    assert k2._check_winds(torch.zeros(T, n, 8), T, n, SHEAR,
                           torch.device('cpu')) == 8
    with pytest.raises(ValueError, match='pairs'):
        k2._check_winds(torch.zeros(T, n, 8), T, n, (1, 2, 6, 7),
                        torch.device('cpu'))
    t = torch.zeros(T, n)
    alive = torch.ones(T, n, dtype=torch.bool)
    last = torch.zeros(n, dtype=torch.int64)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        k2.axi_to_max_wind_raw_cuda(t, t, 3600.0, t, torch.zeros(T, n, 8),
                                    alive, last, SHEAR)
    with pytest.raises(ValueError, match='CUDA'):
        k2.fix_last_sample_cuda(t.clone(), t, t, t, torch.zeros(T, n, 8),
                                alive, last, 3600.0, SHEAR)
    assert not any(kernels.LAUNCHES.values())


def test_k5_row_entry_eight_channels():
    """test_torch_levels.row_entry_matches at the eight wind channels of
    four levels."""
    row_entry_matches(8)


def test_k4_stitch_block_eight_winds():
    """test_torch_levels.stitch_matches at W = 8."""
    stitch_matches(8)
