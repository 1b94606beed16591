"""Three steering levels, (250, 500, 850) hPa with the coefficients of JAX
tests/test_simulator.py:421-425, in the port: its twin against the JAX
package on the CPU (run_downscaling for one year, integrate_segment in
four modes), and the host side of the kernels that take them: K1's and
K7's parameter blocks read back against csrc/integrator.cu read_params,
K2's and K4's blocks against csrc/vmax.cu and csrc/compact.cu, K5's row
entry's channel argument.  The kernels themselves run only on the card
(chip_smoke.py [levels]).  Small size: the 46x90 synthetic pack, 512
seeds per launch, 64 storms for the segments.

Tolerances, with their reasons (tests/test_torch_pipeline.py's and
tests/test_torch_modes.py's): the tracks file within 1e-3 deg in lat/lon
and 1e-2 m/s in the winds, seeds_per_month and months equal; a segment on
the samples alive in both within TRACK_TOL with >= 99.5% of storms on the
same alive history: XLA on the CPU contracts multiply-adds and rounds
transcendentals otherwise, and the RK stages grow those seeds.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import TRACK_TOL
from tropical_cyclone_risk_tpu import runtime as jruntime
from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.io import netcdf as jnetcdf
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu.utils import basins as jbasins
from tropical_cyclone_risk_tpu_torch import kernels, runtime
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
from tropical_cyclone_risk_tpu_torch.models import fast, fields, simulator
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins

LEVELS3 = dict(steering_levels=(250, 500, 850), steering_coefs=(0.1, 0.2, 0.7),
               y_alpha=(0.1, 0.2, 0.7), m_alpha=(0.001, 0.0, -0.001),
               alpha_max=(0.4, 0.4, 0.9), alpha_min=(0.05, 0.05, 0.5))
CFG = Namelist(seed_batch=512, **LEVELS3)
JCFG = JNamelist(seed_batch=512, **LEVELS3)
CSRC = Path(integrator.__file__).resolve().parents[1] / 'csrc'
N = 64
N_STEPS = 121
ALIVE_AGREE = 0.995
MODES = {'default': {}, 'per_step': dict(field_sample_stride=1),
         'time_interp': dict(time_interp_fields=True),
         'substeps2': dict(rk_substeps=2)}


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(JCFG, 12, 46, 90, seed=0)
    assert jpack.wind.shape[-1] == 6 + 21
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


def run_downscaling_matches_jax(jpack, tpack, cfg, jcfg, tmp_path):
    """run_downscaling for one year from the same seed (3) in both
    packages on cfg / jcfg: the same variables (every u/v{level}_trks
    among them), dims and dtypes, the same seeds_per_month and months, the
    tracks within 1e-3 deg and their winds within TRACK_TOL, the 500 hPa
    winds finite at genesis.  Returns the port's file."""
    files = {}
    for name, run, pack, c, kw in (
            ('jax', jruntime.run_downscaling, jpack, jcfg,
             {'key': jax.random.key(3)}),
            ('torch', runtime.run_downscaling, tpack, cfg, {'seed': 3})):
        c = c.replace(output_directory=str(tmp_path / name))
        files[name] = (jnetcdf if name == 'jax' else netcdf).read(
            run(c, 'GL', pack, **kw))
    dj, dt = files['jax'], files['torch']
    assert set(dt.variables) == set(dj.variables)
    winds = [f'{c}{lv}_trks' for lv in cfg.steering_levels for c in 'uv']
    assert set(winds) <= set(dt.variables)
    for k, vj in dj.variables.items():
        vt = dt.variables[k]
        assert (vt.dims, vt.data.dtype, vt.data.shape) == (
            vj.dims, vj.data.dtype, vj.data.shape), k
    assert dt.variables['lon_trks'].data.shape[0] == cfg.tracks_per_year
    for k in ('seeds_per_month', 'tc_month'):
        np.testing.assert_array_equal(dt.variables[k].data,
                                      dj.variables[k].data, err_msg=k)
    for k, tol in [('lon_trks', 1e-3), ('lat_trks', 1e-3)] + [
            (w, TRACK_TOL['wnds']) for w in winds]:
        np.testing.assert_allclose(dt.variables[k].data, dj.variables[k].data,
                                   rtol=0, atol=tol, err_msg=k)
    assert np.isfinite(dt.variables['u500_trks'].data[:, 0]).all()
    return dt


def test_run_downscaling_three_levels_matches_jax(packs, tmp_path):
    """run_downscaling_matches_jax at three levels (all six
    u/v{250,500,850}_trks); the deep-layer shear on 250 and 850 hPa,
    skipping 500 (JAX tests/test_simulator.py:415)."""
    run_kw = dict(tracks_per_year=2, start_year=2016, end_year=2016,
                  exp_name='w3')
    cfg = CFG.replace(**run_kw)
    assert fast.deep_layer_indices(cfg) == (0, 1, 4, 5)
    assert jfast.deep_layer_indices(JCFG) == (0, 1, 4, 5)
    run_downscaling_matches_jax(*packs, cfg, JCFG.replace(**run_kw),
                                tmp_path)


def storms_of(W):
    """Ocean genesis positions, intensities, planes and Fourier draws of W
    wind channels, the same on both sides."""
    r = np.random.default_rng(13)
    lon = r.uniform(130.0, 170.0, N).astype(np.float32)
    lat = r.uniform(8.0, 25.0, N).astype(np.float32)
    v = r.uniform(15.0, 30.0, N).astype(np.float32)
    m = r.uniform(0.4, 0.8, N).astype(np.float32)
    plane = r.integers(0, 12, N).astype(np.int32)
    h_bl = np.full(N, 1400.0, np.float32)
    fj = jfourier.draw_fourier(jax.random.key(5), (N, W), CFG.T_fourier_s)
    jy = jfast.State(*(jnp.asarray(x) for x in (lon, lat, v, m)))
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl), fj)
    ty = fast.State(*(torch.from_numpy(x) for x in (lon, lat, v, m)))
    tp = fast.SeedParams(
        torch.from_numpy(plane.astype(np.int64)), torch.from_numpy(h_bl),
        fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                              torch.from_numpy(np.array(fj.B)),
                              CFG.T_fourier_s))
    return jy, jp, ty, tp


@pytest.fixture(scope='module')
def storms():
    return storms_of(6)


def segment_matches_jax(jpack, tpack, storms, cfg, jcfg):
    """N_STEPS steps of the N storms from one carry on cfg / jcfg against
    the JAX package's integrate_segment: no kernel launched, the winds
    [T, N, W], ALIVE_AGREE of the storms on the same alive history, the
    samples alive in both within TRACK_TOL."""
    jy, jp, ty, tp = storms
    W = cfg.n_wind_levels
    bounds = jbasins.basin_bounds(jcfg, 'GL')
    alive0 = np.ones(N, bool)

    @functools.partial(jax.jit, static_argnums=(4,))
    def ref(pack, y, a0, params, n):
        return jsim.integrate_segment(jfields.build_stacks(pack), jcfg,
                                      bounds, y, a0, params, 0, n)

    outs_j, (_, aend_j) = ref(jpack, jy, jnp.asarray(alive0), jp, N_STEPS)
    kernels.reset_counts()
    outs, (_, aend) = simulator.integrate_segment(
        fields.build_stacks(tpack), cfg, basins.basin_bounds(cfg, 'GL'), ty,
        torch.from_numpy(alive0), tp, 0, N_STEPS)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    assert outs[4].shape == (N_STEPS, N, W)
    al, al_j = outs[5].numpy(), np.asarray(outs_j[5])
    same = (al == al_j).all(axis=0) & (aend.numpy() == np.asarray(aend_j))
    assert same.mean() >= ALIVE_AGREE
    both = al & al_j & same[None]
    for i, nm in enumerate(('lon', 'lat', 'v', 'm', 'wnds')):
        a, b = outs[i].numpy(), np.asarray(outs_j[i])
        msk = both if a.ndim == 2 else both[..., None].repeat(W, -1)
        np.testing.assert_allclose(a[msk], b[msk], rtol=0,
                                   atol=TRACK_TOL[nm], err_msg=nm)


@pytest.mark.parametrize('mode', list(MODES))
def test_integrate_segment_three_levels_matches_jax(packs, storms, mode):
    """segment_matches_jax at three levels in the default strided,
    per-step, time-interpolated and sub-stepped modes; the winds [T, N,
    6]."""
    segment_matches_jax(*packs, storms, CFG.replace(**MODES[mode]),
                        JCFG.replace(**MODES[mode]))


def _fp_names(levels):
    """The float parameters of csrc/integrator.cu read_params, in the
    order it reads them: read_grid's four, a loop over the levels or the
    Fourier components, or one."""
    src = (CSRC / 'integrator.cu').read_text()
    body = src[src.index('void read_params('):]
    body = body[:body.index('\n}\n')]
    names = []
    for m in re.finditer(r'read_grid\(fp, &p\.(\w+)\)|'
                         r'for \(int \w+ = 0; \w+ < (kLevels|kNF); \+\+\w+\) '
                         r'p\.(\w+)\[\w+\] = \*fp\+\+;|'
                         r'([\w.]+) = \*fp\+\+;', body):
        if m.group(1):
            names += [f'{m.group(1)}.{c}' for c in ('lon0', 'dlon', 'lat0',
                                                    'dlat')]
        elif m.group(3):
            n = levels if m.group(2) == 'kLevels' else 15
            names += [f'p.{m.group(3)}[{i}]' for i in range(n)]
        else:
            names.append(m.group(4))
    return names


def _ip_names():
    src = (CSRC / 'integrator.cu').read_text()
    body = src[src.index('void read_params('):]
    body = body[:body.index('\n}\n')]
    return re.findall(r'([\w.\[\]]+) = \*ip\+\+;', body)


def k1_params_match(stacks, cfg, shear, diag):
    """K1's parameter block on cfg's L levels: the per-level steering
    coefficients where read_params reads each, the deep-layer shear's four
    channels, the unit (L levels, the in-scan vmax or not), t_last, and
    the float32 reciprocal of the output interval of vmax_at; K7's block
    is K1's."""
    L = cfg.n_steering_levels
    geometry = integrator.launch_geometry(4097, 132)
    fp, ip = integrator._params(stacks, cfg, (0.0, -60.0, 360.0, 60.0), 4097,
                                60, 3, 20, 0, 1.0, False, geometry, diag, 180)
    fnames, inames = _fp_names(L), _ip_names()
    assert len(fnames) == fp.size and len(inames) == ip.size
    f = dict(zip(fnames, fp.tolist()))
    for name in ('y_alpha', 'm_alpha', 'alpha_min', 'alpha_max'):
        np.testing.assert_array_equal(
            [f[f'p.{name}[{i}]'] for i in range(L)],
            np.float32(getattr(cfg, name)), err_msg=name)
    np.testing.assert_array_equal([f[f'p.steer[{i}]'] for i in range(L)],
                                  np.float32(cfg.steering_coefs))
    assert f['p.vc.inv_dt'] == np.float32(1.0) / np.float32(3600.0)
    assert f['p.dt_out'] == 3600.0
    i = dict(zip(inames, ip.tolist()))
    assert (i['p.iu2'], i['p.iv2'], i['p.iu8'], i['p.iv8']) == shear
    assert (i['l.levels'], i['l.diag'], i['p.t_last']) == (L, int(diag), 180)
    assert tuple(ip[-3:]) == geometry
    fg, ig = integrator.gate_params(stacks, cfg, 1000)
    np.testing.assert_array_equal(fg, integrator._params(
        stacks, cfg, (0.0,) * 4, 1000, 0, 1, 0, 0, 0.0, False, (0, 0, 0))[0])
    assert dict(zip(inames, ig.tolist()))['l.levels'] == L


@pytest.mark.parametrize('diag', [False, True])
def test_k1_params_three_levels(packs, diag):
    """k1_params_match at three levels: the shear on channels (0, 1, 4,
    5), the 27 wind-stat channels in a 136-float in-cell row."""
    _, tpack = packs
    stacks = fields.build_stacks(tpack)
    assert stacks.n_wind_ch == integrator.wind_channels(3) == 27
    assert stacks.cell4.shape[-1] == integrator.cell_row(
        integrator.IN_CELL, 3) == 136
    k1_params_match(stacks, CFG, (0, 1, 4, 5), diag)


def test_k1_k7_wrappers_take_three_levels(packs):
    """The wrappers take three levels, four and five: on CPU tensors
    they refuse the device (ValueError) and launch nothing; levels without
    850 hPa raise fast.deep_layer_indices' ValueError; the units built up
    front are two to four levels, each with and without the in-scan vmax,
    and the level sets of chip_smoke.py's [levels4] phase (five with and
    without it, seven, fifteen and seventeen)."""
    _, tpack = packs
    stacks = fields.build_stacks(tpack)
    r = np.random.default_rng(1)
    n = 8
    y = fast.State(*(torch.tensor(r.uniform(10, 20, n), dtype=torch.float32)
                     for _ in range(4)))
    fs = fourier.FourierSeries(torch.zeros(n, 6, 15), torch.zeros(n, 6, 15),
                               CFG.T_fourier_s)
    params = fast.SeedParams(torch.zeros(n, dtype=torch.int64),
                             torch.full((n,), 1500.0), fs)
    mask = torch.ones(n, dtype=torch.bool)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks, CFG, y, params, mask)
    diag = simulator.DiagState(y.lon, y.lat, torch.full((n,), -np.inf))
    with pytest.raises(ValueError, match='CUDA'):
        integrator.integrate_segment_cuda(
            stacks, CFG, (0.0, -60.0, 360.0, 60.0), y, mask, params, 0, 6,
            torch.zeros(6, n, 6), 3, 2, diag, 5)
    cfg4 = CFG.replace(steering_levels=(250, 500, 700, 850),
                       steering_coefs=(0.1, 0.1, 0.1, 0.7))
    stacks4 = fields.build_stacks(fields.synthetic_pack(cfg4, 2, 10, 20,
                                                          device='cpu'))
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks4, cfg4, y, params, mask)
    cfg5 = CFG.replace(steering_levels=(250, 300, 500, 700, 850),
                       steering_coefs=(0.1, 0.1, 0.1, 0.1, 0.6))
    stacks5 = fields.build_stacks(fields.synthetic_pack(cfg5, 2, 10, 20,
                                                          device='cpu'))
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks5, cfg5, y, params, mask)
    with pytest.raises(ValueError, match='250 and 850'):
        integrator.genesis_gate_cuda(
            stacks5, cfg5.replace(steering_levels=(250, 300, 500, 700, 800)),
            y, params, mask)
    assert not any(kernels.LAUNCHES.values())
    assert integrator.UNITS == ((2, False), (2, True), (3, False),
                                (3, True), (4, False), (4, True),
                                (5, False), (5, True), (7, False),
                                (15, False), (17, False))


def _vmax_source_reads():
    src = (CSRC / 'vmax.cu').read_text()
    return src[src.index('bool read_params('):]


def test_k2_params_six_winds():
    """K2's block at W = 6: the winds per sample at ip[12] where
    read_params reads it, the shear channels (0, 1, 4, 5), and the float32
    reciprocal of the output interval; the wrappers take six winds and
    ten (CPU tensors: ValueError for the device), refuse two and odd
    counts (NotImplementedError) and shear channels that are not two
    (u, v) pairs."""
    body = _vmax_source_reads()
    assert 'const int W = ip[12];' in body
    assert 'W < 4 || W % 2 != 0' in body
    ip, fp = k2._block(60, 4096, 15, None, None, (0, 1, 4, 5), (128, 32, 4),
                       6, 3600.0)
    assert ip.tolist() == [60, 4096, 15, 0, 0, 0, 1, 4, 5, 128, 32, 4, 6]
    assert fp[0] == np.float32(1.0) / np.float32(3600.0)
    T, n = 5, 8
    t = torch.zeros(T, n)
    alive = torch.ones(T, n, dtype=torch.bool)
    last = torch.zeros(n, dtype=torch.int64)
    with pytest.raises(ValueError, match='CUDA'):
        k2.axi_to_max_wind_raw_cuda(t, t, 3600.0, t, torch.zeros(T, n, 6),
                                    alive, last, (0, 1, 4, 5))
    with pytest.raises(ValueError, match='CUDA'):
        k2.fix_last_sample_cuda(t.clone(), t, t, t, torch.zeros(T, n, 6),
                                alive, last, 3600.0, (0, 1, 4, 5))
    assert k2._check_winds(torch.zeros(T, n, 10), T, n, (0, 1, 8, 9),
                           torch.device('cpu')) == 10
    for W in (2, 7):
        with pytest.raises(NotImplementedError, match='winds per sample'):
            k2._check_winds(torch.zeros(T, n, W), T, n, (0, 1, 0, 1),
                            torch.device('cpu'))
    with pytest.raises(ValueError, match='pairs'):
        k2._check_winds(torch.zeros(T, n, 6), T, n, (0, 2, 4, 5),
                        torch.device('cpu'))
    assert k2._check_winds(torch.zeros(T, n, 6), T, n, (0, 1, 4, 5),
                           torch.device('cpu')) == 6


def test_k5_row_entry_channels():
    """K5's row entry takes the channel count as its fourth argument
    (csrc/rng.cu tc_rng_fourier_rows), the twin's draw at the rows is the
    full draw gathered there at six channels, and the wrapper refuses CPU
    tensors before it launches."""
    src = (CSRC / 'rng.cu').read_text()
    sig = src[src.index('extern "C" int tc_rng_fourier_rows('):]
    sig = sig[:sig.index(')')]
    assert re.sub(r'\s+', ' ', sig).split('(')[1].split(', ')[3] == 'int ch'
    row_entry_matches(6)


def row_entry_matches(C):
    """At C wind channels: the twin's draw at the rows is the full draw
    gathered there, and K5's row entry refuses CPU tensors before it
    launches."""
    from tropical_cyclone_risk_tpu_torch import rng
    key, rows = rng.key(3), torch.tensor([5, 0, 7])
    full = fourier.draw_fourier_plain(key, (9, C), CFG.T_fourier_s)
    part = fourier.draw_fourier_plain(key, (9, C), CFG.T_fourier_s,
                                      rows=rows)
    assert part.A.shape == (3, C, 15)
    assert torch.equal(part.A, full.A[rows]) and torch.equal(part.B,
                                                             full.B[rows])
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        k5.fourier_rows_cuda(key, (9, C), rows, fourier._amplitudes('cpu'))
    assert not any(kernels.LAUNCHES.values())


def test_k4_stitch_block_six_winds():
    """K4's stitch block at W = 6: the winds per sample as the fifth
    integer, where tc_k4_stitch reads p.W, and output winds [k, T, 6];
    the plain stitch copies every wind of a survivor's alive samples."""
    src = (CSRC / 'compact.cu').read_text()
    body = src[src.index('extern "C" int tc_k4_stitch('):]
    reads = re.findall(r'(p\.\w+(?:\[f\])?) = [^;]*ip\[q\+\+\]', body)
    assert reads[:5] == ['p.k', 'p.T', 'p.n', 'p.n_segs', 'p.W']
    stitch_matches(6)


def stitch_matches(W):
    """K4's stitch block at W winds per sample (its fifth integer) and
    output winds [k, T, W]; the plain stitch copies every wind of a
    survivor's alive samples and NaN elsewhere."""
    r = np.random.default_rng(2)
    T, w, k = 7, 10, 3
    tm = {f: torch.from_numpy(r.standard_normal((T, w)).astype(np.float32))
          for f in ('lon', 'lat', 'v', 'm', 'vmax')}
    tm['wnds'] = torch.from_numpy(r.standard_normal((T, w, W)).astype(
        np.float32))
    tm['alive'] = torch.from_numpy(r.uniform(size=(T, w)) < 0.7)
    order = torch.tensor([4, 1, 8])
    keep = torch.zeros(w, dtype=torch.bool)
    keep[order] = True
    ip, (out, _), n_kernels = k4._stitch(torch.device('cpu'), order, (tm,),
                                         (), keep, None)
    assert ip[4] == W and n_kernels == 1
    assert out['wnds'].shape == (k, T, W)
    from tropical_cyclone_risk_tpu_torch.ops import compact
    tracks, _ = compact.stitch_survivors(order, (tm,), (), keep, None)
    alive = tm['alive'][:, order].T
    np.testing.assert_array_equal(
        tracks['wnds'][alive].numpy(),
        tm['wnds'][:, order].transpose(0, 1)[alive].numpy())
    assert torch.isnan(tracks['wnds'][~alive]).all()
