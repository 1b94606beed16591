"""The port's thermodynamics, entropy tables and CAPE-PI twin against the
JAX package on the CPU.

Inputs are numpy-seeded float32 arrays handed to both packages: random
(T, p, r, rh) samples over the atmosphere's range for the elementwise
functions, and 28-level tropical soundings (built as in
tests/test_thermo.py) plus land columns (SST 0 K, as thermo_driver's
nan_to_num leaves them) and cold columns (SST 270 K) for CAPE-PI.  Each
test states its tolerance and why.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.ops import pi as jpi
from tropical_cyclone_risk_tpu.ops import thermo as jth
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import cape_pi as k6
from tropical_cyclone_risk_tpu_torch.ops import pi as tpi
from tropical_cyclone_risk_tpu_torch.ops import thermo as tth

sys.path.insert(0, str(Path(__file__).parent))
import golden_pi  # noqa: E402

N = 2000
RNG = np.random.default_rng(11)
f32 = lambda a: np.asarray(a, np.float32)
S = {'T': f32(RNG.uniform(180, 310, N)), 'p': f32(RNG.uniform(5e3, 1.03e5, N)),
     'r': f32(RNG.uniform(1e-5, 0.025, N)), 'sst': f32(RNG.uniform(295, 305, N)),
     'x': f32(-np.exp(RNG.uniform(np.log(1e-6), np.log(0.3678), N)))}
S['r2'] = f32(S['r'] * 1.1)
_Ts, _ps = f32(RNG.uniform(280, 305, N)), f32(RNG.uniform(9.5e4, 1.02e5, N))
_rh = f32(RNG.uniform(0.05, 0.99, N))
S.update(Ts=_Ts, ps=_ps, rh=_rh,
         rr=f32(_rh * golden_pi.sat(_Ts.astype(np.float64), _ps)[1]))
S['sref'] = f32(np.asarray(jth.s_sat(jnp.asarray(S['T']), jnp.asarray(S['p']),
                                     0.0)))

# name -> (function of a module and the sample dict, output index or None)
ELEMENTWISE = {
    'sat_thermo.es': (lambda m, a: m.sat_thermo(a['T'], a['p']), 0),
    'sat_thermo.rs': (lambda m, a: m.sat_thermo(a['T'], a['p']), 1),
    'sat_thermo_pog.rs': (lambda m, a: m.sat_thermo_pog(a['T'], a['p']), 1),
    'conv_q_to_rh': (lambda m, a: m.conv_q_to_rh(a['T'], a['r'], a['p']),
                     None),
    's_unsat_1': (lambda m, a: m.s_unsat(a['T'], a['p'], a['r'], a['r'], 1),
                  None),
    's_unsat_2': (lambda m, a: m.s_unsat(a['T'], a['p'], a['r'], a['r'], 2),
                  None),
    's_sat_1': (lambda m, a: m.s_sat(a['T'], a['p'], a['r'], 1), None),
    's_sat_2': (lambda m, a: m.s_sat(a['T'], a['p'], a['r'], 2), None),
    's_sat_pog': (lambda m, a: m.s_sat(a['T'], a['p'], 0.0, 1, True), None),
    's_sat_der_1': (lambda m, a: m.s_sat_der(a['T'], a['p'], a['r'], 1),
                    None),
    's_sat_der_2': (lambda m, a: m.s_sat_der(a['T'], a['p'], a['r'], 2),
                    None),
    'calc_T_rho_1': (lambda m, a: m.calc_T_rho(a['T'], a['r'], a['r2'], 1),
                     None),
    'calc_T_rho_2': (lambda m, a: m.calc_T_rho(a['T'], a['r'], a['r2'], 2),
                     None),
    'lambertw_m1': (lambda m, a: m.lambertw_m1(a['x']), None),
    'get_LCL': (lambda m, a: m.get_LCL(a['ps'], a['Ts'], a['rr'], a['rh']),
                None),
    'invert_entropy_newton_1': (
        lambda m, a: m.invert_entropy_newton(a['p'], a['sref']), None),
    'invert_entropy_newton_2': (
        lambda m, a: m.invert_entropy_newton(a['p'], a['sref'], a['r'], 2),
        None),
}


def _run(fn, idx, module, conv):
    out = fn(module, {k: conv(v) for k, v in S.items()})
    out = out[idx] if idx is not None else out
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out,
                      np.float64)


@pytest.mark.parametrize('name', sorted(ELEMENTWISE))
def test_thermo_function_matches_jax(name):
    """Every ops/thermo function against the JAX one on the same float32
    samples: relative error <= 2e-6, a few float32 ulps (XLA on the CPU and
    torch round exp/log/pow differently and XLA contracts multiply-adds;
    found <= 1e-6); the same samples are non-finite on both sides (an
    inversion where the saturation pressure exceeds p)."""
    fn, idx = ELEMENTWISE[name]
    want = _run(fn, idx, jth, jnp.asarray)
    got = _run(fn, idx, tth, torch.tensor)
    fin = np.isfinite(want)
    assert fin.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=0)


@pytest.mark.parametrize('select_thermo', [1, 2])
def test_sat_deficit_matches_jax(select_thermo):
    """chi = (s* - s) / (s*_sst - s*) against the JAX package within
    atol 2e-3 (a quotient of two entropy differences of ~1e3 J/kg/K each
    carrying ulp-level differences of ~1e-3; found <= 8e-4)."""
    args = lambda c: (c(S['sst']), c(S['p']), c(S['T']), 60000.0, c(S['r']),
                      select_thermo)
    want = np.asarray(jth.sat_deficit(*args(jnp.asarray)))
    got = tth.sat_deficit(*args(torch.tensor)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_entropy_table_matches_jax():
    """The port's generated 2-D table against the JAX package's: the axes
    within 2 float32 ulps (jnp.linspace's formula, but XLA may contract
    its multiply-add), T within 1e-3 K (25 Newton steps from the same
    start; found <= 2e-4 K)."""
    jp, js, jT = (np.asarray(a) for a in jth.generate_entropy_table())
    tp, ts, tT = (a.numpy() for a in tth.generate_entropy_table())
    np.testing.assert_allclose(tp, jp, rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(ts, js, rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(tT, jT, rtol=0, atol=1e-3)
    table = tpi.EntropyTable.create()
    assert table.grid == tuple(jpi.EntropyTable.create().grid)


def test_entropy_table3_matches_jax():
    """The port's generated 3-D reversible table against the JAX
    package's: axes within 2 float32 ulps, T within 1e-3 K (found
    <= 4e-4 K)."""
    ja = [np.asarray(a) for a in jth.generate_entropy_table_reversible()]
    ta = [a.numpy() for a in tth.generate_entropy_table_reversible()]
    for j, t in zip(ja[:3], ta[:3]):
        np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=1e-12)
    np.testing.assert_allclose(ta[3], ja[3], rtol=0, atol=1e-3)


def _soundings(n=400):
    """28-level tropical soundings (tests/test_thermo.py's construction)
    with the first 20 columns land (SST 0 K) and the next 20 cold (270 K)."""
    rng = np.random.default_rng(5)
    p_env = np.array([1000, 975, 950, 925, 900, 875, 850, 825, 800, 775,
                      750, 700, 650, 600, 550, 500, 450, 400, 350, 300,
                      250, 225, 200, 175, 150, 125, 100, 70]) * 100.0
    sst = rng.uniform(295, 304, n)
    p_surf = rng.uniform(1.004e5, 1.016e5, n)
    T0 = sst - rng.uniform(0.5, 1.5, n)
    Tenv = 200.0 + (T0[None] - 200.0) * (p_env[:, None] / p_env[0]) ** 0.45
    rh = np.clip(0.85 - 0.45 * (1 - p_env / p_env[0])[:, None]
                 + rng.uniform(-0.05, 0.05, (len(p_env), n)), 0.05, 0.99)
    rs = np.stack([golden_pi.sat(Tenv[l], p_env[l])[1]
                   for l in range(len(p_env))])
    sst[:20] = 0.0
    sst[20:40] = 270.0
    return [f32(a) for a in (sst, p_surf, p_env, Tenv, rh * rs)]


@pytest.fixture(scope='module')
def tables():
    jt2 = jpi.EntropyTable.create()
    jt3 = jpi.EntropyTable3.create()
    tt2 = tpi.EntropyTable.from_arrays(jt2.grid.lat_axis(),
                                       jt2.grid.lon_axis(), np.asarray(jt2.T))
    rt = jt3.rt0 + jt3.drt * np.arange(jt3.T.shape[-1])
    tt3 = tpi.EntropyTable3.from_arrays(jt3.grid.lat_axis(),
                                        jt3.grid.lon_axis(), rt,
                                        np.asarray(jt3.T))
    return {2: (jt2, tt2), 3: (jt3, tt3)}


@pytest.mark.parametrize('select_thermo,select_interp,dims', [
    (1, 2, 2), (1, 1, 2), (2, 1, 2), (2, 2, 3)],
    ids=['pseudo-table', 'pseudo-newton', 'reversible-newton',
         'reversible-table3'])
def test_cape_pi_plain_matches_jax(tables, select_thermo, select_interp,
                                   dims):
    """cape_pi_plain against the JAX cape_pi in all three modes (2-D table,
    3-D table, Newton), on the same table passed through from_arrays, land
    and cold columns included: within 5e-3 m/s (found <= 1.1e-3: XLA's
    exp/log/pow and multiply-add contraction against torch's, through
    log-pressure sums and a square root); land and cold columns give 0 in
    both."""
    sst, ps, pe, Te, re = _soundings()
    jt, tt = tables[dims]
    shape = (4, sst.size // 4)
    cols = lambda a: a.reshape(a.shape[:-1] + shape)
    want = np.asarray(jpi.cape_pi(
        jnp.asarray(cols(sst)), jnp.asarray(cols(ps)), jnp.asarray(pe),
        jnp.asarray(cols(Te)), jnp.asarray(cols(re)), jt,
        select_thermo=select_thermo, select_interp=select_interp))
    kernels.reset_counts()
    got = tpi.cape_pi(torch.tensor(cols(sst)), torch.tensor(cols(ps)),
                      torch.tensor(pe), torch.tensor(cols(Te)),
                      torch.tensor(cols(re)), tt,
                      select_thermo=select_thermo,
                      select_interp=select_interp).numpy()
    assert kernels.LAUNCHES['cape_pi'] == 0
    assert got.shape == want.shape == shape
    assert want.max() > 30.0
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    np.testing.assert_array_equal(got.reshape(-1)[:40], 0.0)
    np.testing.assert_array_equal(want.reshape(-1)[:40], 0.0)


def test_cape_pi_kernel_wrapper_refuses_cpu_tensors(tables):
    """The K6 wrapper launches only on CUDA tensors; it never falls back."""
    sst, ps, pe, Te, re = (torch.tensor(a) for a in _soundings(8))
    with pytest.raises(ValueError, match='CUDA'):
        k6.cape_pi_cuda(sst, ps, pe, Te, re, tables[2][1])
    assert kernels.LAUNCHES['cape_pi'] == 0


def test_cape_pi_kernel_params_are_the_twins_constants(tables):
    """The kernel's parameter block holds the float32 roundings of the
    constants the twin uses, in csrc/cape_pi.cu's order."""
    fp, ip = k6.params(tables[2][1], 28, 1000, 1.0)
    g = tables[2][1].grid
    assert fp.dtype == np.float32 and fp.size == 25
    assert fp[8] == np.float32(287.04) and fp[10] == np.float32(2.555e6)
    assert fp[12] == np.float32(tth.LCL_CPV)
    assert tuple(fp[21:]) == tuple(np.float32([g.lon0, g.dlon, g.lat0,
                                               g.dlat]))
    assert ip.tolist() == [g.nlon, g.nlat, 28, 1000]
