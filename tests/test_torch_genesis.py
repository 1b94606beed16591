"""The genesis gate (K7): the port's twin, models/simulator.py
genesis_alive_plain, against the JAX package's genesis_alive on the CPU, and
the host side of the gate kernel (csrc/integrator.cu genesis_gate_kernel):
its parameter block and its refusals.

The twin evaluates F(0) as the sum of the 15 B components in index order
(FourierSeries.evaluate_at_zero), the order the kernel adds them in, where
the JAX package takes A @ sin(0) + B @ cos(0) as a matrix product.
Tolerances: F(0) within 1e-6 (float32 sums of 15 terms of |B| < 1 in
another order); the keep mask exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import fast as jfast
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import simulator as jsim
from tropical_cyclone_risk_tpu.ops import fourier as jfourier
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import fast, fields, simulator
from tropical_cyclone_risk_tpu_torch.ops import fourier

N = 3000
ORDERS = {'250-850': (250, 850), '850-250': (850, 250)}


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(JNamelist(), 12, 91, 180, seed=0)
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


def _seeds(seed):
    """Same seeds on both sides: positions over the whole globe (land,
    the poles' neighbourhood and the ocean), planes, a Fourier draw from
    one JAX key, and an integrate mask."""
    r = np.random.default_rng(seed)
    lon = r.uniform(0.0, 360.0, N).astype(np.float32)
    lat = r.uniform(-60.0, 60.0, N).astype(np.float32)
    v = r.uniform(8.0, 30.0, N).astype(np.float32)
    m = r.uniform(0.2, 0.9, N).astype(np.float32)
    plane = r.integers(0, 12, N).astype(np.int32)
    h_bl = np.full(N, 1500.0, np.float32)
    mask = r.random(N) < 0.8
    fj = jfourier.draw_fourier(jax.random.key(seed), (N, 4),
                               Namelist().T_fourier_s)
    jy = jfast.State(*(jnp.asarray(x) for x in (lon, lat, v, m)))
    jp = jfast.SeedParams(jnp.asarray(plane), jnp.asarray(h_bl), fj)
    ty = fast.State(*(torch.from_numpy(x) for x in (lon, lat, v, m)))
    tp = fast.SeedParams(
        torch.from_numpy(plane), torch.from_numpy(h_bl),
        fourier.FourierSeries(torch.from_numpy(np.array(fj.A)),
                              torch.from_numpy(np.array(fj.B)),
                              Namelist().T_fourier_s))
    return jy, jp, ty, tp, mask


@pytest.mark.parametrize('order', list(ORDERS))
@pytest.mark.parametrize('seed', [5, 17])
def test_gate_twin_matches_jax(packs, seed, order):
    jpack, tpack = packs
    jy, jp, ty, tp, mask = _seeds(seed)
    jcfg = JNamelist(steering_levels=ORDERS[order])
    cfg = Namelist(steering_levels=ORDERS[order])
    f0_j = np.asarray(jp.fourier.evaluate(0.0))
    f0 = tp.fourier.evaluate_at_zero()
    np.testing.assert_allclose(f0.numpy(), f0_j, rtol=0, atol=1e-6)
    keep_j = jax.jit(lambda pack, y, p, msk: jsim.genesis_alive(
        pack, jcfg, y, p, msk))(jpack, jy, jp, jnp.asarray(mask))
    kernels.reset_counts()
    keep = simulator.genesis_alive(fields.build_stacks(tpack), cfg, ty, tp,
                                   torch.from_numpy(mask))
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.PLAIN_ON_CUDA.values())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    # the gate rejects some integrable seeds and keeps most
    rejected = int(mask.sum()) - int(keep.sum())
    assert 0 < rejected < int(mask.sum()) // 2


def test_evaluate_at_zero_is_the_ordered_b_sum():
    """F(0) adds B's components in index order, and equals evaluate(0.0),
    which adds the A terms (+-0 at t = 0) as well, within 1e-6."""
    r = np.random.default_rng(1)
    B = torch.from_numpy(r.normal(0, 0.3, (50, 4, 15)).astype(np.float32))
    A = torch.from_numpy(r.normal(0, 0.3, (50, 4, 15)).astype(np.float32))
    fs = fourier.FourierSeries(A, B, 1e6)
    want = B.numpy()[..., 0].copy()
    for n in range(1, 15):
        want = want + B.numpy()[..., n]
    np.testing.assert_array_equal(fs.evaluate_at_zero().numpy(), want)
    np.testing.assert_allclose(fs.evaluate(0.0).numpy(), want, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('order', list(ORDERS))
def test_gate_params_are_the_twins_constants(packs, order):
    """K7's parameter block: K1's layout, with the grid, the land
    threshold of fast._is_land and the steering order of
    fast.deep_layer_indices as float32 / int32, m seeds, one thread per seed
    in GATE_THREADS-wide blocks."""
    _, tpack = packs
    cfg = Namelist(steering_levels=ORDERS[order])
    stacks = fields.build_stacks(tpack)
    m = 1000
    fp, ip = integrator.gate_params(stacks, cfg, m)
    assert fp.dtype == np.float32 and ip.dtype == np.int32
    g = stacks.grid
    np.testing.assert_array_equal(fp[:4], np.float32([g.lon0, g.dlon, g.lat0,
                                                      g.dlat]))
    assert fp[14] == np.float32(1.0 - 1e-5)
    assert ip[:3].tolist() == [g.nlon, g.nlat, stacks.cell4.shape[0]]
    assert ip[4:8].tolist() == list(fast.deep_layer_indices(cfg))
    assert ip[10] == 0 and ip[11] == m
    assert ip[-3:].tolist() == [integrator.GATE_THREADS,
                                integrator.GATE_THREADS,
                                -(-m // integrator.GATE_THREADS)]
    # the rest of the block is K1's, value for value
    fp1, ip1 = integrator._params(stacks, cfg, (0.0,) * 4, m, 0, 1, 0, 0,
                                  0.0, False, (0, 0, 0))
    np.testing.assert_array_equal(fp, fp1)
    np.testing.assert_array_equal(ip[:-3], ip1[:-3])


def test_gate_wrapper_refuses_what_k1_refuses(packs):
    """CPU tensors (ValueError), and every option K1 raises on
    (NotImplementedError): a cell row that does not fit the stack layout
    (84 channels where land and bathymetry have a grid of their own, which
    takes 76); five steering levels are taken (a unit of their own, built
    at its first launch: CPU tensors refused), levels without 850 hPa
    raise fast.deep_layer_indices' ValueError; nothing is launched or
    counted.
    Land and bathymetry on their own grids are K1's and K7's since they
    take those layouts (tests/test_torch_geo.py); fixed positions too, so
    with debug_fixed_position the wrapper refuses only the CPU tensors."""
    _, tpack = packs
    _, _, ty, tp, mask = _seeds(5)
    stacks = fields.build_stacks(tpack)
    keep_in = torch.from_numpy(mask)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks, Namelist(), ty, tp, keep_in)
    with pytest.raises(NotImplementedError, match='76-channel'):
        integrator.genesis_gate_cuda(stacks._replace(geo_in_cell=False),
                                     Namelist(), ty, tp, keep_in)
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks,
                                     Namelist(debug_fixed_position=True),
                                     ty, tp, keep_in)
    cfg5 = Namelist(steering_levels=(250, 400, 500, 700, 850),
                    steering_coefs=(0.2, 0.2, 0.2, 0.2, 0.2))
    stacks5 = fields.build_stacks(fields.synthetic_pack(cfg5, 2, 10, 20,
                                                        device='cpu'))
    with pytest.raises(ValueError, match='CUDA'):
        integrator.genesis_gate_cuda(stacks5, cfg5, ty, tp, keep_in)
    with pytest.raises(ValueError, match='250 and 850'):
        integrator.genesis_gate_cuda(
            stacks5, cfg5.replace(steering_levels=(250, 400, 500, 700, 800)),
            ty, tp, keep_in)
    assert not any(kernels.LAUNCHES.values())
