"""The port stands alone: every module imports with jax and the JAX package
both blocked, no source (nor chip_smoke.py) imports either, and on CPU
tensors the kernel dispatchers take the plain twins (no kernel is counted)
while the kernel wrappers refuse CPU tensors instead of falling back."""

import ast
import math
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tropical_cyclone_risk_tpu_torch as port
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import integrator, vmax
from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fast,
                                                    fields, simulator)
from tropical_cyclone_risk_tpu_torch.ops import fourier
from tropical_cyclone_risk_tpu_torch.utils import basins

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).parent
# packages the port and chip_smoke.py must never import
BLOCKED = ('jax', 'tropical_cyclone_risk_tpu')
MODULES = sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                       port.__name__ + '.'))


def _imports(path: Path):
    """Each imported module, and for `from m import a` the candidates
    (m, m.a): a is an attribute of m or a submodule."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((a.name,) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from ((node.module, f'{node.module}.{a.name}')
                        for a in node.names)


def test_every_module_imports_with_jax_blocked():
    """...and with the JAX package blocked too."""
    assert len(MODULES) >= 30
    assert {'tropical_cyclone_risk_tpu_torch.' + m for m in (
        'kernels.compact', 'kernels.vmax', 'kernels.integrator', 'bench',
        'analysis', 'utils.util', 'ops.sphere', 'models.bam',
        'parallel.sharding', 'parallel.distributed', 'scripts',
        'scripts.download_era5', 'scripts.download_cmip6',
        'utils.synthetic_cmip6')} <= set(MODULES)
    code = ("import sys, importlib\n"
            f"for b in {BLOCKED!r}: sys.modules[b] = None\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            f"assert not any(k.split('.')[0] in {BLOCKED!r} "
            "for k, v in sys.modules.items() if v is not None)\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize('source', sorted(p.stem for p in
                                          (PKG / 'csrc').glob('*.cu')))
def test_every_cuda_source_has_a_wrapper(source):
    """Each csrc/*.cu is built by one kernel wrapper (kernels/build.py
    library), so chip_smoke.py's build phase and the main path reach it."""
    wrappers = [p for p in (PKG / 'kernels').glob('*.py')
                if f"library('{source}'" in p.read_text()]
    assert len(wrappers) == 1, (source, wrappers)


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py')) +
                         [ROOT / 'chip_smoke.py'],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_sources(path):
    """No import of jax, nor of anything of the JAX package."""
    for names in _imports(path):
        assert names[0].split('.')[0] not in BLOCKED, (path, names)


def test_chip_smoke_refuses_without_cuda():
    """Without a card the measurement script fails and prints no result."""
    res = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py')],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           'CUDA_VISIBLE_DEVICES': ''})
    assert res.returncode != 0
    assert res.stdout == ''


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo
    fails and prints no result."""
    (tmp_path / 'chip_smoke.py').write_text(
        (ROOT / 'chip_smoke.py').read_text())
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0
    assert res.stdout == ''


def _small_segment():
    cfg = Namelist()
    pack = fields.synthetic_pack(cfg, 12, 19, 36, seed=1, device='cpu')
    n = 64
    r = np.random.default_rng(0)
    y = fast.State(*(torch.tensor(x, dtype=torch.float32) for x in (
        r.uniform(120, 200, n), r.uniform(8, 30, n), r.uniform(10, 30, n),
        r.uniform(0.3, 0.8, n))))
    fs = fourier.FourierSeries(torch.zeros(n, 4, 15), torch.zeros(n, 4, 15),
                               cfg.T_fourier_s)
    params = fast.SeedParams(torch.zeros(n, dtype=torch.int64),
                             torch.full((n,), 1500.0), fs)
    return (fields.build_stacks(pack), cfg, basins.basin_bounds(cfg, 'GL'),
            y, torch.ones(n, dtype=torch.bool), params)


def test_cpu_tensors_take_the_plain_twins():
    stacks, cfg, bounds, y, alive, params = _small_segment()
    kernels.reset_counts()
    outs, _ = simulator.integrate_segment(stacks, cfg, bounds, y, alive,
                                          params, 0, 7)
    last = torch.clamp_min(outs[5].sum(0) - 1, 0)
    vm, _ = diagnostics.axi_to_max_wind_raw(outs[0], outs[1], 3600.0,
                                            outs[2], outs[4], outs[5], last,
                                            cfg)
    assert outs[0].shape == vm.shape == (7, 64)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    assert kernels.PLAIN_ON_CUDA == dict.fromkeys(kernels.NAMES, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    stacks, cfg, bounds, y, alive, params = _small_segment()
    f_all = simulator.fourier_grid(cfg, params, 0, 6)
    with pytest.raises(ValueError, match='CUDA'):
        integrator.integrate_segment_cuda(stacks, cfg, bounds, y, alive,
                                          params, 0, 6, f_all, 3, 2)
    with pytest.raises(ValueError, match='CUDA'):
        integrator.integrate_segment_cuda(
            stacks, cfg.replace(rk_substeps=2), bounds, y, alive, params, 0,
            6, None, 3, 0)
    t = torch.zeros(4, 8)
    with pytest.raises(ValueError, match='CUDA'):
        vmax.axi_to_max_wind_raw_cuda(
            t, t, 3600.0, t, torch.zeros(4, 8, 4),
            torch.ones(4, 8, dtype=torch.bool),
            torch.zeros(8, dtype=torch.int64), (0, 1, 2, 3))
    with pytest.raises(ValueError, match='CUDA'):
        k5.fill_cuda('bits', (0, 1), (8,), 'cpu')
    pack = fields.synthetic_pack(cfg, 12, 19, 36, seed=1, device='cpu')
    with pytest.raises(ValueError, match='CUDA'):
        k3.propose_seeds_cuda((0, 1), pack, cfg, 'GL', 256)
    with pytest.raises(ValueError, match='CUDA'):
        k4.partition_cuda(alive, 8, (y.lon,), slot_rank=True)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)


@pytest.mark.parametrize('option', ['vmax_in_scan'])
def test_unported_options_raise(option):
    """The options the port once refused run now: with vmax_in_scan, a
    DiagState carry through integrate_segment on the CPU gives the 7th
    output leaf (vmax) and the carry's DiagState, through the plain twin
    (nothing launched, no twin counted on CUDA)."""
    stacks, cfg, bounds, y, alive, params = _small_segment()
    cfg = cfg.replace(**{option: True})
    n = y.lon.shape[0]
    diag = simulator.DiagState(y.lon, y.lat, torch.full((n,), -math.inf))
    kernels.reset_counts()
    outs, carry = simulator.integrate_segment(stacks, cfg, bounds, y, alive,
                                              params, 0, 3, diag, 2)
    assert len(outs) == 7 and outs[6].shape == (3, n)
    assert bool(torch.isfinite(outs[6]).all())
    # the run's last row (t_last = 2) stays out of the running peak
    peak = torch.where(outs[5][:2], outs[6][:2], -math.inf).amax(0)
    assert torch.equal(carry[2].peak[carry[1]], peak[carry[1]])
    assert torch.equal(carry[2].prev_lon, outs[0][-1])
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    assert kernels.PLAIN_ON_CUDA == dict.fromkeys(kernels.NAMES, 0)
