"""The port's multi-process path (parallel.distributed): two spawned
processes over gloo on the CPU, 4 virtual CPU shards each, one global
8-shard seed mesh, running run_downscaling over two years with
years_per_program=2 (the fused driver across processes, the seed and the
file-name broadcast, the primary-only write).  The processes import torch
and the port only (tests/torch_distributed_worker.py).

Checks: the tracks file the two processes write equals, variable by
variable and bit for bit, the one the same namelist, pack and key write on
a one-process 8-shard mesh (which tests/test_torch_sharding.py holds
against the JAX package); only rank 0 writes, both ranks return its path
and see its broadcast value, and both hold the same tracks.  And
initialize's no-op and forwarding cases with torch.distributed replaced,
as tests/test_distributed_init.py checks the JAX package's.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch import rng, runtime
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.io import netcdf
from tropical_cyclone_risk_tpu_torch.models import fields
from tropical_cyclone_risk_tpu_torch.parallel import distributed, sharding
from torch_distributed_worker import CFG, PACK, SEED

WORKER = Path(__file__).parent / 'torch_distributed_worker.py'
REPO = Path(__file__).parent.parent
TRACK_VARS = ('lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
              'u250_trks', 'v250_trks', 'u850_trks', 'v850_trks',
              'tc_month', 'tc_basins', 'tc_years', 'seeds_per_month')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_two_processes_write_the_one_process_file(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',
                        'LOCAL_RANK', 'LOCAL_WORLD_SIZE')}
    env['PYTHONPATH'] = os.pathsep.join([str(REPO), str(WORKER.parent),
                                         env.get('PYTHONPATH', '')])
    env['CUDA_VISIBLE_DEVICES'] = ''
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(tmp_path), port], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f'rank {r} failed:\n{outs[r][-4000:]}'
    r0, r1 = (np.load(tmp_path / f'rank{r}.npz') for r in range(2))
    assert (int(r0['rank']), int(r1['rank'])) == (0, 1)
    assert (int(r0['primary']), int(r1['primary'])) == (1, 0)
    assert int(r0['bseed']) == int(r1['bseed']) == 1000
    assert str(r0['fn']) == str(r1['fn'])
    assert (int(r0['writes']), int(r1['writes'])) == (1, 0)
    for k in ('month', 'lon', 'vmax', 'n_seeds'):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0['month'].shape[0] == 4 and r0['n_seeds'].shape[0] == 2

    # the same namelist, pack and key on one process's 8-shard mesh, on
    # one torch thread (its 64-seed shards' small ops took 36 s at eight
    # threads and 21 s at one on an 8-core CPU; the result is the same)
    cfg = Namelist(output_directory=str(tmp_path / 'one'), **CFG)
    pack = fields.synthetic_pack(cfg, device='cpu', **PACK)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fn = runtime.run_downscaling(cfg, 'GL', pack, key=rng.key(SEED),
                                     mesh=sharding.make_mesh(8, 'cpu'))
    finally:
        torch.set_num_threads(threads)
    ds_mp, ds_sp = netcdf.read(str(r0['fn'])), netcdf.read(fn)
    for name in TRACK_VARS:
        a, b = ds_mp.variables[name].data, ds_sp.variables[name].data
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture
def record_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, 'init_process_group',
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for v in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',
              'LOCAL_RANK'):
        monkeypatch.delenv(v, raising=False)
    return calls


def test_bare_single_process_is_noop(record_init):
    distributed.initialize()
    distributed.initialize()
    assert record_init == []
    assert distributed.is_primary() and distributed.process_count() == 1
    assert distributed.broadcast_from_primary(7) == 7
    mesh = distributed.global_seed_mesh(['cpu'] * 3)
    assert (mesh.size, mesh.first) == (3, 0)


def test_already_initialized_is_noop(record_init, monkeypatch):
    monkeypatch.setattr(torch.distributed, 'is_initialized', lambda: True)
    distributed.initialize('host0:1234', 2, 0)
    assert record_init == []


def test_explicit_args_forwarded(record_init):
    distributed.initialize('host0:1234', 2, 1)
    assert record_init == [(('gloo',), dict(init_method='tcp://host0:1234',
                                            world_size=2, rank=1))]


def test_env_forwarded(record_init, monkeypatch):
    """torchrun's variables configure the group."""
    for k, v in dict(MASTER_ADDR='host0', MASTER_PORT='29500', RANK='3',
                     WORLD_SIZE='4').items():
        monkeypatch.setenv(k, v)
    distributed.initialize()
    assert record_init == [(('gloo',), dict(init_method='tcp://host0:29500',
                                            world_size=4, rank=3))]


def test_partial_env_raises(record_init, monkeypatch):
    """A rank without a coordinator is a configuration error, raised."""
    monkeypatch.setenv('RANK', '1')
    with pytest.raises(ValueError, match='coordinator'):
        distributed.initialize()
    assert record_init == []


def test_real_failure_propagates(monkeypatch):
    """A failing init_process_group surfaces, whatever its message."""
    def boom(*a, **k):
        raise RuntimeError('already initialized once before')

    monkeypatch.setattr(torch.distributed, 'init_process_group', boom)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        distributed.initialize('host0:1234', 2, 0)


def test_probe_against_real_torch():
    """This process is not in a process group."""
    assert distributed.initialized() is False


def test_gather_bodies_in_a_group_of_one():
    """gather_bodies in a one-process gloo group (its all-gather runs):
    shard-major like the local concatenation, for leaves of odd byte
    lengths and mixed dtypes (each starts aligned in the gathered bytes),
    the time-major ones joined on axis 1."""
    r = np.random.default_rng(3)
    bodies = [{'seed': {'keep': torch.from_numpy(r.random(5) < 0.5),
                        'month': torch.from_numpy(r.integers(1, 13, 5))},
               'slot_rank': None,
               'tm': {'v': torch.from_numpy(r.random((3, 7), np.float32)),
                      'alive': torch.from_numpy(r.random((3, 7)) < 0.5)},
               'tms': ({'v': torch.from_numpy(r.random((2, 3), np.float32))},),
               'overflow': torch.tensor([1, 0])} for _ in range(3)]
    mesh = sharding.local_mesh(['cpu'] * 3)
    local = sharding.gather_bodies(bodies, mesh)
    torch.distributed.init_process_group(
        'gloo', init_method=f'tcp://localhost:{_free_port()}', world_size=1,
        rank=0)
    try:
        grouped = sharding.gather_bodies(bodies, mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert local['slot_rank'] is None and grouped['slot_rank'] is None
    assert local['tm']['v'].shape == (3, 21)
    assert local['tms'][0]['v'].shape == (2, 9)
    assert local['seed']['keep'].shape == (15,)
    for got, ref in ((grouped['seed']['keep'], local['seed']['keep']),
                     (grouped['seed']['month'], local['seed']['month']),
                     (grouped['tm']['v'], local['tm']['v']),
                     (grouped['tm']['alive'], local['tm']['alive']),
                     (grouped['tms'][0]['v'], local['tms'][0]['v']),
                     (grouped['overflow'], local['overflow'])):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    np.testing.assert_array_equal(
        local['tm']['v'].numpy(),
        np.concatenate([b['tm']['v'].numpy() for b in bodies], axis=1))
