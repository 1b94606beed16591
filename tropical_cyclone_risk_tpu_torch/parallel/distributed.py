"""Multi-process runs over torch.distributed (twin of
tropical_cyclone_risk_tpu/parallel/distributed.py).

Every process runs the same run_downscaling program over one global seed
mesh: each integrates its own shards, the launch bodies are all-gathered
once per launch (parallel.sharding), and every process holds the same
tracks; the primary (rank 0) claims the file name and writes the file.

Usage (the same command in every process, e.g. under torchrun, which sets
MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK):

    from tropical_cyclone_risk_tpu_torch.parallel import distributed
    distributed.initialize()          # from the environment, or explicit
    mesh = distributed.global_seed_mesh()
    runtime.run_downscaling(cfg, basin, pack, mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from tropical_cyclone_risk_tpu_torch.parallel import sharding

# the variables torchrun (and torch.distributed's env:// setup) read; any
# one of them set means a process group is configured
_ENV_VARS = ('MASTER_ADDR', 'RANK', 'WORLD_SIZE')


def initialized() -> bool:
    """Whether this process is in a process group (of any size: the
    collectives of a mesh run also in a group of one)."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group over TCP at
    coordinator_address ('host:port'; default MASTER_ADDR:MASTER_PORT),
    with num_processes (default WORLD_SIZE) and process_id (default RANK).
    The backend is NCCL when a card is present, else gloo; with NCCL the
    process takes card LOCAL_RANK (default: its rank modulo the cards).

    A repeat call and a bare single-process call (nothing configured, in
    the arguments or the environment) do nothing, decided from
    torch.distributed.is_initialized() and the environment alone."""
    if initialized():
        return                  # repeat call
    if (coordinator_address is None and process_id is None
            and not any(os.environ.get(v) for v in _ENV_VARS)):
        return                  # bare single process: nothing to set up
    env = os.environ
    if coordinator_address is None:
        if not (env.get('MASTER_ADDR') and env.get('MASTER_PORT')):
            raise ValueError('no coordinator: pass coordinator_address or '
                             'set MASTER_ADDR and MASTER_PORT')
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    rank = int(env.get('RANK', 0)) if process_id is None else process_id
    world = (int(env.get('WORLD_SIZE', 1)) if num_processes is None
             else num_processes)
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(int(env.get('LOCAL_RANK',
                                          rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=f'tcp://{coordinator_address}',
                            world_size=world, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    return not initialized() or dist.get_rank() == 0


def _local_devices() -> tuple:
    """This process's devices: in a process group its card (the one
    initialize made current), alone every card; the CPU without a
    card."""
    if not torch.cuda.is_available():
        return (torch.device('cpu'),)
    if initialized():
        return (torch.device('cuda', torch.cuda.current_device()),)
    return tuple(torch.device('cuda', i)
                 for i in range(torch.cuda.device_count()))


def _collective_device() -> torch.device:
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def broadcast_from_primary(value: int) -> int:
    """The primary's value of an integer, in every process."""
    if not initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_collective_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def global_seed_mesh(local_devices: Optional[Sequence] = None
                     ) -> sharding.SeedMesh:
    """The 1-D seed mesh over every process's devices (local_devices:
    this process's shards, default _local_devices(); repeats are virtual
    shards).  Every process must hold as many shards."""
    local = sharding.local_mesh(local_devices if local_devices is not None
                                else _local_devices()).devices
    if not initialized():
        return sharding.local_mesh(local)
    world = process_count()
    counts = torch.tensor([len(local)], dtype=torch.int64,
                          device=_collective_device())
    parts = [torch.empty_like(counts) for _ in range(world)]
    dist.all_gather(parts, counts)
    if any(int(p.item()) != len(local) for p in parts):
        raise ValueError(f'processes hold {[int(p.item()) for p in parts]} '
                         f'devices each; a seed mesh needs equal counts')
    return sharding.SeedMesh(local, dist.get_rank() * len(local),
                             world * len(local))
