"""Data parallelism over the seed axis (twin of
tropical_cyclone_risk_tpu/parallel/sharding.py).

Seeds are independent until the survivor compaction, so a launch over a
mesh of shards runs ``pipeline.launch_body`` on each shard at n / n_shards
slots, shard d with the key ``fold_in(key, d)`` (also for d = 0, so a
one-shard mesh is not the unsharded launch), and lays the shards' bodies
out shard-major, as the JAX package's ``shard_map`` out_specs do: per-seed
and per-track rows concatenated on their first axis, the time-major track
buffers on their second, the overflow pairs one after the other.  One
``compact_survivors`` over that layout gives the launch's (tracks, meta).

A mesh is a plain value: this process's shards in order (a shard is a
device; CPU shards, and several shards on one card, are virtual), the
global index of its first shard and the global shard count.  Across
processes (parallel.distributed) every process runs its own shards and the
bodies are all-gathered, so every process holds the same result.

Field packs are small (monthly one-degree stacks, tens of MB): each shard
reads the pack on its own device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import pipeline
from tropical_cyclone_risk_tpu_torch.models.fields import FieldPack
from tropical_cyclone_risk_tpu_torch.utils import obs

SEED_AXIS = 'seeds'


class SeedMesh(NamedTuple):
    """A 1-D mesh over the seed axis."""
    devices: Tuple[torch.device, ...]   # this process's shards, in order
    first: int                          # global index of devices[0]'s shard
    size: int                           # global shard count


def _indexed(d: torch.device) -> torch.device:
    """'cuda' as the card it means (the current one), so that shards on
    one card compare equal."""
    if d.type == 'cuda' and d.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return d


def local_mesh(devices: Sequence) -> SeedMesh:
    """A one-process mesh over these devices (repeats allowed: virtual
    shards on one device)."""
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if not devs:
        raise ValueError('a seed mesh needs at least one device')
    return SeedMesh(devs, 0, len(devs))


def make_mesh(n_devices: Optional[int] = None, device='cuda') -> SeedMesh:
    """A mesh over the first n (default: all) local cards; with
    device='cpu', n virtual CPU shards (default 1)."""
    if torch.device(device).type == 'cpu':
        return local_mesh(['cpu'] * (1 if n_devices is None else n_devices))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise ValueError(f'requested {n} devices, have {have}')
    return local_mesh([torch.device('cuda', i) for i in range(n)])


def replicate_pack(pack: FieldPack, mesh: SeedMesh) -> FieldPack:
    """The pack on the mesh's first device, where the launches take it
    from (shard_packs places one copy on each other device)."""
    return pack.to(mesh.devices[0])


def shard_packs(pack: FieldPack, mesh: SeedMesh) -> list:
    """The pack of each shard of the mesh: one copy per distinct device,
    shared by the shards on it."""
    copies = {pack.device: pack}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = pack.to(d)
    return [copies[d] for d in mesh.devices]


def _leaves(body, axis=0, out=None):
    """(tensor, concatenation axis) of each leaf of a launch body, in a
    fixed order: the time-major buffers ('tm', 'tms') join on axis 1."""
    out = [] if out is None else out
    if isinstance(body, dict):
        for k in sorted(body):
            _leaves(body[k], 1 if k in ('tm', 'tms') else axis, out)
    elif isinstance(body, (tuple, list)):
        for b in body:
            _leaves(b, axis, out)
    elif body is not None:
        out.append((body, axis))
    return out


def _rebuild(body, it):
    """The body's structure with its leaves taken in _leaves' order."""
    if isinstance(body, dict):
        return {k: _rebuild(body[k], it) for k in sorted(body)}
    if isinstance(body, (tuple, list)):
        return type(body)(_rebuild(b, it) for b in body)
    return None if body is None else next(it)


def _all_gather(tensors, axes):
    """Each tensor of this process concatenated with every other
    process's on its axis, in process order: one all-gather of their bytes
    (uint8, as no collective carries torch.bool everywhere), each tensor
    padded to a multiple of 8 bytes so that every one starts aligned for
    its dtype."""
    import torch.distributed as dist
    flat = torch.cat([torch.nn.functional.pad(
        t.contiguous().reshape(-1).view(torch.uint8),
        (0, -t.numel() * t.element_size() % 8)) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    out, o = [], 0
    for t, ax in zip(tensors, axes):
        nb = t.numel() * t.element_size()
        out.append(torch.cat([p[o:o + nb].view(t.dtype).reshape(t.shape)
                              for p in parts], dim=ax))
        o += nb + -nb % 8
    return out


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def gather_bodies(bodies: list, mesh: SeedMesh) -> dict:
    """The shard-major body of the mesh's launch on its first device, from
    this process's shards' bodies (and, in a process group, every
    process's, all-gathered, also in a group of one)."""
    dev = mesh.devices[0]
    per = [_leaves(b) for b in bodies]
    axes = [ax for _, ax in per[0]]
    cat = [torch.cat([p[i][0].to(dev) for p in per], dim=ax)
           for i, ax in enumerate(axes)]
    if _in_group():
        cat = _all_gather(cat, axes)
    return _rebuild(bodies[0], iter(cat))


def simulate_batch_sharded(mesh: SeedMesh, key: rng.Key, pack: FieldPack,
                           cfg: Namelist, basin_id: str, n: int, k_max: int,
                           plane_offset: int):
    """pipeline._simulate_batch over a seed mesh: n seeds, n / n_shards on
    each shard.  Returns (tracks, meta) on the mesh's first device, the
    same on every process."""
    n_dev = mesh.size
    if n % n_dev:
        raise ValueError(f'seed batch {n} not divisible by {n_dev} devices')
    n_local = n // n_dev
    with obs.span('tc.launch'):
        bodies = [pipeline.launch_body(rng.fold_in(key, mesh.first + i), p,
                                       cfg, basin_id, n_local, plane_offset,
                                       shard_index=mesh.first + i)
                  for i, p in enumerate(shard_packs(pack, mesh))]
        body = gather_bodies(bodies, mesh)
        with obs.span('tc.launch.compact'):
            return pipeline.compact_survivors(
                body, n_dev * pipeline.launch_width(cfg, n_local), k_max,
                n_basins=len(cfg.basin_ids_sorted()), n_shards=n_dev)


def simulate_years_sharded(mesh: SeedMesh, key: rng.Key, years, plane_idx,
                           vpot_valid, pack: FieldPack, cfg: Namelist,
                           basin_id: str, n: int, k_max: int) -> list:
    """pipeline._simulate_years over a seed mesh: batch 0 of each year,
    each a simulate_batch_sharded launch."""
    return pipeline._simulate_years(key, years, plane_idx, vpot_valid, pack,
                                    cfg, basin_id, n, k_max, mesh=mesh)
