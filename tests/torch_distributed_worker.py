"""One process of the port's multi-process run (tests/test_torch_distributed.py):
torch.distributed over gloo on the CPU, 8 / WORLD virtual CPU shards in
each of WORLD processes (default 2), one global 8-shard seed mesh.  Runs
run_downscaling over two years at years_per_program=2 and records what
this process saw.  Imports torch and the port only.

Usage: python torch_distributed_worker.py RANK OUT_DIR PORT [WORLD]
"""

import os
import sys

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import rng, runtime
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
from tropical_cyclone_risk_tpu_torch.parallel import distributed

# the parent's one-process run uses the same namelist, pack and key
CFG = dict(seed_batch=512, tracks_per_year=2, start_year=2016,
           end_year=2017, years_per_program=2, exp_name='dist')
PACK = dict(n_planes=24, nlat=46, nlon=90, seed=0)
SEED = 11


def main():
    rank, out_dir, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    world = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    torch.set_num_threads(2)
    distributed.initialize(f'localhost:{port}', world, rank)
    distributed.initialize(f'localhost:{port}', world, rank)   # a no-op
    mesh = distributed.global_seed_mesh(['cpu'] * (8 // world))
    assert (mesh.size, mesh.first) == (8, 8 // world * rank), mesh
    cfg = Namelist(output_directory=out_dir, **CFG)
    pack = fields.synthetic_pack(cfg, device='cpu', **PACK)

    # every process sees the primary's value
    bseed = distributed.broadcast_from_primary(1000 + 17 * rank)

    writes, groups = [], []
    orig_write = runtime.write_tracks_nc
    runtime.write_tracks_nc = lambda *a: (writes.append(a[0]),
                                          orig_write(*a))[1]
    # this process's own tracks (the non-primary writes no file): what
    # run_downscaling's fused driver returns here
    orig_fused = pipeline.run_tracks_years_fused
    pipeline.run_tracks_years_fused = lambda *a, **k: (
        groups.append(orig_fused(*a, **k)), groups[-1])[1]
    fn = runtime.run_downscaling(cfg, 'GL', pack, key=rng.key(SEED),
                                 mesh=mesh)
    assert len(groups) == 1, len(groups)
    yts = groups[0]
    np.savez(os.path.join(out_dir, f'rank{rank}.npz'), fn=np.array(fn),
             writes=np.int32(len(writes)),
             rank=np.int32(torch.distributed.get_rank()),
             primary=np.int32(distributed.is_primary()),
             bseed=np.int32(bseed),
             month=np.concatenate([y.month for y in yts]),
             lon=np.nan_to_num(np.concatenate([y.lon for y in yts])),
             vmax=np.nan_to_num(np.concatenate([y.vmax for y in yts])),
             n_seeds=np.stack([y.n_seeds for y in yts]))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f'rank {rank} done', flush=True)


if __name__ == '__main__':
    main()
