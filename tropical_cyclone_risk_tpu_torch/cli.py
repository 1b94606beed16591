"""Command-line entry point (twin of tropical_cyclone_risk_tpu/cli.py):

    python -m tropical_cyclone_risk_tpu_torch.cli BASIN --namelist NL.py \
        [--seed S] [--ensembles N] [--n-years Y] [--device cuda|cpu]
        [--devices N]

Reference equivalent: run.py (basin argument, land-mask generation,
preprocessing, per-basin downscaling) and util/compute.py:24-35
(compute_downscaling_inputs).  Everything runs on the GPU unless
``--device cpu`` asks for the CPU; without a GPU and without that flag it
raises.  ``--devices N`` shards every seed batch over the first N cards
(parallel.sharding; with ``--device cpu``, N virtual CPU shards).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import torch

from tropical_cyclone_risk_tpu_torch import rng, runtime
from tropical_cyclone_risk_tpu_torch.config import Namelist, load_namelist_py
from tropical_cyclone_risk_tpu_torch.models import pack_builder
from tropical_cyclone_risk_tpu_torch.parallel import sharding
from tropical_cyclone_risk_tpu_torch.preprocess import (land_masks,
                                                        thermo_driver, winds)
from tropical_cyclone_risk_tpu_torch.utils import basins as basins_mod


def compute_downscaling_inputs(cfg: Namelist, device='cuda') -> None:
    """Wind statistics and thermodynamic preprocessing, each idempotent
    (util/compute.py:24-35).

    The two stages are independent (separate inputs and output files):
    winds streams most of the raw workspace's bytes from disk in numpy,
    thermo spends its time in CAPE-PI on the device.  So thermo runs in a
    worker thread while winds runs in the calling thread (file reads and
    device work release the GIL), as in the JAX package.
    """
    t_all = time.perf_counter()
    thermo_err: list = []

    def run_thermo():
        try:
            t0 = time.perf_counter()
            thermo_driver.gen_thermo(cfg, device=device)
            print('Finished computing thermodynamic variables. '
                  'Time elapsed: %f s' % (time.perf_counter() - t0))
        except BaseException as e:       # noqa: BLE001 — re-raised below
            thermo_err.append(e)

    print('Computing wind statistics and thermodynamic variables '
          '(overlapped)...')
    th = threading.Thread(target=run_thermo, name='thermo-preproc')
    th.start()
    try:
        t0 = time.perf_counter()
        winds.gen_wind_mean_cov(cfg)
        print('Finished computing wind statistics. Time elapsed: %f s'
              % (time.perf_counter() - t0))
    finally:
        th.join()
    if thermo_err:
        raise thermo_err[0]
    print('Finished downscaling inputs. Time elapsed: %f s'
          % (time.perf_counter() - t_all))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description='Tropical cyclone downscaling on GPUs '
                    '(reference CLI: run.py BASIN)')
    ap.add_argument('basin', help='basin ID (e.g. GL, NA, WP, ...)')
    ap.add_argument('--namelist', default=None,
                    help='path to a reference-style namelist.py to load')
    ap.add_argument('--n-years', type=int, default=None,
                    help='limit the number of simulated years')
    ap.add_argument('--devices', type=int, default=None,
                    help='shard seed batches over this many devices '
                         '(default: one device)')
    ap.add_argument('--ensembles', type=int, default=1,
                    help='number of ensemble members to generate (reruns '
                         'append _eN suffixes, util/compute.py:52-58)')
    ap.add_argument('--seed', type=int, default=None,
                    help='seed for a reproducible run (default: the clock)')
    ap.add_argument('--trace-dir', default=None,
                    help='write a torch.profiler trace of the simulation, '
                         'with the year driver\'s tc.driver.* and the '
                         'launch\'s tc.launch.* spans (utils/obs.py)')
    ap.add_argument('--device', default='cuda',
                    help="device to run on: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; pass --device cpu to run on the '
                           'CPU')
    # the mesh before minutes of preprocessing: too few cards raise here
    mesh = (sharding.make_mesh(args.devices, device)
            if args.devices and args.devices > 1 else None)

    cfg = load_namelist_py(args.namelist) if args.namelist else Namelist()
    # validate and case-normalize the basin before minutes of preprocessing
    args.basin = basins_mod.validate_basin_id(cfg, args.basin)

    out_dir = '%s/%s' % (cfg.output_directory, cfg.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    print('Output directory: %s' % out_dir)

    land_masks.generate_land_masks(cfg.fn_land, cfg.mask_dir)
    compute_downscaling_inputs(cfg, device=device)

    pack = pack_builder.build_field_pack(cfg, args.basin, device=device)
    for e in range(max(1, args.ensembles)):
        key = (rng.fold_in(rng.key(args.seed), e)
               if args.seed is not None else None)
        runtime.run_downscaling(cfg, args.basin, pack, key=key,
                                n_years=args.n_years, device=device,
                                trace_dir=args.trace_dir, mesh=mesh)
    return 0


if __name__ == '__main__':
    sys.exit(main())
