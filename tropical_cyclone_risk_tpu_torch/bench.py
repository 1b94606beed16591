"""Throughput benchmark of the port on one GPU:

    python -m tropical_cyclone_risk_tpu_torch.bench [--device cpu]

Prints ONE JSON line with the keys of the JAX package's bench.py, measured
on this device.  The workload is bench.py's: GL, 131072 seeds per launch
on ``synthetic_pack(cfg, 12, 181, 360)`` with the compaction caps
auto-tuned as a production run tunes them, survivors compacted at k_max
64.  Everything runs on the GPU; without one it raises unless
``--device cpu`` is given.  The size options exist only so that a test
can run it small on the CPU; their defaults are the workload above.

What each number counts:

- value, storm_lifecycles_per_min_per_chip: proposed seeds per minute
  through one full launch (pipeline._simulate_batch: seeding, the 361-step
  coupled integration of the integrable seeds, the TC filters, survivor
  compaction).  Five launches a block, two in flight, each ended by a host
  fetch of its in-launch 'scalars'; the median of three blocks, their
  spread in detail.launch_seconds_spread.
- detail.scan_rows_per_min: storm-steps the integrator actually runs
  (launch width x steps, summed over the re-compaction segments).
- detail.surviving_tcs_per_min: storms passing every TC filter.
- detail.sim_years_per_min: simulated years per minute through the
  default production driver, pipeline.run_tracks_years_fused at
  k_fuse = years_per_program (quota fill, seed accounting, stopping rule,
  host fetch of the survivor tracks), on an 8-year pack (96 planes), the
  median of three warm passes.  detail.seconds_per_sim_year_unfused_loop
  is the same work through the per-year loop with one launch in flight
  (pipeline.prefetch_year_batch0), timed as bench.py times it: from year
  0's batch 0 already issued.

vs_baseline is null: the port has no target yet; its first run on the card
is its own baseline.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import torch

from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import pipeline
from tropical_cyclone_risk_tpu_torch.models.fields import synthetic_pack
from tropical_cyclone_risk_tpu_torch.utils import obs

UNITS_NOTE = ('storms/min counts proposed seeds (reference rejection-loop '
              'iterations; survivor tracks are bit-identical to '
              'integrating every slot); fields sampled once per '
              'field_sample_stride steps; sim_years_per_min through '
              'run_tracks_years_fused at years_per_program, the unfused '
              'loop through prefetch_year_batch0 and run_tracks_year; '
              'every number measured on detail.device')
K_MAX = 64          # survivor track rows a launch compacts (bench.py's)


def scan_rows_per_launch(cfg: Namelist, n: int) -> int:
    """Slot-steps the integration actually executes per launch."""
    m = pipeline.launch_width(cfg, n)
    edges, widths = pipeline.seg_edges_widths(
        pipeline.seg_schedule(cfg, m), m, cfg.n_steps_output)
    return sum(w * (edges[i + 1] - edges[i]) for i, w in enumerate(widths))


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type off the GPU."""
    if device.type != 'cuda':
        return device.type
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', str(device.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()


def workload(device, n_seeds: int = 131072, nlat: int = 181,
             nlon: int = 360, tracks_per_year: Optional[int] = None):
    """(cfg with the compaction caps resolved as a production run resolves
    them, the 12-plane synthetic pack) of the benchmark on device."""
    cfg = Namelist().replace(seed_batch=n_seeds)
    if tracks_per_year is not None:
        cfg = cfg.replace(tracks_per_year=tracks_per_year)
    pack = synthetic_pack(cfg, 12, nlat, nlon, seed=0, device=device)
    return pipeline.auto_integrate_cap(rng.key(0), pack, cfg, 'GL'), pack


def fused_pass(seed: int, pack_y, cfg: Namelist, n_years: int) -> None:
    """n_years years through the default fused driver, k_fuse =
    years_per_program."""
    out = pipeline.run_tracks_years_fused(
        rng.key(seed), pack_y, cfg, 'GL', list(range(2016, 2016 + n_years)),
        k_fuse=max(1, cfg.years_per_program))
    assert all(y.lon.shape[0] == cfg.tracks_per_year for y in out)


def loop_first(seed: int, pack_y, cfg: Namelist):
    """Year 0's batch 0 of loop_pass, issued ahead (prefetch_year_batch0)."""
    return pipeline.prefetch_year_batch0(rng.fold_in(rng.key(seed), 0),
                                         pack_y, cfg, 'GL', 0)


def loop_pass(seed: int, pack_y, cfg: Namelist, n_years: int,
              pending) -> None:
    """n_years years through the per-year loop from year 0's issued batch
    0 (loop_first), each next year's batch 0 issued before the current
    year is read (prefetch_year_batch0)."""
    ykey = rng.key(seed)
    for yi in range(n_years):
        nxt = (pipeline.prefetch_year_batch0(
            rng.fold_in(ykey, yi + 1), pack_y, cfg, 'GL', yi + 1)
            if yi + 1 < n_years else None)
        out_y = pipeline.run_tracks_year(rng.fold_in(ykey, yi), pack_y, cfg,
                                         'GL', yi, first_batch=pending)
        assert out_y.lon.shape[0] == cfg.tracks_per_year
        pending = nxt


def run(device='cuda', n_seeds: int = 131072, nlat: int = 181,
        nlon: int = 360, n_years: int = 8, n_iter: int = 5, n_rep: int = 3,
        tracks_per_year: Optional[int] = None) -> dict:
    """The benchmark's JSON object (see the module docstring)."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device; pass --device cpu to run '
                               'the benchmark on the CPU')
        torch.cuda.reset_peak_memory_stats(device)
    cfg, pack = workload(device, n_seeds, nlat, nlon, tracks_per_year)

    def launch(seed):
        return pipeline._simulate_batch(rng.key(seed), pack, cfg, 'GL',
                                        n_seeds, K_MAX, 0)

    # warm-up; the host fetch of the in-launch scalars ends each launch
    int(launch(0)[1]['scalars'][0])
    # blocks of n_iter launches with distinct keys, two in flight
    block_dts = []
    survivors = 0
    for r in range(n_rep):
        k0 = 1 + r * (n_iter + 1)
        inflight = [launch(k0)]
        t0 = time.perf_counter()
        for i in range(n_iter):
            if i + 1 < n_iter:
                inflight.append(launch(k0 + i + 1))
            _, meta = inflight.pop(0)
            survivors += int(meta['scalars'][0])
        block_dts.append(time.perf_counter() - t0)
    dt = sorted(block_dts)[n_rep // 2]
    per_min = n_seeds * n_iter / dt * 60.0
    rows_min = scan_rows_per_launch(cfg, n_seeds) * n_iter / dt * 60.0
    tcs_min = survivors / sum(block_dts) * 60.0

    # production steady state on an n_years pack: the default fused year
    # driver, then the per-year loop
    pack_y = synthetic_pack(cfg, 12 * n_years, nlat, nlon, seed=0,
                            device=device)
    fused_pass(99, pack_y, cfg, n_years)                 # warm
    years_dts = []
    for r in range(n_rep):
        t1 = time.perf_counter()
        fused_pass(100 + r, pack_y, cfg, n_years)
        years_dts.append(time.perf_counter() - t1)
    dt_years = sorted(years_dts)[len(years_dts) // 2]
    pipeline.run_tracks_year(rng.fold_in(rng.key(100), 9999), pack_y, cfg,
                             'GL', 0)                    # warm
    loop_dts = []
    for _ in range(n_rep):
        # as bench.py times it: from year 0's issued batch 0
        pending = loop_first(100, pack_y, cfg)
        t1 = time.perf_counter()
        loop_pass(100, pack_y, cfg, n_years, pending)
        loop_dts.append(time.perf_counter() - t1)
    dt_loop = sorted(loop_dts)[len(loop_dts) // 2]
    if device.type == 'cuda':
        obs.log.info('bench peak device memory allocated: %.2f MiB',
                     torch.cuda.max_memory_allocated(device) / 2 ** 20)

    return {
        'metric': 'storm_lifecycles_per_min_per_chip',
        'value': round(per_min, 1),
        'unit': 'storms/min/chip',
        'vs_baseline': None,
        'detail': {
            'n_seeds_per_launch': n_seeds,
            'n_steps': cfg.n_steps_output,
            'launch_seconds': round(dt / n_iter, 4),
            'launch_seconds_spread': [round(d / n_iter, 4)
                                      for d in sorted(block_dts)],
            'scan_rows_per_min': round(rows_min, 1),
            'surviving_tcs_per_min': round(tcs_min, 1),
            'sim_years_per_min': round(n_years / dt_years * 60.0, 2),
            'seconds_per_sim_year': round(dt_years / n_years, 4),
            'seconds_per_sim_year_spread': [round(d / n_years, 4)
                                            for d in sorted(years_dts)],
            'seconds_per_sim_year_unfused_loop': round(dt_loop / n_years,
                                                       4),
            'seconds_per_sim_year_unfused_spread': [
                round(d / n_years, 4) for d in sorted(loop_dts)],
            'survivors_per_launch': round(survivors / (n_rep * n_iter), 1),
            'integrate_cap': cfg.integrate_cap,
            'recompact': (list(cfg.recompact_schedule)
                          if cfg.recompact_schedule is not None
                          else [cfg.recompact_step, cfg.recompact_cap]),
            'field_sample_stride': cfg.field_sample_stride,
            'units_note': UNITS_NOTE,
            'device': device_name(device),
            'platform': 'gpu' if device.type == 'cuda' else device.type,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description='Throughput benchmark of the port (one JSON line)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--seeds', type=int, default=131072,
                    help='seeds per launch')
    ap.add_argument('--nlat', type=int, default=181)
    ap.add_argument('--nlon', type=int, default=360)
    ap.add_argument('--years', type=int, default=8,
                    help='simulated years of the year drivers')
    ap.add_argument('--iters', type=int, default=5,
                    help='launches per timed block')
    ap.add_argument('--reps', type=int, default=3,
                    help='timed blocks, and timed passes of each driver')
    ap.add_argument('--tracks-per-year', type=int, default=None,
                    help="the year quota (default: the Namelist's)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.seeds, args.nlat, args.nlon,
                         args.years, args.iters, args.reps,
                         args.tracks_per_year)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
