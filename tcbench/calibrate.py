"""The readings that the limits of ``correct`` are set from.

    python3 -m tcbench.calibrate --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--seconds 3]

For each of --seeds, one run of the cell (tcbench.run.run) with a short
window at the cell's own load: its compared numbers are the program's
readings, the largest of which is the lower reading of each limit.  For
each of --control-seeds, the control: the reference computed in bfloat16
(the precision below the configuration's float32) put in the program's
place for the (member, year) pairs a run checks, judged against the
float32 reference; the smallest of its numbers is the upper reading.  A
control year that cannot fill its quota has crashed and reads nothing.
The benchmark's own runs never run this.  Prints one JSON line per seed
and a summary line.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import torch

from tcbench import judge
from tcbench import pack as pack_mod
from tcbench import run as run_mod
from tcbench.reference import model as ref_model
from tcbench.reference import rng as ref_rng
from tcbench.reference import year as ref_year

CONTROL_DTYPE = torch.bfloat16
CONTROL_MAX_BATCHES = 20


def checked_pairs(cell: dict, seed: int) -> list:
    """The (member, year index) pairs a run of `seed` checks: the members
    it draws from the seed and a later one (member 4 standing in for the
    window's last), the years drawn as a run draws them."""
    c, traffic = cell['cell'], cell['traffic']
    n_years = traffic['end_year'] - traffic['start_year'] + 1
    rs = random.Random(seed)
    members = sorted(rs.sample(range(4), max(0, c['check']['members'] - 1))
                     + [4])
    return [(m, yi) for m in members
            for yi in sorted(rs.sample(range(n_years),
                                       min(n_years, c['check']['years'])))]


def control(cell: dict, seed: int, device: str, log=print) -> dict:
    """The control's numbers for one seed (None where every year crashed)."""
    cfg, traffic = cell['cfg'], cell['traffic']
    years = list(range(traffic['start_year'], traffic['end_year'] + 1))
    pk = pack_mod.make_pack(cfg, 12 * len(years), seed, device)
    base = ref_rng.key(seed)
    md32 = ref_model.model(cfg)
    md16 = ref_model.model(cfg, CONTROL_DTYPE)
    raw, crashed = [], 0
    for mem, yi in checked_pairs(cell, seed):
        yk = ref_rng.fold_in(ref_rng.fold_in(base, mem), years[yi])
        args = (pk, yk, yi, traffic['tracks_per_year'], traffic['seed_batch'])
        r32 = ref_year.simulate_year(md32, *args)
        try:
            r16 = ref_year.simulate_year(md16, *args,
                                         max_batches=CONTROL_MAX_BATCHES)
        except RuntimeError as e:
            crashed += 1
            log(f'control year ({mem}, {yi}) crashed: {e}')
            continue
        raw.append(judge.compare_year(r32.tracks, r32.n_seeds, r16.tracks,
                                      r16.n_seeds))
    log(f'control seed {seed}: {raw}')
    return {'numbers': judge.numbers(raw) if raw else None,
            'crashed_years': crashed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=3.0)
    args = ap.parse_args(argv)
    run_mod.cache_dirs()
    run_mod.host_settings()
    if not torch.cuda.is_available():
        print('tcbench.calibrate: no CUDA device', file=sys.stderr)
        return 2
    cell = run_mod.load_cell(args.workload)
    log = lambda m: print(m, file=sys.stderr, flush=True)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    cseeds = [int(s) for s in args.control_seeds.split(',') if s]
    lower, upper = {}, {}
    for s in seeds:
        t0 = time.perf_counter()
        out = run_mod.run(cell, s, args.seconds, False, 'cuda', [], log=log)
        nums = {k: v['value'] for k, v in out['check'].items()}
        print(json.dumps({'seed': s, 'side': 'program',
                          'correct': out['correct'], 'numbers': nums,
                          'seconds': time.perf_counter() - t0}), flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
    for s in cseeds:
        t0 = time.perf_counter()
        res = control(cell, s, 'cuda', log=log)
        print(json.dumps({'seed': s, 'side': 'control', **res,
                          'seconds': time.perf_counter() - t0}), flush=True)
        for k, v in (res['numbers'] or {}).items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({'workload': args.workload, 'lower': lower,
                      'upper': upper, 'device': torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
