"""Run one cell of the benchmark once and print its result line.

    python3 -m tcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: tcbench/workloads/<cell>.json names
its configuration (tcbench/configs/<config>.json) and its traffic mix
(tcbench/traffic/<traffic>.json); BENCHMARK.json names the metrics the
cell reports, each read by tcbench/metrics/<metric>.py.

Set-up makes the environment on the card from the seed, tunes the
compaction caps once and runs one warm member.  The window then runs
ensemble members one after another for --seconds (closed loop, one
client); with --trace 1 a few members run under torch.profiler instead.
Afterwards the reference recomputes a sample of the delivered years, drawn
from the seed (with --trace 1: the traced years), and the comparison
decides ``correct``.  The last line of standard output is the result, the
last lines of standard error each compared number beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tropical_cyclone_risk_tpu')
WARM_MEMBER = 0xFFFFFFFF      # the warm-up member's index, outside the window's
# the caps are tuned from a key that no seed changes, so that every seed
# runs the same launch widths (the tuning probe's own draws would move a
# run's pace by 15% from seed to seed)
TUNE_SEED = 0
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3     # glibc's mallopt parameters


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA libraries into build/ itself)."""
    build = ROOT / 'build'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(build / 'nv_cache')


def host_settings() -> None:
    """glibc's allocator held at the steady state it reaches by itself in
    most processes: blocks up to 32 MiB taken from the heap and reused, the
    heap not trimmed.  Left dynamic, the threshold settles per process
    either there or low, where every year's host arrays are mapped and
    faulted in afresh, and a run's pace then halves or not by chance (2x
    between processes of one seed on the card)."""
    import ctypes
    libc = ctypes.CDLL('libc.so.6')
    libc.mallopt(M_MMAP_THRESHOLD, 32 * 1024 * 1024)
    libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    cell = load_json('workloads', f'{name}.json')
    return dict(cell=cell, cfg=load_json('configs', f"{cell['config']}.json"),
                traffic=load_json('traffic', f"{cell['traffic']}.json"))


def cell_metrics(name: str, trace: bool) -> list:
    """(name, unit) of the metrics BENCHMARK.json gives this cell: the
    per-layer ones in a traced run, the end-to-end ones otherwise."""
    with open(ROOT / 'BENCHMARK.json') as f:
        bench = json.load(f)
    entries = bench['per_layer' if trace else 'end_to_end']
    return [(m['name'], m['unit']) for m in entries
            if name in m.get('workloads', (name,))]


def reader(metric: str):
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'tcbench_metric_' + metric.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        metrics: list, fault=None, log=print) -> dict:
    """One run of a cell on `device`; returns the result dict.  fault: a
    context manager the window runs inside (the tests break the program
    with it)."""
    import contextlib
    import torch
    from tcbench import judge, pack as pack_mod, program
    from tcbench import trace as trace_mod
    from tcbench.reference import model as ref_model
    from tcbench.reference import rng as ref_rng
    from tcbench.reference import year as ref_year

    cfg, traffic, c = cell['cfg'], cell['traffic'], cell['cell']
    years = list(range(traffic['start_year'], traffic['end_year'] + 1))
    quota, n_seed = traffic['tracks_per_year'], traffic['seed_batch']
    base = ref_rng.key(seed)
    pk = pack_mod.make_pack(cfg, 12 * len(years), seed, device)
    ens = program.Ensemble(cfg, traffic, pk, base)
    ens.tune(ref_rng.key(TUNE_SEED))
    ens.run_member(WARM_MEMBER)
    sync = (torch.cuda.synchronize if device.startswith('cuda')
            else lambda: None)
    sync()
    setup_s = time.perf_counter() - T_START
    log(f'set-up {setup_s:.3f} s; caps {ens.tuned()}')

    rs = random.Random(seed)
    pick = rs.sample(range(4), max(0, c['check']['members'] - 1))
    kept, members, failed, error = {}, [], 0, None
    launches, traced_years, tr = None, 0, None
    fault = fault or contextlib.nullcontext()
    window_start = time.perf_counter()
    try:
        with fault:
            if trace:
                n = int(c['trace_members'])
                before = program.launch_counts()

                def traced():
                    out = {}
                    with program.spans():
                        for i in range(n):
                            out[i] = ens.run_member(i)
                    return out

                window_start = time.perf_counter()
                kept, tr = trace_mod.profile(traced)
                after = program.launch_counts()
                launches = {k: after[k] - before[k] for k in after}
                traced_years = n * len(years)
            else:
                i = 0
                before = program.launch_counts()
                ru0 = resource.getrusage(resource.RUSAGE_SELF)
                while time.perf_counter() - window_start < seconds:
                    t0 = time.perf_counter()
                    res = ens.run_member(i)
                    t1 = time.perf_counter()
                    members.append({'start': t0, 'end': t1, 'years': len(res),
                                    'tracks': sum(y.lon.shape[0]
                                                  for y in res)})
                    if i in pick:
                        kept[i] = res
                    kept['last'] = (i, res)
                    i += 1
                after = program.launch_counts()
                ru1 = resource.getrusage(resource.RUSAGE_SELF)
                n_years = max(1, i * len(years))
                log(f"window: {i} members, "
                    f"{(after['seeding'] - before['seeding']) / n_years:.4f}"
                    " launches a year; host CPU a year: "
                    f"{(ru1.ru_utime - ru0.ru_utime) / n_years * 1e3:.2f} ms "
                    f"user, {(ru1.ru_stime - ru0.ru_stime) / n_years * 1e3:.2f}"
                    " ms system")
    except Exception:                      # the program failed: not correct
        failed += 1
        error = traceback.format_exc()
        log(error)
    sync()
    peak = (torch.cuda.max_memory_allocated() if device.startswith('cuda')
            else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f'forbidden modules loaded: {found}')

    # the sample to check: (member, year index) -> delivered years
    last = kept.pop('last', None)
    if last is not None:
        kept[last[0]] = last[1]
    check = []
    for mem in sorted(kept):
        yis = (range(len(years)) if trace else
               sorted(rs.sample(range(len(years)),
                                min(len(years), c['check']['years']))))
        check += [(mem, yi, kept[mem][yi]) for yi in yis]
    del ens
    kept = None
    gc.collect()
    if device.startswith('cuda'):
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    md = ref_model.model(cfg)
    raw, work = [], {'storm_steps': 0, 'gathers': 0, 'storms': 0, 'cells': 0}
    t_ref = time.perf_counter()
    for mem, yi, got in check:
        yk = ref_rng.fold_in(ref_rng.fold_in(base, mem), years[yi])
        ref = ref_year.simulate_year(md, pk, yk, yi, quota, n_seed)
        raw.append(judge.compare_year(ref.tracks, ref.n_seeds,
                                      program.year_fields(got), got.n_seeds))
        for k in work:
            work[k] += ref.work[k]
    log(f'reference: {len(check)} years in {time.perf_counter() - t_ref:.1f}'
        f' s; {raw}')
    nums = judge.numbers(raw) if raw else {}
    correct, checked = judge.verdict(nums, c['check']['limits'])
    correct = correct and not failed and bool(raw)

    rec = SimpleNamespace(setup_s=setup_s, members=members,
                          window_start=window_start, trace=tr,
                          launches=launches, traced_years=traced_years,
                          k1_work=work if trace else None, W=md.W)
    values = {}
    for name, unit in metrics:
        v = reader(name)(rec)
        if v is not None:
            values[name] = {'value': float(v), 'unit': unit}
    dev = {'platform': 'gpu' if device.startswith('cuda') else device,
           'kind': (torch.cuda.get_device_name(0)
                    if device.startswith('cuda') else device),
           'count': 1, 'memory_peak_bytes': int(peak)}
    out = {'correct': bool(correct),
           'attempted': len(members) if not trace else int(c['trace_members']),
           'failed': failed, 'metrics': values, 'device': dev}
    if tr is not None:
        dev['busy_s'] = tr.busy_s()
        dev['window_s'] = tr.window_s()
        out['breakdown'] = {'device_ops': tr.device_ops(),
                            'idle_gaps': tr.idle_gaps()}
    out['check'] = checked
    if error:
        out['check']['program_failed'] = {'value': 1.0, 'limit': 0.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    host_settings()
    import torch
    cell = load_cell(args.workload)
    chips = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'tcbench: {chips} CUDA device(s) needed, found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    metrics = cell_metrics(args.workload, bool(args.trace))
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    out = run(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
              metrics, log=log)
    for name, v in out['check'].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
