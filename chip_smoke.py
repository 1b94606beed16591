"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device  - require CUDA; print the card's name and power limit.
2. build   - build the CUDA integrator (K1) with nvcc and JIT the Triton
             vmax kernel (K2); print the build times and nvcc's register
             report.
3. K1      - one 131072-seed launch on the 181x360 one-degree pack with
             every integration segment run through K1 and through the plain
             PyTorch twin on the same inputs; agreement within the stated
             tolerance; times on the first segment at full width.
4. K2      - every vmax pass of that launch (with its boundary rows),
             kernel against twin, in the same way.
5. slice   - runtime.run_downscaling(cfg, 'GL', pack, seed=0) at
             seed_batch=131072 for two years on a 24-plane pack, with every
             launch counter reset just before and read just after; the
             tracks file is read back and checked, and a small run on the
             card agrees with the same run through the plain twins on the
             CPU.
6. times   - launch times and the two-year run, beside the card's name and
             power limit.

The line before the card line is a JSON object with each kernel's route,
source, launches on the main path, error against its twin and times; the
last line is {"ok": true, "device": {...}}.  Builds go to build/.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BASIN = 'GL'
N_SEEDS = 131072
# K1 against its twin, over samples where both integrations are alive: the
# two execute the same float32 operations in the same order (the kernel is
# built with -fmad=false and calls CUDA's own libm, as torch's kernels do),
# so any difference is a rounding-level seed that the 4-stage RK loop can
# grow; 1e-3 deg is ~100 m, and 1e-2 m/s is far below the model's noise
K1_TOL = {'lon': 1e-3, 'lat': 1e-3, 'v': 1e-2, 'm': 1e-3, 'wnds': 1e-2}
K1_ALIVE_AGREE = 0.999        # storms whose alive history matches exactly
# K2 against its twin: the JAX package's own width-dependent vmax noise
# (tests/test_pipeline_stats.py, atol 1e-4)
K2_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_k1(out, ref):
    """(share of storms with the same alive history, max abs error per
    field over samples alive in both, share of bit-exact lon samples) of
    one segment integrated by K1 (out) and by its twin (ref)."""
    (ko, (k_end, k_alive)), (po, (p_end, p_alive)) = out, ref
    agree = ((ko[5] == po[5]).all(dim=0) & (k_alive == p_alive))
    both = ko[5] & po[5]
    err = {}
    for i, nm in enumerate(('lon', 'lat', 'v', 'm', 'wnds')):
        msk = both if ko[i].dim() == 2 else both[..., None].expand_as(ko[i])
        err[nm] = float((ko[i] - po[i]).abs()[msk].max()) if msk.any() \
            else 0.0
    end = k_alive & p_alive
    for nm, a, b in zip(('lon', 'lat', 'v', 'm'), k_end, p_end):
        if end.any():
            err[nm] = max(err[nm], float((a - b).abs()[end].max()))
    exact = float((ko[0] == po[0])[both].float().mean()) if both.any() \
        else 1.0
    return float(agree.float().mean()), err, exact


def compare_k2(out, ref, alive):
    """(max abs error of vmax on alive samples and of the finite lifetime
    peaks, whether the finite peaks are the same storms) of one K2 call."""
    (k_vmax, k_peak), (p_vmax, p_peak) = out, ref
    fin = torch.isfinite(p_peak)
    err = max(float((k_vmax - p_vmax).abs()[alive].max()) if alive.any()
              else 0.0,
              float((k_peak - p_peak).abs()[fin].max()) if fin.any()
              else 0.0)
    return err, torch.equal(torch.isfinite(k_peak), fin)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this script measures '
                         'the GPU path and has no CPU fallback')
    from tropical_cyclone_risk_tpu.config import Namelist
    from tropical_cyclone_risk_tpu.io import netcdf
    from tropical_cyclone_risk_tpu_torch import kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as vmax_kernel
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fields,
                                                        pipeline, simulator)

    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'[device] {card}; torch {torch.__version__} cuda '
        f'{torch.version.cuda}')

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    k1_build = integrator.build()
    for line in k1_build['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'[build] nvcc: {line.strip()}')
    t_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    T_tiny, N_tiny = 4, 300
    tiny = [torch.rand((T_tiny, N_tiny), device=dev) for _ in range(3)]
    vmax_kernel.axi_to_max_wind_raw_triton(
        *tiny[:2], 3600.0, tiny[2] * 30,
        torch.rand((T_tiny, N_tiny, 4), device=dev),
        torch.ones((T_tiny, N_tiny), dtype=torch.bool, device=dev),
        torch.full((N_tiny,), T_tiny - 1, device=dev), (0, 1, 2, 3))
    torch.cuda.synchronize()
    t_k2 = time.perf_counter() - t0
    import triton
    log(f'[build] K1 nvcc {t_k1:.1f} s, K2 triton {triton.__version__} JIT '
        f'{t_k2:.1f} s')

    # ---- 3./4. K1 and K2 against their plain twins -----------------------
    # one full launch at the slice's shapes, with both kernel dispatchers
    # wrapped so that every segment's K1 call and every K2 call (with its
    # boundary rows) is repeated through the plain twin on the same inputs
    cfg = Namelist(seed_batch=N_SEEDS, start_year=2016, end_year=2017)
    pack24 = fields.synthetic_pack(cfg, n_planes=24, nlat=181, nlon=360,
                                   seed=0, device=dev)
    pack_y = fields.slice_pack_year(pack24, cfg, 0)
    key = rng.key(0)
    t0 = time.perf_counter()
    cfg_t = pipeline.auto_integrate_cap(rng.fold_in(key, cfg.start_year),
                                        pack24, cfg, BASIN)
    torch.cuda.synchronize()
    log(f'[K1] auto-tune {time.perf_counter() - t0:.2f} s: integrate_cap '
        f'{cfg_t.integrate_cap} schedule {cfg_t.recompact_schedule}')
    k1_kernel = simulator.integrate_segment
    k2_kernel = diagnostics.axi_to_max_wind_raw
    k1_calls, k2_calls = [], []

    def k1_checked(*args):
        out = k1_kernel(*args)
        k1_calls.append((args, compare_k1(
            out, simulator.integrate_segment_plain(*args))))
        return out

    def k2_checked(*args, **kw):
        out = k2_kernel(*args, **kw)
        k2_calls.append(((args, kw), compare_k2(
            out, diagnostics.axi_to_max_wind_raw_plain(*args, **kw),
            args[5])))
        return out

    simulator.integrate_segment = k1_checked
    diagnostics.axi_to_max_wind_raw = k2_checked
    try:
        pipeline.launch_body(rng.fold_in(key, 1), pack_y, cfg_t, BASIN,
                             N_SEEDS, cfg.start_month - 1)
    finally:
        simulator.integrate_segment = k1_kernel
        diagnostics.axi_to_max_wind_raw = k2_kernel
    torch.cuda.synchronize()

    agree = min(c[0] for _, c in k1_calls)
    k1_err = {nm: max(c[1][nm] for _, c in k1_calls) for nm in K1_TOL}
    exact = min(c[2] for _, c in k1_calls)
    args0 = k1_calls[0][0]
    n1, m = args0[7], args0[3].lon.shape[0]
    log(f'[K1] {len(k1_calls)} segments, steps '
        f'{[a[7] for a, _ in k1_calls]}, widths '
        f'{[a[3].lon.shape[0] for a, _ in k1_calls]}: storms with identical '
        f'alive history >= {agree:.6f}; bit-exact lon samples >= '
        f'{exact:.6f}; max abs err {k1_err}')
    if agree < K1_ALIVE_AGREE:
        raise AssertionError(f'K1 alive agreement {agree}')
    for nm, tol in K1_TOL.items():
        if not k1_err[nm] <= tol:
            raise AssertionError(f'K1 {nm} err {k1_err[nm]} > {tol}')
    ms_k1 = cuda_ms(lambda: k1_kernel(*args0), 5)
    ms_k1_plain = cuda_ms(lambda: simulator.integrate_segment_plain(*args0),
                          1)
    log(f'[K1] segment 0, {n1} steps x {m} storms: kernel {ms_k1:.3f} ms, '
        f'plain twin {ms_k1_plain:.3f} ms')

    k2_err = max(c[0] for _, c in k2_calls)
    log(f'[K2] {len(k2_calls)} segments: max abs err {k2_err:.3e}; '
        f'finite peaks identical {all(c[1] for _, c in k2_calls)}')
    if not (k2_err <= K2_TOL and all(c[1] for _, c in k2_calls)):
        raise AssertionError(f'K2 max abs err {k2_err} > {K2_TOL}')
    v_args, v_kw = k2_calls[0][0]
    ms_k2 = cuda_ms(lambda: k2_kernel(*v_args, **v_kw), 20)
    ms_k2_plain = cuda_ms(
        lambda: diagnostics.axi_to_max_wind_raw_plain(*v_args, **v_kw), 5)
    log(f'[K2] segment 0, [{n1}, {m}]: kernel {ms_k2:.3f} ms, plain twin '
        f'{ms_k2_plain:.3f} ms')
    del k1_calls, k2_calls, args0, v_args, v_kw

    # ---- 5. the slice -----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as out_dir:
        cfg_run = cfg.replace(output_directory=out_dir, exp_name='smoke')
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        fn = runtime.run_downscaling(cfg_run, BASIN, pack24, seed=0,
                                     device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        plain_calls = dict(kernels.PLAIN_ON_CUDA)
        ds = netcdf.read(fn)
    log(f'[slice] run_downscaling 2 years in {t_run:.2f} s; kernel '
        f'launches {launches}; plain twins on CUDA {plain_calls}')
    if min(launches.values()) < 1 or max(plain_calls.values()) > 0:
        raise AssertionError('the main path did not run through both '
                             'kernels alone')
    want = {'lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
            'tc_month', 'tc_basins', 'tc_years', 'seeds_per_month',
            'u250_trks', 'v250_trks', 'u850_trks', 'v850_trks'}
    if not want <= set(ds.variables):
        raise AssertionError(f'missing {want - set(ds.variables)}')
    v = ds.variables['v_trks'].data
    lat0 = ds.variables['lat_trks'].data[:, 0]
    n_trk = v.shape[0]
    peaks = np.nanmax(v, axis=1)
    if n_trk != 2 * cfg.tracks_per_year:
        raise AssertionError(f'{n_trk} tracks != 2 x {cfg.tracks_per_year}')
    if not (np.all(peaks >= cfg.seed_v_threshold_ms)
            and np.all(np.abs(lat0) > 2.0)):
        raise AssertionError('survivor tracks fail the TC filters')
    spm = ds.variables['seeds_per_month'].data
    log(f'[slice] {n_trk} tracks, peak v {peaks.min():.1f}..'
        f'{peaks.max():.1f} m/s, seeds per month sum {spm.sum():.0f}')

    # a small launch on the card against the same launch through the plain
    # twins on the CPU (themselves held against the JAX package by the CPU
    # tests): rounding-level differences may flip a borderline verdict, so
    # verdicts must agree on >= 99.5% of slots and matched survivors within
    # 1e-3 deg at genesis and 0.5 m/s in lifetime peak vmax
    small = Namelist(seed_batch=2048, integrate_cap=0.5,
                     recompact_schedule=((90, 0.375), (180, 0.25)))
    outs = {}
    for d in (dev, torch.device('cpu')):
        pk = fields.synthetic_pack(small, 12, 91, 180, seed=3, device=d)
        tr, me = pipeline._simulate_batch(rng.key(7), pk, small, BASIN, 2048,
                                          256, 0)
        outs[d.type] = (me['keep'].cpu().numpy(), me['counted'].cpu().numpy(),
                        {k: tr[k].cpu().numpy() for k in ('lat', 'vmax')})
    (kg, cg, tg), (kc, cc, tc) = outs['cuda'], outs['cpu']
    both = kg & kc
    rg, rc = (np.cumsum(kg) - 1)[both], (np.cumsum(kc) - 1)[both]
    dlat = float(np.abs(tg['lat'][rg, 0] - tc['lat'][rc, 0]).max())
    dpk = float(np.abs(np.nanmax(tg['vmax'][rg], 1)
                       - np.nanmax(tc['vmax'][rc], 1)).max())
    log(f'[slice] small launch GPU vs CPU twins: keep agree '
        f'{(kg == kc).mean():.4f} ({kg.sum()} vs {kc.sum()} survivors), '
        f'counted agree {(cg == cc).mean():.4f}, matched survivors: genesis '
        f'lat diff {dlat:.2e}, peak vmax diff {dpk:.2e}')
    if not ((kg == kc).mean() >= 0.995 and (cg == cc).mean() >= 0.999
            and dlat <= 1e-3 and dpk <= 0.5 and both.sum() > 10):
        raise AssertionError('small launch on the card disagrees with the '
                             'CPU twins')

    # ---- 6. times ---------------------------------------------------------
    plane0 = cfg.start_month - 1
    dts = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracks, meta = pipeline._simulate_batch(
            rng.key(100 + i), pack_y, cfg_t, BASIN, N_SEEDS, 64, plane0)
        n_surv = int(meta['scalars'][0])
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts[1:])
    sched = pipeline.seg_schedule(cfg_t, m)
    e, w = pipeline.seg_edges_widths(sched, m, cfg.n_steps_output)
    rows = sum(w[i] * (e[i + 1] - e[i]) for i in range(len(w)))
    adapt = {'cfg': cfg_t}
    year_dts = []
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for yi, year in enumerate(cfg.years()):
            pipeline.run_tracks_year(rng.fold_in(rng.key(50 + rep), year),
                                     pack24, cfg_t, BASIN, yi, adapt=adapt)
        torch.cuda.synchronize()
        year_dts.append((time.perf_counter() - t0) / len(cfg.years()))
    log(f'[times] {card}: launch {dt * 1e3:.2f} ms median of '
        f'{[round(x * 1e3, 2) for x in dts[1:]]}; '
        f'{N_SEEDS / dt * 60:.4g} storms/min, {rows / dt * 60:.4g} scan '
        f'rows/min, {n_surv / dt * 60:.4g} surviving TCs/min (last launch); '
        f'{year_dts} s per sim-year warm, {60 / min(year_dts):.4g} '
        f'sim-years/min; two-year run_downscaling {t_run:.2f} s incl. '
        f'auto-tune and write')

    src = 'tropical_cyclone_risk_tpu_torch/'
    print(json.dumps({'kernels': [
        {'name': 'integrator', 'route': 'cuda',
         'source': src + 'csrc/integrator.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/simulator.py:111',
         'launches': launches['integrator'],
         'max_abs_err': max(k1_err.values()), 'ms': ms_k1,
         'plain_ms': ms_k1_plain},
        {'name': 'vmax', 'route': 'triton',
         'source': src + 'kernels/vmax.py',
         'replaces': 'tropical_cyclone_risk_tpu/models/diagnostics.py:193',
         'launches': launches['vmax'], 'max_abs_err': k2_err, 'ms': ms_k2,
         'plain_ms': ms_k2_plain}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
