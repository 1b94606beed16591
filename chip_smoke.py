"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device    - require CUDA; print the card's name and power limit.
2. build     - build the CUDA integrator (K1) and the CAPE-PI kernel (K6)
               with nvcc, one process each, started together, while the
               Triton vmax kernel (K2) is JIT-compiled; print the build
               times and nvcc's register and stack report.
3. K1, K2    - one 131072-seed launch on the 181x360 one-degree pack with
               every integration segment run through K1 and through the
               plain PyTorch twin on the same inputs, and every vmax pass
               through K2 and its twin; agreement within the stated
               tolerances; times on the first segment at full width.
4. workspace - write one year of a one-degree ERA5-shaped raw workspace on
               the 28 ERA5 pressure levels (utils/synthetic_era5.py).
5. K6        - gen_thermo over that workspace with cape_pi captured: all
               12 x 181 x 360 columns on 28 levels through K6 and through
               the plain twin on the card (and a sample of columns through
               the twin on the CPU), within the stated tolerances; times.
6. slice 1   - runtime.run_downscaling(cfg, 'GL', pack, seed=0) at
               seed_batch=131072 for two years on a 24-plane synthetic
               pack, counters reset just before and read just after; the
               tracks file is read back and checked; a small launch on the
               card agrees with the same launch through the plain twins on
               the CPU.
7. slice 2   - the workspace path: cli.main(['GL', '--namelist', ...,
               '--seed', '0']) on cuda at seed_batch=131072 (land masks,
               wind statistics, thermo, pack builder, simulation), counters
               reset just before and read just after; the thermo and
               tracks files are read back and checked; stage times; then
               the CLI once more with --trace-dir (the device's busy share
               of the simulation, from the torch.profiler trace).
8. times     - launch times and the two-year run.

The line before the card line is a JSON object with each kernel's route,
source, launches on the workspace path, error against its twin, times and
bound; the last line is {"ok": true, "device": {...}}.  Builds go to
build/.  Every time printed stands beside the card's name and power limit.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import threading
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
# K6 against its twin on the card: the same float32 operations in the same
# order (-fmad=false, CUDA's libm on both sides, CAPE summed level by level
# in both), so equal to rounding; 1e-3 m/s allows a few ulps of PI.  The
# CPU twin rounds exp/log/pow otherwise (torch's CPU libm), which moves PI
# by ~1e-4 m/s, and where a column sits at a threshold (the first level
# above the LCL switches the lifted parcel from the dry adiabat to the
# moist one) a last-bit difference can move a level's contribution: so
# against a sample of columns on the CPU, >= 99% within K6_CPU_TOL and
# every column within K6_CPU_MAX.
K6_TOL = 1e-3
K6_CPU_TOL = 1e-3
K6_CPU_SHARE = 0.99
K6_CPU_MAX = 0.1
K6_CPU_COLUMNS = 4096
WS_YEAR = 2016      # the workspace: one year at one degree
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# HBM bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


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


def bound(n_bytes, n_ops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move n_bytes once and do n_ops float32 operations."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_b, t_o) * 1e3, 'bytes' if t_b >= t_o else 'operations'


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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


def k1_bound(args, out):
    """K1's bound on one segment.  Bytes: F(t), the initial state, the
    outputs and end state once each, and one 336-byte corner-packed row per
    distinct (plane, cell) the storms sampled (what this run's data reads
    of the cell stack).  Operations: at least 360 float32 operations per
    storm-step (four RHS evaluations, the RK4 combination, the wind
    coloring) and 150 per field gather (the 21-channel blend, the 4x4
    Cholesky), counted from csrc/integrator.cu, a transcendental as one."""
    from tropical_cyclone_risk_tpu_torch.models import simulator
    from tropical_cyclone_risk_tpu_torch.ops import interp
    stacks, cfg, _, y0, alive0, params, _, n_steps = args
    (outs, (end_y, end_alive)) = out
    m = y0.lon.shape[0]
    g = stacks.grid
    alive = outs[5]
    ix, _ = interp._cell_and_weight(outs[0][alive], g.lon0, g.dlon, g.nlon)
    iy, _ = interp._cell_and_weight(outs[1][alive], g.lat0, g.dlat, g.nlat)
    plane = params.plane.to(torch.int64)[None].expand_as(alive)[alive]
    cells = int(torch.unique((plane * g.nlat + iy) * g.nlon + ix).numel())
    stride, n_blocks = simulator.segment_plan(cfg, n_steps)
    gathers = n_blocks + (n_steps - n_blocks * stride)
    b = (cells * stacks.cell4.shape[-1] * 4 + n_steps * m * 4 * 4
         + nbytes(y0.lon, y0.lat, y0.v, y0.m, alive0, params.plane,
                  params.h_bl) + nbytes(*outs, *end_y, end_alive))
    return bound(b, m * (360 * n_steps + 150 * gathers))


def k2_bound(args, kw, out):
    """K2's bound on one call: its inputs and outputs once each, against
    at least 40 float32 operations per (step, storm) (the kernel's note)."""
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    ins += [t for v in kw.values() if v is not None
            for t in (v if isinstance(v, tuple) else (v,))
            if isinstance(t, torch.Tensor)]
    return bound(nbytes(*ins, *out), 40 * args[0].numel())


def k6_bound(args, out):
    """K6's bound: sst, p_surf, p_env, both profiles, the table and PI once
    each, against at least 100 float32 operations per level and 140 per
    column (two table lookups, three saturation formulas, the density
    temperatures and sums per level; the LCL with its Lambert W and the
    entropies per column), counted from csrc/cape_pi.cu, a transcendental
    as one."""
    sst, p_surf, p_env, T_env, r_env, table = args[:6]
    n_col, L = sst.numel(), p_env.shape[0]
    return bound(nbytes(sst, p_surf, p_env, T_env, r_env, table.T, out),
                 n_col * (140 + 100 * L))


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_all(dev):
    """nvcc for K1 and K6 in two threads (two processes at once) while the
    Triton K2 JIT-compiles here; returns the build seconds by kernel."""
    from tropical_cyclone_risk_tpu_torch.kernels import cape_pi as k6
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as vmax_kernel
    builds, errors = {}, []

    def nvcc(name, fn):
        try:
            t0 = time.perf_counter()
            builds[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:        # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=nvcc, args=a)
               for a in (('integrator', integrator.build),
                         ('cape_pi', k6.build))]
    for t in threads:
        t.start()
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
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    import triton
    for name, (info, secs) in builds.items():
        for line in info['log'].splitlines():
            if any(w in line for w in ('registers', 'spill', 'stack frame')):
                log(f'[build] {name} nvcc: {line.strip()}')
        log(f'[build] {name} nvcc {secs:.1f} s')
    log(f'[build] vmax triton {triton.__version__} JIT {t_k2:.1f} s '
        f'(concurrent with nvcc)')


def main():
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this script measures '
                         'the GPU path and has no CPU fallback')
    from tropical_cyclone_risk_tpu_torch import cli, kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.config import (Namelist,
                                                        load_namelist_py)
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fields,
                                                        pack_builder,
                                                        pipeline, simulator)
    from tropical_cyclone_risk_tpu_torch.ops import pi as pi_ops
    from tropical_cyclone_risk_tpu_torch.preprocess import (thermo_driver,
                                                            winds)
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_era5

    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'[device] {card}; torch {torch.__version__} cuda '
        f'{torch.version.cuda}')

    # ---- 2. build ---------------------------------------------------------
    build_all(dev)

    # ---- 3. K1 and K2 against their plain twins --------------------------
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
        k1_calls.append((args, out, compare_k1(
            out, simulator.integrate_segment_plain(*args))))
        return out

    def k2_checked(*args, **kw):
        out = k2_kernel(*args, **kw)
        k2_calls.append(((args, kw), out, compare_k2(
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

    agree = min(c[0] for _, _, c in k1_calls)
    k1_err = {nm: max(c[1][nm] for _, _, c in k1_calls) for nm in K1_TOL}
    exact = min(c[2] for _, _, c in k1_calls)
    args0, out0 = k1_calls[0][0], k1_calls[0][1]
    n1, m = args0[7], args0[3].lon.shape[0]
    log(f'[K1] {len(k1_calls)} segments, steps '
        f'{[a[7] for a, _, _ in k1_calls]}, widths '
        f'{[a[3].lon.shape[0] for a, _, _ in k1_calls]}: storms with '
        f'identical alive history >= {agree:.6f}; bit-exact lon samples >= '
        f'{exact:.6f}; max abs err {k1_err}')
    if agree < K1_ALIVE_AGREE:
        raise AssertionError(f'K1 alive agreement {agree}')
    for nm, tol in K1_TOL.items():
        if not k1_err[nm] <= tol:
            raise AssertionError(f'K1 {nm} err {k1_err[nm]} > {tol}')
    ms_k1 = cuda_ms(lambda: k1_kernel(*args0), 5)
    ms_k1_plain = cuda_ms(lambda: simulator.integrate_segment_plain(*args0),
                          1)
    k1_bound_ms, k1_by = k1_bound(args0, out0)
    log(f'[K1] {card}: segment 0, {n1} steps x {m} storms: kernel '
        f'{ms_k1:.3f} ms, plain twin {ms_k1_plain:.3f} ms, bound '
        f'{k1_bound_ms:.4f} ms ({k1_by})')

    k2_err = max(c[0] for _, _, c in k2_calls)
    log(f'[K2] {len(k2_calls)} segments: max abs err {k2_err:.3e}; '
        f'finite peaks identical {all(c[1] for _, _, c in k2_calls)}')
    if not (k2_err <= K2_TOL and all(c[1] for _, _, c in k2_calls)):
        raise AssertionError(f'K2 max abs err {k2_err} > {K2_TOL}')
    (v_args, v_kw), v_out = k2_calls[0][0], k2_calls[0][1]
    ms_k2 = cuda_ms(lambda: k2_kernel(*v_args, **v_kw), 20)
    ms_k2_plain = cuda_ms(
        lambda: diagnostics.axi_to_max_wind_raw_plain(*v_args, **v_kw), 5)
    k2_bound_ms, k2_by = k2_bound(v_args, v_kw, v_out)
    log(f'[K2] {card}: segment 0, [{n1}, {m}]: kernel {ms_k2:.3f} ms, '
        f'plain twin {ms_k2_plain:.3f} ms, bound {k2_bound_ms:.4f} ms '
        f'({k2_by})')
    del k1_calls, k2_calls, args0, out0, v_args, v_kw, v_out

    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        # ---- 4. workspace -------------------------------------------------
        t0 = time.perf_counter()
        ws = f'{tmp}/ws'
        nl = synthetic_era5.make_workspace(ws, WS_YEAR, WS_YEAR, nlat=181,
                                           nlon=360, seed_batch=N_SEEDS)
        log(f'[workspace] {ws}: one year, 181 x 360, '
            f'{synthetic_era5.LEVELS_HPA.size} levels, twice-daily winds, '
            f'written in {time.perf_counter() - t0:.1f} s')

        # ---- 5. K6 against its plain twin ---------------------------------
        # gen_thermo into a side directory with cape_pi captured, so K6
        # sees exactly the main path's inputs
        cfg_ws = load_namelist_py(nl)
        k6_kernel = pi_ops.cape_pi
        k6_calls = []

        def k6_captured(*args, **kw):
            out = k6_kernel(*args, **kw)
            k6_calls.append((args, kw, out))
            return out

        pi_ops.cape_pi = k6_captured
        try:
            thermo_driver.gen_thermo(
                cfg_ws.replace(output_directory=f'{tmp}/k6'), device=dev)
        finally:
            pi_ops.cape_pi = k6_kernel
        torch.cuda.synchronize()
        (k6_args, k6_kw, k6_out), = k6_calls
        k6_ref = pi_ops.cape_pi_plain(*k6_args, **k6_kw)
        torch.cuda.synchronize()
        k6_err = float((k6_out - k6_ref).abs().max())
        k6_exact = float((k6_out == k6_ref).float().mean())
        n_col, L = k6_args[0].numel(), k6_args[2].shape[0]
        pick = torch.randperm(n_col, generator=torch.Generator().manual_seed(
            0))[:K6_CPU_COLUMNS]
        cols = lambda a, lead: (a.reshape(L, -1) if lead else
                                a.reshape(-1))[..., pick.to(dev)].cpu()
        cpu_args = (cols(k6_args[0], False), cols(k6_args[1], False),
                    k6_args[2].cpu(), cols(k6_args[3], True),
                    cols(k6_args[4], True), k6_args[5].to('cpu'))
        k6_cpu = pi_ops.cape_pi_plain(*cpu_args, **k6_kw)
        k6_card = k6_out.reshape(-1)[pick.to(dev)].cpu()
        d_cpu = (k6_card - k6_cpu).abs()
        k6_cpu_err = float(d_cpu.max())
        k6_cpu_share = float((d_cpu <= K6_CPU_TOL).float().mean())
        worst = int(d_cpu.argmax())
        log(f'[K6] {n_col} columns x {L} levels {tuple(k6_args[0].shape)}: '
            f'max abs err {k6_err:.3e} m/s (bit-exact share {k6_exact:.6f}); '
            f'{K6_CPU_COLUMNS} columns against the CPU twin: share within '
            f'{K6_CPU_TOL} m/s {k6_cpu_share:.4f}, max {k6_cpu_err:.3e} m/s '
            f'(card {float(k6_card[worst]):.4f}, CPU '
            f'{float(k6_cpu[worst]):.4f}); PI max '
            f'{float(k6_out.max()):.2f} m/s')
        if not (k6_err <= K6_TOL and k6_cpu_share >= K6_CPU_SHARE
                and k6_cpu_err <= K6_CPU_MAX
                and bool(torch.isfinite(k6_out).all())):
            raise AssertionError(f'K6 err {k6_err} (tol {K6_TOL}), CPU '
                                 f'share {k6_cpu_share}, max {k6_cpu_err}')
        ms_k6 = cuda_ms(lambda: k6_kernel(*k6_args, **k6_kw), 20)
        ms_k6_plain = cuda_ms(
            lambda: pi_ops.cape_pi_plain(*k6_args, **k6_kw), 2)
        k6_bound_ms, k6_by = k6_bound(k6_args, k6_out)
        log(f'[K6] {card}: kernel {ms_k6:.3f} ms, plain twin '
            f'{ms_k6_plain:.3f} ms, bound {k6_bound_ms:.4f} ms ({k6_by})')
        del k6_calls, k6_args, k6_out, k6_ref

        # ---- 6. slice 1: run_downscaling on the synthetic pack ------------
        cfg_run = cfg.replace(output_directory=f'{tmp}/slice1',
                              exp_name='smoke')
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        fn = runtime.run_downscaling(cfg_run, BASIN, pack24, seed=0,
                                     device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches1 = dict(kernels.LAUNCHES)
        plain1 = dict(kernels.PLAIN_ON_CUDA)
        ds = netcdf.read(fn)
        log(f'[slice 1] run_downscaling 2 years in {t_run:.2f} s; kernel '
            f'launches {launches1}; plain twins on CUDA {plain1}')
        if (min(launches1['integrator'], launches1['vmax']) < 1
                or max(plain1.values()) > 0):
            raise AssertionError('slice 1 did not run through K1 and K2 '
                                 'alone')
        n_trk, peaks = check_tracks(ds, cfg)
        if n_trk != 2 * cfg.tracks_per_year:
            raise AssertionError(f'{n_trk} tracks != 2 x '
                                 f'{cfg.tracks_per_year}')
        spm = ds.variables['seeds_per_month'].data
        log(f'[slice 1] {n_trk} tracks, peak v {peaks.min():.1f}..'
            f'{peaks.max():.1f} m/s, seeds per month sum {spm.sum():.0f}')
        check_small_launch(dev, Namelist, fields, pipeline, rng)

        # ---- 7. slice 2: the workspace path through the CLI ---------------
        stage_s = {}
        timed = [(winds, 'gen_wind_mean_cov', 'winds'),
                 (thermo_driver, 'gen_thermo', 'thermo'),
                 (pack_builder, 'build_field_pack', 'pack build'),
                 (runtime, 'run_downscaling', 'simulation')]
        originals = [getattr(mod, nm) for mod, nm, _ in timed]

        def timer(fn_, label):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn_(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    stage_s[label] = time.perf_counter() - t
            return run

        for (mod, nm, label), orig in zip(timed, originals):
            setattr(mod, nm, timer(orig, label))
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        try:
            cli.main(['GL', '--namelist', nl, '--seed', '0'])
        finally:
            for (mod, nm, _), orig in zip(timed, originals):
                setattr(mod, nm, orig)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        plain = dict(kernels.PLAIN_ON_CUDA)
        log(f'[slice 2] {card}: cli.main GL one year in {t_cli:.2f} s; '
            f'stages (s) {json.dumps({k: round(v, 3) for k, v in stage_s.items()})}'
            f' (winds and thermo overlap); kernel launches {launches}; '
            f'plain twins on CUDA {plain}')
        if min(launches.values()) < 1 or max(plain.values()) > 0:
            raise AssertionError('the workspace path did not run through '
                                 'K1, K2 and K6 alone')
        check_thermo_file(thermo_driver.get_fn_thermo(cfg_ws), netcdf,
                          synthetic_era5)
        fn_ws = runtime.get_fn_tracks(cfg_ws, BASIN)
        n_ws, peaks_ws = check_tracks(netcdf.read(fn_ws), cfg_ws)
        if n_ws != cfg_ws.tracks_per_year:
            raise AssertionError(f'{n_ws} tracks != '
                                 f'{cfg_ws.tracks_per_year}')
        log(f'[slice 2] {n_ws} tracks, peak v {peaks_ws.min():.1f}..'
            f'{peaks_ws.max():.1f} m/s')
        # --trace-dir: the CLI again (its preprocessing files reused) with
        # the simulation under torch.profiler; the device's busy share is
        # the union of its kernels' intervals over the traced span
        t0 = time.perf_counter()
        cli.main(['GL', '--namelist', nl, '--seed', '1', '--trace-dir',
                  f'{tmp}/trace'])
        busy, span, n_kern = trace_busy(f'{tmp}/trace/trace.json')
        log(f'[slice 2] {card}: --trace-dir run {time.perf_counter() - t0:.2f}'
            f' s; simulation trace: {n_kern} device kernels, busy '
            f'{busy / 1e3:.2f} ms of {span / 1e3:.2f} ms traced '
            f'({busy / span:.3f} busy share)')

    # ---- 8. times ---------------------------------------------------------
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
        f'auto-tune and write; workspace CLI {t_cli:.2f} s')

    src = 'tropical_cyclone_risk_tpu_torch/'
    print(json.dumps({'kernels': [
        {'name': 'integrator', 'route': 'cuda',
         'source': src + 'csrc/integrator.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/simulator.py:111',
         'launches': launches['integrator'],
         'max_abs_err': max(k1_err.values()), 'ms': ms_k1,
         'plain_ms': ms_k1_plain, 'bound_ms': k1_bound_ms,
         'bound_by': k1_by, 'library_ms': None},
        {'name': 'vmax', 'route': 'triton',
         'source': src + 'kernels/vmax.py',
         'replaces': 'tropical_cyclone_risk_tpu/models/diagnostics.py:193',
         'launches': launches['vmax'], 'max_abs_err': k2_err, 'ms': ms_k2,
         'plain_ms': ms_k2_plain, 'bound_ms': k2_bound_ms,
         'bound_by': k2_by, 'library_ms': None},
        {'name': 'cape_pi', 'route': 'cuda',
         'source': src + 'csrc/cape_pi.cu',
         'replaces': 'tropical_cyclone_risk_tpu/ops/pi.py:92',
         'launches': launches['cape_pi'], 'max_abs_err': k6_err,
         'ms': ms_k6, 'plain_ms': ms_k6_plain, 'bound_ms': k6_bound_ms,
         'bound_by': k6_by, 'library_ms': None}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def trace_busy(path):
    """(device busy microseconds, traced span in microseconds, kernel
    count) of a torch.profiler Chrome trace: the union of the GPU kernel
    intervals against the span of all events."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    kern = sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                  for e in events if e.get('cat') == 'kernel')
    if not kern:
        raise AssertionError('the profiler traced no device kernel')
    busy, end = 0.0, -float('inf')
    for a, b in kern:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(float(e['ts']) + float(e['dur']) for e in events)
            - min(float(e['ts']) for e in events))
    return busy, span, len(kern)


def check_tracks(ds, cfg):
    """The schema of runtime.write_tracks_nc and the TC filters on every
    survivor; returns (track count, lifetime peak v per track)."""
    want = {'lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
            'tc_month', 'tc_basins', 'tc_years', 'seeds_per_month',
            'u250_trks', 'v250_trks', 'u850_trks', 'v850_trks'}
    if not want <= set(ds.variables):
        raise AssertionError(f'missing {want - set(ds.variables)}')
    v = ds.variables['v_trks'].data
    lat0 = ds.variables['lat_trks'].data[:, 0]
    peaks = np.nanmax(v, axis=1)
    if not (v.shape[0] > 0 and np.all(peaks >= cfg.seed_v_threshold_ms)
            and np.all(np.abs(lat0) > 2.0)):
        raise AssertionError('survivor tracks fail the TC filters')
    return v.shape[0], peaks


def check_thermo_file(fn, netcdf, synthetic_era5):
    """vmax, chi and rh_mid finite over the ocean (the generator's land
    mask), PI > 40 m/s somewhere in the warm pool (|lat| < 20)."""
    ds = netcdf.read(fn)
    lat = ds.variables['lat'].data
    vmax, chi, rh = (ds.variables[k].data for k in ('vmax', 'chi', 'rh_mid'))
    ocean = np.broadcast_to(synthetic_era5.land_2d(
        ds.variables['lon'].data, lat) == 0, vmax.shape)
    for nm, a in (('vmax', vmax), ('chi', chi), ('rh_mid', rh)):
        if not np.isfinite(a[ocean]).all():
            raise AssertionError(f'thermo {nm} not finite over the ocean')
    warm = vmax[:, np.abs(lat) < 20]
    log(f'[slice 2] thermo file {vmax.shape}: ocean share '
        f'{ocean.mean():.3f}, warm-pool PI max {warm.max():.2f} m/s, chi '
        f'{np.nanmin(chi[ocean]):.3f}..{np.nanmax(chi[ocean]):.3f}, rh_mid '
        f'{np.nanmin(rh[ocean]):.3f}..{np.nanmax(rh[ocean]):.3f}')
    if not warm.max() > 40.0:
        raise AssertionError('no PI above 40 m/s in the warm pool')


def check_small_launch(dev, Namelist, fields, pipeline, rng):
    """A small launch on the card against the same launch through the plain
    twins on the CPU (themselves held against the JAX package by the CPU
    tests): rounding-level differences may flip a borderline verdict, so
    verdicts must agree on >= 99.5% of slots and matched survivors within
    1e-3 deg at genesis and 0.5 m/s in lifetime peak vmax."""
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
    log(f'[slice 1] small launch GPU vs CPU twins: keep agree '
        f'{(kg == kc).mean():.4f} ({kg.sum()} vs {kc.sum()} survivors), '
        f'counted agree {(cg == cc).mean():.4f}, matched survivors: genesis '
        f'lat diff {dlat:.2e}, peak vmax diff {dpk:.2e}')
    if not ((kg == kc).mean() >= 0.995 and (cg == cc).mean() >= 0.999
            and dlat <= 1e-3 and dpk <= 0.5 and both.sum() > 10):
        raise AssertionError('small launch on the card disagrees with the '
                             'CPU twins')


if __name__ == '__main__':
    sys.exit(main())
