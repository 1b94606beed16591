"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times ROOT    (see kernel_times)
    python3 chip_smoke.py --drivers ROOT         (see drivers_times)
    python3 chip_smoke.py --ranks N              (see ranks_times; N cards)
    python3 chip_smoke.py --sass ROOT            (see sass_against)
    python3 chip_smoke.py --lanes                (see lanes_times)
    python3 chip_smoke.py --stacks-times         (see stacks_times)

Phases (any failure raises, and the script exits non-zero):

1. device    - require CUDA; print the card's name and power limit.
2. build     - build the CUDA integrator and genesis gate (K1, K7; one
               library per unit of kernels/integrator.py UNITS: two, three
               and four steering levels, each with and without the in-scan
               vmax, five with and without it, seven, fifteen and
               seventeen; any other count builds at its first launch),
               vmax (K2, with its
               last-sample entry), seeding (K3), compaction (K4), threefry
               (K5), CAPE-PI (K6) and field stacks kernels with nvcc, one
               process each,
               all started together; print the build times, nvcc's register,
               stack and spill report and the SASS local-memory
               instructions of each kernel (and K3's and K6's SASS
               instruction and loop counts); K1's default instance must have
               no stack frame and no spills, and K1's sin and cos path must
               equal CUDA's sinf and cosf on every float32 it takes.
3. K1, K2,   - one 131072-seed launch on the 181x360 one-degree pack with
   K7          every integration segment run through K1 and through the
               plain PyTorch twin on the same inputs, every vmax pass
               through K2 and its twin, and the genesis gate through K7 and
               its twin; agreement within the stated tolerances (K7 bit
               for bit); K1's and K2's times alone on every segment (and
               their sums per launch) beside their bounds and twins, K7's
               beside its bound and twin.
4. K3, K5    - propose_seeds at 131072 slots through K3 (twice) and
               through its plain twin on the card, without retry caps,
               with the auto-tuned caps and with caps that overflow (slots
               drop), and retry_unresolved_curve (twice); K5's bits /
               uniform / normal / randint at [16, n] and [n], its fused
               draw_fourier at [n, 4, 15], and its row draw at the
               integrate order (131072 -> m rows, the main path's) and at
               m == n against the plain threefry twins: all bit-exact; the
               Fourier entries' shared cos/sin on all 2^23 phases they
               meet against torch.cos and torch.sin; one device operation
               per propose_seeds call under torch.profiler; K3's times
               alone and through its dispatcher (device, event and host),
               K5's row and full-width draws (device time), and bounds
               (each draw's least 32-bit operations at the float32
               instruction rate).
   K4        - one 131072-seed launch with every compaction (the integrate
               compaction, every re-compaction boundary) and
               compact_survivors' partition and survivor stitch at k_max 64
               and at k_max = m through K4 and through the plain twins on
               the same inputs, and the edge cases (the stitch's at 1 to
               16 segments, k 1 to 384, W 2 to 34): all bit-exact; times of
               each of the launch's ten partitions and their sum (beside
               torch.sort's stable order, and torch.sort with one
               index_select per row tensor), of the integrate compaction
               (also with the full-width Fourier rows among its row
               tensors, as the parent launch made it) and of the stitch,
               with their bounds.
   modes     - _omega and the Fourier amplitudes on the card equal the
               CPU's bit for bit; for each of the default path,
               time_interp_fields, rk_exact_stage_fields and rk_substeps=2
               (and time_interp_fields with each of the last two) one
               131072-seed launch with K1 held against its twin on the
               first and the last segment and K7 on the launch; K1's time
               alone per mode.
   geo       - land and bathymetry on grids of their own: one 131072-seed
               launch on the pack with its land regridded onto 0.5 degrees
               and the bathymetry proxy on that grid (fused), and one with
               the bathymetry regridded onto 0.25 degrees (separate), in
               the default mode and with time_interp_fields: K1 bit for bit
               against its twin on the first and the last segment, K7 on
               the launch; K1's time alone per launch and layout beside the
               in-cell pack's, with bounds that count each layout's rows.
5. workspace - write one year of a one-degree ERA5-shaped raw workspace on
               the 28 ERA5 pressure levels (utils/synthetic_era5.py).
   fixed     - one 131072-seed launch with debug_fixed_position: K1
               against its twin on the first and the last segment, K7 bit
               for bit, K2 within 1e-4 m/s on every segment, and every
               alive sample's lon and lat equal bit for bit to the storm's
               start.
   BAM       - models/bam.gen_tracks (the uncoupled beta-advection model)
               at 32768 storms on the 181x360 pack, on the card and on the
               CPU from the same numpy-seeded inputs: agreement within
               1e-3 degrees; the card's wall time per call.
6. K6        - gen_thermo over that workspace with cape_pi captured: all
               12 x 181 x 360 columns on 28 levels through K6 and through
               the plain twin on the card, bit for bit (and a sample of
               columns through the twin on the CPU, within the stated
               tolerances); times.
6b. K6 modes - the same columns through K6's five other instances
               (Newton with select_thermo 1 and 2, the 3-D table with
               both, the 2-D table with select_thermo=2) and their twin on
               the card: the largest difference and the columns that
               differ (within 1e-3 m/s), the kernel's device time, its
               bound (Newton: its steps on these inputs at the SASS of one
               step by pipe) and the twin's time.
7. slice 1   - runtime.run_downscaling(cfg, 'GL', pack, seed=0) at
               seed_batch=131072 for two years on a 24-plane synthetic
               pack, counters reset just before and read just after, K7
               held against its twin on every launch; the tracks file is
               read back and checked; a small launch on the card (K1-K5,
               K7) agrees with the same launch through the plain twins on
               the CPU.
8. dvdt0     - run_downscaling as in 7 for one year with
               m_init_mode='dvdt0', counters reset just before and read
               just after, K7 held against its twin on every launch; the
               tracks file is read back and checked; the same for one year
               with time_interp_fields=True and rk_substeps=2.
8b. years    - the production year drivers on a 36-plane (three-year)
               pack: run_downscaling with years_per_program=2 (the fused
               driver, one group of two years and a tail of one; every
               steady-state year settled without run_tracks_year) and with
               years_per_program=1 (the per-year loop with a prefetched
               batch 0), counters reset just before and read just after
               each, write the same file bit for bit; a forced fallback
               (integrate_cap 1/16) through the fused driver equals the
               per-year loop bit for bit, every year handed its fused
               launch; K7 held against its twin on every launch; the host
               synchronisations of one launch, with their sources, under
               torch.cuda.set_sync_debug_mode.
9. slice 2   - the workspace path: cli.main(['GL', '--namelist', ...,
               '--seed', '0']) on cuda at seed_batch=131072 (land masks,
               wind statistics, thermo, pack builder, simulation), counters
               reset just before and read just after; the thermo and
               tracks files are read back and checked; stage times; then
               the CLI once more with --trace-dir (the device's busy share
               of the simulation, from the torch.profiler trace); then the
               CLI on a second workspace with land on 0.5 degrees and
               bathymetry on 0.25 degrees (K7 held against its twin on
               every launch, the files checked as before).
9c. thermo2  - the CLI on the first workspace with select_thermo=2 (K6 on
               the reversible 3-D table), counters reset just before and
               read just after; the thermo and tracks files checked, the
               thermo stage's seconds.
9d. in-scan  - the bench's launch with vmax_in_scan off and on from one
               key, counters reset just before the in-scan launch and read
               just after (K2's post-pass not launched, its last-sample
               entry is): trajectories, verdicts, valid and the stitched
               tracks bit-identical, vmax within 1e-4 m/s of the post-pass;
               K1's in-scan instance bit-exact against its twin on the
               first and last segment, the last-sample entry on every
               segment; the same checks (tracks and verdicts against the
               post-pass launch, K1 against its twin, the entry) with
               time_interp_fields (K1 bit-exact), with rk_substeps=2 (K1
               within the K1 bars, its vmax within 5e-2 m/s) and on the
               three-level pack of 9e (K1 bit-exact, the entry at six
               winds); the launch's wall time with and without.
9e. levels   - steering_levels (250, 500, 850): a bench-width launch on a
               12-plane 181x360 three-level pack, caps auto-tuned, counters
               reset just before and read just after, against the same
               launch through the twins on the card, every leaf bit for
               bit; K1 on the first and last segment with
               time_interp_fields, rk_exact_stage_fields and rk_substeps=2,
               each bit-exact; each kernel's per-launch
               time (the median and range of three rounds) beside the
               two-level one of the same call, K1's three-level
               registers; run_downscaling on that pack and
               cli.main GL on a workspace with 250/500/850 hPa winds,
               counters reset just before and read just after, their files
               holding all six u/v winds, finite at genesis.
9e2. levels4 - the level sets of LEVEL_SETS, four to fifteen steering
               levels, each a bench-width launch on a 12-plane 181x360
               pack of its winds, caps auto-tuned, through K1 and K7 (the
               unit TC_K1_LEVELS of its count), K2, K5's row entry and K4's
               stitch at W = 2 L, counters reset just before and read just
               after (no twin), against the same launch through the twins
               on the card, every leaf bit for bit: (250, 500, 700, 850)
               and (250, 300, 500, 700, 850) hPa also with
               time_interp_fields, K1 on the first and last segment with
               rk_exact_stage_fields and rk_substeps=2 bit for bit, and
               vmax_in_scan bit for bit the post-pass, the five-level
               set also through cli.main GL on a one-degree workspace of
               its winds; plev19's seven levels in the layer; at five and
               seven levels also the launch on packs with land and
               bathymetry on grids of their own (fused and separate, as
               phase geo; default mode and time_interp_fields), K1 bit
               for bit against its twin on the first and last segment and
               K7 against its twin; the ERA5
               request's fifteen, with K1 against its twin on the first
               segment (the twin's Python Cholesky is the cost) and every
               other kernel over the whole launch; the fifteen and 200 and
               225 hPa (34 winds, more than a warp's lanes) the same way.
               K1's instances not launched otherwise, each on the card and
               bit for bit against its twin on the first 4 steps (2 in
               the analytic modes) of segment 0 of a launch in its stack
               layout, K7 against its twin on those launches: at five
               levels the analytic ones with time_interp_fields or on geo
               packs and 11 of the in-scan unit's 12, at seven the
               analytic ones and time_interp_fields in the cell row, at
               fifteen all but the default (check_instances).  Per set: each kernel's
               per-launch time alone beside its bound, its twin and the
               set before's, the unit's registers, stack and spills and
               nvcc seconds, the launch's peak memory and the share of
               alive storm-steps whose gathered covariance is positive
               definite.
9e3. gcm     - the CMIP6 path: a 1-degree one-year workspace of
               utils/synthetic_cmip6 (noleap calendar, plev in Pa, tos in
               degC on the finer ocean grid) through cli.main GL at
               250/850 hPa, and one with the daily winds on plev8 at
               250/500/700/850 hPa, counters reset just before and read
               just after each (every kernel of the workspace path, K6
               among them, no twin), every regrid on the card; the
               thermo and tracks files checked (the variables of
               tests/test_cmip6_e2e.py, every level's winds); stage times;
               K6 on the workspace's six Amon levels in Pa (CMIP6's
               Amon files hold plev19) bit-exact against its twin and
               timed; the SST regrid on the card against the CPU's,
               bit for bit.
9f. mesh     - seed-axis sharding on the card: 4 virtual shards on the
               one card at the bench launch's width (131072 seeds, 32768 a
               shard), simulate_batch_sharded through the kernels (counters
               reset just before and read just after, K4's partitions and
               stitch and K7 held against their twins call by call) and
               through the twins on the card: keep, scalars, seed tables,
               valid and the tracks bit for bit; its wall time beside the
               one-device launch's, the shard-major partition and stitch
               timed beside their bounds; run_tracks_years_fused on the mesh
               against the per-year loop on the mesh, bit for bit;
               run_downscaling in a one-rank NCCL group
               (distributed.initialize, global_seed_mesh) against the
               one-process one-shard mesh, the same file bit for bit;
               cli.main GL --devices 2 raising make_mesh's 'devices' error;
               _simulate_batches against three _simulate_batch calls;
               simulator.integrate (K7, K1) against its CPU twin.
10. times    - launch times, a torch.profiler trace of three launches
               (device kernels per launch, busy share, host time by
               stage, the genesis gate's among them, device time by
               operator) and the two-year run.
11. bench    - the port's bench entry point (python -m
               tropical_cyclone_risk_tpu_torch.bench) at its full workload
               in process, counters reset just before and read just after:
               its one JSON line (bench.py's keys, the card's name and
               power limit), its rates checked positive, its peak device
               memory and its kernel launches; then the two year drivers
               on its workload pass by pass (8 years, each pass from
               nothing issued): seconds per year, launches, host
               synchronisations with their sources, the device's busy
               share.

The line before the card line is a JSON object with each kernel's route,
source, launches on the workspace path (and in the bench run and the mesh
launch), error
against its twin, times and bound; the last line is {"ok": true,
"device": {...}}.  Builds go to build/.  Every time printed stands beside
the card's name and power limit.
"""

import contextlib
import json
import math
import os
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
# K3 and K5 against their twins on the card: the same operations in the
# same order (-fmad=false, CUDA's libm on both sides, true divisions), so
# every output field is bit-exact
K3_K5_TOL = 0.0
# retry caps whose 2048-wide rounds overflow at 131072 slots: unresolved
# slots beyond a round's width are dropped (the twin's semantics)
OVERFLOW_CAPS = (1 / 64,) * 15
# the kernels a simulation (run_downscaling) launches, those of the
# workspace path (cli.main), and those of a launch with the in-scan vmax
SIMULATION_KERNELS = ('integrator', 'vmax', 'seeding', 'threefry', 'compact',
                      'genesis', 'stacks')
WORKSPACE_KERNELS = SIMULATION_KERNELS + ('cape_pi',)
IN_SCAN_KERNELS = ('integrator', 'vmax_last', 'seeding', 'threefry',
                   'compact', 'genesis', 'stacks')
WS_YEAR = 2016      # the workspace: one year at one degree
# repetitions of each K1 segment, K2 and K4 call when timed alone
K1_REPS = 20
# K7's kernels: the thread-per-seed gate of two to four levels and the
# group gate from GROUP_LEVELS (csrc/integrator.cu kGroupLevels) on
K7_KERNELS = ('genesis_gate_kernel', 'genesis_group_kernel')
GROUP_LEVELS = 5
K2_REPS = 20
K4_REPS = 20
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# HBM bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# no 32-bit operation, integer or float, issues faster than the float32
# FMA rate: an SM issues four warp instructions a clock (128 lanes), which
# is PEAK_F32 / 2 (an FMA counts two of PEAK_F32's operations).  The
# threefry draws (K3, K5) count their least operations at this rate
# (ops32_bound): a static SASS count per pipe at the ALU pipe's 64 lanes
# put K5's row draw at C = 8 above its measured time
PEAK_OPS32 = PEAK_F32 / 2
# the least 32-bit operations of one threefry2x32 draw (csrc/threefry.cuh):
# 20 rounds of an add, a rotate and an xor; the key injections and the
# output xor are not counted (some fold into the rounds' three-input adds)
DRAW_OPS = 60
# a Fourier element of K5 (csrc/rng.cu): its draw, the uniform's subtract,
# the phase product, phase_sincos's 15 float operations and the two
# amplitude products
FOURIER_OPS = DRAW_OPS + 19
# the rounds in which launch_kernel_times times each kernel
TIME_ROUNDS = 3
# instructions a Hopper SM issues per clock on each pipe (lanes): the
# integer ALU 64, the FMA pipe (float32 FFMA / FMUL / FADD and IMAD) 128,
# the multi-function unit and the conversions 16, float64 64; 132 SMs at
# the clock nvidia-smi reports as clocks.max.sm.  K6's Newton steps are
# bound by these (pipe_bound)
PIPE_RATE = {'alu': 64, 'fma': 128, 'mufu': 16, 'fp64': 64}
N_SMS = 132
# SASS opcodes by pipe (the rest: memory, control, moves, uniform datapath)
PIPE_OPS = {
    'alu': ('IADD3', 'LOP3', 'SHF', 'ISETP', 'SEL', 'LEA', 'PRMT', 'IMNMX',
            'VIMNMX', 'VIADD', 'FMNMX', 'FSETP', 'FSEL', 'IABS', 'POPC',
            'FLO', 'BREV', 'PLOP3', 'P2R', 'R2P', 'BMSK', 'SGXT', 'LOP',
            'IADD', 'SHL', 'SHR'),
    'fma': ('FFMA', 'FMUL', 'FADD', 'IMAD', 'IMUL', 'HFMA2', 'HADD2',
            'HMUL2', 'FSWZADD'),
    'mufu': ('MUFU', 'F2I', 'I2F', 'F2F', 'I2I', 'FRND', 'F2FP'),
    'fp64': ('DADD', 'DMUL', 'DFMA', 'DSETP')}


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


def host_ms(fn, reps):
    """Median host milliseconds to issue fn() over reps runs: the
    wrapper's Python and its launches, the device left to run behind them
    (the median, since the host's cores are shared)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e3


@contextlib.contextmanager
def captured(mod, name, check=None, keep=True):
    """Within the block, mod.name is a wrapper that appends (args, kw, out,
    check(out, *args, **kw) or None) of each call to the list it yields
    (without keep, (None, None, None, check)); a check runs as the call is
    made, before later work can touch its inputs."""
    fn, calls = getattr(mod, name), []

    def capture(*args, **kw):
        out = fn(*args, **kw)
        res = None if check is None else check(out, *args, **kw)
        calls.append((args, kw, out, res) if keep else (None, None, None,
                                                        res))
        return out

    setattr(mod, name, capture)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


def uncounted(fn, *args, **kw):
    """fn(*args, **kw) with the launch and twin counters left as they were:
    a twin run only to compare a kernel with it does not count."""
    from tropical_cyclone_risk_tpu_torch import kernels
    saved = dict(kernels.LAUNCHES), dict(kernels.PLAIN_ON_CUDA)
    try:
        return fn(*args, **kw)
    finally:
        kernels.LAUNCHES.update(saved[0])
        kernels.PLAIN_ON_CUDA.update(saved[1])


def check_k7(out, *args):
    """(bit-exact, seeds the gate rejected) of one K7 call (out, the keep
    mask) against its twin on the same inputs, the twin uncounted."""
    from tropical_cyclone_risk_tpu_torch.models import simulator
    ref = uncounted(simulator.genesis_alive_plain, *args)
    return same(out, ref), int(args[4].sum()) - int(out.sum())


def k7_results(label, calls):
    """Log and require K7's checks over the calls of a phase."""
    bad = [i for i, c in enumerate(calls) if not c[3][0]]
    log(f'[{label}] K7 against its twin on {len(calls)} launches: masks '
        f'bit-exact {not bad}; integrable seeds rejected by the gate '
        f'{[c[3][1] for c in calls][:12]}')
    if bad or not calls:
        raise AssertionError(f'{label}: K7 differs from its twin on calls '
                             f'{bad} of {len(calls)}')


def bound(n_bytes, n_ops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move n_bytes once and do n_ops float32 operations."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_b, t_o) * 1e3, 'bytes' if t_b >= t_o else 'operations'


def ops32_bound(n_bytes, n_ops):
    """bound() for n_ops 32-bit operations, integer or float, at
    PEAK_OPS32."""
    return bound(n_bytes, 2 * n_ops)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sm_clock_hz():
    """The SM clock nvidia-smi reports as clocks.max.sm, in Hz."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def pipe_bound(n_bytes, counts, clock_hz):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move n_bytes once and issue `counts` ({pipe: instructions over all
    threads}) at PIPE_RATE on N_SMS SMs at clock_hz."""
    t_b = n_bytes / PEAK_BYTES
    t_o = max([0.0] + [n / (PIPE_RATE[p] * N_SMS * clock_hz)
                       for p, n in counts.items() if p in PIPE_RATE])
    return max(t_b, t_o) * 1e3, 'bytes' if t_b >= t_o else 'operations'


def compare_k1(out, ref):
    """(share of storms with the same alive history, max abs error per
    field over samples alive in both, share of bit-exact lon samples) of
    one segment integrated by K1 (out) and by its twin (ref); with the
    in-scan vmax, its error too ('vmax')."""
    (ko, kc), (po, pc) = out, ref
    (k_end, k_alive), (p_end, p_alive) = kc[:2], pc[:2]
    agree = ((ko[5] == po[5]).all(dim=0) & (k_alive == p_alive))
    both = ko[5] & po[5]
    err = {}
    for i, nm in enumerate(('lon', 'lat', 'v', 'm', 'wnds')):
        msk = both if ko[i].dim() == 2 else both[..., None].expand_as(ko[i])
        err[nm] = float((ko[i] - po[i]).abs()[msk].max()) if msk.any() \
            else 0.0
    if len(ko) > 6:
        err['vmax'] = max_err(ko[6][both], po[6][both])
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


def gather_bytes(stacks, lon, lat, plane):
    """The bytes of the distinct corner-packed rows that field samples at
    (lon, lat, plane) read: a cell row (336 bytes in-cell, 304 otherwise)
    per distinct (plane, cell), and, where land and bathymetry have grids
    of their own, a land_geo4 row (32 bytes fused, 16 separate) per
    distinct cell of the land grid and a 16-byte bathy4 row per distinct
    cell of the bathymetry grid."""
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.ops import interp

    def rows(grid, stack, plane=None):
        ix, _ = interp._cell_and_weight(lon, grid.lon0, grid.dlon, grid.nlon)
        iy, _ = interp._cell_and_weight(lat, grid.lat0, grid.dlat, grid.nlat)
        cell = iy * grid.nlon + ix
        if plane is not None:
            cell = cell + plane.to(torch.int64) * (grid.nlat * grid.nlon)
        return int(torch.unique(cell).numel()) * stack.shape[-1] * 4

    layout = integrator.geo_layout(stacks)
    b = rows(stacks.grid, stacks.cell4,
             plane.clamp(0, stacks.cell4.shape[0] - 1))
    if layout != integrator.IN_CELL:
        b += rows(stacks.land_grid, stacks.land_geo4)
    if layout == integrator.SEPARATE_GEO:
        b += rows(stacks.bathy_grid, stacks.bathy4)
    return b


def k1_bound(args, out):
    """K1's bound on one segment.  Bytes: F(t), the initial state, the
    outputs and end state once each, and the corner-packed rows of the
    distinct cells the storms sampled (gather_bytes: what this run's data
    reads of the stacks).  Operations: at least 360 float32 operations per
    storm-step (four RHS evaluations, the RK4 combination, the wind
    coloring) and 150 per field gather (the 21-channel blend, the 4x4
    Cholesky), counted from csrc/integrator.cu at two steering levels, a
    transcendental as one (more levels do more; the count stays a lower
    bound).  With the in-scan vmax the outputs and carry hold its leaves
    too."""
    from tropical_cyclone_risk_tpu_torch.models import simulator
    stacks, cfg, _, y0, alive0, params, _, n_steps = args[:8]
    outs, carry = out
    end_y, end_alive = carry[:2]
    m = y0.lon.shape[0]
    alive = outs[5]
    plane = params.plane.to(torch.int64)[None].expand_as(alive)[alive]
    stride, n_blocks = simulator.segment_plan(cfg, n_steps)
    gathers = n_blocks + (n_steps - n_blocks * stride)
    b = (gather_bytes(stacks, outs[0][alive], outs[1][alive], plane)
         + n_steps * m * 4 * cfg.n_wind_levels
         + nbytes(y0.lon, y0.lat, y0.v, y0.m, alive0, params.plane,
                  params.h_bl) + nbytes(*outs, *end_y, end_alive)
         + sum(nbytes(*d) for d in (args[8:9] + carry[2:]) if d is not None))
    return bound(b, m * (360 * n_steps + 150 * gathers))


def k1_launcher(args, entry=None):
    """A function that runs K1 on the arguments of one
    simulator.integrate_segment call (with its DiagState and t_last where
    the call has them), with the F(t) grid that its dispatcher builds: the
    launch function of kernels/integrator.py launcher (the kernel alone),
    or, given an entry such as integrator.integrate_segment_cuda, a call
    of it (the wrapper)."""
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.models import simulator
    stacks, cfg, bounds, y0, alive0, params, k0, n_steps = args[:8]
    stride, n_blocks = simulator.segment_plan(cfg, n_steps)
    f_all = (None if simulator.analytic_fourier(cfg)
             else simulator.fourier_grid(cfg, params, k0, n_steps))
    full = args[:8] + (f_all, stride, n_blocks) + tuple(args[8:])
    if entry is None:
        return integrator.launcher(*full)[0]
    return lambda: entry(*full)


def k2_bound(args, kw, out):
    """K2's bound on one call: its inputs and outputs once each, of the
    winds [T, N, W] the four shear components it reads (16 bytes a
    sample, whatever W), against at least 40 float32 operations per
    (step, storm) (the kernel's note)."""
    wnds = args[4]
    ins = [a for a in args if isinstance(a, torch.Tensor) and a is not wnds]
    ins += [t for v in kw.values() if v is not None
            for t in (v if isinstance(v, tuple) else (v,))
            if isinstance(t, torch.Tensor)]
    return bound(nbytes(*ins, *out) + 16 * wnds[..., 0].numel(),
                 40 * args[0].numel())


def k2_launcher(args, kw):
    """The launch function of kernels/vmax.py launcher (the kernel alone)
    on the arguments of one diagnostics.axi_to_max_wind_raw call."""
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
    from tropical_cyclone_risk_tpu_torch.models import diagnostics
    cfg = args[7] if len(args) > 7 else kw.get('cfg')
    return k2.launcher(*args[:7], diagnostics._shear_channels(cfg),
                       kw.get('pos_before'), kw.get('pos_after'))[0]


def gate_ops(levels):
    """K7's float32 operations per seed at `levels` steering levels
    (csrc/integrator.cu gate_keep, genesis_group_kernel), a square root,
    division or power as one: the cell weights (seven a grid axis), the
    blend of the W + W (W + 1) / 2 + 7 channels (nine a channel and the
    two complements), the W x W Cholesky (pivot j: 2 j for its sum, a
    compare, a clamp, the root and the reciprocal; each entry below it 2 j
    and a product), the derived sample (seven), F(0)'s 14 adds a wind, the
    colouring (W products and W - 1 adds a row, the mean and the select),
    the shear's magnitude times chi (eight) and the compare (six)."""
    W = 2 * levels
    cell = W + W * (W + 1) // 2 + 7
    blend = 14 + 9 * cell + 2
    chol = sum(2 * j + 4 + (W - 1 - j) * (2 * j + 1) for j in range(W))
    colour = W * (2 * W + 1) + 8
    return blend + chol + 7 + 14 * W + colour + 6


def k7_bound(args, out):
    """K7's bound on one call.  Bytes: the corner-packed rows of the
    distinct cells the seeds sample (gather_bytes: what this run's data
    reads of the stacks), and lon, lat, the int32 plane, B, the integrate
    mask and the keep mask once each.  Operations: gate_ops at the call's
    level count per seed."""
    stacks, _, y0, params, integrate = args
    m = y0.lon.shape[0]
    b = (gather_bytes(stacks, y0.lon, y0.lat, params.plane) + 4 * m
         + nbytes(y0.lon, y0.lat, params.fourier.B, integrate, out))
    return bound(b, gate_ops(params.fourier.B.shape[1] // 2) * m)


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


# K6's instances besides the default (name: select_thermo, select_interp,
# the table), each held against its twin on the workspace's columns.  The
# tables: the reversible 3-D table the thermo driver builds for
# select_thermo=2; for the pseudoadiabatic branch on a 3-D table, the 2-D
# pseudoadiabatic table on the r_t slabs, 0.05 K apart; for the reversible
# branch on a 2-D table, the 3-D table's slab at r_t = 0.021
K6_MODES = {'pseudo-newton': (1, 1, None),
            'reversible-newton': (2, 1, None),
            'reversible-table3': (2, 2, 'table3'),
            'pseudo-table3': (1, 2, 'pseudo3'),
            'reversible-table2': (2, 2, 'slab')}
K6_NEWTON_REPS = 5


def k6_mode_tables(table, dev):
    """{table name of K6_MODES: the table on dev}, from the default 2-D
    table."""
    from tropical_cyclone_risk_tpu_torch.ops import pi as pi_ops
    t3 = pi_ops.EntropyTable3.create(dev)
    nrt = t3.T.shape[-1]
    rt = t3.rt0 + t3.drt * np.arange(nrt)
    shifted = (table.T.cpu().numpy()[..., None]
               - np.float32(0.05) * np.arange(nrt, dtype=np.float32))
    return {'table3': t3,
            'pseudo3': pi_ops.EntropyTable3.from_arrays(
                table.grid.lat_axis(), table.grid.lon_axis(), rt, shifted,
                dev),
            'slab': pi_ops.EntropyTable.from_arrays(
                t3.grid.lat_axis(), t3.grid.lon_axis(),
                t3.T.cpu().numpy()[..., 9], dev)}


def newton_inversions(args):
    """The Newton inversions a cape_pi call needs on these inputs, as the
    kernel makes them: the saturated parcel on every level of every
    column, the lifted one from its first condensing level up (the
    twin's Icond)."""
    from tropical_cyclone_risk_tpu_torch import constants as pr
    from tropical_cyclone_risk_tpu_torch.ops import thermo
    from tropical_cyclone_risk_tpu_torch.ops.interp import true_div
    sst, p_surf, p_env, T_env, r_env = args[:5]
    L = p_env.shape[0]
    T_ns, r_ns = T_env[0], r_env[0]
    _, rs = thermo.sat_thermo(sst, p_surf)
    rh = r_ns / rs * (1 + true_div(rs, pr.eps)) / (1 + true_div(r_ns, pr.eps))
    p_lcl = thermo.get_LCL(p_env[0], T_ns, r_ns, rh)
    cond = p_lcl[None] > p_env.reshape((L,) + (1,) * sst.dim())
    cond[-1] = True
    first = cond.to(torch.uint8).argmax(dim=0)
    return sst.numel() * L + int((L - first).sum())


def sass_loop_pipes(lib_path, label):
    """{pipe: static SASS instructions} of the shortest loop (the span from
    a backward branch's target to the branch) of the kernel labelled
    `label` (kernel_label) in a built library: the Newton step of K6's
    Newton instances."""
    import collections
    import re
    text = cuobjdump('-sass', lib_path)
    if text is None:
        raise AssertionError('no cuobjdump: the Newton bounds count the '
                             'SASS')
    for part in re.split(r'\n\s*Function : ', text)[1:]:
        if kernel_label(part.split('\n', 1)[0].strip()) != label:
            continue
        ins = []
        for line in part.splitlines():
            m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?'
                          r'([A-Z][A-Z0-9_.]*)([^;]*)', line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
        loops = []
        for at, op, rest in ins:
            b = re.search(r'0x([0-9a-f]+)', rest)
            if op.startswith('BRA') and b and int(b.group(1), 16) < at:
                lo = int(b.group(1), 16)
                # a Newton step's seven IEEE divisions (the level prologue
                # makes one)
                rcp = sum(o.startswith('MUFU.RCP') for a, o, _ in ins
                          if lo <= a <= at)
                if rcp >= 5:
                    loops.append((at - lo, lo, at))
        if not loops:
            raise AssertionError(f'{label}: no Newton loop in the SASS')
        _, lo, hi = min(loops)
        return dict(collections.Counter(pipe_of(op) for at, op, _ in ins
                                        if lo <= at <= hi))
    raise AssertionError(f'{label} not in the SASS of {lib_path}')


def check_k6_modes(args, kw, card, lib_path, clock):
    """Phase K6 modes: on the main path's inputs (the workspace's columns
    and levels, captured in phase K6), each instance of K6_MODES through
    ops.pi.cape_pi (K6) and its twin on the card: agreement (the largest
    difference and the columns that differ), the kernel's device time
    alone, its bound (table instances: k6_bound; Newton: the Newton steps
    these inputs need, NEWTON_ITERS per inversion, at the SASS
    instructions of one step by pipe) and the twin's time.  Returns
    {instance: its numbers}."""
    from tropical_cyclone_risk_tpu_torch.kernels import cape_pi as k6
    from tropical_cyclone_risk_tpu_torch.ops import pi as pi_ops
    from tropical_cyclone_risk_tpu_torch.ops import thermo
    t0 = time.perf_counter()
    tables = k6_mode_tables(args[5], args[0].device)
    log(f'[K6 modes] tables built in {time.perf_counter() - t0:.2f} s '
        f'(the reversible 3-D table {tuple(tables["table3"].T.shape)} by '
        f'Newton on the CPU)')
    out_modes = {}
    for name, (thermo_, interp, tname) in K6_MODES.items():
        margs = args[:5] + (tables.get(tname, args[5]),)
        mkw = dict(kw, select_thermo=thermo_, select_interp=interp)
        out = pi_ops.cape_pi(*margs, **mkw)
        ref = uncounted(pi_ops.cape_pi_plain, *margs, **mkw)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        n_diff = int((out != ref).sum())
        ok = bool(torch.isfinite(out).all()) and err <= K6_TOL
        newton = interp == 1
        reps = K6_NEWTON_REPS if newton else 20
        ms = device_ms(lambda: pi_ops.cape_pi(*margs, **mkw), reps,
                       ('cape_pi_kernel',))
        plain = cuda_ms(lambda: pi_ops.cape_pi_plain(*margs, **mkw), 1)
        if newton:
            steps = newton_inversions(margs) * thermo.NEWTON_ITERS
            per_step = sass_loop_pipes(
                lib_path, f'cape_pi_kernel<{thermo_},{k6.NEWTON}>')
            b, by = pipe_bound(nbytes(*margs[:5], out),
                               {p: n * steps for p, n in per_step.items()},
                               clock)
            extra = (f'; {steps} Newton steps at {per_step} SASS '
                     f'instructions each by pipe')
        else:
            b, by = k6_bound(margs, out)
            extra = ''
        out_modes[name] = {
            'select_thermo': thermo_, 'select_interp': interp,
            'table': tname or 'none', 'max_abs_err': err,
            'differing_columns': n_diff, 'ms': ms, 'plain_ms': plain,
            'bound_ms': b, 'bound_by': by,
            'pi_max': float(out.max())}
        log(f'[K6 modes] {card}: {name} (select_thermo={thermo_}, '
            f'select_interp={interp}, table {tname}): max abs err '
            f'{err:.3e} m/s against the twin, {n_diff} of {out.numel()} '
            f'columns differ, PI max {float(out.max()):.2f} m/s; kernel '
            f'{ms:.4f} ms device, bound {b:.4f} ms ({by}), plain twin '
            f'{plain:.2f} ms{extra}')
        if not ok:
            raise AssertionError(f'K6 {name}: err {err} (tol {K6_TOL}), '
                                 f'{n_diff} columns differ')
        del out, ref
    return out_modes


def check_fixed(key, pack_y, cfg_t, plane0, card):
    """Phase fixed: one full-width launch with debug_fixed_position (the
    reference's intensity-only integration): K1 against its twin on the
    first and the last segment (K1_TOL, K1_ALIVE_AGREE; the share of
    bit-exact samples logged), K7 bit for bit on the launch, K2 within
    K2_TOL on every segment, and every alive sample's lon and lat equal
    bit for bit to the position the storm started its segment from (so,
    segment by segment, to its genesis point).  Returns K1's largest
    error."""
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics,
                                                        pipeline, simulator)
    cfg = cfg_t.replace(debug_fixed_position=True)
    with captured(simulator, 'integrate_segment') as calls, \
            captured(simulator, 'genesis_alive', check_k7,
                     keep=False) as gates, \
            captured(diagnostics, 'axi_to_max_wind_raw',
                     lambda out, *a, **kw: compare_k2(
                         out, uncounted(
                             diagnostics.axi_to_max_wind_raw_plain, *a,
                             **kw), a[5]), keep=False) as k2_calls:
        pipeline._simulate_batch(key, pack_y, cfg, BASIN, N_SEEDS, 64,
                                 plane0)
    torch.cuda.synchronize()
    k7_results('fixed', gates)
    frozen = True
    for args, _, out, _ in calls:
        y0, (outs, (end_y, end_alive)) = args[3], out[:1] + (out[1][:2],)
        alive = outs[5]
        for got, start, end in ((outs[0], y0.lon, end_y.lon),
                                (outs[1], y0.lat, end_y.lat)):
            frozen &= bool((got == start[None])[alive].all())
            frozen &= bool((end == start)[end_alive].all())
    res = []
    worst = 0.0
    for args, _, out, _ in (calls[0], calls[-1]):
        agree, err, exact = compare_k1(
            out, uncounted(simulator.integrate_segment_plain, *args))
        res.append((args[7], args[3].lon.shape[0], agree, exact, err))
        worst = max([worst] + list(err.values()))
        if agree < K1_ALIVE_AGREE or any(not err[nm] <= tol
                                         for nm, tol in K1_TOL.items()):
            raise AssertionError(f'K1 with fixed positions: alive agreement '
                                 f'{agree}, errors {err}')
    k2_err = max(c[3][0] for c in k2_calls)
    n_alive = sum(int(c[2][0][5].sum()) for c in calls)
    log(f'[fixed] {card}: debug_fixed_position, {len(calls)} segments, '
        f'{n_alive} alive samples: every alive lon and lat equal to the '
        f'segment start bit for bit {frozen}; K1 against its twin on the '
        f'first and last (steps, storms, alive agreement, bit-exact lon '
        f'share, max abs err) {res}; K2 max abs err {k2_err:.3e} on '
        f'{len(k2_calls)} calls')
    if not frozen:
        raise AssertionError('fixed positions moved')
    if not (k2_err <= K2_TOL and all(c[3][1] for c in k2_calls)):
        raise AssertionError(f'K2 with fixed positions: err {k2_err}')
    return worst


BAM_STORMS = 32768
BAM_TOL = 1e-3        # degrees, as tests/test_torch_bam.py against JAX


def check_bam(pack_y, cfg, card):
    """Phase BAM: models/bam.gen_tracks (the uncoupled beta-advection
    model, plain torch) at BAM_STORMS storms on the pack, on the card and
    on the CPU from the same numpy-seeded inputs (genesis points in the GL
    belt, planes, Fourier A/B): alive histories equal up to exits on the
    basin margin, lon and lat within BAM_TOL where both are alive; the
    card's wall time per call.  Returns its numbers."""
    from tropical_cyclone_risk_tpu_torch.models import bam
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    from tropical_cyclone_risk_tpu_torch.utils import basins
    r = np.random.default_rng(0)
    n = BAM_STORMS
    lon = r.uniform(0.0, 360.0, n).astype(np.float32)
    lat = (r.choice([-1.0, 1.0], n) * r.uniform(5.0, 30.0, n)).astype(
        np.float32)
    plane = r.integers(0, 12, n).astype(np.int32)
    k = np.arange(1, fourier.N_FOURIER + 1, dtype=np.float32)
    amp = np.sqrt(2.0 / np.sum(k ** -3.0)) * k ** -1.5
    phi = r.random((n, 4, fourier.N_FOURIER))
    A = (amp * np.cos(2 * np.pi * phi)).astype(np.float32)
    B = (amp * np.sin(2 * np.pi * phi)).astype(np.float32)

    def run(pack):
        dev = pack.device
        t = lambda a: torch.from_numpy(a).to(dev)
        return bam.gen_tracks(pack, cfg, BASIN, t(lon), t(lat), t(plane),
                              fourier.FourierSeries(t(A), t(B),
                                                    cfg.T_fourier_s))

    pack_cpu = type(pack_y)(*(x.cpu() if isinstance(x, torch.Tensor) else x
                              for x in pack_y))
    t0 = time.perf_counter()
    want = [x.numpy() for x in run(pack_cpu)]
    t_cpu = time.perf_counter() - t0
    got = [x.cpu().numpy() for x in run(pack_y)]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(pack_y)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    (gl, ga, galive), (wl, wa, walive) = got, want
    lon_lo, lat_lo, lon_hi, lat_hi = basins.basin_bounds(cfg, BASIN)
    bad = []
    for i in np.flatnonzero((galive != walive).any(axis=1)):
        d = int(np.argmax(galive[i] != walive[i]))
        x, y = (gl[i, d], ga[i, d]) if galive[i, d] else (wl[i, d], wa[i, d])
        if min(abs(x - (lon_lo + 1)), abs(x - (lon_hi - 1)),
               abs(y - (lat_lo + 1)), abs(y - (lat_hi - 1))) > BAM_TOL:
            bad.append(i)
    both = galive & walive
    err = max(float(np.abs(gl - wl)[both].max()),
              float(np.abs(ga - wa)[both].max()))
    res = {'storms': n, 'steps': int(galive.shape[1]),
           'alive_differ': int((galive != walive).any(axis=1).sum()),
           'max_abs_err_deg': err, 'wall_s': statistics.median(walls),
           'walls_s': walls, 'cpu_s': t_cpu}
    log(f'[BAM] {card}: gen_tracks {n} storms x {res["steps"]} steps on '
        f'the card against the CPU: {res["alive_differ"]} alive histories '
        f'differ ({len(bad)} off the margin), lon/lat max abs err '
        f'{err:.3e} deg (tol {BAM_TOL}); card wall '
        f'{res["wall_s"]:.4f} s per call (median of '
        f'{[round(w, 4) for w in walls]}), CPU {t_cpu:.2f} s')
    if bad or not err <= BAM_TOL or not galive[:, 0].all():
        raise AssertionError(f'BAM card against CPU: err {err}, storms off '
                             f'the margin {bad[:10]}')
    return res


def same(a, b):
    """Bit-exact equality of two tensors (NaN equal to NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    eq = a == b
    if a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return bool(eq.all())


def max_err(a, b):
    """Max abs difference of two tensors of one shape (NaN pairs skipped)."""
    if a.is_floating_point():
        d = (a - b).abs()[~(torch.isnan(a) & torch.isnan(b))]
    else:
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return float(d.max()) if d.numel() else 0.0


def check_counts(label, launches, plain, names):
    """Every kernel of `names` launched on the path and no twin on CUDA."""
    log(f'[{label}] kernel launches {launches}; plain twins on CUDA {plain}')
    if min(launches[k] for k in names) < 1 or max(plain.values()) > 0:
        raise AssertionError(f'{label} did not run through {names} alone')


# K3's operations beside its draws (DRAW_OPS each): an interpolated value
# ~25 float32 operations (two cell lookups and the blend)
OPS_PER_VALUE = 25


def k3_bound(key, pack, cfg, prop):
    """K3's bound on one propose_seeds call.  Bytes: the run-mask cells
    (four corners) of the rounds its slots test, the basin-mask cells (all
    basins) and env cells (vpot and rh of the slot's plane) at each slot's
    final position, and its 11 outputs, each once.  Operations: the draws
    it needs (two per round of the sequential walk up to the first pass;
    month two, rejection one, v_init one) and the values it
    interpolates: each draw DRAW_OPS, each value OPS_PER_VALUE
    (ops32_bound).  Returns ((ms, by), the rounds the sequential walk
    tests)."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.models import seeding
    from tropical_cyclone_risk_tpu_torch.ops import interp
    from tropical_cyclone_risk_tpu_torch.utils import basins
    R, n, dev = seeding.N_RETRY_ROUNDS, N_SEEDS, pack.device
    k_lon, k_lat0, k_latr, *_ = rng.split(key, 6)
    lon_r, lat_r = seeding._position_rounds(
        k_lon, k_lat0, k_latr, basins.basin_bounds(cfg, BASIN), n, dev)
    passes = (seeding._mask_lookup(pack)(lon_r.reshape(-1), lat_r.reshape(-1))
              .reshape(R, n) >= seeding.MASK_PASS)
    first = torch.where(passes.any(0), passes.to(torch.uint8).argmax(0), R)
    tested = torch.arange(R, device=dev)[:, None] <= first[None]

    def cells(grid, lon, lat, plane=None):
        ix, _ = interp._cell_and_weight(lon, grid.lon0, grid.dlon, grid.nlon)
        iy, _ = interp._cell_and_weight(lat, grid.lat0, grid.dlat, grid.nlat)
        base = iy * grid.nlon + ix
        if plane is not None:
            base = base + plane.to(torch.int64) * (grid.nlat * grid.nlon)
        return int(torch.unique(torch.cat([
            base, base + 1, base + grid.nlon, base + grid.nlon + 1])).numel())

    n_tested = int(tested.sum())
    B = pack.basin_masks.shape[-1]
    n_bytes = 4 * (cells(pack.mask_grid, lon_r[tested], lat_r[tested])
                   + B * cells(pack.mask_grid, prop.lon, prop.lat)
                   + 2 * cells(pack.grid, prop.lon, prop.lat, prop.plane)
                   ) + nbytes(*prop)
    draws = 2 * n_tested + 4 * n
    values = n_tested + (B + 2) * n
    return ops32_bound(n_bytes, draws * DRAW_OPS + values * OPS_PER_VALUE), \
        n_tested


def k3_times(key, pack, cfg, plane0):
    """One propose_seeds call (the dispatcher) at N_SEEDS slots: its device
    time, CUDA-event time and host time per call, and its device
    operations per call with their names."""
    from tropical_cyclone_risk_tpu_torch.models import seeding

    def call():
        return seeding.propose_seeds(key, pack, cfg, BASIN, N_SEEDS, plane0)
    ops, names = device_ops(call, 10)
    return {'device_ms': device_ms(call, 20, entry='seeding'),
            'event_ms': cuda_ms(call, 20),
            'host_ms': host_ms(call, 50), 'device_ops': ops,
            'device_op_names': names}


def k3_alone(key, pack, cfg, plane0):
    """K3's kernel alone on one kept launcher and arena: device time
    (torch.profiler) and CUDA-event time per launch."""
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
    lau = k3.launcher(pack, cfg, BASIN, N_SEEDS, plane0)
    arena, _ = lau.outputs()
    launch = lambda: lau(key, arena)
    return {'ms': device_ms(launch, 20, ('seed_kernel',)),
            'alone_event_ms': cuda_ms(launch, 20)}


def check_k3_k5(pack_y, cfg_t, card):
    """Phase 4: K3 and K5 against their plain twins on the card at the
    bench's shapes, then their times and bounds.  Returns the two kernels'
    JSON entries (launches are filled in from the workspace path)."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    from tropical_cyclone_risk_tpu_torch.models import pipeline, seeding
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    from tropical_cyclone_risk_tpu_torch.utils import basins
    dev = pack_y.device
    key = rng.fold_in(rng.key(0), 3)
    plane0 = cfg_t.start_month - 1
    props, cfgs, err3 = {}, {}, 0.0
    for name, caps in (('no caps', None),
                       ('auto-tuned caps', cfg_t.seed_retry_caps),
                       ('overflow caps', OVERFLOW_CAPS)):
        c = cfgs[name] = cfg_t.replace(seed_retry_caps=caps)
        # twice: the kernel leaves its scratch zeroed for the next call
        outs = [seeding.propose_seeds(key, pack_y, c, BASIN, N_SEEDS, plane0)
                for _ in range(2)]
        ref = seeding.propose_seeds_plain(key, pack_y, c, BASIN, N_SEEDS,
                                          plane0)
        bad = [f'{f} (call {i})' for i, out in enumerate(outs)
               for f, a, b in zip(out._fields, out, ref) if not same(a, b)]
        err3 = max([err3] + [max_err(a, b) for out in outs
                             for a, b in zip(out, ref)])
        props[name] = out = outs[0]
        log(f'[K3] {name} {caps}: {N_SEEDS} slots, dropped '
            f'{int(out.dropped.sum())} (twin {int(ref.dropped.sum())}), '
            f'integrable {int(out.integrate.sum())}; fields not bit-exact '
            f'in two calls: {bad or "none"}')
        if bad:
            raise AssertionError(f'K3 ({name}) differs from its twin: {bad}')
    if not props['overflow caps'].dropped.sum() > \
            props['no caps'].dropped.sum():
        raise AssertionError('the overflow caps dropped no slot')
    curves = [seeding.retry_unresolved_curve(key, pack_y, cfg_t, BASIN,
                                             N_SEEDS) for _ in range(2)]
    curve_ref = seeding.retry_unresolved_curve_plain(key, pack_y, cfg_t,
                                                     BASIN, N_SEEDS)
    same_curve = all(np.array_equal(cv, curve_ref) for cv in curves)
    log(f'[K3] retry_unresolved_curve {curves[0].tolist()}, twin equal in '
        f'two calls: {same_curve}')
    if not same_curve:
        raise AssertionError(f'K3 curve {curves} != twin {curve_ref}')

    b = basins.basin_bounds(cfg_t, BASIN)
    k5key = rng.fold_in(rng.key(0), 5)
    samplers = {'bits': (rng.bits, rng.bits_plain, ()),
                'uniform': (rng.uniform, rng.uniform_plain, (b[0], b[2])),
                'normal': (rng.normal, rng.normal_plain, ()),
                'randint': (rng.randint, rng.randint_plain, (1, 13))}
    err5 = 0.0
    for shape in ((seeding.N_RETRY_ROUNDS, N_SEEDS), (N_SEEDS,)):
        for nm, (kern, plain, extra) in samplers.items():
            a = kern(k5key, shape, *extra, device=dev)
            r = plain(k5key, shape, *extra, device=dev)
            err5 = max(err5, max_err(a, r))
            if not same(a, r):
                raise AssertionError(f'K5 {nm} at {shape} differs from its '
                                     f'twin (max abs {max_err(a, r)})')
    shape4 = (N_SEEDS, 4)
    fs = fourier.draw_fourier(k5key, shape4, cfg_t.T_fourier_s, dev)
    fr = fourier.draw_fourier_plain(k5key, shape4, cfg_t.T_fourier_s, dev)
    err5 = max(err5, max_err(fs.A, fr.A), max_err(fs.B, fr.B))
    if not (same(fs.A, fr.A) and same(fs.B, fr.B)):
        raise AssertionError(f'K5 draw_fourier differs from its twin '
                             f'(max abs {err5})')
    log(f'[K5] bits, uniform, normal, randint at [16, {N_SEEDS}] and '
        f'[{N_SEEDS}], draw_fourier at {tuple(fs.A.shape)}: bit-exact')
    # the row entry at a launch's integrate order (N_SEEDS -> m, the main
    # path's) and at m == n (the order of a partition with w = n), against
    # the full draw gathered (the twin's route); the phase function on
    # every phase the Fourier entries meet against torch.cos and torch.sin
    m = pipeline.launch_width(cfg_t, N_SEEDS)
    integ = props['auto-tuned caps'].integrate
    orders = {w: compact_ops.partition_take(integ, w).order
              for w in (m, N_SEEDS)}
    for w, order in orders.items():
        fk = fourier.draw_fourier(k5key, shape4, cfg_t.T_fourier_s, dev,
                                  rows=order)
        fp = fourier.draw_fourier_plain(k5key, shape4, cfg_t.T_fourier_s,
                                        dev, rows=order)
        err5 = max(err5, max_err(fk.A, fp.A), max_err(fk.B, fp.B))
        if not (same(fk.A, fp.A) and same(fk.B, fp.B)):
            raise AssertionError(f'K5 row draw at {N_SEEDS} -> {w} differs '
                                 f'from the full draw gathered (max abs '
                                 f'{err5})')
    del fk, fp
    c_tab, s_tab = k5.phase_table(dev)
    u = torch.arange(k5.PHASES, dtype=torch.float32, device=dev) * 2.0 ** -23
    bad_c = int((c_tab != torch.cos(2 * math.pi * u)).sum())
    bad_s = int((s_tab != torch.sin(2 * math.pi * u)).sum())
    log(f'[K5] row draw at the integrate order {N_SEEDS} -> {m} and '
        f'{N_SEEDS} -> {N_SEEDS}: bit-exact against draw_fourier_plain(..., '
        f'rows=order); the shared cos/sin reduction against torch.cos / '
        f'torch.sin on all {k5.PHASES} phases: {bad_c} / {bad_s} differ')
    if bad_c or bad_s:
        raise AssertionError(f'K5 phase_sincos differs from torch.cos on '
                             f'{bad_c} and torch.sin on {bad_s} phases')
    del c_tab, s_tab, u

    # K3 through propose_seeds (the main path's dispatcher) and the kernel
    # alone, with the auto-tuned caps (the main path's), without caps (no
    # histogram, no last block) and with the overflow caps: one device
    # operation per call, device time under the profiler
    c = cfgs['auto-tuned caps']
    k3t = {}
    for name in ('auto-tuned caps', 'no caps', 'overflow caps'):
        k3t[name] = k3_times(key, pack_y, cfgs[name], plane0)
        k3t[name].update(k3_alone(key, pack_y, cfgs[name], plane0))
        ops = k3t[name]['device_ops']
        log(f'[K3] {card}: propose_seeds {N_SEEDS} slots, {name}: kernel '
            f'alone {k3t[name]["ms"]:.4f} ms device '
            f'({k3t[name]["alone_event_ms"]:.4f} ms event); through the '
            f'dispatcher {k3t[name]["device_ms"]:.4f} ms device, '
            f'{k3t[name]["event_ms"]:.4f} ms event, host '
            f'{k3t[name]["host_ms"]:.4f} ms per call; device operations '
            f'per call {ops} ({k3t[name]["device_op_names"]})')
        if ops != 1:
            raise AssertionError(f'K3 ({name}): {ops} device operations per '
                                 f'propose_seeds call, not one')
    main = props['auto-tuned caps']
    ms3_plain = cuda_ms(lambda: seeding.propose_seeds_plain(
        key, pack_y, c, BASIN, N_SEEDS, plane0), 3)
    (b3, by3), n_tested = k3_bound(key, pack_y, c, main)
    log(f'[K3] {card}: propose_seeds {N_SEEDS} slots (caps '
        f'{c.seed_retry_caps}, {n_tested} rounds of the sequential walk): '
        f'kernel {k3t["auto-tuned caps"]["ms"]:.4f} ms device, plain twin '
        f'{ms3_plain:.3f} ms, bound {b3:.5f} ms ({by3})')
    # K5 on the main path: the row draw at the integrate order, one launch
    # per bench launch; beside it the full-width entry (m == n) and the
    # uniform fill; device times (torch.profiler), bounds from the least
    # operations of an element (FOURIER_OPS, a uniform DRAW_OPS + 1)
    amp = fourier._amplitudes(dev)
    order = orders[m]
    rows_call = lambda: k5.fourier_rows_cuda(k5key, shape4, order, amp)
    full_call = lambda: k5.fourier_cuda(k5key, shape4, amp)
    A_r, B_r = rows_call()
    k5t = {'rows_ms': device_ms(rows_call, 20, ('rng_fourier',)),
           'rows_event_ms': cuda_ms(rows_call, 20),
           'full_ms': device_ms(full_call, 20, ('rng_fourier',)),
           'full_event_ms': cuda_ms(full_call, 20),
           'rows_plain_ms': cuda_ms(lambda: fourier.draw_fourier_plain(
               k5key, shape4, c.T_fourier_s, dev, rows=order), 5),
           'full_plain_ms': cuda_ms(lambda: fourier.draw_fourier_plain(
               k5key, shape4, c.T_fourier_s, dev), 5),
           'draws_rows': A_r.numel(), 'draws_full': fs.A.numel()}
    b5, by5 = ops32_bound(nbytes(A_r, B_r, order, amp),
                          FOURIER_OPS * A_r.numel())
    b5f, by5f = ops32_bound(nbytes(fs.A, fs.B, amp), FOURIER_OPS * fs.A.numel())
    k5t.update(full_bound_ms=b5f, full_bound_by=by5f)
    shape16 = (seeding.N_RETRY_ROUNDS, N_SEEDS)
    ms5u = cuda_ms(lambda: rng.uniform(k5key, shape16, device=dev), 20)
    ms5u_plain = cuda_ms(lambda: rng.uniform_plain(k5key, shape16,
                                                   device=dev), 5)
    b5u, by5u = ops32_bound(4 * math.prod(shape16),
                            (DRAW_OPS + 1) * math.prod(shape16))
    log(f'[K5] {card}: row draw {N_SEEDS} -> {m} rows {tuple(A_r.shape)}: '
        f'kernel {k5t["rows_ms"]:.4f} ms device ({k5t["rows_event_ms"]:.4f} '
        f'ms event), plain twin {k5t["rows_plain_ms"]:.3f} ms, bound '
        f'{b5:.5f} ms ({by5}, {100 * b5 / k5t["rows_ms"]:.0f}% of it); '
        f'full-width entry {tuple(fs.A.shape)}: {k5t["full_ms"]:.4f} ms '
        f'device ({k5t["full_event_ms"]:.4f} ms event), plain twin '
        f'{k5t["full_plain_ms"]:.3f} ms, bound {b5f:.5f} ms ({by5f}, '
        f'{100 * b5f / k5t["full_ms"]:.0f}% of it); uniform {shape16}: '
        f'kernel {ms5u:.4f} ms, plain twin {ms5u_plain:.3f} ms, bound '
        f'{b5u:.5f} ms ({by5u})')
    src = 'tropical_cyclone_risk_tpu_torch/'
    return [
        {'name': 'seeding', 'route': 'cuda', 'source': src + 'csrc/seeding.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/seeding.py:95',
         'launches': None, 'max_abs_err': err3,
         'ms': k3t['auto-tuned caps']['ms'], 'plain_ms': ms3_plain,
         'bound_ms': b3, 'bound_by': by3, 'library_ms': None,
         'per': 'call, auto-tuned caps (the kernel alone, device time)',
         'times': k3t},
        {'name': 'threefry', 'route': 'cuda', 'source': src + 'csrc/rng.cu',
         'replaces': 'tropical_cyclone_risk_tpu/ops/fourier.py:84',
         'launches': None, 'max_abs_err': err5, 'ms': k5t['rows_ms'],
         'plain_ms': k5t['rows_plain_ms'], 'bound_ms': b5, 'bound_by': by5,
         'library_ms': None,
         'per': f'launch: the row draw {N_SEEDS} -> {m} (the kernel alone, '
                f'device time)', 'times': k5t}]


def same_parts(a, b):
    """Names of the fields where two K4 results differ (None pairs equal).
    A result is an ops.compact.Partition or a stitch's (tracks, keep)."""
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], dict):
        bad = [f'tracks.{k}' for k in a[0] if not same_bits(a[0][k], b[0][k])]
        return bad + ([] if same(a[1], b[1]) else ['keep_full'])
    pairs = [(f, x, y) for f, x, y in zip(a._fields, a, b) if f != 'rows']
    pairs += [(f'rows[{i}]', x, y)
              for i, (x, y) in enumerate(zip(a.rows, b.rows))]
    return [nm for nm, x, y in pairs
            if (x is None) != (y is None)
            or (x is not None and not same(x, y))]


def same_bits(a, b):
    """Equality of two float32 tensors bit for bit (NaNs by their bits)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def stitch_edge_cases(dev):
    """stitch_survivors through K4 and its twin on the card, bit for bit,
    at utils/synthetic_segments.STITCH_CASES (one segment without
    slot_rank, 2, 3, 9 and 16 segments with a segment of width 1; k = 1,
    64, 77, 96, 384 and above the survivors; W = 2, 4, 6, 10, 34; tiles of
    4, 8 and 32 steps), and each W = 4 case again with its first
    segment's winds 8 bytes off a 16-byte boundary (8-byte words).
    Returns the number of cases."""
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_segments
    cases = 0
    for name in synthetic_segments.STITCH_CASES:
        order, tms, segs, keep, rank = to_device(
            synthetic_segments.stitch_case(name), dev)
        variants = [tms]
        if tms[0]['wnds'].shape[-1] == 4:
            off = torch.empty(tms[0]['wnds'].numel() + 2,
                              dtype=torch.float32, device=dev)[2:]
            off = off.view(tms[0]['wnds'].shape).copy_(tms[0]['wnds'])
            variants.append([dict(tms[0], wnds=off)] + tms[1:])
        for tv in variants:
            out = compact_ops.stitch_survivors(order, tv, segs, keep, rank)
            ref = uncounted(compact_ops.stitch_survivors_plain, order, tv,
                            segs, keep, rank)
            bad = same_parts(out, ref)
            if bad:
                raise AssertionError(f'K4 stitch edge case {name}: {bad} '
                                     f'differ from the twin')
            cases += 1
    return cases


def to_device(x, dev):
    """x with every tensor in it (in tuples, lists and dicts) on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x


def k4_edge_cases(dev):
    """partition_take through K4 and its twin on the edge cases: n = 1,
    a tile's width, not a multiple of it and the launch's width; masks all
    False, all True and sparse; w below, at and above the true count and
    w >= n; every option.  Returns the number of cases (all bit-exact)."""
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    g = torch.Generator(device=dev).manual_seed(4)
    cases = 0
    for n in (1, 1024, 4097, N_SEEDS):
        for density in (0.0, 1.0, 0.3):
            mask = torch.rand((n,), generator=g, device=dev) < density
            count = int(mask.sum())
            rows = (torch.randn((n,), generator=g, device=dev),
                    torch.randint(0, 1 << 40, (n,), generator=g, device=dev),
                    mask.clone(),
                    torch.randn((n, 4, 15), generator=g, device=dev))
            a_prev = torch.randperm(n + 7, generator=g, device=dev)[:n]
            acc = torch.tensor([5], dtype=torch.int64, device=dev)
            for w in sorted({max(count - 7, 0), count, min(count + 5, n),
                             n + 3}):
                for kw in ({}, dict(acc=acc, slot_rank=True, a_prev=a_prev,
                                    inv_len=n + 7)):
                    out = compact_ops.partition_take(mask, w, rows, **kw)
                    ref = compact_ops.partition_take_plain(mask, w, rows,
                                                           **kw)
                    bad = same_parts(out, ref)
                    if bad:
                        raise AssertionError(f'K4 edge case n={n} density='
                                             f'{density} w={w} {kw.keys()}:'
                                             f' {bad} differ from the twin')
                    cases += 1
    return cases


def partition_bound(mask, out, a_prev=None):
    """K4's bound on one partition_take call: the mask read once, the w
    rows that the order picks of each row tensor (and of a_prev) read once,
    the order, the gathered rows and the optional outputs written once;
    ~12 integer operations per slot (the count, the scan, the rank),
    against the float32 peak."""
    outs = [t for t in (out.order, out.overflow, out.slot_rank, out.a_idx,
                        out.inv, out.selected) if t is not None]
    picked = list(out.rows) + ([out.a_idx] if a_prev is not None else [])
    return bound(nbytes(mask, *picked, *outs, *out.rows), 12 * mask.numel())


def stitch_needs(order, tms, segs):
    """What a survivor stitch needs of its segments: for each, its
    buffers, the slots of the survivors selected on it (all k on the
    first), their columns and which of their samples are alive ([T_s,
    columns])."""
    slots = [order] + [order[seg['selected'][order]] for seg in segs]
    cols = [order] + [seg['inv'][s] for seg, s in zip(segs, slots[1:])]
    return [(tm, s, c, tm['alive'][:, c])
            for tm, s, c in zip(tms, slots, cols)]


def stitch_bound(args, out):
    """K4's bound on one survivor stitch (args: order, tms, segs, keep,
    slot_rank; out: its tracks and keep_full): what the function needs,
    read once (order; on each later segment every survivor's selected
    flag and the selected ones' map entry; alive of every selected
    sample; the five fields and W winds of the selected samples that are
    alive; with slot_rank, every rank and keep at the ranked slots), and
    the [k, T] outputs and keep_full written once; 4 operations an output
    sample."""
    order, tms, segs, _, rank = args
    k, T, W = out[0]['wnds'].shape
    needs = stitch_needs(order, tms, segs)
    reads = nbytes(order) + k * len(segs) + 8 * sum(
        slots.numel() for _, slots, _, _ in needs[1:])
    for *_, live in needs:
        reads += live.numel() + int(live.sum()) * (5 * 4 + 4 * W)
    writes = nbytes(*out[0].values())
    if rank is not None:
        reads += nbytes(rank) + int((rank >= 0).sum())
        writes += nbytes(out[1])
    return bound(reads + writes, 4 * k * T)


def sectors(offsets, size):
    """The number of 32-byte sectors that values of `size` bytes at the
    byte offsets `offsets` (an integer tensor) touch."""
    if offsets.numel() == 0:
        return 0
    first, last = offsets // 32, (offsets + size - 1) // 32
    mark = torch.zeros(int(last.max()) + 1, dtype=torch.bool,
                       device=offsets.device)
    for j in range(int((last - first).max()) + 1):
        mark[torch.minimum(first + j, last)] = True
    return int(mark.sum())


def stitch_sectors(args, out):
    """stitch_bound's bytes at the card's 32-byte sector granularity: each
    value it counts as read costs the sectors it touches, once, where
    sparse survivors pay a sector for a 4-byte value (order, the ranks
    and the [k, T] outputs are whole rows of sectors)."""
    order, tms, segs, _, rank = args
    k, T, W = out[0]['wnds'].shape
    needs = stitch_needs(order, tms, segs)
    n = sum(sectors(order, 1) + sectors(slots * 8, 8)
            for _, slots, _, _ in needs[1:])
    for tm, _, c, live in needs:
        t, j = live.nonzero(as_tuple=True)
        w_s = tm['alive'].shape[1]
        steps = torch.arange(live.shape[0], device=c.device)
        n += sectors((steps[:, None] * w_s + c[None]).reshape(-1), 1)
        at = t * w_s + c[j]
        n += 5 * sectors(at * 4, 4) + sectors(at * 4 * W, 4 * W)
    rows = nbytes(order) + nbytes(*out[0].values())
    if rank is not None:
        n += sectors(rank[rank >= 0], 1)
        rows += nbytes(rank, out[1])
    return bound(32 * n + rows, 4 * k * T)[0]


def launch_setup(dev):
    """The slice's launch inputs: the namelist at N_SEEDS seeds for two
    years, the 24-plane 181x360 synthetic pack, its first year, and the
    namelist auto-tuned on it (integrate cap, re-compaction schedule)."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.config import Namelist
    from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
    cfg = Namelist(seed_batch=N_SEEDS, start_year=2016, end_year=2017)
    pack24 = fields.synthetic_pack(cfg, n_planes=24, nlat=181, nlon=360,
                                   seed=0, device=dev)
    pack_y = fields.slice_pack_year(pack24, cfg, 0)
    cfg_t = pipeline.auto_integrate_cap(rng.fold_in(rng.key(0),
                                                    cfg.start_year),
                                        pack24, cfg, BASIN)
    return cfg, pack24, pack_y, cfg_t


def launch_calls(key, pack_y, cfg_t, plane0, k_maxes=(64,), check=False):
    """One full-width launch: launch_body, then compact_survivors at each
    k_max of k_maxes, with simulator.integrate_segment and K4's two
    dispatchers and the Fourier draw captured; with check, each K4 call is
    repeated through its plain twin as it is made (its record's check: the
    fields that differ).  Returns (K1 calls, partition calls, stitch calls,
    the number of partitions in launch_body, draw_fourier calls)."""
    from tropical_cyclone_risk_tpu_torch.models import pipeline, simulator
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier

    def twin(plain):
        return (lambda out, *a, **kw: same_parts(out, plain(*a, **kw))) \
            if check else None

    m = pipeline.launch_width(cfg_t, N_SEEDS)
    with captured(simulator, 'integrate_segment') as segs, \
            captured(compact_ops, 'partition_take',
                     twin(compact_ops.partition_take_plain)) as parts, \
            captured(compact_ops, 'stitch_survivors',
                     twin(compact_ops.stitch_survivors_plain)) as stitches, \
            captured(fourier, 'draw_fourier') as draws:
        body = pipeline.launch_body(key, pack_y, cfg_t, BASIN, N_SEEDS,
                                    plane0)
        n_launch = len(parts)
        for k_max in k_maxes:
            pipeline.compact_survivors(body, m, k_max,
                                       len(cfg_t.basin_ids_sorted()))
    torch.cuda.synchronize()
    return segs, parts, stitches, n_launch, draws


def mode_calls(key, pack_y, cfg, plane0, gate=False):
    """The K1 calls of one full-width launch (_simulate_batch at k_max 64)
    on cfg, captured; with gate, also (K1 calls, K7 calls), each K7 call
    checked against its twin as it is made (check_k7)."""
    from tropical_cyclone_risk_tpu_torch.models import pipeline, simulator
    with captured(simulator, 'integrate_segment') as calls, \
            (captured(simulator, 'genesis_alive', check_k7, keep=False)
             if gate else contextlib.nullcontext([])) as gates:
        pipeline._simulate_batch(key, pack_y, cfg, BASIN, N_SEEDS, 64,
                                 plane0)
    torch.cuda.synchronize()
    return (calls, gates) if gate else calls


def check_k4(key, pack_y, cfg_t, plane0, card):
    """Phase K4: one full-width launch (the auto-tuned cfg_t) with both K4
    dispatchers captured, so that every compaction of the launch (the
    integrate compaction, every boundary) and compact_survivors' partition
    and stitch at k_max 64 and at k_max = m are repeated through the plain
    twins on the same inputs: all bit-exact; then the edge cases, and the
    times of the integrate compaction and the stitch.  Returns the kernel's
    JSON entry (launches are filled in from the workspace path)."""
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.models import pipeline
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    m = pipeline.launch_width(cfg_t, N_SEEDS)
    _, parts_all, stitches, n_launch, _ = launch_calls(
        key, pack_y, cfg_t, plane0, (64, m), True)
    bad = [(kind, i, c[3]) for kind, calls in (('partition', parts_all),
                                               ('stitch', stitches))
           for i, c in enumerate(calls) if c[3]]
    sizes = [(c[0][0].shape[0], c[0][1]) for c in parts_all]
    log(f'[K4] {len(parts_all) + len(stitches)} K4 calls ({n_launch} in the '
        f'launch, the rest compact_survivors at k_max 64 and {m}): '
        f'partitions (n, w) {sizes}; not bit-exact: {bad or "none"}')
    if bad or n_launch != (m < N_SEEDS) + len(pipeline.seg_schedule(cfg_t,
                                                                      m)):
        raise AssertionError(f'K4 differs from its twin: {bad}')
    n_edge = k4_edge_cases(pack_y.device)
    log(f'[K4] {n_edge} edge cases (n 1, 1024, 4097, {N_SEEDS}; masks none, '
        f'all, sparse; w below, at, above the count and >= n): bit-exact')
    n_stitch = stitch_edge_cases(pack_y.device)
    log(f'[K4] {n_stitch} stitch edge cases (1 to 16 segments, a segment of '
        f'width 1; k 1 to 384 and above the survivors; W 2 to 34; W = 4 '
        f'in 8-byte words): bit for bit')

    # the launch's partitions: launch_body's and compact_survivors' at
    # k_max 64; each timed as K4's kernels alone, torch.sort's order
    # alone, and torch.sort with one index_select per row tensor, in
    # device time (torch.profiler), since a small call's launches take
    # longer to issue from the host than to run
    parts = parts_all[:n_launch + 1]
    rows_k4 = []
    for (mask, w, rows), kw, out, _ in parts:
        launch, _ = k4.launcher('partition', mask, w, rows, kw.get('acc'),
                                kw.get('slot_rank', False), kw.get('a_prev'),
                                kw.get('inv_len'))
        rows_k4.append({
            'n': mask.shape[0], 'w': w, 'rows': len(rows),
            'ms': device_ms(launch, K4_REPS, entry='compact'),
            'library_ms': device_ms(lambda: sort_order(mask, w), K4_REPS,
                                    entry='compact'),
            'sort_take_ms': device_ms(lambda: sort_take(mask, w, rows),
                                      K4_REPS, entry='compact'),
            'bound_ms': partition_bound(mask, out, kw.get('a_prev'))[0]})
    launch_k4 = {k: sum(r[k] for r in rows_k4)
                 for k in ('ms', 'library_ms', 'sort_take_ms', 'bound_ms')}
    log(f'[K4] {card}: the launch\'s {len(rows_k4)} partitions (n, w, row '
        f'tensors: device ms of the kernels / torch.sort / sort + '
        f'index_select / bound ms) ' +
        '; '.join(f'{r["n"]}->{r["w"]} x{r["rows"]}: {r["ms"]:.4f} / '
                  f'{r["library_ms"]:.4f} / {r["sort_take_ms"]:.4f} / '
                  f'{r["bound_ms"]:.5f}' for r in rows_k4))
    log(f'[K4] {card}: per launch, device time: kernels '
        f'{launch_k4["ms"]:.4f} ms, torch.sort {launch_k4["library_ms"]:.4f} '
        f'ms, sort + index_select {launch_k4["sort_take_ms"]:.4f} ms, bound '
        f'{launch_k4["bound_ms"]:.5f} ms')

    # the integrate compaction (the launch's first partition): K4 through
    # its dispatcher, its order alone, the plain twin
    (mask, w, rows), kw, out, _ = parts[0]
    first = rows_k4[0]
    ms_call = cuda_ms(lambda: compact_ops.partition_take(mask, w, rows, **kw),
                      50)
    ms_order = device_ms(k4.launcher('partition', mask, w, (), None, False,
                                     None, None)[0], K4_REPS,
                         entry='compact')
    ms_plain = cuda_ms(lambda: compact_ops.partition_take_plain(
        mask, w, rows, **kw), 20)
    b4, by4 = partition_bound(mask, out, kw.get('a_prev'))
    # the same compaction as the parent's launch made it, with the
    # full-width Fourier rows A and B [n, 4, 15] among its row tensors
    # (this launch draws them after it, at the order's rows alone)
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    ab = k5.fourier_cuda(rng.key(1), (mask.shape[0], 4),
                         fourier._amplitudes(mask.device))
    ms_ab = device_ms(k4.launcher('partition', mask, w, rows + ab,
                                  kw.get('acc'), kw.get('slot_rank', False),
                                  kw.get('a_prev'), kw.get('inv_len'))[0],
                      K4_REPS, entry='compact')
    b4_ab, _ = partition_bound(mask, out._replace(rows=out.rows + tuple(
        t[out.order] for t in ab)), kw.get('a_prev'))
    log(f'[K4] {card}: integrate compaction {N_SEEDS} -> {w}: kernels '
        f'{first["ms"]:.4f} ms device with the launch\'s {len(rows)} row '
        f'tensors (bound {b4:.5f} ms), {ms_ab:.4f} ms with A and B among '
        f'them as well ({len(rows) + 2} row tensors, bound {b4_ab:.5f} ms)')
    del ab
    sargs, _, sout, _ = stitches[0]
    ms_st = cuda_ms(k4.launcher('stitch', *sargs)[0], 50)
    ms_st_call = cuda_ms(lambda: compact_ops.stitch_survivors(*sargs), 50)
    ms_st_plain = cuda_ms(lambda: compact_ops.stitch_survivors_plain(*sargs),
                          20)
    b4s, by4s = stitch_bound(sargs, sout)
    log(f'[K4] {card}: integrate compaction {N_SEEDS} -> {w} with '
        f'{len(rows)} row tensors: kernels {first["ms"]:.4f} ms '
        f'({ms_call:.4f} ms through the dispatcher; the order alone '
        f'{ms_order:.4f} ms), plain twin {ms_plain:.4f} ms, torch.sort '
        f'{first["library_ms"]:.4f} ms, torch.sort + index_select '
        f'{first["sort_take_ms"]:.4f} ms, bound {b4:.5f} ms ({by4}); '
        f'survivor stitch {tuple(sout[0]["lon"].shape)} over '
        f'{len(sargs[1])} segments: kernel {ms_st:.4f} ms ({ms_st_call:.4f} '
        f'ms through the dispatcher), plain twin {ms_st_plain:.4f} ms, bound '
        f'{b4s:.5f} ms ({by4s})')
    return {'name': 'compact', 'route': 'cuda',
            'source': 'tropical_cyclone_risk_tpu_torch/csrc/compact.cu',
            'replaces': 'tropical_cyclone_risk_tpu/ops/compact.py:30',
            'launches': None, 'max_abs_err': 0.0, 'ms': first['ms'],
            'plain_ms': ms_plain, 'bound_ms': b4, 'bound_by': by4,
            'library_ms': first['library_ms'], 'per': 'integrate compaction',
            'with_ab_ms': ms_ab, 'with_ab_bound_ms': b4_ab,
            'sort_take_ms': first['sort_take_ms'], 'dispatch_ms': ms_call,
            'order_ms': ms_order, 'launch_partitions': len(rows_k4),
            'launch_ms': launch_k4['ms'],
            'launch_library_ms': launch_k4['library_ms'],
            'launch_sort_take_ms': launch_k4['sort_take_ms'],
            'launch_bound_ms': launch_k4['bound_ms'], 'stitch_ms': ms_st,
            'stitch_dispatch_ms': ms_st_call, 'stitch_plain_ms': ms_st_plain,
            'stitch_bound_ms': b4s}


def sort_order(mask, w):
    """K4's one-call yardstick: torch.sort's stable order, True first."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices[:w]


def sort_take(mask, w, rows):
    """The same work as a K4 partition's order and row gathers in library
    calls: torch.sort and one index_select per row tensor."""
    order = sort_order(mask, w)
    return [r.index_select(0, order) for r in rows]


# the integration modes of the modes phase on the auto-tuned namelist; the
# default path first, so that K1's times per mode compare within one phase
MODES = {'default': {},
         'time_interp_fields': dict(time_interp_fields=True),
         'rk_exact_stage_fields': dict(rk_exact_stage_fields=True),
         'rk_substeps=2': dict(rk_substeps=2),
         'time_interp_fields+rk_substeps=2': dict(time_interp_fields=True,
                                                  rk_substeps=2),
         'time_interp_fields+rk_exact_stage_fields': dict(
             time_interp_fields=True, rk_exact_stage_fields=True)}


def check_modes(key, pack_y, cfg_t, plane0, card):
    """Phase modes: _omega and the Fourier amplitudes that K5 and its twin
    draw with on the card equal the CPU's bit for bit (and the amplitudes'
    formula evaluated on the card is logged beside them); for the default
    path and each mode one full-width launch with K1 held against its twin
    on the first and the last segment (K1_TOL, K1_ALIVE_AGREE), K7 against
    its twin on the launch, and K1's time on the first segment, the kernel
    alone.  Returns (the largest error found, {mode: K1's time on
    segment 0, the kernel alone})."""
    from tropical_cyclone_risk_tpu_torch.models import simulator
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    w_card = fourier._omega(cfg_t.T_fourier_s, pack_y.device).cpu()
    w_cpu = fourier._omega(cfg_t.T_fourier_s, 'cpu')
    log(f'[modes] _omega on the card equals the CPU\'s bit for bit: '
        f'{torch.equal(w_card, w_cpu)}')
    if not torch.equal(w_card, w_cpu):
        raise AssertionError(f'_omega differs: {w_card} vs {w_cpu}')
    a_used = fourier._amplitudes(pack_y.device).cpu()
    a_formula = fourier.amplitudes_formula(pack_y.device).cpu()
    a_cpu = fourier._amplitudes('cpu')
    log(f'[modes] Fourier amplitudes K5 and its twin draw with on the card '
        f'equal the CPU\'s bit for bit: {torch.equal(a_used, a_cpu)}; the '
        f'formula evaluated on the card (pow, sum, sqrt there) would: '
        f'{torch.equal(a_formula, a_cpu)} (max abs '
        f'{float((a_formula - a_cpu).abs().max()):.3e})')
    if not torch.equal(a_used, a_cpu):
        raise AssertionError(f'amplitudes differ: {a_used} vs {a_cpu}')
    worst, modes_ms = 0.0, {}
    for name, kw in MODES.items():
        calls, gates = mode_calls(key, pack_y, cfg_t.replace(**kw), plane0,
                                  gate=True)
        k7_results(f'modes {name}', gates)
        res = []
        for args, _, out, _ in (calls[0], calls[-1]):
            agree, err, _ = compare_k1(
                out, simulator.integrate_segment_plain(*args))
            res.append((args[7], args[3].lon.shape[0], agree, err))
            worst = max([worst] + list(err.values()))
            if agree < K1_ALIVE_AGREE or any(
                    not err[nm] <= tol for nm, tol in K1_TOL.items()):
                raise AssertionError(f'K1 under {name}: alive agreement '
                                     f'{agree}, errors {err}')
        args0 = calls[0][0]
        ms = modes_ms[name] = cuda_ms(k1_launcher(args0), 5)
        log(f'[modes] {name}: {len(calls)} segments; K1 against its twin on '
            f'the first and last (steps, storms, alive agreement, max abs '
            f'err) {res}; {card}: K1 segment 0 ({args0[7]} steps x '
            f'{args0[3].lon.shape[0]} storms) {ms:.4f} ms, the kernel alone')
        del calls, args0
    return worst, modes_ms


# the stack layouts of the geo phase (kernels/integrator.py geo_layout),
# each held in these modes
GEO_LAYOUTS = ('fused', 'separate')
GEO_MODES = {'default': {},
             'time_interp_fields': dict(time_interp_fields=True)}


def geo_pack(cfg, dev, layout):
    """The 12-plane one-degree synthetic pack (fields.synthetic_pack_numpy,
    seed 0) with its land mask regridded onto 0.5 degrees and its
    bathymetry either the land-derived proxy on that grid (as
    preprocess/static.py load_bathy makes it without a file: 'fused') or
    regridded onto 0.25 degrees ('separate')."""
    from tropical_cyclone_risk_tpu_torch.models import fields
    from tropical_cyclone_risk_tpu_torch.ops import interp
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_era5
    pk = fields.synthetic_pack_numpy(cfg, 12, 181, 360, seed=0)
    g = pk['grid']

    def onto(a, res):
        lon, lat = synthetic_era5.res_axes(res)
        return (interp.UniformGrid.from_axes(lon, lat),
                interp.regrid(a, g.lon_axis(), g.lat_axis(), lon,
                              lat).numpy())

    pk['land_grid'], pk['land'] = onto(pk['land'], 0.5)
    if layout == 'fused':
        pk['bathy_grid'] = pk['land_grid']
        pk['bathy'] = np.where(pk['land'] >= 0.5, 100.0, -4500.0).astype(
            np.float32)
    else:
        pk['bathy_grid'], pk['bathy'] = onto(pk['bathy'], 0.25)
    return fields.pack_from_numpy(pk, dev)


def k1_differs(out, ref):
    """The outputs of one K1 segment (out) that differ from its twin's (ref)
    in any bit: the time-major buffers, the end state and alive mask."""
    (ko, (k_end, k_alive)), (po, (p_end, p_alive)) = out, ref
    names = ('lon', 'lat', 'v', 'm', 'wnds', 'alive')
    return ([nm for nm, a, b in zip(names, ko, po) if not same(a, b)]
            + [f'end {nm}' for nm, a, b in zip(names, (*k_end, k_alive),
                                               (*p_end, p_alive))
               if not same(a, b)])


def geo_stacks(pack, layout):
    """The GatherStacks of `pack`, required to be in `layout` ('in-cell'
    or one of GEO_LAYOUTS) as the kernels read it."""
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.models import fields
    want = {'in-cell': integrator.IN_CELL, 'fused': integrator.FUSED_GEO,
            'separate': integrator.SEPARATE_GEO}[layout]
    stacks = fields.build_stacks(pack)
    if integrator.geo_layout(stacks) != want:
        raise AssertionError(f'geo {layout}: the stacks are in layout '
                             f'{integrator.geo_layout(stacks)}')
    return stacks


def geo_modes(label, key, pack, cfg, plane0, layout):
    """K1 and K7 on a pack whose land and bathymetry lie on grids of their
    own (geo_pack's `layout`), in each of GEO_MODES: one N_SEEDS launch
    (_simulate_batch), K7 against its twin on it, K1 bit for bit against
    its twin on the first and the last segment.  Returns the default
    mode's K1 calls (mode_calls)."""
    from tropical_cyclone_risk_tpu_torch.models import simulator
    out = None
    for mode, kw in GEO_MODES.items():
        calls, gates = mode_calls(key, pack, cfg.replace(**kw), plane0,
                                  gate=True)
        k7_results(f'{label} {layout} {mode}', gates)
        for args, _, res, _ in (calls[0], calls[-1]):
            bad = k1_differs(res, uncounted(simulator.integrate_segment_plain,
                                            *args))
            log(f'[{label}] {layout}, {mode}: K1 segment of {args[7]} '
                f'steps x {args[3].lon.shape[0]} storms from sample '
                f'{args[6]}: not bit-exact against its twin: '
                f'{bad or "none"}')
            if bad:
                raise AssertionError(f'{label}: K1 in the {layout} layout '
                                     f'({mode}) differs from its twin in '
                                     f'{bad}')
        if mode == 'default':
            out = calls
        del calls, gates
    return out


def check_geo(key, pack_y, cfg_t, plane0, card):
    """Phase geo: geo_modes on a pack with land and bathymetry on one grid
    of their own (fused) and on two (separate); then K1's time alone on
    every segment of the default launch beside its bound, for each layout
    and for the in-cell pack pack_y.  Returns {layout: K1's segment times
    and bounds}."""
    out = {}
    for layout in ('in-cell',) + GEO_LAYOUTS:
        pack = (pack_y if layout == 'in-cell'
                else geo_pack(cfg_t, pack_y.device, layout))
        stacks = geo_stacks(pack, layout)
        calls = (mode_calls(key, pack, cfg_t, plane0) if layout == 'in-cell'
                 else geo_modes('geo', key, pack, cfg_t, plane0, layout))
        segs = [{'steps': args[7], 'width': args[3].lon.shape[0],
                 'ms': cuda_ms(k1_launcher(args), 5),
                 'bound_ms': k1_bound(args, res)[0]}
                for args, _, res, _ in calls]
        out[layout] = {
            'segments': segs,
            'cell_row_bytes': stacks.cell4.shape[-1] * 4,
            **{k: sum(sg[k] for sg in segs) for k in ('ms', 'bound_ms')}}
        log(f'[geo] {card}: K1 in the {layout} layout (cell row '
            f'{stacks.cell4.shape[-1] * 4} bytes; land grid '
            f'{stacks.land_grid.nlat} x {stacks.land_grid.nlon}, '
            f'bathymetry grid {stacks.bathy_grid.nlat} x '
            f'{stacks.bathy_grid.nlon}): per launch ({len(segs)} '
            f'segments) {out[layout]["ms"]:.4f} ms, bound '
            f'{out[layout]["bound_ms"]:.5f} ms; segment 0 '
            f'{segs[0]["ms"]:.4f} ms, bound {segs[0]["bound_ms"]:.5f} '
            f'ms; the kernel alone')
        del calls
    return out


def profile_launches(run, reps, path):
    """torch.profiler over `reps` launches, each pipeline stage under a
    record_function range.  Returns (device kernels per launch, busy
    share, traced ms per launch, {stage: (host ms, device span ms)} per
    launch, the top device operators as (ms per launch, name, calls per
    launch)).  A stage's host ms is its range on the host; its device span
    runs from its first kernel's start to its last kernel's end, idle gaps
    included."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fields,
                                                        pipeline, seeding,
                                                        simulator)
    from tropical_cyclone_risk_tpu_torch.ops import compact, fourier
    stages = [(seeding, 'propose_seeds'), (fourier, 'draw_fourier'),
              (fields, 'build_stacks'), (simulator, 'genesis_alive'),
              (simulator, 'integrate_segment'),
              (diagnostics, 'axi_to_max_wind_raw'),
              (pipeline, 'compact_survivors'),
              (compact, 'partition_take'), (compact, 'stitch_survivors')]
    originals = [getattr(mod, nm) for mod, nm in stages]

    def ranged(fn, label):
        def run_ranged(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run_ranged

    for (mod, nm), fn in zip(stages, originals):
        setattr(mod, nm, ranged(fn, 'stage:' + nm))
    try:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    finally:
        for (mod, nm), fn in zip(stages, originals):
            setattr(mod, nm, fn)
    prof.export_chrome_trace(path)
    busy, span, n_kern = trace_busy(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    stage_ms = {}
    for e in events:
        if e.get('ph') == 'X' and str(e.get('name')).startswith('stage:'):
            side = 1 if e.get('cat') == 'gpu_user_annotation' else 0
            ms = stage_ms.setdefault(e['name'][len('stage:'):], [0.0, 0.0])
            ms[side] += float(e['dur']) / 1e3 / reps
    avg = prof.key_averages()
    attr = ('self_device_time_total'
            if hasattr(avg[0], 'self_device_time_total')
            else 'self_cuda_time_total')
    top = sorted(((getattr(e, attr) / 1e3 / reps, e.key[:60], e.count / reps)
                  for e in avg if getattr(e, attr) > 0
                  and not e.key.startswith('stage:')), reverse=True)[:12]
    return n_kern / reps, busy / span, span / 1e3 / reps, stage_ms, top


# three steering levels as JAX tests/test_simulator.py:421-425 runs them
LEVELS3 = dict(steering_levels=(250, 500, 850), steering_coefs=(0.1, 0.2, 0.7),
               y_alpha=(0.1, 0.2, 0.7), m_alpha=(0.001, 0.0, -0.001),
               alpha_max=(0.4, 0.4, 0.9), alpha_min=(0.05, 0.05, 0.5))
# K1's default-path instance of the three-level unit
K1_L3_INSTANCE = 'integrate_segment_kernel<3,0,0,0,0>'
# the modes the levels phase holds K1 in on its first and last segment, and
# whether K1 is bit-exact against its twin there: all of them, the
# analytic modes too since the twin's F(t) sums in K1's order
# (fourier.FourierSeries.evaluate)
LEVELS3_MODES = {'time_interp_fields': (dict(time_interp_fields=True), True),
                 'rk_exact_stage_fields': (dict(rk_exact_stage_fields=True),
                                           True),
                 'rk_substeps=2': (dict(rk_substeps=2), True)}


def k1_exact(out, ref):
    """(bit-exact, the outputs that differ) of one K1 call against its
    twin's: every output leaf and every carry element, the in-scan vmax
    and DiagState among them where the call has them."""
    (ko, kc), (po, pc) = out, ref
    flat = lambda c: [x for e in c for x in (e if isinstance(e, tuple)
                                            else (e,))]
    diff = [f'out {i}' for i, (a, b) in enumerate(zip(ko, po))
            if not same(a, b)]
    diff += [f'carry {i}' for i, (a, b) in enumerate(zip(flat(kc), flat(pc)))
             if not same(a, b)]
    return not diff, diff


def check_k1_exact(label, calls):
    """Require K1 bit-exact against its twin on every call of `calls`
    (captured with check k1_exact)."""
    bad = [(i, c[3][1]) for i, c in enumerate(calls) if not c[3][0]]
    log(f'[{label}] K1 against its twin on {len(calls)} segments (steps x '
        f'storms {[(c[0][7], c[0][3].lon.shape[0]) for c in calls]}): '
        f'bit-exact {not bad}')
    if bad or not calls:
        raise AssertionError(f'{label}: K1 differs from its twin: {bad}')


def k5_rows_exact(out, *args, **kw):
    """K5's draw against draw_fourier_plain on the same inputs, the twin
    uncounted: bit-exact A and B."""
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    ref = uncounted(fourier.draw_fourier_plain, *args, **kw)
    return same(out.A, ref.A) and same(out.B, ref.B)


def k4_exact(plain):
    """A capture check: K4's call against its plain twin on the same
    inputs, uncounted; the fields that differ."""
    return lambda out, *a, **kw: same_parts(out, uncounted(plain, *a, **kw))


def launch_kernel_times(k1_calls, k2_calls, k7_calls, draws, stitches,
                        k1_plain_ms=None):
    """Per launch, from the captured calls of one launch: each kernel
    alone (K1 summed over the segments, event time, K1_REPS runs a
    segment, fewer where a run takes longer (k1_ms); K2 over the segments,
    K7's gate, K5's row draw and K4's stitch, device time, each launch
    after an L2 flush (cold)), each timed in
    TIME_ROUNDS rounds, the median and [least, most] of them; its bound as
    the phases reckon it; and its plain twin's time (K1's on segment 0:
    k1_plain_ms where the caller has timed it already)."""
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.models import diagnostics, simulator
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    k1_fns = [k1_launcher(a) for a, *_ in k1_calls]
    k2_fns = [cold(k2_launcher(a, kw)) for a, kw, *_ in k2_calls]
    (g_args, _, g_out, _), = k7_calls
    (d_args, d_kw, d_out, _), = draws
    (s_args, _, s_out, _) = stitches[0]
    res = {}
    for key, fn in (
            ('K1', lambda: sum(k1_ms(f) for f in k1_fns)),
            ('K2', lambda: device_ms(lambda: [f() for f in k2_fns], K2_REPS,
                                     ('vmax_kernel',))),
            ('K7', lambda: device_ms(cold(integrator.gate_launcher(
                *g_args)[0]), 20, K7_KERNELS)),
            ('K5', lambda: device_ms(cold(lambda: fourier.draw_fourier(
                *d_args, **d_kw)), 20, ('rng_fourier',))),
            ('K4_stitch', lambda: device_ms(cold(k4.launcher(
                'stitch', *s_args)[0]), 20, ('stitch_kernel',)))):
        ts = sorted(fn() for _ in range(TIME_ROUNDS))
        res[key], res[key + '_range'] = ts[len(ts) // 2], [ts[0], ts[-1]]
    k1b = [k1_bound(a, out) for a, _, out, _ in k1_calls]
    k2b = [k2_bound(a, kw, out) for a, kw, out, _ in k2_calls]
    k5b = ops32_bound(nbytes(d_out.A, d_out.B, d_kw['rows']),
                      FOURIER_OPS * d_out.A.numel())
    bounds = {'K1': (sum(b[0] for b in k1b), max(k1b)[1]),
              'K2': (sum(b[0] for b in k2b), max(k2b)[1]),
              'K7': k7_bound(g_args, g_out), 'K5': k5b,
              'K4_stitch': stitch_bound(s_args, s_out)}
    for key, (ms, by) in bounds.items():
        res[key + '_bound'], res[key + '_bound_by'] = ms, by
        res[key + '_below_bound'] = res[key + '_range'][0] < ms
    return {
        **res,
        'K1_plain_segment0': k1_plain_ms if k1_plain_ms is not None
        else cuda_ms(lambda: uncounted(simulator.integrate_segment_plain,
                                       *k1_calls[0][0]), 1),
        'K2_plain': sum(cuda_ms(lambda: uncounted(
            diagnostics.axi_to_max_wind_raw_plain, *a, **kw), 1)
            for a, kw, *_ in k2_calls),
        'K7_plain': cuda_ms(lambda: uncounted(simulator.genesis_alive_plain,
                                              *g_args), 5),
        'K5_plain': cuda_ms(lambda: fourier.draw_fourier_plain(
            *d_args, **d_kw), 5),
        'K5_shape': list(d_out.A.shape),
        'K4_stitch_plain': cuda_ms(lambda: uncounted(
            compact_ops.stitch_survivors_plain, *s_args), 5),
        'K4_stitch_shape': list(s_out[0]['wnds'].shape)}


# a K1 timing round's length on one segment, beyond which it takes fewer
# than K1_REPS runs
K1_ROUND_MS = 100.0


def k1_ms(fn):
    """K1's event time on one segment (cuda_ms): K1_REPS runs, or as many
    as take about K1_ROUND_MS where a run is longer, at least 3 (at
    fifteen levels a segment takes 10-30 ms)."""
    one = cuda_ms(fn, 1)
    return cuda_ms(fn, max(3, min(K1_REPS, int(K1_ROUND_MS / one))))


# bytes written before each launch that cold() times: more than the H100's
# 50 MB L2, so that the launch reads its inputs from HBM, as the bytes
# bounds count them, and not from the L2 its previous repetition filled
L2_FLUSH_BYTES = 256 * 2 ** 20


L2_FLUSH = []


def cold(fn):
    """fn preceded by a write of L2_FLUSH_BYTES on the card (a fill
    kernel, which device_ms leaves out when it times fn's kernels by
    name), into one buffer that every cold() shares.  The flush leaves
    the L2 full of dirty lines, whose write-backs then share the HBM
    with fn's reads (as after a kernel that wrote its outputs)."""
    if not L2_FLUSH:
        L2_FLUSH.append(torch.empty(L2_FLUSH_BYTES // 4,
                                    dtype=torch.float32, device='cuda'))

    def run():
        L2_FLUSH[0].zero_()
        return fn()
    return run


def clean(fn):
    """cold(fn) with a read of another L2_FLUSH_BYTES between the write
    and fn (a reduction, left out by name like the fill): the flush's
    dirty lines are written back before fn starts, and fn finds an L2 of
    clean lines that are not its inputs, so it moves the bytes a bytes
    bound counts and no write-backs of others'."""
    write = cold(lambda: None)
    if len(L2_FLUSH) < 2:
        L2_FLUSH.append(torch.zeros(L2_FLUSH_BYTES // 4,
                                    dtype=torch.float32, device='cuda'))

    def run():
        write()
        L2_FLUSH[1].sum()
        return fn()
    return run


def times_line(t, ref, keys):
    """Each kernel of `keys` in launch_kernel_times' t: its median time,
    [range], bound and twin, beside ref's median and [range]."""
    rng = lambda d, k: f'[{d[k + "_range"][0]:.4f}, {d[k + "_range"][1]:.4f}]'
    return '; '.join(
        f'{k} {t[k]:.4f} {rng(t, k)} / {ref[k]:.4f} {rng(ref, k)} ms '
        f'(bound {t[k + "_bound"]:.5f}, {t[k + "_bound_by"]}'
        f'{", a round below it" if t[k + "_below_bound"] else ""}; twin '
        f'{t[k + "_plain" if k != "K1" else "K1_plain_segment0"]:.3f})'
        for k in keys)


def check_tracks_levels(ds, cfg, label):
    """A tracks file of a three-level run: check_tracks, and every
    u/v{level}_trks present and finite at each survivor's first sample."""
    n, peaks = check_tracks(ds, cfg)
    names = [f'{c}{lv}_trks' for lv in cfg.steering_levels for c in 'uv']
    missing = [nm for nm in names if nm not in ds.variables]
    first = {nm: ds.variables[nm].data[:, 0] for nm in names
             if nm not in missing}
    bad = [nm for nm, a in first.items() if not np.isfinite(a).all()]
    log(f'[{label}] {n} tracks with {names}; first samples finite: '
        f'{not bad}; u500 at genesis {first.get("u500_trks", [])[:4]}')
    if missing or bad or n < 1:
        raise AssertionError(f'{label}: missing {missing}, not finite {bad}')
    return n, peaks


def levels_setup(dev):
    """The three-level launch inputs: the namelist of LEVELS3 at N_SEEDS
    seeds for one year, the 12-plane 181x360 synthetic pack of its winds,
    and the namelist auto-tuned on it (integrate cap, re-compaction
    schedule)."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.config import Namelist
    from tropical_cyclone_risk_tpu_torch.models import fast, fields, pipeline
    cfg = Namelist(seed_batch=N_SEEDS, start_year=2016, end_year=2016,
                   **LEVELS3)
    if fast.deep_layer_indices(cfg) != (0, 1, 4, 5):
        raise AssertionError(fast.deep_layer_indices(cfg))
    pack = fields.synthetic_pack(cfg, 12, 181, 360, seed=0, device=dev)
    cfg_t = pipeline.auto_integrate_cap(rng.fold_in(rng.key(0), 2016), pack,
                                        cfg, BASIN)
    return cfg, pack, cfg_t


def k1_modes(label, pack, cfg_t, plane0, modes):
    """K1 on the first and last segment of an N_SEEDS launch on pack in
    each of `modes` ({name: (namelist fields, bit-exact)}) against its
    twin: bit for bit where the mode is exact, else within the K1 bars;
    K7 on each launch's gate.  Returns {mode: K1's largest error}."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.models import simulator
    modes_err = {}
    for name, (kw, exact) in modes.items():
        calls, gates = mode_calls(rng.key(93), pack, cfg_t.replace(**kw),
                                  plane0, gate=True)
        k7_results(f'{label} {name}', gates)
        res = []
        for args, _, out, _ in (calls[0], calls[-1]):
            ref = uncounted(simulator.integrate_segment_plain, *args)
            agree, err, _ = compare_k1(out, ref)
            same_bits, diff = k1_exact(out, ref)
            res.append((args[7], args[3].lon.shape[0], agree,
                        max(err.values()), same_bits))
            modes_err[name] = max(modes_err.get(name, 0.0),
                                  max(err.values()))
            if (exact and not same_bits) or agree < K1_ALIVE_AGREE or any(
                    not err[nm] <= tol for nm, tol in K1_TOL.items()):
                raise AssertionError(f'{label} {name}: K1 alive agreement '
                                     f'{agree}, errors {err}, differs in '
                                     f'{diff}')
        log(f'[{label}] {name}: K1 against its twin on the first and last '
            f'segment (steps, storms, alive agreement, max abs err, '
            f'bit-exact) {res}')
        del calls
    return modes_err


@contextlib.contextmanager
def launch_captures(keep=True):
    """Within the block, the calls of K1, K2, K7, K5's row draw and K4's
    stitch are captured (captured, keep), yielded as one tuple of the five
    lists: launch_kernel_times' arguments."""
    from tropical_cyclone_risk_tpu_torch.models import diagnostics, simulator
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    with captured(simulator, 'integrate_segment', keep=keep) as k1c, \
            captured(diagnostics, 'axi_to_max_wind_raw', keep=keep) as k2c, \
            captured(simulator, 'genesis_alive', keep=keep) as k7c, \
            captured(fourier, 'draw_fourier', keep=keep) as draws, \
            captured(compact_ops, 'stitch_survivors', keep=keep) as sts:
        yield k1c, k2c, k7c, draws, sts


def check_widths(label, caps, w):
    """Require the wind channels of a launch's captures (launch_captures)
    to be w in K2's winds, K5's row draw and K4's stitch."""
    k1c, k2c, k7c, draws, sts = caps
    got = (k2c[0][0][4].shape[-1], draws[0][2].A.shape[1],
           sts[0][2][0]['wnds'].shape[-1])
    if got != (w, w, w):
        raise AssertionError(f'{label}: channels {got}, not {w}')


def check_levels(dev, card, tmp, libs, pack_y, cfg_t, levels):
    """Phase levels: steering_levels (250, 500, 850) at the bench's width.
    One launch on the 12-plane 181x360 pack of three levels (levels:
    levels_setup's), caps auto-tuned, through the kernels against the same
    launch through the twins on the card (launch_against_twins: every leaf
    bit for bit, every kernel launched, no twin); K1 on the first and last
    segment of a launch in each of LEVELS3_MODES; the kernels' per-launch
    times beside the two-level ones, timed alike on a launch of the
    two-level pack pack_y at cfg_t; then
    run_downscaling on that pack and cli.main GL on a workspace with 500
    hPa winds, counters reset just before and read just after each, their
    files holding every level's winds.  Returns the per-launch times and
    the largest errors."""
    from tropical_cyclone_risk_tpu_torch import kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    from tropical_cyclone_risk_tpu_torch.models import pipeline
    t_phase = time.perf_counter()
    with launch_captures() as caps:
        pipeline._simulate_batch(rng.key(94), pack_y, cfg_t, BASIN, N_SEEDS,
                                 64, cfg_t.start_month - 1)
    base = launch_kernel_times(*caps)
    del caps
    rep = ptxas_report(libs['integrator L3']['log']).get(K1_L3_INSTANCE)
    sass = sass_local_memory(libs['integrator L3']['path']).get(
        K1_L3_INSTANCE, 'not read')
    log(f'[levels] K1 {K1_L3_INSTANCE}: {rep or "no ptxas report"}; SASS '
        f'local loads/stores {sass}')
    cfg, pack, cfg_t = levels
    plane0 = cfg.start_month - 1
    log(f'[levels] pack winds {tuple(pack.wind.shape)}; integrate_cap '
        f'{cfg_t.integrate_cap} schedule {cfg_t.recompact_schedule}')
    three = launch_against_twins('levels', rng.key(94), pack, cfg_t, plane0,
                                 capture=True)
    check_widths('levels', three['caps'], 6)
    t3 = launch_kernel_times(*three.pop('caps'))
    modes_err = k1_modes('levels', pack, cfg_t, plane0, LEVELS3_MODES)
    log(f'[levels] {card}: per launch, the kernel alone, three levels '
        f'against two (this call; median [range] of {TIME_ROUNDS} rounds): '
        + times_line(t3, base, ('K1', 'K2', 'K7', 'K5', 'K4_stitch')) +
        f'; K5 rows {t3["K5_shape"]}, stitch {t3["K4_stitch_shape"]}')

    # run_downscaling on the three-level pack
    cfg_run = cfg.replace(output_directory=f'{tmp}/levels', exp_name='l3')
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    fn = runtime.run_downscaling(cfg_run, BASIN, pack, seed=4, device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    check_counts('levels run', dict(kernels.LAUNCHES),
                 dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
    n_run, _ = check_tracks_levels(netcdf.read(fn), cfg_run, 'levels run')
    log(f'[levels] run_downscaling one year at three levels in {t_run:.2f} '
        f's: {n_run} tracks')

    # cli.main GL on a workspace with 250, 500 and 850 hPa winds
    t_cli = workspace_cli(tmp, card, 'levels', LEVELS3)
    log(f'[levels] phase {time.perf_counter() - t_phase:.1f} s')
    return {'ms': t3, 'two_levels_ms': base, 'launch': three,
            'k1_modes_max_abs_err': modes_err, 'k1_l3_ptxas': rep,
            'run_s': t_run, 'cli_s': t_cli}


# four steering levels, (250, 500, 700, 850) hPa: the levels of CMIP6's
# plev8 from 250 to 850 hPa (tests/test_torch_levels4.py's coefficients)
LEVELS4 = dict(steering_levels=(250, 500, 700, 850),
               steering_coefs=(0.1, 0.2, 0.2, 0.5),
               y_alpha=(0.1, 0.2, 0.2, 0.5), m_alpha=(0.001, 0.0, 0.0, -0.001),
               alpha_max=(0.4, 0.4, 0.4, 0.9),
               alpha_min=(0.05, 0.05, 0.05, 0.5))
# the modes K1 is held in on the first and last segment of a four-level
# launch (time_interp_fields runs through the whole launch against the
# twins instead)
LEVELS4_MODES = {k: v for k, v in LEVELS3_MODES.items()
                 if k != 'time_interp_fields'}


def steering_fields(levels):
    """Namelist steering fields for `levels` (250 hPa first, 850 hPa
    last): half the steering at 850 hPa and half shared by the others,
    y_alpha likewise, the intensity slope at the two ends
    (tests/test_torch_levels4.py's coefficients beyond four levels)."""
    n = len(levels)
    share = (0.5 / (n - 1),) * (n - 1) + (0.5,)
    return dict(steering_levels=tuple(levels), steering_coefs=share,
                y_alpha=share, m_alpha=(0.001,) + (0.0,) * (n - 2) + (-0.001,),
                alpha_max=(0.4,) * (n - 1) + (0.9,),
                alpha_min=(0.05,) * (n - 1) + (0.5,))


# the ERA5 request's levels from 250 to 850 hPa (utils/synthetic_era5.py
# LEVELS_HPA): the deepest steering layer a user can ask of a workspace
ERA5_LAYER = (250, 300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775,
              800, 825, 850)
# the stack layouts of K1's instances (csrc/integrator.cu kInCell,
# kFusedGeo, kSeparateGeo), and the namelist of each analytic mode
LAYOUTS = ('in-cell', 'fused', 'separate')
ANALYTIC_MODES = {'exact': dict(rk_exact_stage_fields=True),
                  'substeps': dict(rk_substeps=2)}
# the steps of the first segment on which check_instances holds an
# instance against its twin: one strided block of three and a per-step
# remainder, or two analytic steps
INSTANCE_STEPS = {False: 4, True: 2}


def k1_instances(diag):
    """The twelve K1 instances of a unit (diag: the in-scan unit) as
    (diag, time_interp_fields, analytic mode or None, layout); each
    analytic instance in one of ANALYTIC_MODES (rk_exact_stage_fields and
    rk_substeps=2 take turns, both run its code)."""
    out = []
    for n, layout in enumerate(LAYOUTS):
        for interp in (False, True):
            mode = 'exact' if (n + interp) % 2 == 0 else 'substeps'
            out += [(diag, interp, None, layout), (diag, interp, mode, layout)]
    return out


def instance_label(levels, inst):
    """A K1 instance's template arguments, <L,diag,interp,analytic,layout>,
    and its analytic mode."""
    diag, interp, mode, layout = inst
    return (f'<{levels},{int(diag)},{int(interp)},{int(mode is not None)},'
            f'{LAYOUTS.index(layout)}>' + (f' {mode}' if mode else ''))


def check_instances(label, dev, pack, cfg_t, plane0, key, instances):
    """K1's `instances` (k1_instances' tuples) of the set's units, each
    launched on the card and held bit for bit against its twin on the first
    INSTANCE_STEPS steps of the first segment of a launch on the pack in
    its layout (geo_pack for fused and separate; with the launch's
    DiagState for the in-scan unit), K7 against its twin on each of those
    launches (mode_calls).  Returns the labels held."""
    from tropical_cyclone_risk_tpu_torch.models import simulator
    lv = cfg_t.n_steering_levels
    held = []
    for layout in LAYOUTS:
        if not any(i[3] == layout for i in instances):
            continue
        pack_l = pack if layout == 'in-cell' else geo_pack(cfg_t, dev,
                                                           layout)
        geo_stacks(pack_l, layout)
        for diag in (False, True):
            todo = [i for i in instances if i[0] == diag and i[3] == layout]
            if not todo:
                continue
            cfg_l = cfg_t.replace(vmax_in_scan=diag)
            calls, gates = mode_calls(key, pack_l, cfg_l, plane0, gate=True)
            k7_results(f'{label} {layout}{" in-scan" if diag else ""}',
                       gates)
            args, kw = calls[0][:2]
            del calls, gates
            for inst in todo:
                _, interp, mode, _ = inst
                cfg_i = cfg_l.replace(time_interp_fields=interp,
                                      **ANALYTIC_MODES.get(mode, {}))
                short = ((args[0], cfg_i) + tuple(args[2:7])
                         + (INSTANCE_STEPS[mode is not None],)
                         + tuple(args[8:]))
                out = uncounted(simulator.integrate_segment, *short, **kw)
                ref = uncounted(simulator.integrate_segment_plain, *short,
                                **kw)
                same_bits, diff = k1_exact(out, ref)
                name = instance_label(lv, inst)
                if not same_bits:
                    raise AssertionError(f'{label}: K1 {name} differs from '
                                         f'its twin in {diff}')
                held.append(name)
        del pack_l
    log(f'[{label}] K1 instances launched and bit-exact against their twins '
        f'on the first {INSTANCE_STEPS[False]} (analytic: '
        f'{INSTANCE_STEPS[True]}) steps of segment 0: {held}')
    return held


# The [levels4] phase's level sets, each a bench-width launch through K1,
# K7 (the unit TC_K1_LEVELS of its count), K2, K5's row entry and K4's
# stitch at W = 2 L, held against the same launch through the twins on the
# card: (label, namelist steering fields, PRNG key, checks).  Checks:
# 'k1_segments' K1 against its twin on that many first segments alone (the
# launch through the twins keeps K1: its Python Cholesky of W^3/6 steps a
# gather is the cost at fifteen levels), else the whole launch;
# 'interp' the launch again with time_interp_fields; 'modes' K1 on the
# first and last segment in each of LEVELS4_MODES, bit for bit; 'geo'
# geo_modes on the set's pack with land and bathymetry on grids of their
# own (geo_pack: fused and separate, each in GEO_MODES);
# 'in_scan' vmax_in_scan bit for bit the post-pass; 'cli' cli.main GL one
# year on a one-degree workspace with the set's winds; 'instances' K1's
# instances held on a short first segment (check_instances).  The kernels
# line names the instances of each set (level_entries).
LEVEL_SETS = (
    ('levels4', LEVELS4, 88, dict(interp=True, modes=True, in_scan=True)),
    ('L5', steering_fields((250, 300, 500, 700, 850)), 78,
     dict(interp=True, modes=True, geo=True, in_scan=True, cli=True,
          instances=[i for i in k1_instances(False)
                     if i[2] and i[1:] != (False, 'exact', 'in-cell')]
          + [i for i in k1_instances(True)
             if i[1:] != (False, None, 'in-cell')])),
    # CMIP6's plev19 levels in the layer
    ('L7', steering_fields((250, 300, 400, 500, 600, 700, 850)), 74,
     dict(geo=True, instances=[
         i for i in k1_instances(False) if (i[2] or i[3] == 'in-cell')
         and i[1:] != (False, None, 'in-cell')])),
    ('L15', steering_fields(ERA5_LAYER), 72,
     dict(k1_segments=1,
          instances=[i for i in k1_instances(False)
                     if i[1:] != (False, None, 'in-cell')])),
    # the ERA5 request's fifteen and 200 and 225 hPa: W = 34 winds, more
    # than a warp's lanes, so lanes own several rows and levels
    ('L17', steering_fields((200, 225) + ERA5_LAYER), 70,
     dict(k1_segments=1)))


def level_entries():
    """The kernels line's entries of the level sets: (set, name, the
    launch_kernel_times key, counter, launch_against_twins' call key,
    source, the JAX function replaced, the instance); K4's stitch at four
    and five levels (the stitch takes any W: one instance)."""
    out = []
    for label, steer, _, _ in LEVEL_SETS:
        lv = len(steer['steering_levels'])
        w = 2 * lv
        k25 = w if lv == 4 else 0          # K2's and K5's instance
        k1, k7 = (('integrate_group_kernel', 'genesis_group_kernel')
                  if lv >= GROUP_LEVELS else
                  ('integrate_segment_kernel', 'genesis_gate_kernel'))
        out += [
            (label, f'integrator_l{lv}', 'K1', 'integrator', 'integrator',
             'integrator.cu', 'models/simulator.py:111',
             f'{k1}<{lv},*,*,*,*> (unit TC_K1_LEVELS={lv})'),
            (label, f'genesis_l{lv}', 'K7', 'genesis', 'genesis',
             'integrator.cu', 'models/simulator.py:295', f'{k7}<{lv},*>'),
            (label, 'vmax_l4' if lv == 4 else f'vmax_w{w}', 'K2', 'vmax',
             'vmax', 'vmax.cu', 'models/diagnostics.py:193',
             f'vmax_kernel<{k25}> at W = {w}'),
            (label, 'threefry_rows_l4' if lv == 4 else f'threefry_rows_c{w}',
             'K5', 'threefry', 'threefry rows', 'rng.cu',
             'ops/fourier.py:84', f'rng_fourier_kernel<1,{k25}> at C = {w}')]
        if lv in (4, 5):
            out.append((label, f'compact_stitch_l{lv}', 'K4_stitch',
                        'compact', 'stitch', 'compact.cu', 'ops/compact.py:30',
                        f'stitch_kernel<0> at W = {w}'))
    return out
# the [gcm] workspaces' one noleap year
GCM_YEAR = 2030


def launch_fields(body, out):
    """A launch's leaves that must agree bit for bit: every segment's
    time-major buffers, the compacted track metadata, compact_survivors'
    tracks and meta."""
    segs = (body['tm'],) + tuple(body.get('tms', ()))
    leaves = {f'seg {i} {f}': t[f] for i, t in enumerate(segs)
              for f in ('lon', 'lat', 'v', 'm', 'wnds', 'alive', 'vmax')
              if f in t}
    leaves.update({f'trk {f}': body['trk'][f]
                   for f in ('keep', 'month', 'basin_idx')})
    tracks, meta = out
    leaves.update({f'tracks {f}': v for f, v in tracks.items()})
    leaves.update({f'meta {f}': meta[f]
                   for f in ('keep', 'scalars', 'spm_upto', 'spm_all')})
    return leaves


def same_launches(a, b):
    """(leaves of launch_fields that differ, largest error of the tracks'
    float fields where both are finite, 0.0 for a bit-exact pair)."""
    diff = [k for k in a if not same(a[k], b[k])]
    err = max(max_err(a[k], b[k]) for k in a
              if k.startswith('tracks') and a[k].is_floating_point())
    return diff, err


@contextlib.contextmanager
def timed_calls(mod, name):
    """Within the block, each call of mod.name appends its wall time in ms
    (the card synchronised before and after) to the list it yields."""
    fn, ms = getattr(mod, name), []

    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(mod, name, call)
    try:
        yield ms
    finally:
        setattr(mod, name, fn)


def launch_against_twins(label, key, pack, cfg, plane0, capture=False,
                         k1_segments=None):
    """One N_SEEDS launch (launch_body, compact_survivors at k_max 64)
    through the kernels, counters reset just before and read just after
    (every kernel of a simulation launched, no twin), its peak device
    memory, and the same launch through the twins on the card
    (twins_on_card), K1's twin timed per call; requires every leaf bit for
    bit (launch_fields).  With k1_segments (which needs capture), K1 stays
    the kernel in the launch through the twins, which then holds every
    other kernel, and K1 is held bit for bit against its twin on the
    launch's first k1_segments segments alone (its twin costs the most at
    many levels).  Returns {'launches': the counters, 'calls': the calls
    of K1, K2, K7, K5's row draw and K4's stitch in the launch through the
    kernels (each one launch of its kernel), 'max_abs_err': the tracks'
    largest error, 'k1_twin_ms': K1's twin per launch (on the segments
    compared), 'peak_mib': the launch's peak device memory, 'pd_share':
    the share of alive storm-steps whose gathered wind covariance was
    positive definite (coloured winds, not zeros), 'caps': with capture,
    the calls themselves (launch_captures) for launch_kernel_times}."""
    from tropical_cyclone_risk_tpu_torch import kernels
    from tropical_cyclone_risk_tpu_torch.models import pipeline, simulator
    m = pipeline.launch_width(cfg, N_SEEDS)
    n_basins = len(cfg.basin_ids_sorted())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    kernels.reset_counts()
    with launch_captures(keep=capture) as caps:
        body = pipeline.launch_body(key, pack, cfg, BASIN, N_SEEDS, plane0)
        out = pipeline.compact_survivors(body, m, 64, n_basins)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = dict(kernels.LAUNCHES)
    check_counts(label, launches, dict(kernels.PLAIN_ON_CUDA),
                 SIMULATION_KERNELS)
    kern = launch_fields(body, out)
    del body, out
    keep, ms = (), []
    if k1_segments is not None:
        keep = ('integrate_segment',)
        for args, kw, k_out, _ in caps[0][:k1_segments]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = uncounted(simulator.integrate_segment_plain, *args, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            same_bits, diff = k1_exact(k_out, ref)
            if not same_bits:
                raise AssertionError(f'{label}: K1 differs from its twin on '
                                     f'segment {len(ms) - 1} in {diff}')
            del ref
    with twins_on_card(keep), (contextlib.nullcontext(ms) if keep else
                               timed_calls(simulator, 'integrate_segment')
                               ) as ms:
        body = pipeline.launch_body(key, pack, cfg, BASIN, N_SEEDS, plane0)
        out = pipeline.compact_survivors(body, m, 64, n_basins)
        torch.cuda.synchronize()
    diff, err = same_launches(kern, launch_fields(body, out))
    n_surv = int(out[1]['scalars'][0])
    del body, out
    pd = pd_share(caps[0]) if capture else None
    log(f'[{label}] {launches["integrator"]} segments, {n_surv} '
        f'survivors; through the kernels against the twins on the card'
        + (f' (K1 the kernel in both, and against its twin bit for bit on '
           f'the first {len(ms)} segments)' if keep else '') +
        f': differing leaves {diff or "none"} of {len(kern)}, tracks max '
        f'abs err {err!r}; K1\'s twin {sum(ms):.1f} ms on {len(ms)} '
        f'segments; peak {peak:.1f} MiB ({base_mib:.1f} before); '
        f'positive-definite share of alive storm-steps {pd}')
    if diff or err != 0.0 or n_surv < 1 or (capture and not pd > 0.0):
        raise AssertionError(f'{label}: differs from the twins in {diff}, '
                             f'error {err}, {n_surv} survivors, '
                             f'positive-definite share {pd}')
    calls = dict(zip(('integrator', 'vmax', 'genesis', 'threefry rows',
                      'stitch'), map(len, caps)))
    return {'launches': launches, 'calls': calls, 'max_abs_err': err,
            'k1_twin_ms': sum(ms), 'k1_twin_segments': len(ms),
            'k1_twin_segment0_ms': ms[0],
            'peak_mib': peak, 'pd_share': pd,
            'caps': caps if capture else None}


def pd_share(k1_calls):
    """The share of the alive storm-steps of K1's calls (launch_captures)
    whose winds are coloured: a sample whose gathered covariance is not
    positive definite gets zero winds (fast.color_winds_given_f), so a
    nonzero wind marks one that is."""
    alive = coloured = 0
    for _, _, out, _ in k1_calls:
        wnds, live = out[0][4], out[0][5]
        alive += int(live.sum())
        coloured += int((live & (wnds != 0).any(-1)).sum())
    return coloured / max(alive, 1)


def level_setup(dev, steer):
    """A level set's launch inputs: the namelist of the steering fields
    `steer` at N_SEEDS seeds for one year, the 12-plane 181x360 synthetic
    pack of its winds, and the namelist auto-tuned on it."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.config import Namelist
    from tropical_cyclone_risk_tpu_torch.models import fast, fields, pipeline
    cfg = Namelist(seed_batch=N_SEEDS, start_year=2016, end_year=2016,
                   **steer)
    i2, i8 = (2 * cfg.steering_levels.index(p) for p in (250, 850))
    if fast.deep_layer_indices(cfg) != (i2, i2 + 1, i8, i8 + 1):
        raise AssertionError(fast.deep_layer_indices(cfg))
    pack = fields.synthetic_pack(cfg, 12, 181, 360, seed=0, device=dev)
    cfg_t = pipeline.auto_integrate_cap(rng.fold_in(rng.key(0), 2016), pack,
                                        cfg, BASIN)
    return cfg, pack, cfg_t


def unit_reports(libs, levels):
    """{K1/K7 instance of the units of `levels` levels: its ptxas report
    and SASS local loads/stores} and {unit: its nvcc seconds} (build_all's
    libraries; 0 where build/ already held the unit)."""
    reps, secs = {}, {}
    for unit in (f'integrator L{levels}', f'integrator L{levels} diag'):
        if unit not in libs:
            continue
        secs[unit] = libs[unit]['seconds']
        sass = sass_local_memory(libs[unit]['path'])
        for fn, rep in ptxas_report(libs[unit]['log']).items():
            if f'<{levels},' in fn:
                reps[f'{fn}{" (in-scan unit)" if "diag" in unit else ""}'] \
                    = f'{rep}; SASS local loads/stores {sass.get(fn, "?")}'
    return reps, secs


def check_level_set(dev, card, libs, tmp, label, steer, key, checks,
                    ref_ms):
    """One level set of LEVEL_SETS: its unit's ptxas reports and nvcc
    seconds, a bench-width launch (caps auto-tuned) through the kernels
    against the twins (launch_against_twins: every leaf bit for bit, no
    twin on CUDA, the peak memory, the positive-definite share), each
    kernel's per-launch time alone (TIME_ROUNDS rounds, L2 flushed) beside
    its bound, its twin and ref_ms (the set before's, or [levels]'), then
    the set's checks.  Returns the figures."""
    from tropical_cyclone_risk_tpu_torch import rng
    t_phase = time.perf_counter()
    n = len(steer['steering_levels'])
    reps, secs = unit_reports(libs, n)
    for fn, rep in reps.items():
        log(f'[{label}] {fn}: {rep}')
    cfg, pack, cfg_t = level_setup(dev, steer)
    plane0 = cfg.start_month - 1
    log(f'[{label}] levels {cfg.steering_levels}: pack winds '
        f'{tuple(pack.wind.shape)}; integrate_cap {cfg_t.integrate_cap} '
        f'schedule {cfg_t.recompact_schedule}; units\' nvcc s {secs}')
    res = launch_against_twins(label, rng.key(key), pack, cfg_t, plane0,
                               capture=True,
                               k1_segments=checks.get('k1_segments'))
    check_widths(label, res['caps'], 2 * n)
    t = launch_kernel_times(*res.pop('caps'),
                            k1_plain_ms=res['k1_twin_segment0_ms'])
    if checks.get('interp'):
        launch_against_twins(f'{label} time_interp_fields', rng.key(key - 1),
                             pack, cfg_t.replace(time_interp_fields=True),
                             plane0)
    if checks.get('modes'):
        res['k1_modes_max_abs_err'] = k1_modes(label, pack, cfg_t, plane0,
                                               LEVELS4_MODES)
    if checks.get('geo'):
        for layout in GEO_LAYOUTS:
            pack_g = geo_pack(cfg_t, dev, layout)
            geo_stacks(pack_g, layout)
            geo_modes(label, rng.key(key - 3), pack_g, cfg_t, plane0, layout)
            del pack_g
    if checks.get('in_scan'):
        res['in_scan_max_abs_err'], res['in_scan_last_max_abs_err'] = \
            in_scan_k1(label, rng.key(key - 2), pack, cfg_t, plane0, True,
                       vmax_tol=0.0)
    if checks.get('instances'):
        t_inst = time.perf_counter()
        res['instances'] = check_instances(label, dev, pack, cfg_t, plane0,
                                           rng.key(key - 4),
                                           checks['instances'])
        res['instances_s'] = time.perf_counter() - t_inst
    del pack
    if checks.get('cli'):
        res['cli_s'] = workspace_cli(tmp, card, label, steer)
    ref_label, ref = ref_ms
    log(f'[{label}] {card}: per launch, the kernel alone, {n} levels '
        f'against {ref_label} (median [range] of {TIME_ROUNDS} rounds): '
        + times_line(t, ref, ('K1', 'K2', 'K7', 'K5', 'K4_stitch')) +
        f'; K1\'s twin {res["k1_twin_ms"]:.1f} ms on '
        f'{res["k1_twin_segments"]} segments; K5 rows {t["K5_shape"]}, '
        f'stitch {t["K4_stitch_shape"]}; peak {res["peak_mib"]:.1f} MiB; '
        f'positive-definite share {res["pd_share"]:.4f}; phase '
        f'{time.perf_counter() - t_phase:.1f} s')
    return {'ms': t, **res, 'ptxas': reps, 'nvcc_s': secs,
            'levels': cfg.steering_levels,
            'phase_s': time.perf_counter() - t_phase}


def check_levels4(dev, card, libs, tmp, levels3_ms):
    """Phase levels4: the level sets of LEVEL_SETS, each through
    check_level_set, its times beside the set before's (the first's beside
    [levels]' three-level launch, levels3_ms).  Returns {label: figures}."""
    out, ref = {}, ('three of [levels]', levels3_ms)
    for label, steer, key, checks in LEVEL_SETS:
        out[label] = check_level_set(dev, card, libs, tmp, label, steer, key,
                                     checks, ref)
        ref = (f'{len(steer["steering_levels"])} of [{label}]',
               out[label]['ms'])
        torch.cuda.empty_cache()
    return out


def workspace_cli(tmp, card, label, steer):
    """cli.main GL for one year on a one-degree 181x360 workspace
    (utils/synthetic_era5) with winds at steer's levels and its steering
    fields appended to the namelist, counters reset just before and read
    just after (every kernel of the workspace path, no twin); the tracks
    file holds every level's winds, finite at genesis.  Returns the CLI's
    seconds."""
    from tropical_cyclone_risk_tpu_torch import cli, kernels, runtime
    from tropical_cyclone_risk_tpu_torch.config import load_namelist_py
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_era5
    t0 = time.perf_counter()
    nl = synthetic_era5.make_workspace(
        f'{tmp}/ws_{label}', WS_YEAR, WS_YEAR, nlat=181, nlon=360,
        seed_batch=N_SEEDS, wind_levels=steer['steering_levels'])
    with open(nl, 'a') as f:
        f.write(''.join(f'{k} = {v!r}\n' for k, v in steer.items()))
    cfg_ws = load_namelist_py(nl)
    t_write = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    cli.main(['GL', '--namelist', nl, '--seed', '0'])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    check_counts(f'{label} workspace', dict(kernels.LAUNCHES),
                 dict(kernels.PLAIN_ON_CUDA), WORKSPACE_KERNELS)
    n_ws, _ = check_tracks_levels(
        netcdf.read(runtime.get_fn_tracks(cfg_ws, BASIN)), cfg_ws,
        f'{label} workspace')
    log(f'[{label}] {card}: cli.main GL one year on a '
        f'{"/".join(map(str, steer["steering_levels"]))} hPa workspace '
        f'(written in {t_write:.1f} s) in {t_cli:.2f} s: {n_ws} tracks')
    return t_cli


def check_gcm_tracks(ds, cfg, label):
    """A tracks file of the GCM path: the variables tests/test_cmip6_e2e.py
    checks (and every steering level's winds), check_tracks_levels' checks,
    the year's seeds_per_month and its tracks."""
    n, peaks = check_tracks_levels(ds, cfg, label)
    years = ds.variables['tc_years'].data
    spm = ds.variables['seeds_per_month'].data
    if not (n == cfg.tracks_per_year and set(years.tolist()) == {
            cfg.start_year} and spm.shape[0] == 1 and spm.sum() > 0):
        raise AssertionError(f'{label}: {n} tracks, years {set(years)}, '
                             f'seeds_per_month {spm.shape}')
    return n, peaks


def check_gcm(dev, tmp, card):
    """Phase gcm: the CMIP6 path on the card.  A 1-degree one-year
    workspace of utils/synthetic_cmip6 (noleap days, plev in Pa, tos in
    degC on the 0.5-degree ocean grid) through cli.main GL at 250/850 hPa,
    counters reset just before and read just after (every kernel of the
    workspace path, K6 among them, no twin), each regrid (the thermo
    driver's 12 SST months, the pack builder's 24 mld and strat months)
    handed a tensor on the card, the thermo and tracks files checked, the
    stages timed (on this synthetic workspace's six Amon levels; CMIP6's
    Amon ta and hus come on the 19 levels of plev19); K6 on the six Amon
    levels in Pa timed alone beside its bound and twin; the SST regrid on the card against the CPU's, bit for bit,
    on all 12 months.  Then a workspace with the daily winds on the four
    plev8 levels from 250 to 850 hPa through cli.main GL at those four
    levels, the same checks, the u/v500 and u/v700 winds in the file.
    Returns the figures."""
    from tropical_cyclone_risk_tpu_torch import cli, kernels, runtime
    from tropical_cyclone_risk_tpu_torch.config import load_namelist_py
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    from tropical_cyclone_risk_tpu_torch.ops import interp
    from tropical_cyclone_risk_tpu_torch.ops import pi as pi_ops
    from tropical_cyclone_risk_tpu_torch.preprocess import thermo_driver
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_cmip6
    t_phase = time.perf_counter()
    res = {}
    for name, day_levels, fields in (
            ('two levels', synthetic_cmip6.PLEV_DAY, {}),
            ('four levels', synthetic_cmip6.PLEV8, LEVELS4)):
        t0 = time.perf_counter()
        nl = synthetic_cmip6.build(f'{tmp}/gcm {name}', GCM_YEAR, GCM_YEAR,
                                   seed_batch=N_SEEDS, day_levels=day_levels)
        with open(nl, 'a') as f:
            f.write(''.join(f'{k} = {v!r}\n' for k, v in fields.items()))
        cfg = load_namelist_py(nl)
        t_write = time.perf_counter() - t0
        regrids, orig = [], interp.regrid

        def spy(field, *a):
            regrids.append(getattr(field, 'device', None))
            return orig(field, *a)

        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with stage_times() as stages, \
                captured(pi_ops, 'cape_pi', keep=name == 'two levels') as k6c:
            interp.regrid = spy
            try:
                cli.main(['GL', '--namelist', nl, '--seed', '0'])
            finally:
                interp.regrid = orig
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        check_counts(f'gcm {name}', launches, dict(kernels.PLAIN_ON_CUDA),
                     WORKSPACE_KERNELS)
        if len(regrids) != 36 or {str(d) for d in regrids} != {'cuda:0'}:
            raise AssertionError(f'gcm {name}: regrids on {regrids}')
        check_thermo_file(thermo_driver.get_fn_thermo(cfg), netcdf,
                          synthetic_cmip6, f'gcm {name}')
        n, peaks = check_gcm_tracks(
            netcdf.read(runtime.get_fn_tracks(cfg, BASIN)), cfg,
            f'gcm {name}')
        res[name] = {'write_s': t_write, 'cli_s': t_cli,
                     'stages_s': dict(stages), 'launches': launches,
                     'tracks': n}
        log(f'[gcm] {card}: {name} ({"/".join(map(str, cfg.steering_levels))}'
            f' hPa; daily winds on {len(day_levels)} levels, workspace '
            f'written in {t_write:.1f} s): cli.main GL one year in '
            f'{t_cli:.2f} s; stages (s) '
            f'{json.dumps({k: round(v, 3) for k, v in stages.items()})}; '
            f'{n} tracks, peak v {peaks.min():.1f}..{peaks.max():.1f} m/s; '
            f'every regrid on the card (12 SST and 24 climatology months)')
        if name == 'two levels':
            (k6_args, k6_kw, k6_out, _), = k6c
            ref = uncounted(pi_ops.cape_pi_plain, *k6_args, **k6_kw)
            if not same(k6_out, ref):
                raise AssertionError('gcm: K6 differs from its twin')
            k6 = {'ms': device_ms(lambda: pi_ops.cape_pi(*k6_args, **k6_kw),
                                  20, ('cape_pi_kernel',)),
                  'plain_ms': cuda_ms(lambda: uncounted(
                      pi_ops.cape_pi_plain, *k6_args, **k6_kw), 2),
                  'shape': list(k6_args[3].shape),
                  'levels': 'the synthetic workspace\'s six Amon levels '
                            '(CMIP6 Amon files: plev19)'}
            k6['bound_ms'], k6['bound_by'] = k6_bound(k6_args, k6_out)
            res['k6'] = k6
            log(f'[gcm] {card}: K6 on {k6["shape"]} (the synthetic '
                f'workspace\'s six Amon levels in Pa, months, lat, lon; '
                f'CMIP6 Amon files hold plev19) bit-exact against its twin; kernel '
                f'{k6["ms"]:.4f} ms device, bound {k6["bound_ms"]:.4f} ms '
                f'({k6["bound_by"]}), twin {k6["plain_ms"]:.3f} ms')
            del k6c, k6_args, k6_out, ref
            res['regrid'] = check_regrid(cfg, interp, netcdf, dev, card)
    res['phase_s'] = time.perf_counter() - t_phase
    log(f'[gcm] phase {res["phase_s"]:.1f} s')
    return res


def check_regrid(cfg, interp, netcdf, dev, card):
    """The workspace's tos (12 months on the ocean grid, NaN as 0) regridded
    onto the atmosphere grid on the card and on the CPU: bit for bit (the
    same float32 operations in the same order).  Returns its figures."""
    from tropical_cyclone_risk_tpu_torch.io import input as tcin
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_cmip6
    ds = netcdf.read(tcin.glob_prefix(cfg, 'tos')[0])
    tos = np.nan_to_num(np.asarray(ds['tos'].data, np.float32))
    lon_s, lat_s = np.asarray(ds['lon'].data), np.asarray(ds['lat'].data)
    lon_a, lat_a = synthetic_cmip6.grids(False)
    months = torch.from_numpy(tos)
    card_out = torch.stack([interp.regrid(x, lon_s, lat_s, lon_a, lat_a)
                            for x in months.to(dev)])
    cpu_out = torch.stack([interp.regrid(x, lon_s, lat_s, lon_a, lat_a)
                           for x in months])
    ok = same(card_out.cpu(), cpu_out)
    err = max_err(card_out.cpu(), cpu_out)
    ms = cuda_ms(lambda: [interp.regrid(x, lon_s, lat_s, lon_a, lat_a)
                          for x in months.to(dev)], 5)
    log(f'[gcm] {card}: SST regrid {tuple(tos.shape)} -> '
        f'{tuple(card_out.shape)} on the card against the CPU: bit-exact '
        f'{ok} (max abs err {err}); {ms:.3f} ms for 12 months')
    if not ok:
        raise AssertionError(f'gcm: the SST regrid on the card differs from '
                             f'the CPU\'s by {err}')
    return {'bit_exact': ok, 'ms_12_months': ms}


def fix_calls():
    """A context that wraps diagnostics.fix_in_scan, which on the card
    fixes every segment's vmax buffer and the peak in place in one launch:
    each call's buffers are copied first and the plain twin (the loop of
    fix_last_sample_plain and bank_peak) runs on the copies, uncounted;
    yields the list of (args, kw, out, (bit-exact, largest error of the
    fixed buffers and of the finite peaks)), args holding the copies."""
    from tropical_cyclone_risk_tpu_torch.models import diagnostics
    fn, calls = diagnostics.fix_in_scan, []

    def wrap(raws, edges, a_idxs, orders, last_step, peak, dt_s, cfg=None):
        before = [dict(r, vmax=r['vmax'].clone()) for r in raws]
        peak0 = peak.clone()
        out = fn(raws, edges, a_idxs, orders, last_step, peak, dt_s, cfg)
        args = (before, edges, a_idxs, orders, last_step, peak0, dt_s, cfg)
        ref = uncounted(diagnostics.fix_in_scan_plain,
                        [dict(r) for r in before], *args[1:])
        exact = (all(same(a, b) for a, b in zip(out[0], ref[0]))
                 and same(out[1], ref[1]))
        fin = torch.isfinite(ref[1])
        err = max([max_err(a, b) for a, b in zip(out[0], ref[0])]
                  + [max_err(out[1][fin], ref[1][fin])])
        calls.append((args, {}, out, (exact, err)))
        return out

    @contextlib.contextmanager
    def ctx():
        diagnostics.fix_in_scan = wrap
        try:
            yield calls
        finally:
            diagnostics.fix_in_scan = fn
    return ctx()


def fix_launcher(args):
    """The launch function of the last-sample entry (the kernel alone) on
    copies of the buffers of one captured fix_in_scan call (fix_calls'
    args); the entry is idempotent, so it may be launched again and
    again."""
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2
    from tropical_cyclone_risk_tpu_torch.models import diagnostics
    raws, edges, a_idxs, orders, last_step, peak0, dt_s, cfg = args
    segs = diagnostics.in_scan_segments(
        [dict(r, vmax=r['vmax'].clone()) for r in raws], edges, a_idxs,
        orders)
    return k2.last_launcher(segs, last_step, dt_s,
                            diagnostics._shear_channels(cfg),
                            peak0.clone())[0]


def last_bound(args, kw, out):
    """The last-sample entry's bound on one in-scan launch (fix_calls'
    args), summed over its segments: per column the rows L and L-1 of lon
    and lat, v, the four shear winds and alive at L, its slot's last step
    and (after segment 0) its slot map read once; for the columns whose
    last sample is the segment's first row (after segment 0) the boundary
    order and the row before; for the ok columns the fixed sample written
    and the slot's peak read and written (this call's data); ~45 float32
    operations per column (vmax_at and the extrapolation)."""
    raws, edges, a_idxs, *_ = args
    last_step = args[4]
    n_bytes = n_cols = 0
    for k, r in enumerate(raws):
        T, N = r['lon'].shape
        ls = (last_step[a_idxs[k - 1]] if k else last_step) - edges[k]
        Lc = ls.clamp(0, T - 1)
        ok = (ls >= 0) & (ls < T) & torch.gather(r['alive'], 0,
                                                 Lc[None, :])[0]
        n_bytes += N * (4 * 4 + 4 + 16 + 1 + 8 + (8 if k else 0))
        n_bytes += 12 * int(ok.sum())
        if k:
            n_bytes += 16 * int((ls == 0).sum())
        n_cols += N
    return bound(n_bytes, 45 * n_cols)


# the in-scan instances the in-scan phase holds against their twins besides
# the default path's: (steering levels of the pack, namelist fields,
# whether K1 is bit-exact against its twin there, as LEVELS3_MODES)
IN_SCAN_MODES = {'time_interp_fields': (2, dict(time_interp_fields=True),
                                        True),
                 'rk_substeps=2': (2, dict(rk_substeps=2), False),
                 'three levels': (3, {}, True)}
# K1's in-scan vmax against its twin where the integration is within
# K1_TOL rather than bit-exact (the analytic modes): a sample's vmax is
# its v plus a share of the translation speed, a centred difference of
# positions two output steps apart, so it moves by the v error and a
# small share of the position errors (1e-3 deg is ~111 m)
K1_VMAX_TOL = 5e-2


def same_launch(off, on):
    """The fields in which two launches' (tracks, meta) of compact_survivors
    differ, vmax aside, and the largest vmax difference of their tracks
    (inf where their NaN masks differ)."""
    (tr_off, meta_off), (tr_on, meta_on) = off, on
    diff = [f for f in ('lon', 'lat', 'v', 'm', 'wnds', 'valid', 'month',
                        'basin_idx') if not same(tr_off[f], tr_on[f])]
    diff += [f for f in ('keep', 'scalars', 'spm_upto', 'spm_all')
             if not same(meta_off[f], meta_on[f])]
    nan_same = same(torch.isnan(tr_off['vmax']), torch.isnan(tr_on['vmax']))
    return diff, (max_err(tr_off['vmax'], tr_on['vmax']) if nan_same
                  else math.inf)


def in_scan_k1(label, key, pack, cfg, plane0, exact, vmax_tol=K2_TOL):
    """One full-width launch (_simulate_batch, k_max 64) on cfg with and
    without vmax_in_scan (the same key): the tracks and verdicts
    bit-identical and vmax within vmax_tol (same_launch); K1's in-scan
    instance against its twin on the first and last segment, on the vmax
    as K1 wrote it (the last-sample entry then fixes it in place):
    bit-exact where `exact`, else K1_ALIVE_AGREE of the storms on the
    same alive history, within K1_TOL and K1_VMAX_TOL; the last-sample
    entry, one launch over every segment, bit-exact against
    fix_in_scan_plain (each segment's fixed buffer and the banked peak).
    Returns ({field: K1's largest error}, the last-sample entry's largest
    error)."""
    from tropical_cyclone_risk_tpu_torch.models import pipeline, simulator
    off = pipeline._simulate_batch(key, pack, cfg, BASIN, N_SEEDS, 64,
                                   plane0)
    with captured(simulator, 'integrate_segment',
                  lambda out, *a, **kw: out[0][6].clone()) as k1c, \
            fix_calls() as fixes:
        on = pipeline._simulate_batch(key, pack,
                                      cfg.replace(vmax_in_scan=True), BASIN,
                                      N_SEEDS, 64, plane0)
    torch.cuda.synchronize()
    diff, t_err = same_launch(off, on)
    log(f'[in-scan] {label}: {int(on[1]["scalars"][0])} survivors, in-scan '
        f'against post-pass: not bit-identical {diff or "none"}, stitched '
        f'vmax max abs err {t_err:.3e}')
    if diff or not t_err <= vmax_tol:
        raise AssertionError(f'in-scan {label}: differs in {diff}, vmax '
                             f'{t_err}')
    res, worst = [], {}
    for args, kw, out, raw in (k1c[0], k1c[-1]):
        out = (out[0][:6] + (raw,), out[1])
        ref = uncounted(simulator.integrate_segment_plain, *args, **kw)
        same_bits, diff = k1_exact(out, ref)
        agree, err, _ = compare_k1(out, ref)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in err.items()}
        res.append((args[7], args[3].lon.shape[0], args[9], agree,
                    max(err.values()), same_bits))
        if (exact and not same_bits) or agree < K1_ALIVE_AGREE or any(
                not err[nm] <= tol for nm, tol in K1_TOL.items()) \
                or not err['vmax'] <= K1_VMAX_TOL:
            raise AssertionError(f'in-scan {label}: K1 alive agreement '
                                 f'{agree}, errors {err}, differs in {diff}')
    fix_bad = [i for i, c in enumerate(fixes) if not c[3][0]]
    fix_err = max((c[3][1] for c in fixes), default=0.0)
    log(f'[in-scan] {label}: {len(k1c)} segments; K1 with the DiagState '
        f'against its twin on the first and last (steps, storms, t_last, '
        f'alive agreement, max abs err, bit-exact) {res}; the last-sample '
        f'entry in {len(fixes)} launch(es) over '
        f'{[len(c[0][0]) for c in fixes]} segments (winds '
        f'{tuple(fixes[0][0][0][0]["wnds"].shape) if fixes else None}), '
        f'each segment\'s fixed buffer and the banked peak bit-exact '
        f'against fix_in_scan_plain: {not fix_bad}')
    if fix_bad or len(fixes) != 1:
        raise AssertionError(f'in-scan {label}: the last-sample entry '
                             f'differs in calls {fix_bad} of '
                             f'{len(fixes)} (one a launch)')
    return worst, fix_err


def check_in_scan(dev, card, pack_y, cfg_t, plane0, k1_base, levels):
    """Phase in-scan: the bench's launch with vmax_in_scan off and on
    (the same key): every segment's lon/lat/v/m/wnds/alive, the keep
    verdicts and compact_survivors' valid and stitched tracks bit-identical,
    vmax within K2_TOL of K2's post-pass on alive samples and the peaks'
    verdicts equal; counters reset just before the in-scan launch and read
    just after (K2's post-pass not launched, its last-sample entry is); K1's
    in-scan instance bit-exact against its twin on the first and last
    segment; the last-sample entry bit-exact against fix_last_sample_plain
    on every segment; then the same checks of K1 and the last-sample entry
    on a launch in each of IN_SCAN_MODES (in_scan_k1; the three-level one
    on levels, levels_setup's pack and auto-tuned namelist); the launch's
    wall time with and without, and the kernels' per-launch times.
    Returns the phase's numbers."""
    from tropical_cyclone_risk_tpu_torch import kernels, rng
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics,
                                                        pipeline, simulator)
    t_phase = time.perf_counter()
    m = pipeline.launch_width(cfg_t, N_SEEDS)
    n_basins = len(cfg_t.basin_ids_sorted())
    cfg_on = cfg_t.replace(vmax_in_scan=True)
    key = rng.key(92)
    body_off = pipeline.launch_body(key, pack_y, cfg_t, BASIN, N_SEEDS,
                                    plane0)
    tr_off, meta_off = pipeline.compact_survivors(body_off, m, 64, n_basins)
    torch.cuda.synchronize()
    kernels.reset_counts()
    # K1's vmax output as the kernel wrote it (the last-sample entry then
    # fixes it in place)
    with captured(simulator, 'integrate_segment',
                  lambda out, *a, **kw: out[0][6].clone()) as k1c, \
            fix_calls() as fixes:
        body_on = pipeline.launch_body(key, pack_y, cfg_on, BASIN, N_SEEDS,
                                       plane0)
        tr_on, meta_on = pipeline.compact_survivors(body_on, m, 64,
                                                    n_basins)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_counts('in-scan', launches, dict(kernels.PLAIN_ON_CUDA),
                 IN_SCAN_KERNELS)
    if launches['vmax'] != 0:
        raise AssertionError(f'in-scan: K2\'s post-pass launched '
                             f'{launches["vmax"]} times')
    segs_off = (body_off['tm'],) + body_off.get('tms', ())
    segs_on = (body_on['tm'],) + body_on.get('tms', ())
    diff = [(i, f) for i, (a, b) in enumerate(zip(segs_off, segs_on))
            for f in ('lon', 'lat', 'v', 'm', 'wnds', 'alive')
            if not same(a[f], b[f])]
    diff += [f for f in ('keep', 'month', 'basin_idx')
             if not same(body_off['trk'][f], body_on['trk'][f])]
    d_launch, t_err = same_launch((tr_off, meta_off), (tr_on, meta_on))
    diff += d_launch
    v_err = max(max_err(a['vmax'][a['alive']], b['vmax'][a['alive']])
                for a, b in zip(segs_off, segs_on))
    v_exact = min(float((a["vmax"] == b["vmax"])[a["alive"]].double().mean())
                  for a, b in zip(segs_off, segs_on))
    log(f'[in-scan] {len(segs_on)} segments, {int(meta_on["scalars"][0])} '
        f'survivors: not bit-identical {diff or "none"}; vmax against K2\'s '
        f'post-pass on alive samples max abs err {v_err:.3e} (bit-exact '
        f'share >= {v_exact:.6f}), stitched vmax {t_err:.3e} (inf: NaN '
        f'masks differ); kernel launches {launches}')
    if diff or not (v_err <= K2_TOL and t_err <= K2_TOL):
        raise AssertionError(f'in-scan: differs in {diff}, vmax {v_err}, '
                             f'{t_err}')
    # K1's in-scan instance against its twin on the first and last segment
    res = []
    for args, kw, out, raw in (k1c[0], k1c[-1]):
        out = (out[0][:6] + (raw,), out[1])
        ref = uncounted(simulator.integrate_segment_plain, *args, **kw)
        same_bits, d = k1_exact(out, ref)
        res.append((args[7], args[3].lon.shape[0], args[9], same_bits, d))
        if not same_bits:
            vk, vp, alive = out[0][6], ref[0][6], out[0][5]
            bad = ~((vk == vp) | (torch.isnan(vk) & torch.isnan(vp)))
            idx = bad.nonzero()[:6].tolist()
            log(f'[in-scan] K1 vmax differs from its twin on '
                f'{int(bad.sum())} samples ({int((bad & alive).sum())} '
                f'alive); max abs err alive {max_err(vk[alive], vp[alive])}'
                f', all {max_err(vk, vp)}; (row, storm, kernel, twin, lon, '
                f'lat, v, alive): ' + '; '.join(
                    f'{t} {n} {float(vk[t, n])!r} {float(vp[t, n])!r} '
                    f'{float(out[0][0][t, n])!r} {float(out[0][1][t, n])!r} '
                    f'{float(out[0][2][t, n])!r} {bool(alive[t, n])}'
                    for t, n in idx))
            raise AssertionError(f'in-scan: K1 differs from its twin in {d}')
    fix_bad = [i for i, c in enumerate(fixes) if not c[3][0]]
    fix_err = max(c[3][1] for c in fixes)
    log(f'[in-scan] K1 with the DiagState against its twin (steps, storms, '
        f't_last, bit-exact, differing) {res}; the last-sample entry in '
        f'{len(fixes)} launch over {len(fixes[0][0][0])} segments, each '
        f'segment\'s fixed buffer and the banked peak bit-exact against '
        f'fix_in_scan_plain: {not fix_bad} (max abs err {fix_err:.3e})')
    if fix_bad or len(fixes) != 1 or launches['vmax_last'] != 1:
        raise AssertionError(f'in-scan: the last-sample entry differs in '
                             f'calls {fix_bad} of {len(fixes)}, or launched '
                             f'{launches["vmax_last"]} times (one a launch)')
    # K1's other in-scan instances and the last-sample entry at W = 6
    cfg3, pack3, cfg3_t = levels
    modes = {}
    for name, (n_levels, kw_mode, exact) in IN_SCAN_MODES.items():
        pack, cfg, p0 = ((pack3, cfg3_t, cfg3.start_month - 1)
                         if n_levels == 3 else (pack_y, cfg_t, plane0))
        modes[name], f_err = in_scan_k1(name, rng.key(91), pack,
                                        cfg.replace(**kw_mode), p0, exact)
        fix_err = max(fix_err, f_err)
    # times: K1's in-scan instance per launch (every segment, the kernel
    # alone) beside the post-pass instance's from the K1 phase; the
    # last-sample entry per launch (device time, after an L2 flush and
    # warm) beside its twin; the launch's wall time with and without, in
    # turns
    k1_on = sum(cuda_ms(k1_launcher(a), K1_REPS) for a, _, _, _ in k1c)
    k1_on_bound = sum(k1_bound(a, out)[0] for a, _, out, _ in k1c)
    (f_args, f_kw, f_out, _), = fixes
    # the per-segment API (diagnostics.fix_last_sample) through the same
    # entry on one segment, the launch's last (vmax_L and ok written)
    raws, edges, a_idxs, orders, last_step, _, dt_s, cfg_f = f_args
    k, r = len(raws) - 1, raws[-1]
    one_args = (r['vmax'], r['lon'], r['lat'], r['v'], r['wnds'],
                r['alive'], last_step[a_idxs[k - 1]] - edges[k] if k
                else last_step, dt_s, cfg_f)
    one_kw = {'pos_before': torch.stack(
        [raws[k - 1]['lon'][-1][orders[k - 1]],
         raws[k - 1]['lat'][-1][orders[k - 1]]]) if k else None}
    one = diagnostics.fix_last_sample(r['vmax'].clone(), *one_args[1:],
                                      **one_kw)
    one_ref = uncounted(diagnostics.fix_last_sample_plain,
                        r['vmax'].clone(), *one_args[1:], **one_kw)
    one_exact = all(same(a, b) for a, b in zip(one, one_ref))
    log(f'[in-scan] the per-segment API on segment {k} '
        f'({tuple(r["lon"].shape)}, {int(one[2].sum())} tracks ending '
        f'there) through the same '
        f'entry: vmax, vmax_L and ok bit-exact against '
        f'fix_last_sample_plain: {one_exact}')
    if not one_exact:
        raise AssertionError('in-scan: the one-segment last-sample entry '
                             'differs from fix_last_sample_plain')
    fix_launch = fix_launcher(f_args)
    fix_ms = device_ms(clean(fix_launch), 20, ('last_sample_kernel',))
    fix_cold_ms = device_ms(cold(fix_launch), 20, ('last_sample_kernel',))
    fix_warm_ms = device_ms(fix_launch, 20, ('last_sample_kernel',))
    fix_plain = cuda_ms(lambda: uncounted(
        diagnostics.fix_in_scan_plain, [dict(r) for r in f_args[0]],
        *f_args[1:]), 5)
    fix_bound = [last_bound(f_args, f_kw, f_out)]
    wall = {False: [], True: []}
    for i in range(5):
        for flag in (False, True, True, False):
            c = cfg_on if flag else cfg_t
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipeline._simulate_batch(rng.key(200 + i), pack_y, c, BASIN,
                                     N_SEEDS, 64, plane0)
            torch.cuda.synchronize()
            wall[flag].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in wall.items()}
    log(f'[in-scan] {card}: K1 per launch, the kernel alone: in-scan '
        f'{k1_on:.4f} ms (bound {k1_on_bound:.5f} ms), post-pass instance '
        f'{k1_base:.4f} ms (K1 phase); '
        f'the last-sample entry per launch (one launch over the segments) '
        f'{fix_ms:.4f} ms device after a clean L2 flush, {fix_cold_ms:.4f} '
        f'after a write flush, {fix_warm_ms:.4f} warm (plain twin '
        f'{fix_plain:.3f} ms, bound '
        f'{sum(b for b, _ in fix_bound):.5f} ms); launch wall time, median '
        f'of 10 in turns: in-scan {med[True]:.2f} ms, post-pass '
        f'{med[False]:.2f} ms; phase {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'vmax_max_abs_err': v_err,
            'vmax_exact_share': v_exact, 'k1_ms': k1_on,
            'k1_bound_ms': k1_on_bound,
            'fix_ms': fix_ms, 'fix_cold_ms': fix_cold_ms,
            'fix_warm_ms': fix_warm_ms,
            'fix_plain_ms': fix_plain,
            'fix_bound_ms': sum(b for b, _ in fix_bound),
            'fix_bound_by': fix_bound[0][1], 'fix_max_abs_err': fix_err,
            'k1_modes_max_abs_err': modes,
            'launch_ms': med[True], 'launch_post_pass_ms': med[False]}


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_all(dev):
    """nvcc for K1 with K7 (a library per unit of
    kernels/integrator.py UNITS: two, three and four steering levels, each
    with and without the in-scan vmax, and the level sets of [levels4]: five
    with and without it, seven, fifteen and seventeen), K2, K3, K4, K5
    and K6, one
    thread each (seventeen processes at once, the field stacks' kernel
    among them); logs the wall
    time of the builds, each build's seconds, each kernel's registers,
    stack frame, spills and SASS local-memory instructions (K1's and K7's
    instances of every stack layout among them); requires K1's default
    instance to have neither a stack frame nor spills, and K1's sin and
    cos to equal CUDA's sinf and cosf.  Returns {name: kernels/build.py's
    info}."""
    from tropical_cyclone_risk_tpu_torch.kernels import cape_pi as k6
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
    from tropical_cyclone_risk_tpu_torch.kernels import stacks as kstacks
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as vmax_kernel
    builds, errors = {}, []

    def nvcc(name, fn):
        try:
            t0 = time.perf_counter()
            builds[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:        # noqa: BLE001 — raised below
            errors.append(e)

    units = [(('integrator' + (f' L{lv}' if lv != 2 else '')
                + (' diag' if diag else '')),
              lambda lv=lv, diag=diag: integrator.build(lv, diag))
             for lv, diag in integrator.UNITS]
    threads = [threading.Thread(target=nvcc, args=a)
               for a in (*units, ('vmax', vmax_kernel.build),
                         ('seeding', k3.build), ('compact', k4.build),
                         ('threefry', k5.build), ('cape_pi', k6.build),
                         ('stacks', kstacks.build))]
    t_all = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log(f'[build] {len(threads)} nvcc processes at once: '
        f'{time.perf_counter() - t_all:.1f} s of wall time')
    for name, (info, secs) in builds.items():
        sass = sass_local_memory(info['path'])
        for fn, rep in ptxas_report(info['log']).items():
            log(f'[build] {name} {fn}: {rep}; SASS local loads/stores '
                f'{sass.get(fn, "not read")}')
        if name in ('cape_pi', 'seeding'):
            for fn, (n_ins, loops) in sass_counts(info['path']).items():
                log(f'[build] {name} {fn}: {n_ins} SASS instructions, '
                    f'loops of {loops} instructions')
        log(f'[build] {name} nvcc {secs:.1f} s')
    report, clean = k1_frame(builds['integrator'][0])
    if clean is None:
        log(f'[build] K1 {K1_DEFAULT_INSTANCE}: stack frame and spills not '
            f'checked ({report})')
    elif not clean:
        raise AssertionError(f'K1 {K1_DEFAULT_INSTANCE}: {report}')
    n_trig = 0
    for lo, count in TRIG_CHECK_RANGES:
        bad, first = integrator.trig_check(lo, count, dev)
        n_trig += count
        if bad:
            raise AssertionError(f'K1 sincos_rad differs from sinf or cosf '
                                 f'on {bad} inputs, first 0x{first:08x}')
    log(f'[build] K1 sin and cos path equals CUDA\'s sinf and cosf on all '
        f'{n_trig} float32 inputs with |x| < 105615, +-inf and NaN')
    return {name: info for name, (info, _) in builds.items()}


# the K1 instance of the default path, and the float32 bit patterns on
# which its sin and cos path must equal CUDA's sinf and cosf: |x| < 105615
# of both signs, the infinities and every NaN
K1_DEFAULT_INSTANCE = 'integrate_segment_kernel<2,0,0,0,0>'
TRIG_CHECK_RANGES = ((0x00000000, 0x47ce4780), (0x80000000, 0x47ce4780),
                    (0x7f800000, 0x00800000), (0xff800000, 0x00800000))


def k1_frame(info):
    """(report, clean) of K1's default instance in the built library
    (kernels/build.py's info): clean when it has no stack frame and no
    spills, by nvcc's -Xptxas -v log, or, where the library was already
    built (an empty log), by cuobjdump -res-usage (STACK and LOCAL bytes);
    clean is None, with the reason as the report, where neither reads."""
    if info['log']:
        rep = ptxas_report(info['log']).get(K1_DEFAULT_INSTANCE)
        if rep is None:
            return 'no ptxas report', False
        return rep, (' 0 bytes stack frame' in rep
                     and ' 0 bytes spill stores' in rep)
    text = cuobjdump('-res-usage', info['path'])
    if text is None:
        return 'a cached build, and no cuobjdump to read it', None
    import re
    for name, stack, local in re.findall(
            r'Function ([\w$]+):\s+REG:\d+ STACK:(\d+) SHARED:\d+ '
            r'LOCAL:(\d+)', text):
        if kernel_label(name) == K1_DEFAULT_INSTANCE:
            return (f'cuobjdump -res-usage of a cached build: STACK {stack}, '
                    f'LOCAL {local}'), stack == local == '0'
    return 'no cuobjdump -res-usage entry', False


def kernel_label(mangled):
    """A short name for a mangled kernel name: its identifier ending in
    _kernel with its integer and bool template arguments (<0,0>), or the
    name."""
    import re
    found = re.search(r'([a-z][a-z_]*_kernel)(I(?:L[a-z]+\d+E)+E)?', mangled)
    if found is None:
        return mangled
    args = re.findall(r'L[a-z]+(\d+)E', found.group(2) or '')
    return found.group(1) + (f'<{",".join(args)}>' if args else '')


def ptxas_report(text):
    """{kernel: 'N registers, S bytes stack frame, ...'} from nvcc's
    -Xptxas -v output (empty when the library was already built)."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = kernel_label(m.group(1))
            continue
        if cur is None:
            continue
        if 'stack frame' in line:
            out[cur] = (out.get(cur, '') + ' ' + line.strip()).strip()
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out[cur] = f'{m.group(1)} registers, ' + out.get(cur, '')
    return out


def cuobjdump(flag, lib_path):
    """cuobjdump's output for one flag on a built library, or None when
    cuobjdump is not found."""
    tool = os.path.join(os.environ.get('CUDA_HOME') or '/usr/local/cuda',
                        'bin', 'cuobjdump')
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, flag, str(lib_path)], capture_output=True,
                          text=True).stdout


def sass_local_memory(lib_path):
    """{kernel: 'LDL n, STL n'} counted in cuobjdump -sass of a built
    library; empty when cuobjdump is not found."""
    import re
    text = cuobjdump('-sass', lib_path)
    if text is None:
        return {}
    out = {}
    for part in re.split(r'\n\s*Function : ', text)[1:]:
        name = kernel_label(part.split('\n', 1)[0].strip())
        out[name] = (f'LDL {len(re.findall(r"LDL", part))}, '
                     f'STL {len(re.findall(r"STL", part))}')
    return out


def pipe_of(op):
    """The pipe of a SASS opcode (PIPE_OPS), or 'other'."""
    base = op.split('.')[0]
    for pipe, ops in PIPE_OPS.items():
        if base in ops:
            return pipe
    return 'other'


def sass_pipes(lib_path):
    """{mangled kernel name: {pipe: static SASS instructions}} by
    cuobjdump -sass of a built library; empty when cuobjdump is not
    found."""
    import collections
    import re
    text = cuobjdump('-sass', lib_path)
    if text is None:
        return {}
    out = {}
    for part in re.split(r'\n\s*Function : ', text)[1:]:
        name = part.split('\n', 1)[0].strip()
        out[name] = dict(collections.Counter(
            pipe_of(m.group(1)) for m in re.finditer(
                r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)',
                part)))
    return out


def sass_counts(lib_path):
    """{kernel: (SASS instructions, [instructions in each loop])} of a
    built library by cuobjdump -sass: a loop is the span from a backward
    branch's target to the branch (static counts; a loop nested in another
    is counted in both).  Empty when cuobjdump is not found."""
    import re
    text = cuobjdump('-sass', lib_path)
    if text is None:
        return {}
    out = {}
    for part in re.split(r'\n\s*Function : ', text)[1:]:
        name = kernel_label(part.split('\n', 1)[0].strip())
        addrs, loops = [], []
        for line in part.splitlines():
            m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(.*)', line)
            if not m:
                continue
            at = int(m.group(1), 16)
            addrs.append(at)
            b = re.search(r'\bBRA\b[^;]*?0x([0-9a-f]+)', m.group(2))
            if b and int(b.group(1), 16) < at:
                loops.append((at - int(b.group(1), 16)) // 16 + 1)
        out[name] = (len(addrs), sorted(loops))
    return out


def main():
    """The phases of the module's docstring; exits non-zero on a failure."""
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this script measures '
                         'the GPU path and has no CPU fallback')
    from tropical_cyclone_risk_tpu_torch import cli, kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.config import (Namelist,
                                                        load_namelist_py)
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as vmax_kernel
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
    libs = build_all(dev)
    clock = sm_clock_hz()

    # ---- 3. K1, K2 and K7 against their plain twins ----------------------
    # one full launch at the slice's shapes, with the kernel dispatchers
    # wrapped so that every segment's K1 call, every K2 call (with its
    # boundary rows) and the K7 call are repeated through the plain twin on
    # the same inputs
    t0 = time.perf_counter()
    cfg, pack24, pack_y, cfg_t = launch_setup(dev)
    torch.cuda.synchronize()
    log(f'[K1] pack and auto-tune {time.perf_counter() - t0:.2f} s: '
        f'integrate_cap {cfg_t.integrate_cap} schedule '
        f'{cfg_t.recompact_schedule}')
    key = rng.key(0)
    with captured(simulator, 'integrate_segment',
                  lambda out, *a: compare_k1(
                      out, simulator.integrate_segment_plain(*a))
                  ) as k1_calls, \
            captured(diagnostics, 'axi_to_max_wind_raw',
                     lambda out, *a, **kw: compare_k2(
                         out, diagnostics.axi_to_max_wind_raw_plain(*a, **kw),
                         a[5])) as k2_calls, \
            captured(simulator, 'genesis_alive', check_k7) as k7_calls:
        pipeline.launch_body(rng.fold_in(key, 1), pack_y, cfg_t, BASIN,
                             N_SEEDS, cfg.start_month - 1)
    torch.cuda.synchronize()

    agree = min(c[0] for *_, c in k1_calls)
    k1_err = {nm: max(c[1][nm] for *_, c in k1_calls) for nm in K1_TOL}
    exact = min(c[2] for *_, c in k1_calls)
    args0 = k1_calls[0][0]
    n1, m = args0[7], args0[3].lon.shape[0]
    log(f'[K1] {len(k1_calls)} segments, steps '
        f'{[c[0][7] for c in k1_calls]}, widths '
        f'{[c[0][3].lon.shape[0] for c in k1_calls]}: storms with '
        f'identical alive history >= {agree:.6f}; bit-exact lon samples >= '
        f'{exact:.6f}; max abs err {k1_err}')
    if agree < K1_ALIVE_AGREE:
        raise AssertionError(f'K1 alive agreement {agree}')
    for nm, tol in K1_TOL.items():
        if not k1_err[nm] <= tol:
            raise AssertionError(f'K1 {nm} err {k1_err[nm]} > {tol}')
    # the kernel alone on every segment, beside its bound and its twin
    k1_segs = []
    for s, (args, _, out, _) in enumerate(k1_calls):
        ms = cuda_ms(k1_launcher(args), K1_REPS)
        plain = cuda_ms(lambda: simulator.integrate_segment_plain(*args), 1)
        b, by = k1_bound(args, out)
        seg = {'steps': args[7], 'width': args[3].lon.shape[0], 'ms': ms,
               'us_per_step': 1e3 * ms / args[7], 'bound_ms': b,
               'bound_by': by, 'plain_ms': plain}
        k1_segs.append(seg)
        log(f'[K1] {card}: segment {s}, {seg["steps"]} steps x '
            f'{seg["width"]} storms: kernel {ms:.4f} ms '
            f'({seg["us_per_step"]:.2f} us per step), bound {b:.5f} ms '
            f'({by}), plain twin {plain:.1f} ms')
    ms_k1, ms_k1_plain, k1_bound_ms = (
        sum(sg[k] for sg in k1_segs) for k in ('ms', 'plain_ms', 'bound_ms'))
    k1_by = max(k1_segs, key=lambda sg: sg['bound_ms'])['bound_by']
    ms_k1_call = cuda_ms(lambda: simulator.integrate_segment(*args0),
                         K1_REPS)
    log(f'[K1] {card}: per launch ({len(k1_segs)} segments, '
        f'{sum(sg["steps"] for sg in k1_segs)} steps): kernel '
        f'{ms_k1:.4f} ms, bound {k1_bound_ms:.5f} ms '
        f'({100 * k1_bound_ms / ms_k1:.1f}% of it), plain twin '
        f'{ms_k1_plain:.1f} ms; segment 0 through the dispatcher '
        f'{ms_k1_call:.4f} ms')

    k2_err = max(c[0] for *_, c in k2_calls)
    log(f'[K2] {len(k2_calls)} segments, [T, N] '
        f'{[tuple(c[0][0].shape) for c in k2_calls]}: max abs err '
        f'{k2_err:.3e} (per segment '
        f'{[float(f"{c[3][0]:.3e}") for c in k2_calls]}); finite peaks '
        f'identical {all(c[3][1] for c in k2_calls)}')
    if not (k2_err <= K2_TOL and all(c[3][1] for c in k2_calls)):
        raise AssertionError(f'K2 max abs err {k2_err} > {K2_TOL}')
    # the kernel alone on every segment (device time under torch.profiler,
    # and CUDA-event time), beside its bound and its twin
    k2_segs = []
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for s, (args, kw, out, _) in enumerate(k2_calls):
        launch = k2_launcher(args, kw)
        T_k, N_k = args[0].shape
        b, by = k2_bound(args, kw, out)
        seg = {'steps': T_k, 'width': N_k,
               'geometry': vmax_kernel.launch_geometry(T_k, N_k, n_sm),
               'ms': device_ms(launch, K2_REPS, ('vmax_kernel',)),
               'event_ms': cuda_ms(launch, K2_REPS),
               'plain_ms': cuda_ms(lambda: diagnostics.
                                   axi_to_max_wind_raw_plain(*args, **kw), 3),
               'bound_ms': b, 'bound_by': by}
        k2_segs.append(seg)
        log(f'[K2] {card}: segment {s}, [{T_k}, {N_k}] (threads, storm '
            f'blocks, rows per chunk, chunks {seg["geometry"]}): kernel '
            f'{seg["ms"]:.4f} ms device ({seg["event_ms"]:.4f} ms event), '
            f'bound {b:.5f} ms ({by}, {100 * b / seg["ms"]:.0f}% of it), '
            f'plain twin {seg["plain_ms"]:.3f} ms')
    ms_k2, ms_k2_plain, k2_bound_ms = (
        sum(sg[k] for sg in k2_segs) for k in ('ms', 'plain_ms', 'bound_ms'))
    k2_by = max(k2_segs, key=lambda sg: sg['bound_ms'])['bound_by']
    v_args, v_kw, _, _ = k2_calls[0]
    ms_k2_call = cuda_ms(
        lambda: diagnostics.axi_to_max_wind_raw(*v_args, **v_kw), K2_REPS)
    log(f'[K2] {card}: per launch ({len(k2_segs)} segments): kernel '
        f'{ms_k2:.4f} ms device, bound {k2_bound_ms:.5f} ms '
        f'({100 * k2_bound_ms / ms_k2:.1f}% of it), plain twin '
        f'{ms_k2_plain:.3f} ms; segment 0 through the dispatcher '
        f'{ms_k2_call:.4f} ms')

    k7_results('K7', k7_calls)
    g_args, _, g_out, _ = k7_calls[0]
    launch7 = integrator.gate_launcher(*g_args)[0]
    # after a clean L2 flush (the bound counts the rows from HBM), after
    # a write flush, and warm
    ms_k7 = device_ms(clean(launch7), 20, ('genesis_gate_kernel',))
    ms_k7_cold = device_ms(cold(launch7), 20, ('genesis_gate_kernel',))
    ms_k7_warm = device_ms(launch7, 20, ('genesis_gate_kernel',))
    ms_k7_event = cuda_ms(launch7, 20)
    ms_k7_call = cuda_ms(lambda: simulator.genesis_alive(*g_args), 20)
    ms_k7_plain = cuda_ms(lambda: simulator.genesis_alive_plain(*g_args), 5)
    k7_bound_ms, k7_by = k7_bound(g_args, g_out)
    log(f'[K7] {card}: genesis gate over {g_out.shape[0]} seeds: kernel '
        f'{ms_k7:.4f} ms device after a clean L2 flush, {ms_k7_cold:.4f} '
        f'after a write flush, {ms_k7_warm:.4f} ms warm ({ms_k7_event:.4f} '
        f'ms event, warm, '
        f'{ms_k7_call:.4f} ms through the dispatcher), plain twin '
        f'{ms_k7_plain:.3f} ms, bound {k7_bound_ms:.5f} ms ({k7_by})')
    del k1_calls, k2_calls, k7_calls, args0, v_args, v_kw, g_args, g_out

    # ---- 4. K3 and K5 against their plain twins --------------------------
    k35 = check_k3_k5(pack_y, cfg_t, card)
    plane0 = cfg.start_month - 1

    # ---- K4 against its plain twins on a launch's compactions ------------
    k4_entry = check_k4(rng.key(99), pack_y, cfg_t, plane0, card)

    # ---- modes: K1 under the integration modes ----------------------------
    modes_err, modes_ms = check_modes(rng.key(97), pack_y, cfg_t, plane0,
                                      card)

    # ---- geo: K1 and K7 with land and bathymetry on their own grids ------
    geo = check_geo(rng.key(96), pack_y, cfg_t, plane0, card)

    # ---- fixed: K1, K7 and K2 with debug_fixed_position ------------------
    fixed_err = check_fixed(rng.key(95), pack_y, cfg_t, plane0, card)

    # ---- BAM: the uncoupled beta-advection model, card against CPU -------
    bam_res = check_bam(pack_y, cfg, card)

    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        # ---- 5. workspace -------------------------------------------------
        t0 = time.perf_counter()
        ws = f'{tmp}/ws'
        nl = synthetic_era5.make_workspace(ws, WS_YEAR, WS_YEAR, nlat=181,
                                           nlon=360, seed_batch=N_SEEDS)
        log(f'[workspace] {ws}: one year, 181 x 360, '
            f'{synthetic_era5.LEVELS_HPA.size} levels, twice-daily winds, '
            f'written in {time.perf_counter() - t0:.1f} s')

        # ---- 6. K6 against its plain twin ---------------------------------
        # gen_thermo into a side directory with cape_pi captured, so K6
        # sees exactly the main path's inputs
        cfg_ws = load_namelist_py(nl)
        with captured(pi_ops, 'cape_pi') as k6_calls:
            thermo_driver.gen_thermo(
                cfg_ws.replace(output_directory=f'{tmp}/k6'), device=dev)
        torch.cuda.synchronize()
        (k6_args, k6_kw, k6_out, _), = k6_calls
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
        if not (k6_err == 0.0 and k6_exact == 1.0):
            raise AssertionError(f'K6 not bit-exact against its twin: share '
                                 f'{k6_exact}, max abs err {k6_err}')
        ms_k6_device = device_ms(lambda: pi_ops.cape_pi(*k6_args, **k6_kw),
                                 20, ('cape_pi_kernel',))
        ms_k6 = cuda_ms(lambda: pi_ops.cape_pi(*k6_args, **k6_kw), 20)
        ms_k6_plain = cuda_ms(
            lambda: pi_ops.cape_pi_plain(*k6_args, **k6_kw), 2)
        k6_bound_ms, k6_by = k6_bound(k6_args, k6_out)
        log(f'[K6] {card}: kernel {ms_k6_device:.4f} ms device, '
            f'{ms_k6:.4f} ms event through cape_pi, plain twin '
            f'{ms_k6_plain:.3f} ms, bound {k6_bound_ms:.4f} ms ({k6_by})')
        del k6_out, k6_ref

        # ---- 6b. K6's other instances on the same inputs ----------------
        k6_modes = check_k6_modes(k6_args, k6_kw, card,
                                  libs['cape_pi']['path'], clock)
        del k6_calls, k6_args

        # ---- 7. slice 1: run_downscaling on the synthetic pack ------------
        cfg_run = cfg.replace(output_directory=f'{tmp}/slice1',
                              exp_name='smoke')
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with captured(simulator, 'genesis_alive', check_k7,
                      keep=False) as k7_runs:
            fn = runtime.run_downscaling(cfg_run, BASIN, pack24, seed=0,
                                         device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        log(f'[slice 1] run_downscaling 2 years in {t_run:.2f} s (with K7 '
            f'checked on every launch)')
        check_counts('slice 1', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
        k7_results('slice 1', k7_runs)
        ds = netcdf.read(fn)
        n_trk, peaks = check_tracks(ds, cfg)
        if n_trk != 2 * cfg.tracks_per_year:
            raise AssertionError(f'{n_trk} tracks != 2 x '
                                 f'{cfg.tracks_per_year}')
        spm = ds.variables['seeds_per_month'].data
        log(f'[slice 1] {n_trk} tracks, peak v {peaks.min():.1f}..'
            f'{peaks.max():.1f} m/s, seeds per month sum {spm.sum():.0f}')
        check_small_launch(dev, Namelist, fields, pipeline, rng)

        # ---- 8. m_init_mode='dvdt0' ---------------------------------------
        cfg_dv = cfg.replace(output_directory=f'{tmp}/dvdt0', exp_name='dv',
                             end_year=cfg.start_year, m_init_mode='dvdt0')
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with captured(simulator, 'genesis_alive', check_k7,
                      keep=False) as k7_runs:
            fn_dv = runtime.run_downscaling(cfg_dv, BASIN, pack24, seed=2,
                                            device=dev)
        torch.cuda.synchronize()
        t_dv = time.perf_counter() - t0
        check_counts('dvdt0', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
        k7_results('dvdt0', k7_runs)
        ds_dv = netcdf.read(fn_dv)
        n_dv, peaks_dv = check_tracks(ds_dv, cfg_dv)
        m0 = ds_dv.variables['m_trks'].data[:, 0]
        log(f'[dvdt0] run_downscaling one year in {t_dv:.2f} s: {n_dv} '
            f'tracks, peak v {peaks_dv.min():.1f}..{peaks_dv.max():.1f} m/s, '
            f'genesis m {m0.min():.4f}..{m0.max():.4f}')
        if not (n_dv == cfg.tracks_per_year and np.all((m0 >= 0) & (m0 <= 1))):
            raise AssertionError(f'dvdt0: {n_dv} tracks, genesis m {m0}')
        cfg_md = cfg.replace(output_directory=f'{tmp}/modes', exp_name='md',
                             end_year=cfg.start_year, time_interp_fields=True,
                             rk_substeps=2)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with captured(simulator, 'genesis_alive', check_k7,
                      keep=False) as k7_runs:
            fn_md = runtime.run_downscaling(cfg_md, BASIN, pack24, seed=3,
                                            device=dev)
        torch.cuda.synchronize()
        t_md = time.perf_counter() - t0
        check_counts('modes', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
        k7_results('modes run', k7_runs)
        n_md, peaks_md = check_tracks(netcdf.read(fn_md), cfg_md)
        log(f'[modes] run_downscaling one year with time_interp_fields and '
            f'rk_substeps=2 in {t_md:.2f} s: {n_md} tracks, peak v '
            f'{peaks_md.min():.1f}..{peaks_md.max():.1f} m/s')
        if n_md != cfg.tracks_per_year:
            raise AssertionError(f'modes: {n_md} tracks')

        # ---- 8b. years: the production year drivers -----------------------
        n_sync, sync_where = check_years(dev, cfg_t, pack_y, plane0, tmp,
                                         card)

        # ---- 9. slice 2: the workspace path through the CLI ---------------
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with stage_times() as stage_s:
            cli.main(['GL', '--namelist', nl, '--seed', '0'])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        log(f'[slice 2] {card}: cli.main GL one year in {t_cli:.2f} s; '
            f'stages (s) {json.dumps({k: round(v, 3) for k, v in stage_s.items()})}'
            f' (winds and thermo overlap)')
        check_counts('slice 2', launches, dict(kernels.PLAIN_ON_CUDA),
                     WORKSPACE_KERNELS)
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
        kernels.reset_counts()
        cli.main(['GL', '--namelist', nl, '--seed', '1', '--trace-dir',
                  f'{tmp}/trace'])
        busy, span, n_kern = trace_busy(f'{tmp}/trace/trace.json')
        n_prop = kernels.LAUNCHES['seeding']
        log(f'[slice 2] {card}: --trace-dir run {time.perf_counter() - t0:.2f}'
            f' s; simulation trace (auto-tune probes and the year\'s '
            f'launches, {n_prop} K3 launches): {n_kern} device kernels, busy '
            f'{busy / 1e3:.2f} ms of {span / 1e3:.2f} ms traced '
            f'({busy / span:.3f} busy share)')

        # ---- 9b. the workspace path with land on 0.5 degrees and
        # bathymetry on 0.25 degrees (the separate stack layout) ----------
        t0 = time.perf_counter()
        nl_geo = synthetic_era5.make_workspace(
            f'{tmp}/ws_geo', WS_YEAR, WS_YEAR, nlat=181, nlon=360,
            seed_batch=N_SEEDS, land_res=0.5, bathy_res=0.25)
        cfg_geo = load_namelist_py(nl_geo)
        t_write = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with captured(pack_builder, 'build_field_pack') as built, \
                captured(simulator, 'genesis_alive', check_k7,
                         keep=False) as k7_runs:
            cli.main(['GL', '--namelist', nl_geo, '--seed', '0'])
        torch.cuda.synchronize()
        t_cli_geo = time.perf_counter() - t0
        check_counts('geo workspace', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), WORKSPACE_KERNELS)
        k7_results('geo workspace', k7_runs)
        (_, _, pack_geo, _), = built
        stacks_geo = fields.build_stacks(pack_geo)
        grids = [(g.nlat, g.nlon) for g in (pack_geo.grid, pack_geo.land_grid,
                                            pack_geo.bathy_grid)]
        if (integrator.geo_layout(stacks_geo) != integrator.SEPARATE_GEO
                or grids != [(181, 360), (361, 720), (721, 1440)]):
            raise AssertionError(f'geo workspace: grids {grids}, layout '
                                 f'{integrator.geo_layout(stacks_geo)}')
        check_thermo_file(thermo_driver.get_fn_thermo(cfg_geo), netcdf,
                          synthetic_era5)
        n_geo, peaks_geo = check_tracks(
            netcdf.read(runtime.get_fn_tracks(cfg_geo, BASIN)), cfg_geo)
        if n_geo != cfg_geo.tracks_per_year:
            raise AssertionError(f'{n_geo} tracks != '
                                 f'{cfg_geo.tracks_per_year}')
        log(f'[geo workspace] {card}: cli.main GL one year with the wind '
            f'grid, land and bathymetry on {grids} (written in {t_write:.1f}'
            f' s) in {t_cli_geo:.2f} s: {n_geo} tracks, peak v '
            f'{peaks_geo.min():.1f}..{peaks_geo.max():.1f} m/s; kernel '
            f'launches {dict(kernels.LAUNCHES)}')
        del built, pack_geo, stacks_geo

        # ---- 9c. the workspace path with select_thermo=2 (the reversible
        # branch, K6 on the 3-D table) -----------------------------------
        nl_t2 = f'{tmp}/namelist_thermo2.py'
        with open(nl) as f:
            text = f.read().replace(repr(f'{ws}/out'),
                                    repr(f'{tmp}/out_thermo2'))
        with open(nl_t2, 'w') as f:
            f.write(text + 'select_thermo = 2\n')
        os.makedirs(f'{tmp}/out_thermo2')
        cfg_t2 = load_namelist_py(nl_t2)
        if cfg_t2.select_thermo != 2 or \
                cfg_t2.output_directory != f'{tmp}/out_thermo2':
            raise AssertionError(f'thermo2 namelist: {cfg_t2}')
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with stage_times() as stage_t2, \
                captured(pi_ops, 'cape_pi', keep=False,
                         check=lambda out, *a, **kw: (
                             type(a[5]).__name__, kw.get('select_thermo'),
                             kw.get('select_interp'))) as t2_calls:
            cli.main(['GL', '--namelist', nl_t2, '--seed', '0'])
        torch.cuda.synchronize()
        t_cli_t2 = time.perf_counter() - t0
        check_counts('thermo2', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), WORKSPACE_KERNELS)
        modes_t2 = sorted({c[3] for c in t2_calls})
        if modes_t2 != [('EntropyTable3', 2, 2)]:
            raise AssertionError(f'thermo2: cape_pi called as {modes_t2}')
        check_thermo_file(thermo_driver.get_fn_thermo(cfg_t2), netcdf,
                          synthetic_era5, 'thermo2')
        n_t2, peaks_t2 = check_tracks(
            netcdf.read(runtime.get_fn_tracks(cfg_t2, BASIN)), cfg_t2)
        if n_t2 != cfg_t2.tracks_per_year:
            raise AssertionError(f'{n_t2} tracks != '
                                 f'{cfg_t2.tracks_per_year}')
        log(f'[thermo2] {card}: cli.main GL one year with select_thermo=2 '
            f'(cape_pi as {modes_t2} in {len(t2_calls)} calls) in '
            f'{t_cli_t2:.2f} s; stages (s) '
            f'{json.dumps({k: round(v, 3) for k, v in stage_t2.items()})}; '
            f'{n_t2} tracks, peak v {peaks_t2.min():.1f}..'
            f'{peaks_t2.max():.1f} m/s')

        # ---- 9d. in-scan: the vmax computed in K1, against the post-pass --
        levels_in = levels_setup(dev)
        in_scan = check_in_scan(dev, card, pack_y, cfg_t, plane0, ms_k1,
                                levels_in)

        # ---- 9e. levels: three steering levels through every kernel ------
        levels = check_levels(dev, card, tmp, libs, pack_y, cfg_t,
                              levels_in)
        del levels_in

        # ---- 9e2. levels4: four to fifteen steering levels through every
        # kernel -----------------------------------------------------------
        level_sets = check_levels4(dev, card, libs, tmp, levels['ms'])

        # ---- 9e3. gcm: the CMIP6 workspace path --------------------------
        gcm = check_gcm(dev, tmp, card)

        # ---- 9f. mesh: seed-axis sharding on the card ---------------------
        mesh_res, mesh_launches = check_mesh(dev, card, tmp, cfg_t, pack24,
                                             pack_y, plane0)

        # ---- 10. times ----------------------------------------------------
        per_launch, share, traced_ms, stage_ms, top = profile_launches(
            lambda: pipeline._simulate_batch(rng.key(98), pack_y, cfg_t,
                                             BASIN, N_SEEDS, 64, plane0),
            3, f'{tmp}/launches.json')
        log(f'[times] {card}: torch.profiler over 3 launches: '
            f'{per_launch:.0f} device kernels per launch, busy share '
            f'{share:.3f}, {traced_ms:.2f} ms traced per launch (the '
            f'profiler slows the host); by stage, ms per launch on the host '
            f'and device span: ' + '; '.join(
                f'{nm} {h:.3f} / {d:.3f}' for nm, (h, d) in stage_ms.items()))
        log('[times] device ms per launch by operator: ' + '; '.join(
            f'{nm} {ms:.4f} ({calls:.0f}x)' for ms, nm, calls in top))
        g_host, g_span = stage_ms.get('genesis_alive', (None, None))
        log(f'[times] {card}: the genesis_alive stage (K7): {g_host:.3f} ms '
            f'on the host and {g_span:.3f} ms device span per launch, under '
            f'the profiler; {per_launch:.0f} device kernels per launch')

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

    # ---- 11. bench: the port's bench entry point --------------------------
    del pack24
    bench_line, bench_launches, bench_peak, drivers = run_bench(card)

    for k in k35 + [k4_entry]:
        k['launches'] = launches[k['name']]
    src = 'tropical_cyclone_risk_tpu_torch/'
    entries = [
        {'name': 'integrator', 'route': 'cuda',
         'source': src + 'csrc/integrator.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/simulator.py:111',
         'launches': launches['integrator'],
         'max_abs_err': max(k1_err.values()), 'ms': ms_k1,
         'plain_ms': ms_k1_plain, 'bound_ms': k1_bound_ms,
         'bound_by': k1_by, 'library_ms': None,
         'per': 'launch (every segment, the kernel alone)',
         'segment0_dispatch_ms': ms_k1_call, 'segments': k1_segs,
         'modes_max_abs_err': modes_err, 'modes_ms': modes_ms,
         'geo': geo, 'fixed_max_abs_err': fixed_err,
         'levels3': levels, 'in_scan': {k: v for k, v in in_scan.items()
                                        if not k.startswith('fix')}},
        {'name': 'vmax', 'route': 'cuda', 'source': src + 'csrc/vmax.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/diagnostics.py:193',
         'launches': launches['vmax'], 'max_abs_err': k2_err, 'ms': ms_k2,
         'plain_ms': ms_k2_plain, 'bound_ms': k2_bound_ms,
         'bound_by': k2_by, 'library_ms': None,
         'per': 'launch (every segment, the kernel alone, device time)',
         'segment0_dispatch_ms': ms_k2_call, 'segments': k2_segs},
        *k35, k4_entry,
        {'name': 'cape_pi', 'route': 'cuda',
         'source': src + 'csrc/cape_pi.cu',
         'replaces': 'tropical_cyclone_risk_tpu/ops/pi.py:92',
         'launches': launches['cape_pi'], 'max_abs_err': k6_err,
         'ms': ms_k6_device, 'plain_ms': ms_k6_plain,
         'bound_ms': k6_bound_ms, 'bound_by': k6_by, 'library_ms': None,
         'per': '12 months (the kernel alone, device time)',
         'event_ms': ms_k6,
         'instance': 'cape_pi_kernel<1,0> (select_thermo=1, 2-D table)',
         'instances': k6_modes,
         'thermo2_cli_thermo_s': stage_t2['thermo']},
        {'name': 'vmax_last', 'route': 'cuda',
         'source': src + 'csrc/vmax.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/diagnostics.py:148',
         'launches': in_scan['launches']['vmax_last'],
         'max_abs_err': in_scan['fix_max_abs_err'], 'ms': in_scan['fix_ms'],
         'plain_ms': in_scan['fix_plain_ms'],
         'bound_ms': in_scan['fix_bound_ms'],
         'bound_by': in_scan['fix_bound_by'], 'library_ms': None,
         'cold_ms': in_scan['fix_cold_ms'],
         'warm_ms': in_scan['fix_warm_ms'],
         'per': 'in-scan launch (one launch over every segment, the kernel '
                'alone, device time after a clean L2 flush; cold_ms after a '
                'write flush, warm_ms without); launches from the in-scan '
                'phase\'s launch'},
        {'name': 'genesis', 'route': 'cuda',
         'source': src + 'csrc/integrator.cu',
         'replaces': 'tropical_cyclone_risk_tpu/models/simulator.py:295',
         'launches': launches['genesis'], 'max_abs_err': 0.0, 'ms': ms_k7,
         'plain_ms': ms_k7_plain, 'bound_ms': k7_bound_ms,
         'bound_by': k7_by, 'library_ms': None,
         'per': 'one launch\'s gate (the kernel alone, device time after '
                'a clean L2 flush; cold_ms after a write flush, warm_ms '
                'without)',
         'cold_ms': ms_k7_cold, 'warm_ms': ms_k7_warm,
         'event_ms': ms_k7_event,
         'dispatch_ms': ms_k7_call,
         'stage_host_ms': g_host, 'stage_device_span_ms': g_span,
         'device_kernels_per_launch': per_launch}]
    for k in entries:
        k['bench_launches'] = bench_launches[k['name']]
        k['mesh_launches'] = mesh_launches[k['name']]
        k['ms_timing'] = ms_timing(k['name'])
    k4_entry['mesh'] = mesh_res
    by_name = {k['name']: k for k in entries}
    by_name['cape_pi']['gcm'] = gcm['k6']
    # the instances of each level set of [levels4]: launches are the
    # instance's own in the set's launch, counter_launches its counter's
    # total there (and in [gcm]'s four-level run); max_abs_err the launch's
    # against the twins (every leaf compared)
    gcm4 = gcm['four levels']['launches']
    for label, name, key, counter, call, source, replaces, inst in \
            level_entries():
        got = level_sets[label]
        t = got['ms']
        entries.append({
            'name': name, 'route': 'cuda', 'source': src + 'csrc/' + source,
            'replaces': 'tropical_cyclone_risk_tpu/' + replaces,
            'launches': got['calls'][call],
            'max_abs_err': got['max_abs_err'], 'ms': t[key],
            'plain_ms': t[key + '_plain' if key != 'K1'
                          else 'K1_plain_segment0'],
            'bound_ms': t[key + '_bound'],
            'bound_by': t[key + '_bound_by'], 'library_ms': None,
            'instance': inst, 'ms_range': t[key + '_range'],
            'per': f'the {len(got["levels"])}-level bench-width launch of '
                   f'[{label}] (the kernel alone, median of {TIME_ROUNDS} '
                   f'rounds' + ('; plain_ms on segment 0)' if key == 'K1'
                               else ')'),
            'counter': counter, 'counter_launches': got['launches'][counter],
            'ms_timing': ms_timing(counter)})
        if label == 'levels4':
            entries[-1]['gcm_counter_launches'] = gcm4[counter]
        if key == 'K1':
            entries[-1].update(
                ptxas=got['ptxas'], nvcc_s=got['nvcc_s'],
                twin_launch_ms=got['k1_twin_ms'],
                twin_segments=got['k1_twin_segments'],
                peak_mib=got['peak_mib'], pd_share=got['pd_share'],
                **{k: got[g] for k, g in (
                    ('modes_max_abs_err', 'k1_modes_max_abs_err'),
                    ('in_scan_max_abs_err', 'in_scan_max_abs_err'),
                    ('instances', 'instances'),
                    ('instances_s', 'instances_s'),
                    ('cli_s', 'cli_s')) if g in got})
    log(f'[summary] {card}: host synchronisations per launch {n_sync}; '
        f'BAM {json.dumps(bam_res)}; '
        f'bench peak {bench_peak:.2f} MiB; bench sim-years/min '
        f'{bench_line["detail"]["sim_years_per_min"]}; s per sim-year by '
        f'driver, each pass from nothing issued: '
        f'{ {k: v["s_per_year"] for k, v in drivers.items()} }')
    print(json.dumps({'kernels': entries}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


@contextlib.contextmanager
def stage_times():
    """Within the block, the workspace path's stages (wind statistics,
    thermo, pack build, simulation) are timed, each to a synchronised end;
    yields {stage: seconds}."""
    from tropical_cyclone_risk_tpu_torch import runtime
    from tropical_cyclone_risk_tpu_torch.models import pack_builder
    from tropical_cyclone_risk_tpu_torch.preprocess import (thermo_driver,
                                                            winds)
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
    try:
        yield stage_s
    finally:
        for (mod, nm, _), orig in zip(timed, originals):
            setattr(mod, nm, orig)


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


def check_thermo_file(fn, netcdf, synthetic_era5, label='slice 2'):
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
    log(f'[{label}] thermo file {vmax.shape}: ocean share '
        f'{ocean.mean():.3f}, warm-pool PI max {warm.max():.2f} m/s, chi '
        f'{np.nanmin(chi[ocean]):.3f}..{np.nanmax(chi[ocean]):.3f}, rh_mid '
        f'{np.nanmin(rh[ocean]):.3f}..{np.nanmax(rh[ocean]):.3f}')
    if not warm.max() > 40.0:
        raise AssertionError('no PI above 40 m/s in the warm pool')


def check_small_launch(dev, Namelist, fields, pipeline, rng):
    """A small launch on the card (K1, K2, K3, K5) against the same launch
    through the plain twins on the CPU (themselves held against the JAX
    package by the CPU tests): rounding-level differences may flip a borderline verdict, so
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


def same_years(ref, got):
    """Every YearTracks field of two lists of years equal bit for bit
    (NaN where NaN, the same dtype)."""
    keys = ('lon', 'lat', 'v', 'm', 'vmax', 'wnds', 'month', 'basin_idx',
            'n_seeds')
    return len(ref) == len(got) and all(
        getattr(r, k).dtype == getattr(f, k).dtype
        and np.array_equal(getattr(r, k), getattr(f, k),
                           equal_nan=getattr(r, k).dtype.kind == 'f')
        for r, f in zip(ref, got) for k in keys) and all(
        (r.n_dropped, r.n_proposed) == (f.n_dropped, f.n_proposed)
        for r, f in zip(ref, got))


def host_syncs(fn):
    """(count, {source: count}) of the synchronizing CUDA operations fn()
    makes, as torch.cuda.set_sync_debug_mode('warn') reports them while
    fn() runs (switching the mode off reports one of its own); a
    source is the innermost line of the port on the stack (file:line
    function), or the innermost line when no line of the port is on it."""
    import collections
    import traceback
    import warnings
    where = collections.Counter()
    inside = [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or 'synchroniz' not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith('warnings.py')]
        port = [f for f in stack
                if 'tropical_cyclone_risk_tpu_torch' in f.filename]
        f = (port or stack)[-1]
        where[f'{f.filename.split("tropical_cyclone_risk_tpu_torch/")[-1]}'
              f':{f.lineno} {f.name}'] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode('warn')
        inside[0] = True
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
    return sum(where.values()), dict(where)


MESH_SHARDS = 4      # the [mesh] phase's virtual shards on the one card
MESH_K_MAX = 4096    # holds every survivor of a bench-width launch


@contextlib.contextmanager
def twins_on_card(keep=()):
    """Within the block, every kernel dispatcher of a launch runs its plain
    twin, on the card, but those named in `keep` (simulator's
    'integrate_segment': K1 stays the kernel), and the launch and twin
    counters are left as they were: a launch through the twins only to
    compare the kernels' with."""
    from tropical_cyclone_risk_tpu_torch import kernels
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics, fields,
                                                        seeding, simulator)
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    swaps = [(seeding, 'propose_seeds'), (fourier, 'draw_fourier'),
             (fields, 'build_stacks'),
             (simulator, 'genesis_alive'), (simulator, 'integrate_segment'),
             (diagnostics, 'axi_to_max_wind_raw'),
             (diagnostics, 'fix_in_scan'),
             (compact_ops, 'partition_take'),
             (compact_ops, 'stitch_survivors')]
    swaps = [(mod, nm) for mod, nm in swaps if nm not in keep]
    originals = [getattr(mod, nm) for mod, nm in swaps]
    saved = dict(kernels.LAUNCHES), dict(kernels.PLAIN_ON_CUDA)
    for mod, nm in swaps:
        setattr(mod, nm, getattr(mod, nm + '_plain'))
    try:
        yield
    finally:
        for (mod, nm), fn in zip(swaps, originals):
            setattr(mod, nm, fn)
        kernels.LAUNCHES.update(saved[0])
        kernels.PLAIN_ON_CUDA.update(saved[1])


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def wall_ms(fn, reps=5):
    """Median wall milliseconds of fn() to a synchronised end, after a
    warm call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def files_differ(fn_a, fn_b):
    """The variables of two tracks files that differ (NaN equal to NaN)."""
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    a, b = netcdf.read(fn_a), netcdf.read(fn_b)
    return sorted(set(a.variables) ^ set(b.variables)) + [
        k for k, v in a.variables.items() if k in b.variables
        and not (v.data.dtype == b.variables[k].data.dtype and np.array_equal(
            v.data, b.variables[k].data, equal_nan=v.data.dtype.kind == 'f'))]


def check_mesh(dev, card, tmp, cfg_t, pack24, pack_y, plane0):
    """Phase 'mesh': seed-axis sharding on the card, MESH_SHARDS virtual
    shards on one card at the bench launch's full width.  The sharded
    launch through the kernels, counters reset just before and read just
    after, with K4's partitions and stitch and K7 held against their twins
    call by call, against the same launch through the twins on the card:
    keep, the scalars, the seed tables and valid bit for bit, the tracks
    within K1_TOL (vmax K2_TOL); its wall time beside the one-device
    launch's, and the shard-major partition and stitch timed beside their
    bounds.  The fused driver on the mesh against the per-year loop on the
    mesh, bit for bit; run_downscaling in a one-rank NCCL group
    (distributed.initialize, global_seed_mesh) writes the file of the
    one-process one-shard mesh; cli.main GL --devices 2 raises make_mesh's
    'devices' error; _simulate_batches against three _simulate_batch
    calls; simulator.integrate on the card against its CPU twin.  Returns
    (the kernels line's mesh numbers, launches per kernel in the sharded
    launch)."""
    from tropical_cyclone_risk_tpu_torch import cli, kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.models import (fast, pipeline,
                                                        seeding, simulator)
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    from tropical_cyclone_risk_tpu_torch.parallel import (distributed,
                                                          sharding)
    t_phase = time.perf_counter()
    mesh = sharding.local_mesh([dev] * MESH_SHARDS)
    n_local = N_SEEDS // MESH_SHARDS
    m_local = pipeline.launch_width(cfg_t, n_local)
    key = rng.key(61)

    def launch():
        return sharding.simulate_batch_sharded(mesh, key, pack_y, cfg_t,
                                               BASIN, N_SEEDS, MESH_K_MAX,
                                               plane0)

    def k4_twin(plain):
        return lambda out, *a, **kw: same_parts(out, uncounted(plain, *a,
                                                                **kw))

    launch()                                  # warm
    torch.cuda.synchronize()
    kernels.reset_counts()
    with captured(compact_ops, 'partition_take',
                  k4_twin(compact_ops.partition_take_plain)) as parts, \
            captured(compact_ops, 'stitch_survivors',
                     k4_twin(compact_ops.stitch_survivors_plain)) as sts, \
            captured(simulator, 'genesis_alive', check_k7,
                     keep=False) as k7_runs:
        tr, meta = launch()
        torch.cuda.synchronize()
    mesh_launches = dict(kernels.LAUNCHES)
    check_counts('mesh', mesh_launches, dict(kernels.PLAIN_ON_CUDA),
                 SIMULATION_KERNELS)
    k7_results('mesh', k7_runs)
    bad = [(i, c[3]) for i, c in enumerate(parts + sts) if c[3]]
    sizes = [(c[0][0].shape[0], c[0][1]) for c in parts]
    log(f'[mesh] {MESH_SHARDS} shards of {n_local} seeds on {dev} (width '
        f'{m_local} a shard): {len(parts)} partitions (n, w) {sizes} and '
        f'{len(sts)} stitch against their twins, not bit-exact: '
        f'{bad or "none"}')
    if bad or len(sts) != 1 or sizes[-1] != (MESH_SHARDS * m_local,
                                             MESH_K_MAX):
        raise AssertionError(f'mesh: K4 against its twins {bad}, partitions '
                             f'{sizes}')
    with twins_on_card():
        tr_p, meta_p = launch()
    torch.cuda.synchronize()
    n_surv = int(meta['scalars'][0])
    exact = {k: same(meta[k], meta_p[k]) for k in meta}
    exact.update((k, same(tr[k], tr_p[k])) for k in ('valid', 'month',
                                                      'basin_idx'))
    tol = dict(K1_TOL, vmax=K2_TOL)
    errs = {}
    for k, t in tol.items():
        a, b = tr[k], tr_p[k]
        fin = torch.isfinite(a)
        errs[k] = (float((a - b).abs()[fin].max()) if fin.any() else 0.0,
                   bool((fin == torch.isfinite(b)).all()), same(a, b))
    shard_surv = meta['keep'].reshape(MESH_SHARDS, -1).sum(dim=1).tolist()
    log(f'[mesh] the sharded launch through the kernels and through the '
        f'twins on the card: {n_surv} survivors (per shard {shard_surv}), '
        f'scalars {meta["scalars"].tolist()}; bit-exact {exact}; tracks '
        f'(max abs err, same NaN, bit-exact) {errs}')
    if not (all(exact.values()) and 0 < n_surv <= MESH_K_MAX
            and min(shard_surv) > 0
            and all(e <= tol[k] and nan_ok for k, (e, nan_ok, _)
                    in errs.items())):
        raise AssertionError(f'mesh launch differs from its twins: {exact} '
                             f'{errs}')
    del tr_p, meta_p

    # times: the mesh launch beside the one-device launch; the shard-major
    # partition (compact_survivors', the last) and the stitch
    ms_mesh, ts_mesh = wall_ms(launch)
    ms_one, ts_one = wall_ms(lambda: pipeline._simulate_batch(
        key, pack_y, cfg_t, BASIN, N_SEEDS, MESH_K_MAX, plane0))
    (mask, w, rows), kw, pout, _ = parts[-1]
    ms_part = device_ms(k4.launcher('partition', mask, w, rows, kw.get('acc'),
                                    kw.get('slot_rank', False),
                                    kw.get('a_prev'), kw.get('inv_len'))[0],
                        K4_REPS, entry='compact')
    ms_part_lib = device_ms(lambda: sort_order(mask, w), K4_REPS,
                            entry='compact')
    ms_part_plain = cuda_ms(lambda: uncounted(
        compact_ops.partition_take_plain, mask, w, rows, **kw), 5)
    b_part, by_part = partition_bound(mask, pout, kw.get('a_prev'))
    sargs, _, sout, _ = sts[0]
    ms_st = device_ms(k4.launcher('stitch', *sargs)[0], K4_REPS,
                      entry='compact')
    ms_st_plain = cuda_ms(lambda: uncounted(
        compact_ops.stitch_survivors_plain, *sargs), 5)
    b_st, by_st = stitch_bound(sargs, sout)
    log(f'[mesh] {card}: launch {ms_mesh:.2f} ms wall on the mesh (median '
        f'of {[round(t, 2) for t in ts_mesh]}) against {ms_one:.2f} ms on '
        f'one device ({[round(t, 2) for t in ts_one]}); shard-major '
        f'partition {mask.shape[0]} -> {w} ({len(rows)} row tensors): '
        f'kernels {ms_part:.4f} ms device, torch.sort {ms_part_lib:.4f} ms, '
        f'plain twin {ms_part_plain:.4f} ms, bound {b_part:.5f} ms '
        f'({by_part}); stitch {tuple(sout[0]["lon"].shape)} over '
        f'{len(sargs[1])} segments of width {[tm["lon"].shape[1] for tm in sargs[1]]}: '
        f'kernel {ms_st:.4f} ms device, plain twin {ms_st_plain:.4f} ms, '
        f'bound {b_st:.5f} ms ({by_st})')
    del parts, sts, tr, meta, mask, rows, sargs, sout, pout

    # the fused driver on the mesh against the per-year loop on the mesh
    years = list(cfg_t.years())
    ykey = rng.key(62)
    t0 = time.perf_counter()
    ref = [pipeline.run_tracks_year(rng.fold_in(ykey, yr), pack24, cfg_t,
                                    BASIN, yi, mesh=mesh)
           for yi, yr in enumerate(years)]
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    kernels.reset_counts()
    t0 = time.perf_counter()
    with captured(pipeline, '_simulate_years', keep=False) as groups:
        fused = pipeline.run_tracks_years_fused(ykey, pack24, cfg_t, BASIN,
                                                years, k_fuse=2, mesh=mesh)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    check_counts('mesh, fused years', dict(kernels.LAUNCHES),
                 dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
    equal = same_years(ref, fused)
    log(f'[mesh] {card}: {len(years)} years on the mesh: fused driver '
        f'{t_fused:.2f} s ({len(groups)} group), per-year loop {t_loop:.2f} '
        f's; equal bit for bit {equal}; tracks {[y.lon.shape[0] for y in fused]}')
    if not (equal and len(groups) == 1):
        raise AssertionError('mesh: fused years differ from the loop')
    del ref, fused

    # run_downscaling in a one-rank NCCL group against the one-process
    # one-shard mesh (the same key, so the same file)
    cfg_r = cfg_t.replace(output_directory=f'{tmp}/mesh', exp_name='one')
    fn_one = runtime.run_downscaling(cfg_r, BASIN, pack24, key=rng.key(63),
                                     mesh=sharding.local_mesh([dev]))
    t0 = time.perf_counter()
    distributed.initialize(f'localhost:{free_port()}', 1, 0)
    try:
        distributed.initialize(f'localhost:{free_port()}', 1, 0)   # no-op
        backend = torch.distributed.get_backend()
        gmesh = distributed.global_seed_mesh()
        bcast = distributed.broadcast_from_primary(1234)
        kernels.reset_counts()
        fn_grp = runtime.run_downscaling(cfg_r.replace(exp_name='group'),
                                         BASIN, pack24, key=rng.key(63),
                                         mesh=gmesh)
        torch.cuda.synchronize()
        check_counts('mesh, NCCL group', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
    finally:
        torch.distributed.destroy_process_group()
    t_grp = time.perf_counter() - t0
    diff = files_differ(fn_one, fn_grp)
    log(f'[mesh] {card}: run_downscaling in a one-rank {backend} group '
        f'(mesh {gmesh.devices}, first {gmesh.first}, size {gmesh.size}; '
        f'broadcast {bcast}) in {t_grp:.2f} s; its file against the '
        f'one-process one-shard mesh\'s: differing {diff or "none"}')
    if diff or backend != 'nccl' or bcast != 1234 or gmesh.size != 1:
        raise AssertionError(f'mesh: NCCL group run: {backend} {diff}')

    # cli --devices 2 on one card: make_mesh's error, before any work
    try:
        cli.main(['GL', '--devices', '2'])
    except ValueError as e:
        if 'devices' not in str(e):
            raise
        log(f'[mesh] cli.main GL --devices 2 on one card: ValueError {e}')
    else:
        raise AssertionError('cli --devices 2 on one card did not raise')

    # _simulate_batches against three _simulate_batch calls
    keys = [rng.fold_in(rng.key(64), i) for i in range(3)]
    kernels.reset_counts()
    outs = pipeline._simulate_batches(keys, pack_y, cfg_t, BASIN, N_SEEDS,
                                      64, plane0)
    torch.cuda.synchronize()
    check_counts('mesh, _simulate_batches', dict(kernels.LAUNCHES),
                 dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
    differ = [(i, k) for i, (got, k_i) in enumerate(zip(outs, keys))
              for ref_d, got_d in zip(pipeline._simulate_batch(
                  k_i, pack_y, cfg_t, BASIN, N_SEEDS, 64, plane0), got)
              for k in ref_d if not same(got_d[k], ref_d[k])]
    log(f'[mesh] _simulate_batches of 3 keys against 3 _simulate_batch '
        f'calls: differing leaves {differ or "none"}')
    if differ:
        raise AssertionError(f'_simulate_batches differs: {differ}')
    del outs

    # simulator.integrate on the card (K7, K1) against its CPU twin
    n = 2048
    r = np.random.default_rng(65)
    cols = (r.uniform(120.0, 260.0, n), r.choice([-1.0, 1.0], n)
            * r.uniform(8.0, 30.0, n), r.uniform(12.0, 30.0, n),
            r.uniform(0.3, 0.8, n))
    fs = fourier.draw_fourier_plain(rng.key(66), (n, 4), cfg_t.T_fourier_s)
    plane = torch.from_numpy(r.integers(0, 12, n))
    res = {}
    for d in (dev, torch.device('cpu')):
        y0 = fast.State(*(torch.tensor(c, dtype=torch.float32, device=d)
                          for c in cols))
        params = fast.SeedParams(plane.to(d), torch.full((n,), 1400.0,
                                                          device=d),
                                 fs._replace(A=fs.A.to(d), B=fs.B.to(d)))
        pk = pack_y.to(d)
        kernels.reset_counts()
        out = simulator.integrate(pk, cfg_t, BASIN, y0, params,
                                  torch.ones(n, dtype=torch.bool, device=d))
        if d == dev:
            torch.cuda.synchronize()
            int_launches = dict(kernels.LAUNCHES)
        res[d.type] = {k: v.cpu() for k, v in out._asdict().items()}
    g, c = res['cuda'], res['cpu']
    agree = float((g['alive'] == c['alive']).all(dim=1).float().mean())
    both = g['alive'] & c['alive']
    ierr = {k: float((g[k] - c[k]).abs()[both].max())
            for k in ('lon', 'lat', 'v', 'm')}
    log(f'[mesh] simulator.integrate {n} storms x {g["lon"].shape[1]} '
        f'samples on the card (launches {int_launches}) against its CPU '
        f'twin: same alive history {agree:.4f}, {int(g["alive"][:, 0].sum())}'
        f' alive at genesis, max abs err {ierr}')
    if not (agree >= K1_ALIVE_AGREE and int_launches['integrator'] >= 1
            and int_launches['genesis'] >= 1
            and all(e <= K1_TOL[k] for k, e in ierr.items())):
        raise AssertionError(f'integrate on the card: {agree} {ierr}')
    secs = time.perf_counter() - t_phase
    log(f'[mesh] {card}: phase {secs:.1f} s')
    return {'launch_ms': ms_mesh, 'one_device_ms': ms_one,
            'partition_ms': ms_part, 'partition_library_ms': ms_part_lib,
            'partition_plain_ms': ms_part_plain,
            'partition_bound_ms': b_part, 'stitch_ms': ms_st,
            'stitch_plain_ms': ms_st_plain, 'stitch_bound_ms': b_st,
            'phase_s': secs}, mesh_launches


def check_years(dev, cfg_t, pack_y, plane0, tmp, card):
    """Phase 'years': the production year drivers on a 36-plane pack.
    run_downscaling with years_per_program 2 (the fused driver: one group
    of two years and a tail of one, every steady-state year settled without
    run_tracks_year) and 1 (the per-year loop with its prefetched batch 0)
    writes the same file bit for bit; a forced fallback (integrate_cap
    1/16, no quota prefix) through the fused driver equals the per-year
    loop; K7 against its twin on every launch; the host synchronisations of
    one launch.  Returns the synchronisation count and its sources."""
    from tropical_cyclone_risk_tpu_torch import kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    from tropical_cyclone_risk_tpu_torch.models import (fields, pipeline,
                                                        simulator)
    cfg_y = cfg_t.replace(start_year=2016, end_year=2018,
                          output_directory=f'{tmp}/years')
    pack36 = fields.synthetic_pack(cfg_y, n_planes=36, nlat=181, nlon=360,
                                   seed=0, device=dev)
    fns, t_run = {}, {}
    for ypp, name in ((2, 'fused'), (1, 'loop')):
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        with captured(simulator, 'genesis_alive', check_k7,
                      keep=False) as k7_runs, \
                captured(pipeline, 'run_tracks_year', keep=False) as rty, \
                captured(pipeline, '_simulate_years', keep=False) as groups:
            fns[name] = runtime.run_downscaling(
                cfg_y.replace(years_per_program=ypp, exp_name=name), BASIN,
                pack36, seed=0, device=dev)
        torch.cuda.synchronize()
        t_run[name] = time.perf_counter() - t0
        check_counts(f'years, {name}', dict(kernels.LAUNCHES),
                     dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
        k7_results(f'years, {name}', k7_runs)
        log(f'[years] {card}: run_downscaling three years with '
            f'years_per_program={ypp} in {t_run[name]:.2f} s: '
            f'{len(groups)} fused groups, {len(rty)} calls of '
            f'run_tracks_year, {len(k7_runs)} launches')
        if name == 'fused' and (len(groups) != 2 or rty):
            raise AssertionError(f'fused route: {len(groups)} groups, '
                                 f'{len(rty)} run_tracks_year calls')
    df, dl = netcdf.read(fns['fused']), netcdf.read(fns['loop'])
    diff = [k for k, v in dl.variables.items()
            if k not in df.variables or not np.array_equal(
                df.variables[k].data, v.data,
                equal_nan=v.data.dtype.kind == 'f')]
    n_trk, _ = check_tracks(df, cfg_y)
    log(f'[years] the two files: {len(dl.variables)} variables, '
        f'{n_trk} tracks, differing {diff}')
    if diff or set(df.variables) != set(dl.variables) \
            or n_trk != 3 * cfg_y.tracks_per_year:
        raise AssertionError(f'fused and per-year files differ: {diff}')

    # a forced fallback: every year's batch 0 overflows its cap
    cfg_fb = cfg_y.replace(integrate_cap=1.0 / 16.0, survivors_per_slot=None)
    years = list(cfg_fb.years())
    key = rng.key(5)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    with captured(simulator, 'genesis_alive', check_k7,
                  keep=False) as k7_runs:
        ref = [pipeline.run_tracks_year(rng.fold_in(key, yr), pack36, cfg_fb,
                                        BASIN, yi)
               for yi, yr in enumerate(years)]
        with captured(pipeline, 'run_tracks_year') as fb_calls:
            fused = pipeline.run_tracks_years_fused(key, pack36, cfg_fb,
                                                    BASIN, years, k_fuse=2)
    torch.cuda.synchronize()
    check_counts('years, fallback', dict(kernels.LAUNCHES),
                 dict(kernels.PLAIN_ON_CUDA), SIMULATION_KERNELS)
    k7_results('years, fallback', k7_runs)
    handed = sum(c[1].get('first_batch') is not None for c in fb_calls)
    equal = same_years(ref, fused)
    log(f'[years] {card}: forced fallback (integrate_cap 1/16) in '
        f'{time.perf_counter() - t0:.2f} s: {len(fb_calls)} fallback years, '
        f'{handed} handed their fused launch; equal to the per-year loop '
        f'bit for bit {equal}')
    if not (equal and len(fb_calls) == len(years) == handed):
        raise AssertionError('forced fallback differs from the loop')
    del fb_calls, ref, fused, pack36

    # the host synchronisations of one launch (a warm one)
    def launch():
        pipeline._simulate_batch(rng.key(95), pack_y, cfg_t, BASIN,
                                 N_SEEDS, 64, plane0)
    launch()
    n_sync, where = host_syncs(launch)
    log(f'[years] host synchronisations in one launch (_simulate_batch, '
        f'torch.cuda.set_sync_debug_mode): {n_sync} {json.dumps(where)}')
    return n_sync, where


def run_bench(card):
    """Phase 'bench': the bench entry point at its full workload, in
    process; its JSON line, its peak device memory and its kernel
    launches."""
    import contextlib
    import io
    from tropical_cyclone_risk_tpu_torch import bench, kernels
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        bench.main([])
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lines = out.getvalue().splitlines()
    if len(lines) != 1:
        raise AssertionError(f'the bench printed {len(lines)} lines')
    log(f'[bench] {lines[0]}')
    res = json.loads(lines[0])
    d = res['detail']
    rates = (res['value'], d['scan_rows_per_min'], d['surviving_tcs_per_min'],
             d['sim_years_per_min'], d['seconds_per_sim_year_unfused_loop'])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f'[bench] {card}: {dt:.1f} s in all; peak device memory allocated '
        f'{peak:.2f} MiB')
    check_counts('bench', launches, dict(kernels.PLAIN_ON_CUDA),
                 SIMULATION_KERNELS)
    if not (min(rates) > 0 and d['platform'] == 'gpu'
            and d['device'] == card and res['vs_baseline'] is None):
        raise AssertionError(f'bench line: {res}')
    drivers = compare_drivers(card)
    return res, launches, peak, drivers


def compare_drivers(card, n_years=8, reps=3):
    """The two year drivers on the bench's workload (its auto-tuned caps,
    an 8-year 181x360 pack), pass by pass, each pass timed from nothing
    issued: wall time (median of reps, after a warm pass), launches per
    pass (K3 launches once per launch), host synchronisations per pass
    with their sources, and the device's busy share over one pass under
    torch.profiler.  Returns {driver: numbers}."""
    from torch.profiler import ProfilerActivity, profile
    from tropical_cyclone_risk_tpu_torch import bench, kernels
    from tropical_cyclone_risk_tpu_torch.models import fields
    dev = torch.device('cuda', 0)
    cfg, _ = bench.workload(dev)
    pack = fields.synthetic_pack(cfg, 12 * n_years, 181, 360, seed=0,
                                 device=dev)
    passes = {
        'fused': lambda s: bench.fused_pass(s, pack, cfg, n_years),
        'loop': lambda s: bench.loop_pass(s, pack, cfg, n_years,
                                          bench.loop_first(s, pack, cfg))}
    out = {}
    with tempfile.TemporaryDirectory(prefix='drivers_') as tmp:
        for name, one in passes.items():
            one(300)
            dts = []
            for r in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one(301 + r)
                dts.append(time.perf_counter() - t0)
            kernels.reset_counts()
            one(310)
            n_launch = kernels.LAUNCHES['seeding']
            n_sync, where = host_syncs(lambda: one(311))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one(312)
                torch.cuda.synchronize()
            prof.export_chrome_trace(f'{tmp}/{name}.json')
            busy, span, n_kern = trace_busy(f'{tmp}/{name}.json')
            out[name] = {'s_per_year': statistics.median(dts) / n_years,
                         's_per_year_all': [d / n_years for d in dts],
                         'launches': n_launch, 'host_syncs': n_sync,
                         'sync_sources': where, 'busy_share': busy / span,
                         'device_kernels': n_kern}
            log(f'[bench] {card}: {name} driver, {n_years} years per pass: '
                f'{json.dumps(out[name])}')
    return out


# profiles taken per measurement before giving up: the card's tracer now
# and then hands torch.profiler a session with no device activity at all
# (at times several in a row), so a retry waits a little longer each time
PROFILE_TRIES = 5


class ProfilerLost(AssertionError):
    """torch.profiler recorded no device activity in PROFILE_TRIES
    profiles."""


def profiled(fn, reps):
    """(profile, its key_averages, the device-time attribute) of
    torch.profiler over reps runs of fn(), after one run to warm up.  A
    profile that recorded no device time at all is taken again, up to
    PROFILE_TRIES times, else ProfilerLost."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        attr = ('self_device_time_total'
                if hasattr(avg[0], 'self_device_time_total')
                else 'self_cuda_time_total')
        if any(getattr(e, attr) > 0 for e in avg):
            return prof, avg, attr
    raise ProfilerLost(f'torch.profiler recorded no device time in '
                       f'{PROFILE_TRIES} profiles')


# the device_ms calls that returned CUDA-event time because torch.profiler
# was lost, each as its entry of the kernels line or its kernel names; the
# kernels line says which of its times they are (ms_timing)
EVENT_TIMED = set()


def device_ms(fn, reps, names=None, entry=None):
    """Milliseconds of device time per fn() in the kernels whose names
    contain one of `names` (None: every kernel), from torch.profiler over
    reps runs (so the host's dispatch between launches is not counted);
    where the card's tracer records nothing at all, the CUDA-event time
    over reps runs (launch gaps included), logged as such and recorded in
    EVENT_TIMED as `entry` (the kernels line's entry the time belongs to)
    or, without one, as `names`."""
    try:
        _, avg, attr = profiled(fn, reps)
    except ProfilerLost as e:
        ms = cuda_ms(fn, reps)
        EVENT_TIMED.add(entry or tuple(names or ()))
        log(f'[profiler] {e}; CUDA-event time {ms:.4f} ms per call instead '
            f'({names or "every kernel"})')
        return ms
    total = sum(getattr(e, attr) for e in avg
                if names is None and e.device_type.name == 'CUDA'
                or names is not None and any(n in e.key for n in names))
    if total > 0:
        return total / 1e3 / reps
    raise AssertionError(f'torch.profiler recorded no device time in '
                         f'{names or "any kernel"}')


# the kernel names by which device_ms times each entry of the kernels
# line, besides the calls that name the entry (K3's and K4's); K1's times
# are CUDA-event times throughout
TIMED_AS = {'vmax': ('vmax_kernel',), 'seeding': ('seed_kernel',),
            'threefry': ('rng_fourier',), 'compact': ('stitch_kernel',),
            'cape_pi': ('cape_pi_kernel',),
            'vmax_last': ('last_sample_kernel',),
            'genesis': K7_KERNELS}


def ms_timing(name):
    """How the times of the kernels line's entry `name` were taken: device
    time under torch.profiler, or CUDA events (launch gaps included) for
    K1, and for the entry's times where EVENT_TIMED holds one of its
    measurements (then the entry says so, naming them)."""
    if name not in TIMED_AS:
        return 'CUDA events'
    lost = sorted(str(k) for k in EVENT_TIMED
                  if k == name or isinstance(k, tuple)
                  and any(n in TIMED_AS[name] for n in k))
    return ('device time (torch.profiler)' if not lost else
            f'device time (torch.profiler); CUDA events where the profiler '
            f'was lost: {", ".join(lost)}')


def device_ops(fn, reps):
    """(device operations per fn(), {their short names: count per fn()}):
    the kernels, memsets and copies on the card in a torch.profiler trace
    over reps runs.  A trace whose count is not a whole number per run has
    lost records (the card's tracer drops one now and then, as it drops
    whole profiles: profiled), so it is taken again, up to PROFILE_TRIES
    times; the last one counts."""
    import collections
    for _ in range(PROFILE_TRIES):
        prof, _, _ = profiled(fn, reps)
        with tempfile.TemporaryDirectory(prefix='device_ops_') as tmp:
            prof.export_chrome_trace(f'{tmp}/trace.json')
            with open(f'{tmp}/trace.json') as f:
                events = json.load(f)['traceEvents']
        names = collections.Counter(
            kernel_label(str(e.get('name')))[:48] for e in events
            if e.get('ph') == 'X'
            and e.get('cat') in ('kernel', 'gpu_memset', 'gpu_memcpy'))
        if sum(names.values()) % reps == 0:
            break
        log(f'[profiler] {sum(names.values())} device operations in {reps} '
            f'runs: a record lost, profiled again')
    return (sum(names.values()) / reps,
            {k: v / reps for k, v in sorted(names.items())})


def k6_times(dev):
    """K6 through ops.pi.cape_pi on the main path's inputs: gen_thermo on
    the one-year one-degree workspace of utils/synthetic_era5 (written into
    build/kernel_times_ws on first use, then reused) with cape_pi
    captured, then that call's device time (its kernels under
    torch.profiler), CUDA-event time and host time."""
    from tropical_cyclone_risk_tpu_torch.config import load_namelist_py
    from tropical_cyclone_risk_tpu_torch.ops import pi as pi_ops
    from tropical_cyclone_risk_tpu_torch.preprocess import thermo_driver
    from tropical_cyclone_risk_tpu_torch.utils import synthetic_era5
    ws = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                      'kernel_times_ws')
    nl = f'{ws}/namelist.py'
    if not os.path.exists(nl):
        nl = synthetic_era5.make_workspace(ws, WS_YEAR, WS_YEAR, nlat=181,
                                           nlon=360, seed_batch=N_SEEDS)
    cfg_ws = load_namelist_py(nl)
    # gen_thermo's progress goes to stderr: stdout is the JSON line
    with tempfile.TemporaryDirectory(prefix='k6_times_') as tmp, \
            captured(pi_ops, 'cape_pi') as calls, \
            contextlib.redirect_stdout(sys.stderr):
        thermo_driver.gen_thermo(cfg_ws.replace(output_directory=tmp),
                                 device=dev)
    (args, kw, out, _), = calls

    def call():
        return pi_ops.cape_pi(*args, **kw)
    return {'columns': out.numel(), 'levels': args[2].shape[0],
            'device_ms': device_ms(call, 20, ('cape_pi_kernel',)),
            'event_ms': cuda_ms(call, 20), 'host_ms': host_ms(call, 20)}


# the bench launch's compact_survivors k_max at which --kernel-times times
# the stitch (and at m, the integrate width), the wind widths it times at
# k_max 64 (W = 2 x steering levels: three to seventeen levels), and the
# seeds of the launch where it times k_max = m at the namelist's default
# seed_batch
STITCH_K_MAXES = (64, 4096)
STITCH_WIDTHS = (6, 8, 10, 14, 30, 34)
STITCH_DENSE_SEEDS = 8192


def stitch_runs(key, pack_y, cfg_t, plane0, m):
    """The survivor stitches --kernel-times times, as (label, arguments):
    one bench launch's compact_survivors at k_max STITCH_K_MAXES and m;
    the [mesh] phase's launch over MESH_SHARDS virtual shards (its one
    shard-major stitch at MESH_K_MAX); a STITCH_DENSE_SEEDS-seed launch
    at k_max = its width (every slot stitched, as at any tracks_per_year
    at or above the width)."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.models import pipeline
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.parallel import sharding
    n_basins = len(cfg_t.basin_ids_sorted())
    body = pipeline.launch_body(key, pack_y, cfg_t, BASIN, N_SEEDS, plane0)
    cfg_d = cfg_t.replace(seed_batch=STITCH_DENSE_SEEDS)
    m_d = pipeline.launch_width(cfg_d, STITCH_DENSE_SEEDS)
    with captured(compact_ops, 'stitch_survivors') as calls:
        for k_max in STITCH_K_MAXES + (m,):
            pipeline.compact_survivors(body, m, k_max, n_basins)
        sharding.simulate_batch_sharded(
            sharding.local_mesh([pack_y.device] * MESH_SHARDS), rng.key(61),
            pack_y, cfg_t, BASIN, N_SEEDS, MESH_K_MAX, plane0)
        pipeline.compact_survivors(pipeline.launch_body(
            key, pack_y, cfg_d, BASIN, STITCH_DENSE_SEEDS, plane0), m_d, m_d,
            n_basins)
    torch.cuda.synchronize()
    labels = [f'bench k_max {k}' for k in STITCH_K_MAXES + (m,)] + [
        f'mesh k_max {MESH_K_MAX}',
        f'{STITCH_DENSE_SEEDS} seeds k_max = m {m_d}']
    return [(label, args) for label, (args, *_) in zip(labels, calls)]


def stitch_times(runs, dev):
    """K4's survivor stitch on runs (stitch_runs) at W = 4, and on the
    first (k_max 64) with each segment's winds widened to each of
    STITCH_WIDTHS as seeded random floats (the same segments, order and
    maps; the stitch only copies the winds): each bit for bit against its
    twin, its device time after a clean L2 flush (clean) and after a
    write flush (cold), TIME_ROUNDS rounds each (median and range), and
    warm, its bound (stitch_bound) and the share of it in each, and the
    bound at sector granularity (stitch_sectors)."""
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    g = torch.Generator(device=dev).manual_seed(18)
    order, tms, segs, keep, rank = runs[0][1]
    runs = runs + [(f'bench k_max 64 W {W}', lambda W=W: (
        order, tuple(dict(tm, wnds=torch.randn(
            tuple(tm['wnds'].shape[:2]) + (W,), generator=g, device=dev))
            for tm in tms), segs, keep, rank)) for W in STITCH_WIDTHS]
    rows = []
    for label, args in runs:
        args = args() if callable(args) else args
        launch, out = k4.launcher('stitch', *args)
        launch()
        ref = uncounted(compact_ops.stitch_survivors_plain, *args)
        b_ms, b_by = stitch_bound(args, out)
        row = {'run': label, 'shape': list(out[0]['wnds'].shape),
               'segments': len(args[1]), 'exact': not same_parts(out, ref),
               'bound_ms': b_ms, 'bound_by': b_by,
               'sector_bound_ms': stitch_sectors(args, out)}
        del ref
        for name, flush in (('clean', clean), ('cold', cold)):
            ts = sorted(device_ms(flush(launch), K4_REPS, ('stitch_kernel',))
                        for _ in range(TIME_ROUNDS))
            row[name + '_ms'], row[name + '_range'] = ts[len(ts) // 2], [
                ts[0], ts[-1]]
        row['warm_ms'] = device_ms(launch, K4_REPS, ('stitch_kernel',))
        for name in ('clean', 'cold', 'warm'):
            row[name + '_share'] = b_ms / row[name + '_ms']
        log(f'[kernel-times] stitch {row}')
        rows.append(row)
        del args, launch, out
    return rows


def kernel_times(root):
    """--kernel-times ROOT: with the port imported from the tree at ROOT,
    K1 and K2 on every segment and K4 on every partition of one full-width
    launch (launch_calls, as the K4 phase makes it) and K1 on the first
    segment of each integration mode (mode_calls, as the modes phase),
    each through its wrapper or dispatcher (integrator.integrate_segment_cuda,
    diagnostics.axi_to_max_wind_raw, ops.compact.partition_take, which the
    port has had since those kernels were written): the device time of its
    kernels under torch.profiler, the CUDA-event time per call, and the
    host time to make a call (for K4 also split into the launcher's
    preparation and the launch); K3 through models.seeding.propose_seeds
    at N_SEEDS slots with the auto-tuned caps, none and the overflow caps
    (k3_times: device, event and host time, device operations per call);
    K4's partitions also after a clean L2 flush (clean), and its stitch
    at the bench launch's k_max 64, 4096 and m, on the mesh launch, at
    k_max = m on a launch of the default seed_batch (stitch_runs) and at
    wider winds (stitch_times);
    K6 through ops.pi.cape_pi on the 12 x 181 x 360 columns and 28
    levels that gen_thermo gives it on the one-year workspace of
    utils/synthetic_era5 (written once into build/ and reused), and K6's
    SASS instruction counts; K5 through ops.fourier.draw_fourier as the
    launch calls it (device, event and host time) and the SASS
    instructions by pipe of csrc/rng.cu's kernels; the device memory one
    launch allocates at its peak; the wall time of five launches (_simulate_batch at k_max 64,
    after one more); and a torch.profiler trace of three launches
    (profile_launches: device kernels per launch, busy share, host and
    device-span ms per stage, the genesis gate's among them); prints one
    JSON line, with the registers, stack and spills of K1's default
    instance (k1_frame).  Run on two trees, a parent commit and its change,
    in one chip call, it compares the two on one card."""
    import concurrent.futures
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import tropical_cyclone_risk_tpu_torch as pkg
    if not pkg.__file__.startswith(root + os.sep):
        raise SystemExit(f'the port was imported from {pkg.__file__}')
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.kernels import cape_pi
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5_kernel
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3_kernel
    from tropical_cyclone_risk_tpu_torch.models import diagnostics, pipeline
    from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
    from tropical_cyclone_risk_tpu_torch.ops import fourier
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        built = [pool.submit(b) for b in (integrator.build, k4.build,
                                          k3_kernel.build, k5_kernel.build,
                                          cape_pi.build)]
        k1_info, _, _, k5_info, k6_info = [f.result() for f in built]
    k5_lib, k6_lib = k5_info['path'], k6_info['path']
    dev = torch.device('cuda', 0)
    cfg, _, pack_y, cfg_t = launch_setup(dev)
    plane0 = cfg.start_month - 1
    k3 = {name: k3_times(rng.fold_in(rng.key(0), 3), pack_y,
                         cfg_t.replace(seed_retry_caps=caps), plane0)
          for name, caps in (('auto-tuned caps', cfg_t.seed_retry_caps),
                             ('no caps', None),
                             ('overflow caps', OVERFLOW_CAPS))}
    k6 = k6_times(dev)
    k6['sass'] = {fn: {'instructions': n_ins, 'loops': loops}
                  for fn, (n_ins, loops) in sass_counts(k6_lib).items()}
    m = pipeline.launch_width(cfg_t, N_SEEDS)
    with captured(diagnostics, 'axi_to_max_wind_raw') as k2_calls:
        segs, parts, _, n_launch, draws = launch_calls(
            rng.key(99), pack_y, cfg_t, plane0)
    stitches = stitch_runs(rng.key(99), pack_y, cfg_t, plane0, m)
    modes = {name: mode_calls(rng.key(97), pack_y, cfg_t.replace(**kw),
                              plane0)[0][0]
             for name, kw in MODES.items()}

    def timed(call, reps, names):
        return {'device_ms': device_ms(call, reps, names),
                'event_ms': cuda_ms(call, reps),
                'host_ms': host_ms(call, reps)}

    k1 = [{'steps': args[7], 'width': args[3].lon.shape[0],
           **timed(k1_launcher(args, integrator.integrate_segment_cuda),
                   K1_REPS, ('integrate_segment_kernel',))}
          for args, *_ in segs]
    k2 = [{'steps': args[0].shape[0], 'width': args[0].shape[1],
           **timed(lambda: diagnostics.axi_to_max_wind_raw(*args, **kw),
                   K2_REPS, ('vmax_kernel',))}
          for args, kw, *_ in k2_calls]
    k1_modes = {name: device_ms(k1_launcher(
        args, integrator.integrate_segment_cuda), 5,
        ('integrate_segment_kernel',)) for name, args in modes.items()}
    # K4's host time split: the launcher's checks, outputs and parameter
    # block (Python), and the launch (ctypes and the kernel launches)
    k4_rows = []
    for args, kw, *_ in parts:
        largs = ('partition', *args, kw.get('acc'), kw.get('slot_rank', False),
                 kw.get('a_prev'), kw.get('inv_len'))
        call = lambda: compact_ops.partition_take(*args, **kw)
        names = ('count_kernel', 'partition_kernel', 'gather_kernel')
        k4_rows.append({
            'n': args[0].shape[0], 'w': args[1],
            **timed(call, K4_REPS, names),
            'clean_device_ms': statistics.median(
                device_ms(clean(call), K4_REPS, names)
                for _ in range(TIME_ROUNDS)),
            'prep_host_ms': host_ms(lambda: k4.launcher(*largs), K4_REPS),
            'launch_host_ms': host_ms(k4.launcher(*largs)[0], K4_REPS)})
    k4_stitch = stitch_times(stitches, dev)
    del stitches
    (d_args, d_kw, d_out, _), = draws
    k5 = {'shape': list(d_out.A.shape),
          **timed(lambda: fourier.draw_fourier(*d_args, **d_kw), 20,
                  ('rng_fourier',)),
          'sass_pipes': {kernel_label(fn): p
                         for fn, p in sass_pipes(k5_lib).items()
                         if 'fourier' in fn}}
    # the device memory one launch allocates above what it starts from
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pipeline._simulate_batch(rng.key(99), pack_y, cfg_t, BASIN, N_SEEDS, 64,
                             plane0)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    launch_ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline._simulate_batch(rng.key(100 + i), pack_y, cfg_t, BASIN,
                                 N_SEEDS, 64, plane0)
        torch.cuda.synchronize()
        launch_ms.append((time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory(prefix='kernel_times_') as tmp:
        per_launch, share, traced_ms, stage_ms, _ = profile_launches(
            lambda: pipeline._simulate_batch(rng.key(98), pack_y, cfg_t,
                                             BASIN, N_SEEDS, 64, plane0),
            3, f'{tmp}/launches.json')
    res = {'kernel_times': root, 'card': card_line(),
           'k1_default_instance': k1_frame(k1_info)[0], 'k1': k1, 'k2': k2,
           'k3': k3, 'k4': k4_rows, 'k4_stitch': k4_stitch, 'k5': k5,
           'k6': k6,
           'k1_modes_segment0_device_ms': k1_modes,
           'launch_ms': launch_ms[1:], 'launch_peak_mib': peak_mib,
           'launch_ms_median': statistics.median(launch_ms[1:]),
           'profile': {'device_kernels_per_launch': per_launch,
                       'busy_share': share, 'traced_ms_per_launch': traced_ms,
                       'stage_host_and_span_ms': stage_ms}}
    for name, rows in (('k1', k1), ('k2', k2), ('k4', k4_rows)):
        for key in rows[0]:
            if key.endswith('_ms'):
                res[f'{name}_{key}'] = sum(r[key] for r in rows)
    print(json.dumps(res))
    return 0 if all(r['exact'] for r in k4_stitch) else 1


# the level counts and K7 block shapes at which gate_times times the
# staged gate: threads a block, tried where the tree has gate_plan
GATE_SETS = {2: (250, 850), 3: (250, 500, 850), 4: (250, 500, 700, 850)}
GATE_PLANS = (32, 64, 96, 128)


def gate_times(root):
    """--gate-times ROOT: with the port imported from the tree at ROOT, K7
    at two, three and four levels in each stack layout (the seeds of one
    N_SEEDS launch's launch_inputs on a pack of that count, in-cell or
    with land and bathymetry on grids of their own, geo_pack): its device
    time after a clean L2 flush (clean) and after a write flush (cold)
    in TIME_ROUNDS rounds, and warm, its bound (k7_bound) and share of
    the clean time, and its keep mask bit for bit against the twin; where
    ROOT's integrator has gate_plan, each of GATE_PLANS threads a block
    (GATE_THREADS set for the launcher), clean.  Then
    the bench's two-level launch with vmax_in_scan: the kernel launches
    of one launch (vmax_last among them), the last-sample
    entry's device time in a launch (every launch of it, under
    torch.profiler), the host ms from the fix's first call (ROOT's
    diagnostics.fix_in_scan, or its first fix_last_sample) to
    launch_body's return (median of five launches), and the device
    kernels of a launch (profile_launches).  Prints one JSON line.  Run on
    a parent and its change in one chip call (parent, change, change,
    parent), it compares the two on one card."""
    import concurrent.futures
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import tropical_cyclone_risk_tpu_torch as pkg
    if not pkg.__file__.startswith(root + os.sep):
        raise SystemExit(f'the port was imported from {pkg.__file__}')
    from tropical_cyclone_risk_tpu_torch import kernels, rng
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.kernels import rng as k5_kernel
    from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3_kernel
    from tropical_cyclone_risk_tpu_torch.kernels import vmax as k2_kernel
    from tropical_cyclone_risk_tpu_torch.models import (diagnostics,
                                                        pipeline, simulator)
    t0 = time.perf_counter()
    jobs = [lambda lv=lv: integrator.build(lv, False) for lv in GATE_SETS]
    jobs += [lambda: integrator.build(2, True), k2_kernel.build, k4.build,
             k3_kernel.build, k5_kernel.build]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = [f.result() for f in [pool.submit(j) for j in jobs]]
    t_build = time.perf_counter() - t0
    # the ptxas reports of the gates and the last-sample entry
    ptxas = {k: v for info in built
             for k, v in ptxas_report(info['log']).items()
             if 'genesis_gate' in k or 'last_sample' in k}
    dev = torch.device('cuda', 0)
    takes_plan = hasattr(integrator, 'gate_plan')
    gate = {}
    for lv, levels in GATE_SETS.items():
        cfg, pack, cfg_t = level_setup(dev, steering_fields(levels))
        plane0 = cfg.start_month - 1
        for layout in LAYOUTS:
            pk = pack if layout == 'in-cell' else geo_pack(cfg, dev, layout)
            with captured(simulator, 'genesis_alive') as gc:
                pipeline.launch_inputs(rng.key(93), pk, cfg_t, BASIN,
                                       N_SEEDS, plane0)
            (g_args, _, g_out, _), = gc
            ref = uncounted(simulator.genesis_alive_plain, *g_args)
            launch, keep = integrator.gate_launcher(*g_args)
            launch()
            torch.cuda.synchronize()
            b_ms, b_by = k7_bound(g_args, g_out)
            row = {'seeds': g_out.shape[0], 'exact': same(keep, ref)
                   and same(g_out, ref), 'bound_ms': b_ms, 'bound_by': b_by}
            for name, flush in (('clean', clean), ('cold', cold)):
                rounds = sorted(device_ms(flush(launch), 20, K7_KERNELS)
                                for _ in range(TIME_ROUNDS))
                row[name + '_ms'] = rounds[len(rounds) // 2]
                row[name + '_range'] = [rounds[0], rounds[-1]]
            row['warm_ms'] = device_ms(launch, 20, K7_KERNELS)
            row['share'] = b_ms / row['clean_ms']
            if takes_plan:
                row['plans'] = {}
                for plan in GATE_PLANS:
                    default = integrator.GATE_THREADS
                    integrator.GATE_THREADS = plan
                    try:
                        pl, kp = integrator.gate_launcher(*g_args)
                    finally:
                        integrator.GATE_THREADS = default
                    pl()
                    torch.cuda.synchronize()
                    row['plans'][plan] = {
                        'exact': same(kp, ref),
                        'clean_ms': device_ms(clean(pl), 20, K7_KERNELS)}
            gate[f'L{lv} {layout}'] = row
            log(f'[gate-times] L{lv} {layout}: {row}')
            del gc, g_args, g_out, ref, launch, keep, pk
    # the in-scan launch at two levels
    cfg, _, pack_y, cfg_t = launch_setup(dev)
    plane0 = cfg.start_month - 1
    cfg_on = cfg_t.replace(vmax_in_scan=True)
    fix_name = ('fix_in_scan' if hasattr(diagnostics, 'fix_in_scan')
                else 'fix_last_sample')
    run = lambda i: pipeline._simulate_batch(rng.key(300 + i), pack_y,
                                             cfg_on, BASIN, N_SEEDS, 64,
                                             plane0)
    run(0)
    torch.cuda.synchronize()
    kernels.reset_counts()
    run(1)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    marks = {}
    fix_fn, body_fn = getattr(diagnostics, fix_name), pipeline.launch_body

    def fix_marked(*a, **kw):
        marks.setdefault('first', time.perf_counter())
        return fix_fn(*a, **kw)

    def body_marked(*a, **kw):
        out = body_fn(*a, **kw)
        marks['end'] = time.perf_counter()
        return out

    host = []
    setattr(diagnostics, fix_name, fix_marked)
    pipeline.launch_body = body_marked
    try:
        for i in range(6):
            marks.clear()
            torch.cuda.synchronize()
            run(2 + i)
            torch.cuda.synchronize()
            host.append((marks['end'] - marks['first']) * 1e3)
    finally:
        setattr(diagnostics, fix_name, fix_fn)
        pipeline.launch_body = body_fn
    fix_dev = device_ms(lambda: run(9), 5, ('last_sample_kernel',))
    with tempfile.TemporaryDirectory(prefix='gate_times_') as tmp:
        per_launch, share, traced_ms, stage_ms, _ = profile_launches(
            lambda: run(10), 3, f'{tmp}/launches.json')
    in_scan = {'fix': fix_name, 'launches': launches,
               'fix_device_ms_per_launch': fix_dev,
               'fix_to_body_end_host_ms': statistics.median(host[1:]),
               'fix_to_body_end_host_ms_all': host[1:],
               'device_kernels_per_launch': per_launch,
               'busy_share': share, 'traced_ms_per_launch': traced_ms,
               'stage_host_and_span_ms': stage_ms}
    log(f'[gate-times] in-scan: {in_scan}')
    bad = [k for k, v in gate.items() if not v['exact'] or any(
        not p['exact'] for p in v.get('plans', {}).values())]
    res = {'gate_times': root, 'card': card_line(), 'build_s': t_build,
           'ptxas': ptxas, 'gate': gate, 'in_scan': in_scan, 'not_exact': bad}
    print(json.dumps(res))
    return 1 if bad else 0


def drivers_times(root):
    """--drivers ROOT: with the port imported from the tree at ROOT, its
    kernels built (build_all) and compare_drivers on the bench's workload;
    prints one JSON line.  Run on two trees, a parent and its change, in
    one chip call, it compares their year drivers on one card."""
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import tropical_cyclone_risk_tpu_torch as pkg
    if not pkg.__file__.startswith(root + os.sep):
        raise SystemExit(f'the port was imported from {pkg.__file__}')
    card = card_line()
    with contextlib.redirect_stdout(sys.stderr):
        build_all(torch.device('cuda', 0))
        out = compare_drivers(card)
    print(json.dumps({'root': root, 'card': card, 'drivers': out}))


def sass_of(lib_path):
    """{kernel's mangled name: its SASS instructions without addresses}
    of a built library (cuobjdump -sass); the anonymous namespace's
    per-file hash is masked, so the same code built from two paths
    compares equal."""
    import re
    text = cuobjdump('-sass', lib_path)
    if text is None:
        raise RuntimeError('cuobjdump not found')
    out = {}
    for part in re.split(r'\n\s*Function : ', text)[1:]:
        name = re.sub(r'_GLOBAL__N__[0-9a-f]+_', '_GLOBAL__N_',
                      part.split('\n', 1)[0].strip())
        out[name] = [' '.join(m.group(1).split()) for m in re.finditer(
            r'/\*[0-9a-f]{4,}\*/\s+([^;]*;)', part)]
    return out


def sass_against(root):
    """--sass ROOT: every library of this tree's csrc/ (one per unit of
    csrc/integrator.cu: kernels/integrator.py UNITS) built with nvcc here
    and from the same source under ROOT (the units of ROOT's own UNITS,
    or of its LEVELS_TAKEN each with and without the in-scan vmax, as
    trees before UNITS list them), with the same flags and definitions,
    and their
    cuobjdump -sass compared kernel by kernel.  Prints each library's
    kernels that are identical in both trees, that differ, and that one
    tree alone has, then one JSON line.  Needs nvcc and cuobjdump; run on
    a parent and its change, it shows which kernels a change left
    untouched."""
    import ast
    import concurrent.futures
    import re
    from pathlib import Path
    from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    trees = {'here': kbuild.PKG,
             'root': Path(os.path.abspath(root)) /
             'tropical_cyclone_risk_tpu_torch'}
    text = (trees['root'] / 'kernels' / 'integrator.py').read_text()
    found = re.search(r'^UNITS = (\(.*?\))\n(?!\s)', text, re.M | re.S)
    taken = {'here': integrator.UNITS, 'root': ast.literal_eval(
        found.group(1)) if found else tuple(
            (lv, d) for lv in ast.literal_eval(re.search(
                r'^LEVELS_TAKEN = (\(.*?\))', text, re.M).group(1))
            for d in (False, True))}
    work = tempfile.mkdtemp(prefix='sass_')
    jobs = []
    for tree, pkg in trees.items():
        for src in sorted((kbuild.PKG / 'csrc').glob('*.cu')):
            units = ([(('TC_K1_LEVELS', lv), ('TC_K1_DIAG', int(d)))
                      for lv, d in taken[tree]]
                     if src.stem == 'integrator' else [()])
            jobs += [(tree, pkg / 'csrc' / src.name, defs) for defs in units]

    def build(job):
        tree, src, defs = job
        lib = os.path.join(work, f'{tree}_{src.stem}'
                           + ''.join(f'_{v}' for _, v in defs) + '.so')
        res = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS,
                              *(f'-D{k}={v}' for k, v in defs), '-o', lib,
                              str(src)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src}:\n{res.stderr}')
        return job, sass_of(lib)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build, jobs))
    libs = {}
    for (tree, src, defs), funcs in built:
        key = src.stem + ''.join(f' {k}={v}' for k, v in defs)
        libs.setdefault(key, {})[tree] = funcs
    out = {'root': os.path.abspath(root), 'identical': 0, 'differ': [],
           'only_here': [], 'only_root': []}
    for key, by_tree in sorted(libs.items()):
        here, there = by_tree.get('here', {}), by_tree.get('root', {})
        same_k = [kernel_label(f) for f in here
                  if f in there and here[f] == there[f]]
        differ = [kernel_label(f) for f in here
                  if f in there and here[f] != there[f]]
        only_h = [kernel_label(f) for f in here if f not in there]
        only_r = [kernel_label(f) for f in there if f not in here]
        out['identical'] += len(same_k)
        for field, names in (('differ', differ), ('only_here', only_h),
                             ('only_root', only_r)):
            out[field] += [f'{key}: {n}' for n in names]
        log(f'[sass] {key}: identical {len(same_k)} {sorted(same_k)}; '
            f'differ {differ}; only here {only_h}; only at ROOT {only_r}')
    log(f'[sass] {len(jobs)} nvcc processes in '
        f'{time.perf_counter() - t0:.1f} s')
    print(json.dumps(out))
    return 0


# the level sets and lanes per storm at which lanes_times builds and times
# the group units, and the first-segment steps on which it holds them
# against the twin
LANE_SETS = ('L5', 'L7', 'L15', 'L17')
LANE_COUNTS = (4, 8, 16, 32)
LANE_TWIN_STEPS = 7


@contextlib.contextmanager
def group_lanes_as(lanes):
    """Within the block, kernels/integrator.py builds and launches the
    group units with `lanes` lanes per storm (csrc/integrator.cu
    TC_K1_LANES, a library of its own) in place of group_lanes' count."""
    from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    saved = integrator.build, integrator.group_lanes
    integrator.build = lambda levels=2, diag=False: kbuild.library(
        'integrator', (('TC_K1_LEVELS', int(levels)),
                       ('TC_K1_DIAG', int(diag)), ('TC_K1_LANES', lanes)))
    integrator.group_lanes = lambda levels: lanes
    integrator._lib.cache_clear()
    try:
        yield
    finally:
        integrator.build, integrator.group_lanes = saved
        integrator._lib.cache_clear()


def lanes_times():
    """python3 chip_smoke.py --lanes: K1's and K7's group units built at
    each of LANE_COUNTS lanes per storm (TC_K1_LANES; all nvcc processes
    at once) for the level sets LANE_SETS, with each build's ptxas report
    of the default instances; per set one bench-width launch (caps
    auto-tuned) through the units at group_lanes' count, and then per lane
    count K1 on the launch's segments (event time, summed, as [levels4]
    times it) and K7 on its gate (device time, after an L2 flush), in
    TIME_ROUNDS rounds, lane counts in turn, and K1 on the first
    LANE_TWIN_STEPS steps of segment 0 and K7 held bit for bit against
    their twins.  Prints one JSON line; needs one card."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
    from tropical_cyclone_risk_tpu_torch.kernels import integrator
    from tropical_cyclone_risk_tpu_torch.models import pipeline, simulator
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke --lanes: no CUDA device')
    dev = torch.device('cuda', 0)
    card = card_line()
    sets = [(label, steer, key) for label, steer, key, _ in LEVEL_SETS
            if label in LANE_SETS]
    jobs = [(len(steer['steering_levels']), g) for _, steer, _ in sets
            for g in LANE_COUNTS]
    infos, errors = {}, []

    def nvcc(lv, g):
        try:
            infos[lv, g] = kbuild.library(
                'integrator', (('TC_K1_LEVELS', lv), ('TC_K1_DIAG', 0),
                               ('TC_K1_LANES', g)))
        except Exception as e:        # noqa: BLE001 — raised below
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=nvcc, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log(f'[lanes] {len(jobs)} nvcc processes at once: '
        f'{time.perf_counter() - t0:.1f} s')
    out = {'card': card, 'sets': {}}
    for label, steer, key in sets:
        lv = len(steer['steering_levels'])
        reps = {g: {fn: rep for fn, rep in ptxas_report(
            infos[lv, g]['log']).items()
            if fn in (f'integrate_group_kernel<{lv},0,0,0,0>',
                      f'genesis_group_kernel<{lv},0>')}
            for g in LANE_COUNTS}
        for g in LANE_COUNTS:
            log(f'[lanes] {label} G={g}: nvcc '
                f'{infos[lv, g]["seconds"]:.1f} s; {reps[g]}')
        cfg, pack, cfg_t = level_setup(dev, steer)
        rule = integrator.group_lanes(lv)
        with group_lanes_as(rule), launch_captures() as caps:
            pipeline._simulate_batch(rng.key(key), pack, cfg_t, BASIN,
                                     N_SEEDS, 64, cfg.start_month - 1)
        torch.cuda.synchronize()
        k1c, _, k7c, _, _ = caps
        args0 = k1c[0][0]
        short = args0[:7] + (min(args0[7], LANE_TWIN_STEPS),) + args0[8:]
        ref = uncounted(simulator.integrate_segment_plain, *short)
        g_args = k7c[0][0]
        gate_ref = uncounted(simulator.genesis_alive_plain, *g_args)
        times = {g: {'K1': [], 'K7': []} for g in LANE_COUNTS}
        exact = {}
        for g in LANE_COUNTS:
            with group_lanes_as(g):
                k1_same, diff = k1_exact(
                    uncounted(simulator.integrate_segment, *short), ref)
                k7_same = same(uncounted(simulator.genesis_alive, *g_args),
                               gate_ref)
                exact[g] = (k1_same, diff, k7_same)
        for _ in range(TIME_ROUNDS):
            for g in LANE_COUNTS:
                with group_lanes_as(g):
                    fns = [k1_launcher(a) for a, *_ in k1c]
                    times[g]['K1'].append(sum(k1_ms(f) for f in fns))
                    times[g]['K7'].append(device_ms(cold(
                        integrator.gate_launcher(*g_args)[0]), 20,
                        K7_KERNELS))
        bounds = {'K1': sum(k1_bound(a, o)[0] for a, _, o, _ in k1c),
                  'K7': k7_bound(g_args, k7c[0][2])[0]}
        res = {}
        for g in LANE_COUNTS:
            res[g] = {k: {'median': statistics.median(v), 'range':
                          [min(v), max(v)]} for k, v in times[g].items()}
            res[g].update(k1_exact=exact[g][0], k1_differs=exact[g][1],
                          k7_exact=exact[g][2], ptxas=reps[g],
                          nvcc_s=infos[lv, g]['seconds'])
            log(f'[lanes] {card}: {label} G={g}: K1 per launch '
                f'{res[g]["K1"]["median"]:.4f} ms {res[g]["K1"]["range"]}, '
                f'K7 {res[g]["K7"]["median"]:.4f} ms {res[g]["K7"]["range"]}'
                f' (bounds {bounds["K1"]:.4f}, {bounds["K7"]:.5f}); K1 '
                f'bit-exact against its twin on {short[7]} steps x '
                f'{short[3].lon.shape[0]} storms {exact[g][0]} '
                f'{exact[g][1] or ""}, K7 {exact[g][2]}')
        out['sets'][label] = {'levels': lv, 'rule_lanes': rule,
                              'bounds_ms': bounds, 'by_lanes': res,
                              'segments': [(a[7], a[3].lon.shape[0])
                                           for a, *_ in k1c]}
        del caps, k1c, k7c, pack, ref
        torch.cuda.empty_cache()
    print(json.dumps(out))
    bad = [(label, g) for label, r in out['sets'].items()
           for g, v in r['by_lanes'].items()
           if not (v['k1_exact'] and v['k7_exact'])]
    if bad:
        log(f'[lanes] not bit-exact against the twins: {bad}')
        return 1
    return 0


def ranks_cfg(out_dir):
    """The --ranks mode's namelist: the bench's seeds per launch over two
    years of the 24-plane pack, written under out_dir."""
    from tropical_cyclone_risk_tpu_torch.config import Namelist
    return Namelist(seed_batch=N_SEEDS, start_year=2016, end_year=2017,
                    output_directory=out_dir, exp_name='ranks')


RANKS_KEY = 71


def ranks_launch_ms(mesh, pack, cfg):
    """(median wall ms, all five) of one sharded launch on the mesh at the
    bench's width, caps tuned as run_downscaling tunes them."""
    from tropical_cyclone_risk_tpu_torch import rng
    from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
    from tropical_cyclone_risk_tpu_torch.parallel import sharding
    cfg_t = pipeline.auto_integrate_cap(rng.fold_in(rng.key(RANKS_KEY), 2016),
                                        pack, cfg, BASIN)
    pack_y = fields.slice_pack_year(pack, cfg, 0)
    return wall_ms(lambda: sharding.simulate_batch_sharded(
        mesh, rng.key(RANKS_KEY + 1), pack_y, cfg_t, BASIN, N_SEEDS, 64, 0))


def rank_worker(rank, n_ranks, port, out_dir):
    """One process of --ranks: rank `rank` of an NCCL group of n_ranks on
    card `rank` (LOCAL_RANK, as torchrun sets it), one shard of the global
    seed mesh; run_downscaling over two years on the mesh, counters reset
    just before and read just after, then the sharded launch's wall time;
    writes rank<r>.json into out_dir."""
    os.environ['LOCAL_RANK'] = str(rank)
    from tropical_cyclone_risk_tpu_torch import kernels, rng, runtime
    from tropical_cyclone_risk_tpu_torch.models import fields
    from tropical_cyclone_risk_tpu_torch.parallel import distributed
    distributed.initialize(f'localhost:{port}', n_ranks, rank)
    try:
        mesh = distributed.global_seed_mesh()
        cfg = ranks_cfg(out_dir)
        pack = fields.synthetic_pack(cfg, 24, 181, 360, seed=0,
                                     device=mesh.devices[0])
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        fn = runtime.run_downscaling(cfg, BASIN, pack,
                                     key=rng.key(RANKS_KEY), mesh=mesh)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_ON_CUDA)
        ms, ts = ranks_launch_ms(mesh, pack, cfg)
        with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
            json.dump({'rank': rank, 'backend': torch.distributed.get_backend(),
                       'mesh': [str(d) for d in mesh.devices],
                       'first': mesh.first, 'size': mesh.size, 'fn': fn,
                       'run_s': t_run, 'launches': launches, 'plain': plain,
                       'launch_ms': ms, 'launch_ms_all': ts}, f)
    finally:
        torch.distributed.destroy_process_group()


def ranks_times(n_ranks):
    """--ranks N: the seed mesh across N cards, one process each, in an
    NCCL group (rank_worker, spawned), against the same namelist and key
    on one process's N virtual shards on card 0: the tracks file bit for
    bit, every kernel launched in every rank and no twin; the sharded
    launch's wall time per rank beside the one-process mesh's and the
    one-device launch's.  Prints one JSON line, then the card line and
    the device line."""
    import tempfile
    from tropical_cyclone_risk_tpu_torch import rng, runtime
    from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
    from tropical_cyclone_risk_tpu_torch.parallel import sharding
    if not torch.cuda.is_available() or torch.cuda.device_count() < n_ranks:
        raise SystemExit(f'chip_smoke: --ranks {n_ranks} needs {n_ranks} '
                         f'cards')
    dev = torch.device('cuda', 0)
    card = card_line()
    with contextlib.redirect_stdout(sys.stderr):
        build_all(dev)
    out_dir = tempfile.mkdtemp()
    ctx = torch.multiprocessing.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=rank_worker,
                         args=(r, n_ranks, port, out_dir))
             for r in range(n_ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    t_ranks = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f'--ranks: exit codes {codes}')
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f'rank{r}.json')) as f:
            ranks.append(json.load(f))
    for res in ranks:
        check_counts(f'ranks, rank {res["rank"]}', res['launches'],
                     res['plain'], SIMULATION_KERNELS)
    fns = {res['fn'] for res in ranks}

    # the same namelist and key on one process's n virtual shards
    cfg = ranks_cfg(os.path.join(out_dir, 'one'))
    pack = fields.synthetic_pack(cfg, 24, 181, 360, seed=0, device=dev)
    mesh = sharding.local_mesh([dev] * n_ranks)
    fn_one = runtime.run_downscaling(cfg, BASIN, pack, key=rng.key(RANKS_KEY),
                                     mesh=mesh)
    diff = files_differ(ranks[0]['fn'], fn_one)
    ms_one_mesh, ts_one_mesh = ranks_launch_ms(mesh, pack, cfg)
    cfg_t = pipeline.auto_integrate_cap(rng.fold_in(rng.key(RANKS_KEY), 2016),
                                        pack, cfg, BASIN)
    pack_y = fields.slice_pack_year(pack, cfg, 0)
    ms_one, ts_one = wall_ms(lambda: pipeline._simulate_batch(
        rng.key(RANKS_KEY + 1), pack_y, cfg_t, BASIN, N_SEEDS, 64, 0))
    out = {'ranks': n_ranks, 'card': card, 'spawn_to_exit_s': t_ranks,
           'per_rank': [{k: res[k] for k in ('rank', 'backend', 'mesh',
                                              'first', 'size', 'run_s',
                                              'launch_ms', 'launch_ms_all')}
                        for res in ranks],
           'one_process_mesh_launch_ms': ms_one_mesh,
           'one_process_mesh_launch_ms_all': ts_one_mesh,
           'one_device_launch_ms': ms_one, 'one_device_launch_ms_all': ts_one,
           'file_differs': diff, 'paths': sorted(fns)}
    log(f'[ranks] {card}: {n_ranks} ranks (NCCL), each one card: file '
        f'against one process\'s {n_ranks} shards on one card differing '
        f'{diff or "none"}; launch ms per rank '
        f'{[round(r["launch_ms"], 2) for r in ranks]}, one-process mesh '
        f'{ms_one_mesh:.2f}, one device {ms_one:.2f}')
    if diff or len(fns) != 1 or any(r['backend'] != 'nccl' for r in ranks):
        raise AssertionError(f'--ranks: {diff} {fns}')
    print(json.dumps(out))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


# the field stacks' shapes of the benchmark's cells: (label, wind
# statistics, env channels); 12 planes of the one-degree grid, land and
# bathymetry in the cell row
STACK_SHAPES = (('dlm17.landfall', 629, 5), ('gl2.landfall', 14, 5))
STACK_REPS = 10


def stack_pack(n_wind, n_env, dev):
    """A FieldPack of 12 one-degree planes with n_wind wind statistics and
    n_env env channels of random values (the kernel copies), land and
    bathymetry on the atmospheric grid."""
    from tropical_cyclone_risk_tpu_torch.models import fields
    from tropical_cyclone_risk_tpu_torch.ops.interp import UniformGrid
    gen = torch.Generator(device=dev).manual_seed(n_wind)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)   # noqa
    grid = UniformGrid(0.0, 1.0, 360, -90.0, 1.0, 181)
    return fields.FieldPack(
        grid=grid, wind=rand(12, 181, 360, n_wind),
        env=rand(12, 181, 360, n_env), land_grid=grid, land=rand(181, 360),
        bathy_grid=grid, bathy=rand(181, 360), mask_grid=grid,
        basin_masks=rand(181, 360, 1), run_mask=rand(181, 360))


def stacks_res_usage(lib_path):
    """{the kernel's word type: 'REG r STACK s LOCAL l'} of each instance
    of stack_corners_kernel, by cuobjdump -res-usage (None without
    cuobjdump); its shared memory is the plan's, at run time."""
    import re
    text = cuobjdump('-res-usage', lib_path)
    if text is None:
        return None
    return {re.search(r'stack_corners_kernelI(\w+?)E', name).group(1):
            f'REG {reg} STACK {stack} LOCAL {local}'
            for name, reg, stack, local in re.findall(
                r'Function ([\w$]+):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ '
                r'LOCAL:(\d+)', text)
            if 'stack_corners_kernel' in name}


def stacks_times():
    """The field stacks at the benchmark cells' shapes on the card: the
    kernel on the cell row alone (device time under torch.profiler and
    CUDA-event time) beside its bytes bound, the three launches of one
    build_stacks, the plain twin (build_stacks_plain, all three outputs)
    and the cell row by PyTorch's cat chain (ops/interp.py pack_corners of
    torch.cat, the library yardstick), every output held bit for bit
    against the twin's, and each path's peak device memory; the kernel's
    registers (cuobjdump) and its plan.  One JSON line."""
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke --stacks-times: no CUDA device')
    from tropical_cyclone_risk_tpu_torch import kernels
    from tropical_cyclone_risk_tpu_torch.kernels import stacks as kstacks
    from tropical_cyclone_risk_tpu_torch.models import fields
    from tropical_cyclone_risk_tpu_torch.ops.interp import pack_corners
    dev = torch.device('cuda', 0)
    card = card_line()
    info = kstacks.build()
    res = {'card': card, 'nvcc_s': info['seconds'],
           'res_usage': stacks_res_usage(info['path']), 'shapes': {}}
    log(f'[stacks] {card}; nvcc {info["seconds"]:.1f} s; {res["res_usage"]}')
    for label, n_wind, n_env in STACK_SHAPES:
        pack = stack_pack(n_wind, n_env, dev)
        cell_src = fields.stack_sources(pack)[0]
        launch, cell4 = kstacks.launcher(cell_src)
        C = cell4.shape[-1] // 4
        pl = kstacks.plan(360, C)
        # the least bytes: every source float read once (land and
        # bathymetry once, not once a plane), every output float written
        # once
        by = nbytes(*cell_src, cell4)
        bound_ms = by / PEAK_BYTES * 1e3
        kernel_ms = device_ms(launch, STACK_REPS, ('stack_corners_kernel',))
        event_ms = cuda_ms(launch, STACK_REPS)
        launch = cell4 = None
        kernels.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = fields.build_stacks(pack)
        torch.cuda.synchronize()
        peak_kernel = torch.cuda.max_memory_allocated(dev) - base
        launches = kernels.LAUNCHES['stacks']
        all_by = sum(nbytes(*src, out) for src, out in zip(
            fields.stack_sources(pack),
            (got.cell4, got.land_geo4, got.bathy4)))
        build_ms = device_ms(lambda: fields.build_stacks(pack), STACK_REPS,
                             ('stack_corners_kernel',))
        got = (got.cell4, got.land_geo4, got.bathy4)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        want = uncounted(fields.build_stacks_plain, pack)
        torch.cuda.synchronize()
        peak_twin = torch.cuda.max_memory_allocated(dev) - base
        same_all = all(torch.equal(a, b) for a, b in zip(
            got, (want.cell4, want.land_geo4, want.bathy4)))
        want = None
        twin_ms = device_ms(lambda: uncounted(fields.build_stacks_plain,
                                              pack), 3)
        library_ms = device_ms(lambda: pack_corners(torch.cat(
            [pack.wind, pack.env, torch.stack([pack.land, pack.bathy], -1)
             [None].expand(12, 181, 360, 2)], -1)), 3)
        out = {'C': C, 'plan': pl._asdict(), 'bytes': by,
               'bound_ms': bound_ms, 'kernel_ms': kernel_ms,
               'kernel_event_ms': event_ms,
               'share_of_bound': bound_ms / kernel_ms,
               'build_stacks_ms': build_ms,
               'build_stacks_bound_ms': all_by / PEAK_BYTES * 1e3,
               'launches': launches, 'twin_ms': twin_ms,
               'library_ms': library_ms, 'bit_exact': same_all,
               'peak_bytes_kernel': peak_kernel,
               'peak_bytes_twin': peak_twin}
        res['shapes'][label] = out
        log(f'[stacks] {label}: C {C}, plan {tuple(pl)}; kernel '
            f'{kernel_ms:.4f} ms ({event_ms:.4f} event) against the bound '
            f'{bound_ms:.4f} ({100 * bound_ms / kernel_ms:.1f}%); '
            f'build_stacks {build_ms:.4f} ms in {launches} launches; twin '
            f'{twin_ms:.4f}, cat chain (cell row) {library_ms:.4f}; '
            f'bit-exact {same_all}; peak {peak_kernel / 1e9:.2f} GB against '
            f'the twin\'s {peak_twin / 1e9:.2f}')
        if not same_all or launches != 3:
            raise AssertionError(f'stacks {label}: bit-exact {same_all}, '
                                 f'{launches} launches')
        pack = got = None
        torch.cuda.empty_cache()
    print(json.dumps(res))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--kernel-times':
        sys.exit(kernel_times(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--gate-times':
        sys.exit(gate_times(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--drivers':
        sys.exit(drivers_times(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--ranks':
        sys.exit(ranks_times(int(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == '--sass':
        sys.exit(sass_against(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == '--lanes':
        sys.exit(lanes_times())
    if len(sys.argv) == 2 and sys.argv[1] == '--stacks-times':
        sys.exit(stacks_times())
    sys.exit(main())
