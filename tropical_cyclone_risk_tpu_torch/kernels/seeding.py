"""K3 wrapper: build csrc/seeding.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused propose_seeds and
retry_unresolved_curve; see the note at the top of the source.  The
dispatch lives in models/seeding.py, whose plain twins
(propose_seeds_plain, retry_unresolved_curve_plain) CPU tensors take.  The
parameter block holds every constant as the twin rounds it: the uniform
bounds as rng.uniform_params gives them, the thresholds and grid origins
as float32, the randint multiplier and split keys as rng.randint_params.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import kernels, rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import build as kbuild
from tropical_cyclone_risk_tpu_torch.models import fields as F
from tropical_cyclone_risk_tpu_torch.models import seeding
from tropical_cyclone_risk_tpu_torch.utils import basins

MAX_ROUNDS = 32          # csrc/seeding.cu MAX_ROUNDS
MAX_BASINS = 16          # csrc/seeding.cu MAX_BASINS
MODES = {'propose': 0, 'propose_caps': 1, 'curve': 2}
N_OUT = 11               # outputs of tc_propose_seeds (SeedProposal)


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('seeding')


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build()['path'])).tc_propose_seeds
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (9 + N_OUT + 1)
    fn.restype = ctypes.c_int
    return fn


def _f32(x) -> float:
    return float(np.float32(x))


def params(key: rng.Key, pack: F.FieldPack, cfg: Namelist, basin_id: str,
           n: int, plane_offset: int):
    """(keys uint32 [14], dparams float64 [10], fparams float32 [51],
    iparams int64 [15 + MAX_ROUNDS]) in the order csrc/seeding.cu reads
    them."""
    R = seeding.N_RETRY_ROUNDS
    n_basins = pack.basin_masks.shape[-1]
    powers = cfg.lat_vort_power_by_basin()
    h_bls = cfg.h_bl_by_basin()
    if not (R <= MAX_ROUNDS and n_basins <= MAX_BASINS
            and len(powers) == len(h_bls) == n_basins):
        raise ValueError(f'seeding kernel: {R} rounds, {n_basins} basin '
                         f'masks, {len(powers)} basin powers')
    b = basins.basin_bounds(cfg, basin_id)
    k_lon, k_lat0, k_latr, k_month, k_reject, k_vinit = rng.split(key, 6)
    (k_m1, k_m2), m_span, m_mult = rng.randint_params(k_month, 1, 13)
    keys = np.array([w for k in (k_lon, k_lat0, k_latr, k_m1, k_m2, k_reject,
                                 k_vinit) for w in k], np.uint32)
    dp = np.array([*rng.uniform_params(b[0], b[2]),
                   *rng.uniform_params(*seeding.lat0_bounds(b)),
                   *rng.uniform_params(b[1], b[3]),
                   *rng.uniform_params(0.0, 1.0),
                   *rng.uniform_params(rng.NORMAL_LO, 1.0)], np.float64)
    mg, eg = pack.mask_grid, pack.grid
    pad = lambda xs: list(xs) + [0.0] * (MAX_BASINS - len(xs))
    fp = np.array([_f32(x) for x in (
        180.0 / math.pi, seeding.MASK_PASS, seeding.BASIN_MIN,
        seeding.VPOT_GATE, mg.lon0, mg.dlon, mg.lat0, mg.dlat,
        eg.lon0, eg.dlon, eg.lat0, eg.dlat, cfg.lat_vort_fac,
        seeding.LAT_VORT_SCALE, cfg.seed_v_init_ms, cfg.m_init_mid,
        cfg.m_init_slope, cfg.m_init_amp, cfg.m_init_base,
        *pad(powers), *pad(h_bls))], np.float32)
    widths = ([n] + seeding.retry_widths(cfg, n)
              if cfg.seed_retry_caps is not None else [n] * R)
    ip = np.array([n, R, mg.nlon, mg.nlat, eg.nlon, eg.nlat, n_basins,
                   pack.env.shape[-1], F.VPOT, F.RH, pack.env.shape[0],
                   int(plane_offset) - cfg.start_month, m_span, m_mult, 1,
                   *widths, *[n] * (MAX_ROUNDS - len(widths))], np.int64)
    return keys, dp, fp, ip


def _fields(pack: F.FieldPack):
    """(device, [run_mask, basin_masks, env] contiguous), checked against
    the grids the kernel indexes them by."""
    dev = pack.env.device
    if dev.type != 'cuda':
        raise ValueError(f'seeding kernel needs CUDA tensors, got {dev}')
    mg, eg = pack.mask_grid, pack.grid
    lead = {'run_mask': (mg.nlat, mg.nlon), 'basin_masks': (mg.nlat, mg.nlon),
            'env': (pack.env.shape[0], eg.nlat, eg.nlon)}
    out = []
    for name, shape in lead.items():
        t = getattr(pack, name)
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape[:len(shape)]) != shape:
            raise ValueError(f'{name}: need float32 {shape} on {dev}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
        out.append(t.contiguous())
    if pack.env.shape[-1] <= max(F.VPOT, F.RH):
        raise ValueError(f'env: {pack.env.shape[-1]} channels')
    return dev, out


def launcher(mode: str, key, pack: F.FieldPack, cfg: Namelist,
             basin_id: str, n: int, plane_offset: int, outs):
    """A function that launches K3 once in ``mode`` ('propose',
    'propose_caps' or 'curve') on these inputs, writing ``outs`` (the 11
    SeedProposal tensors, or Nones for 'curve'), and returns the histogram
    [R + 1] of the full-width first passing rounds.  The parameter block,
    the field checks and the scratch are made here, once."""
    dev, (run_mask, basin_masks, env) = _fields(pack)
    keys, dp, fp, ip = params(key, pack, cfg, basin_id, n, plane_offset)
    first = torch.empty((n if mode == 'propose_caps' else 0,),
                        dtype=torch.int32, device=dev)
    hist = torch.empty((seeding.N_RETRY_ROUNDS + 1,), dtype=torch.int32,
                       device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (MODES[mode], keys.ctypes.data, dp.ctypes.data, fp.ctypes.data,
            ip.ctypes.data, run_mask.data_ptr(), basin_masks.data_ptr(),
            env.data_ptr(), ptr(first), hist.data_ptr(),
            *(ptr(t) for t in outs))
    fn = _entry()

    def launch():
        if mode != 'propose':           # the histogram is scratch there
            hist.zero_()
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f'seeding kernel ({mode}) launch failed: '
                               f'CUDA error {err}')
        kernels.LAUNCHES['seeding'] += 1
        return hist
    # what the pointers point to lives as long as the launcher
    launch.buffers = (keys, dp, fp, ip, run_mask, basin_masks, env, first,
                      outs)
    return launch


def propose_seeds_cuda(key: rng.Key, pack: F.FieldPack, cfg: Namelist,
                       basin_id: str, n: int, plane_offset: int = 0):
    """Launch K3: the 11 fields of a SeedProposal for n slots, exactly as
    models/seeding.py propose_seeds_plain."""
    dev = pack.env.device
    dtypes = (torch.float32, torch.float32, torch.int32, torch.int64,
              torch.bool, torch.bool, torch.bool, torch.float32,
              torch.float32, torch.float32, torch.int64)
    outs = [torch.empty((n,), dtype=d, device=dev) for d in dtypes]
    if n > 0:
        mode = 'propose' if cfg.seed_retry_caps is None else 'propose_caps'
        launcher(mode, key, pack, cfg, basin_id, n, plane_offset, outs)()
    return outs


def retry_unresolved_curve_cuda(key: rng.Key, pack: F.FieldPack,
                                cfg: Namelist, basin_id: str,
                                n: int) -> np.ndarray:
    """Launch K3's histogram pass: [R] slots still unresolved after each
    round, those whose full-width first passing round is later (a slot
    that never passes counts as round R)."""
    R = seeding.N_RETRY_ROUNDS
    if n == 0:
        return np.zeros((R,), np.int64)
    hist = launcher('curve', key, pack, cfg, basin_id, n, 0,
                    [None] * N_OUT)().cpu().numpy().astype(np.int64)
    return np.cumsum(hist[::-1])[::-1][1:]
