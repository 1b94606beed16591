"""K3 wrapper: build csrc/seeding.cu with nvcc (kernels/build.py), bind it
with ctypes and launch it on PyTorch's current stream.

The kernel replaces the JAX package's XLA-fused propose_seeds and
retry_unresolved_curve; see the note at the top of the source.  The
dispatch lives in models/seeding.py, whose plain twins
(propose_seeds_plain, retry_unresolved_curve_plain) CPU tensors take.  The
parameter block holds every constant as the twin rounds it: the uniform
bounds as rng.uniform_params gives them, the thresholds and grid origins
as float32, the randint span and multiplier as rng.randint_span.  The
stream keys are not in it: the kernel derives them from the call's key.

A thin dispatcher: the parameter block, the field checks, the contiguous
fields and the scratch are made once for each (pack's fields, cfg, basin,
n, plane_offset, stream) and kept while the pack's fields live (a
launcher holds none of the pack's own tensors, and goes when the first of
them is freed); a call allocates its 11 outputs as views of one arena and
launches one kernel with the key's two words.  The scratch (histogram,
counter, lists) is left zeroed by the kernel itself, so each launcher
launches on the one stream it was made for, and its launches run in
order there.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import weakref

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
THREADS = 256            # csrc/seeding.cu THREADS
# the SeedProposal fields in the arena, widest first so that every view is
# aligned to its type
ARENA = (('basin_idx', torch.int64), ('plane', torch.int64),
         ('lon', torch.float32), ('lat', torch.float32),
         ('month', torch.int32), ('v_init', torch.float32),
         ('m_init', torch.float32), ('h_bl', torch.float32),
         ('counted', torch.bool), ('integrate', torch.bool),
         ('dropped', torch.bool))


def arena_layout(n: int):
    """(byte sizes in ARENA's order, {field: byte offset}) of the arena of
    n slots."""
    sizes = [n * d.itemsize for _, d in ARENA]
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    return sizes, dict(zip((f for f, _ in ARENA), offsets))


def arena_views(arena: torch.Tensor, n: int) -> list:
    """The 11 SeedProposal tensors of n slots as views of a uint8 arena,
    in SeedProposal's order."""
    sizes, _ = arena_layout(n)
    views = {f: part.view(d) for (f, d), part in
             zip(ARENA, arena.split(sizes))}
    return [views[f] for f in seeding.SeedProposal._fields]


def build() -> dict:
    """Build (or find) the kernel library; see kernels/build.py."""
    return kbuild.library('seeding')


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build()['path'])).tc_propose_seeds
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_uint32] * 2 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _f32(x) -> float:
    return float(np.float32(x))


def params(pack: F.FieldPack, cfg: Namelist, basin_id: str, n: int,
           plane_offset: int):
    """(dparams float64 [10], fparams float32 [51], iparams int64
    [15 + MAX_ROUNDS]) in the order csrc/seeding.cu reads them."""
    R = seeding.N_RETRY_ROUNDS
    n_basins = pack.basin_masks.shape[-1]
    powers = cfg.lat_vort_power_by_basin()
    h_bls = cfg.h_bl_by_basin()
    if not (R <= MAX_ROUNDS and n_basins <= MAX_BASINS
            and len(powers) == len(h_bls) == n_basins):
        raise ValueError(f'seeding kernel: {R} rounds, {n_basins} basin '
                         f'masks, {len(powers)} basin powers')
    b = basins.basin_bounds(cfg, basin_id)
    m_span, m_mult = rng.randint_span(1, 13)
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
    return dp, fp, ip


def _device(pack: F.FieldPack) -> torch.device:
    dev = pack.env.device
    if dev.type != 'cuda':
        raise ValueError(f'seeding kernel needs CUDA tensors, got {dev}')
    return dev


def _fields(pack: F.FieldPack):
    """[run_mask, basin_masks, env] contiguous, checked against the grids
    the kernel indexes them by."""
    dev = _device(pack)
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
    return out


def _pack_fields(pack: F.FieldPack) -> tuple:
    """The pack's tensors the kernel reads, in _fields' order."""
    return pack.run_mask, pack.basin_masks, pack.env


class Launcher:
    """K3 on one (pack, cfg, basin_id, n, plane_offset) and one stream: the
    parameter block, the checked fields and the scratch, made once.
    ``curve``: the histogram pass of retry_unresolved_curve, no outputs.
    Calling it with a key (and, unless ``curve``, an arena from
    ``outputs``) launches the kernel once on ``stream``, which must be the
    current stream."""

    def __init__(self, pack: F.FieldPack, cfg: Namelist, basin_id: str,
                 n: int, plane_offset: int, stream: int,
                 curve: bool = False):
        self.cfg = cfg       # held, so that id(cfg) names it while kept
        self.dev = dev = _device(pack)
        self.stream = stream
        if not 0 < n < 2 ** 31:
            raise ValueError(f'seeding kernel: {n} slots')
        self.n = n
        fields = _fields(pack)
        # only the copies _fields made: the pack's own tensors are not
        # held, so that the pack, and this launcher with it, can go
        self.copies = [c for c, t in zip(fields, _pack_fields(pack))
                       if c is not t]
        self.finalizers = []
        self.blocks = params(pack, cfg, basin_id, n, plane_offset)
        R = seeding.N_RETRY_ROUNDS
        caps = cfg.seed_retry_caps is not None and not curve
        i32 = dict(dtype=torch.int32, device=dev)
        n_blocks = -(-n // THREADS)
        # hist and count start at zero and the kernel leaves them so
        self.hist = torch.zeros((R + 1,), **i32) if caps or curve else None
        self.count = torch.zeros((1,), **i32) if caps or curve else None
        self.cand = torch.empty((n_blocks * THREADS, 2), **i32) \
            if caps else None
        self.n_cand = torch.empty((n_blocks,), **i32) if caps else None
        self.ge = torch.empty(((MAX_ROUNDS + 1) * THREADS,), **i32) \
            if caps else None
        self.curve = torch.empty((R,), **i32) if curve else None
        sizes, at = arena_layout(n)
        self.arena_bytes = sum(sizes)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        self.ptrs = np.array(
            [t.data_ptr() for t in fields]
            + [ptr(t) for t in (self.hist, self.count, self.cand,
                                self.n_cand, self.ge, self.curve)]
            + [at[f] for f in seeding.SeedProposal._fields], np.int64)
        self.args = tuple(a.ctypes.data for a in (*self.blocks, self.ptrs))
        self.fn = _entry()

    def outputs(self):
        """(arena, the 11 SeedProposal tensors as views of it)."""
        arena = torch.empty((self.arena_bytes,), dtype=torch.uint8,
                            device=self.dev)
        return arena, arena_views(arena, self.n)

    def __call__(self, key: rng.Key, arena=None) -> None:
        dev = self.dev
        guard = (contextlib.nullcontext()
                 if torch.cuda.current_device() == dev.index
                 else torch.cuda.device(dev))
        with guard:
            if torch.cuda.current_stream(dev).cuda_stream != self.stream:
                raise RuntimeError('seeding launcher called on another '
                                   'stream than its own: its scratch would '
                                   'race')
            err = self.fn(*self.args, key.k0, key.k1,
                          None if arena is None else arena.data_ptr(),
                          self.stream)
        if err != 0:
            raise RuntimeError(f'seeding kernel launch failed: CUDA error '
                               f'{err}')
        kernels.LAUNCHES['seeding'] += 1


# the kept launchers, each until the first of its pack's fields is freed
_LAUNCHERS: dict = {}


def _evict(tag) -> None:
    lau = _LAUNCHERS.pop(tag, None)
    if lau is not None:
        for fin in lau.finalizers:
            fin.detach()


def launcher(pack: F.FieldPack, cfg: Namelist, basin_id: str, n: int,
             plane_offset: int = 0, curve: bool = False) -> Launcher:
    """The kept Launcher of these inputs on the current stream, made on
    first use.  It is dropped when any of the pack's run_mask, basin_masks
    or env is freed: a year's pack from fields.slice_pack_year takes its
    launchers with it."""
    dev = _device(pack)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tag = (*map(id, _pack_fields(pack)), id(cfg), basin_id, n,
           int(plane_offset), curve, stream)
    lau = _LAUNCHERS.get(tag)
    if lau is None:
        lau = Launcher(pack, cfg, basin_id, n, plane_offset, stream, curve)
        # a field's id names it until it is freed, and then the entry goes
        lau.finalizers = [weakref.finalize(t, _evict, tag)
                          for t in _pack_fields(pack)]
        _LAUNCHERS[tag] = lau
    return lau


def propose_seeds_cuda(key: rng.Key, pack: F.FieldPack, cfg: Namelist,
                       basin_id: str, n: int, plane_offset: int = 0):
    """Launch K3: the 11 fields of a SeedProposal for n slots, exactly as
    models/seeding.py propose_seeds_plain."""
    dev = _device(pack)
    if n == 0:
        return [torch.empty((0,), dtype=dict(ARENA)[f], device=dev)
                for f in seeding.SeedProposal._fields]
    lau = launcher(pack, cfg, basin_id, n, plane_offset)
    arena, outs = lau.outputs()
    lau(key, arena)
    return outs


def retry_unresolved_curve_cuda(key: rng.Key, pack: F.FieldPack,
                                cfg: Namelist, basin_id: str,
                                n: int) -> np.ndarray:
    """Launch K3's histogram pass: [R] slots still unresolved after each
    round, those whose full-width first passing round is later (a slot
    that never passes counts as round R)."""
    _device(pack)
    if n == 0:
        return np.zeros((seeding.N_RETRY_ROUNDS,), np.int64)
    lau = launcher(pack, cfg, basin_id, n, 0, curve=True)
    lau(key)
    return lau.curve.cpu().numpy().astype(np.int64)
