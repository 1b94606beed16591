"""K2: the vmax diagnostic pass as a Triton kernel.

Replaces the XLA-fused pass of the JAX package (models/diagnostics.py:193
axi_to_max_wind_raw with :83 _translation_tm and :69 _vmax_from_inc,
called at models/pipeline.py:415 and per segment at :541).  Its plain twin
is models/diagnostics.py axi_to_max_wind_raw_plain.

Work layout: one program per block of storms, looping over time.  A
program keeps the previous and current rows of lon/lat in registers and
loads the next, so every row is read once, contiguously across the storm
axis; the centered difference, each track's last-sample edge extrapolation
(last_step, pos_before / pos_after) and the alive-masked lifetime peak all
happen in that one pass.

What bounds it on this card: memory.  Per (step, storm) it reads 33 bytes
(lon, lat, v, 4 winds, alive) and writes 4 (vmax), against ~40 float
operations, far below the card's ~20 operations per byte.  Hence one pass
with no intermediate buffers, instead of the ~30 elementwise torch ops
(each a full read and write of [T, N]) of the plain twin.  Triton serves as
well as CUDA here: the pass has no matrix product, no shared-memory staging
and no dependence between blocks.

Numerics: the kernel is compiled without contracting a*b+c into fused
multiply-adds (enable_fp_fusion=False), as the plain twin's separate torch
kernels round: the zonal chord differences two longitudes of ~3 radians,
and a contracted product there moves ut by up to 1e-3 m/s.  sin, cos,
tanh, sqrt and division come from libdevice (CUDA's
accurate libm and IEEE round-to-nearest), not Triton's hardware
approximations: the approximate sine's absolute error is large against the
tiny half-step angles of the zonal chord.  Divisions are true divisions as
in the JAX package, where torch's CUDA kernels multiply by the reciprocal
of a Python-scalar divisor, so vmax agrees with the plain twin to a few
ulps, inside the JAX package's own width-dependent noise (atol 1e-4,
tests/test_pipeline_stats.py).

This module must import where triton is absent, so triton is imported, and
the kernel defined, at the first launch.
"""

import functools

import torch

from tropical_cyclone_risk_tpu_torch import kernels

BLOCK = 256
# triton.language and its libdevice bindings, bound at the first launch (the
# kernel body reads them as globals, see _kernel)
tl = None
libdevice = None


@functools.cache
def _kernel():
    global tl, libdevice
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _vmax_kernel(lon_ptr, lat_ptr, v_ptr, w_ptr, alive_ptr, last_ptr,
                     before_ptr, after_ptr, vmax_ptr, peak_ptr, T, N,
                     dt_s, km2, deg2rad,
                     IU2: tl.constexpr, IV2: tl.constexpr,
                     IU8: tl.constexpr, IV8: tl.constexpr,
                     HAS_BEFORE: tl.constexpr, HAS_AFTER: tl.constexpr,
                     BLOCK: tl.constexpr):
        n = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        msk = n < N
        last = tl.load(last_ptr + n, mask=msk, other=-1)
        cur_lon = tl.load(lon_ptr + n, mask=msk, other=0.0)
        cur_lat = tl.load(lat_ptr + n, mask=msk, other=0.0)
        # neighbour before row 0, and the extrapolation base of a track
        # whose last sample is row 0
        if HAS_BEFORE:
            prev_lon = tl.load(before_ptr + n, mask=msk, other=0.0)
            prev_lat = tl.load(before_ptr + N + n, mask=msk, other=0.0)
            base_lon = prev_lon
            base_lat = prev_lat
        else:
            prev_lon = 2 * cur_lon - tl.load(lon_ptr + N + n, mask=msk,
                                             other=0.0)
            prev_lat = 2 * cur_lat - tl.load(lat_ptr + N + n, mask=msk,
                                             other=0.0)
            base_lon = cur_lon
            base_lat = cur_lat
        if HAS_AFTER:
            end_lon = tl.load(after_ptr + n, mask=msk, other=0.0)
            end_lat = tl.load(after_ptr + N + n, mask=msk, other=0.0)
        peak = tl.full([BLOCK], float('-inf'), tl.float32)
        for t in range(0, T):
            has_next = t + 1 < T
            nxt_lon = tl.load(lon_ptr + (t + 1) * N + n,
                              mask=msk & has_next, other=0.0)
            nxt_lat = tl.load(lat_ptr + (t + 1) * N + n,
                              mask=msk & has_next, other=0.0)
            if HAS_AFTER:
                a_lon = tl.where(has_next, nxt_lon, end_lon)
                a_lat = tl.where(has_next, nxt_lat, end_lat)
            else:
                a_lon = tl.where(has_next, nxt_lon, cur_lon)
                a_lat = tl.where(has_next, nxt_lat, cur_lat)
            # each track's last valid sample: linear edge extrapolation
            is_last = last == t
            p_lon = tl.where(t == 0, base_lon, prev_lon)
            p_lat = tl.where(t == 0, base_lat, prev_lat)
            b_lon = tl.where(is_last, p_lon, prev_lon)
            b_lat = tl.where(is_last, p_lat, prev_lat)
            a_lon = tl.where(is_last, cur_lon + (cur_lon - p_lon), a_lon)
            a_lat = tl.where(is_last, cur_lat + (cur_lat - p_lat), a_lat)

            # diagnostics._translation_tm
            s = libdevice.cos(cur_lat * deg2rad) * tl.abs(
                libdevice.sin((b_lon * deg2rad - a_lon * deg2rad) * 0.5))
            s2 = s * s
            hav_lon = km2 * (s * (1.0 + s2 * (0.16666666666666666
                                              + s2 * 0.075)))
            hav_lat = km2 * tl.abs((b_lat * deg2rad - a_lat * deg2rad) * 0.5)
            d_lon = a_lon - b_lon
            d_lat = a_lat - b_lat
            sg_lon = tl.where(d_lon > 0, 1.0, tl.where(d_lon < 0, -1.0, 0.0))
            sg_lat = tl.where(d_lat > 0, 1.0, tl.where(d_lat < 0, -1.0, 0.0))
            ut = libdevice.div_rn(0.5 * (sg_lon * hav_lon) * 1000.0, dt_s)
            vt = libdevice.div_rn(0.5 * (sg_lat * hav_lat) * 1000.0, dt_s)

            # diagnostics.vmax_step
            row = t * N + n
            v = tl.load(v_ptr + row, mask=msk, other=0.0)
            w_row = w_ptr + row * 4
            u_shr = (tl.load(w_row + IU2, mask=msk, other=0.0)
                     - tl.load(w_row + IU8, mask=msk, other=0.0))
            v_shr = (tl.load(w_row + IV2, mask=msk, other=0.0)
                     - tl.load(w_row + IV8, mask=msk, other=0.0))
            x = libdevice.div_rn(cur_lat - 35.0, 10.0)
            G = tl.minimum(0.8 + 0.35 * (1.0 + libdevice.tanh(x)), 1.0,
                           propagate_nan=tl.PropagateNan.ALL)
            U_inc = G * ut + libdevice.div_rn(0.1 * u_shr * v, 15.0)
            V_inc = G * vt + libdevice.div_rn(0.1 * v_shr * v, 15.0)
            mag = libdevice.sqrt_rn(U_inc * U_inc + V_inc * V_inc)
            vmax = v + tl.minimum(mag, 0.5 * v,
                                  propagate_nan=tl.PropagateNan.ALL)
            tl.store(vmax_ptr + row, vmax, mask=msk)
            alive = tl.load(alive_ptr + row, mask=msk, other=0) != 0
            peak = tl.maximum(peak, tl.where(alive, vmax, float('-inf')),
                              propagate_nan=tl.PropagateNan.ALL)

            prev_lon = cur_lon
            prev_lat = cur_lat
            cur_lon = nxt_lon
            cur_lat = nxt_lat
        tl.store(peak_ptr + n, peak, mask=msk)

    return _vmax_kernel


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous {dtype} tensor on '
                         f'{device}, got {t.dtype} on {t.device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)} != {tuple(shape)}')


def axi_to_max_wind_raw_triton(lon, lat, dt_track, tc_v, env_wnds, alive,
                               last_step, shear_channels, pos_before=None,
                               pos_after=None):
    """Launch K2: (vmax [T, N], peak [N]) exactly as
    models/diagnostics.py axi_to_max_wind_raw_plain."""
    from tropical_cyclone_risk_tpu_torch.models.diagnostics import (
        DEG2RAD, KM2)
    dev = lon.device
    if dev.type != 'cuda':
        raise ValueError(f'vmax kernel needs CUDA tensors, got {dev}')
    T, N = lon.shape
    f32 = torch.float32
    for name, t in (('lon', lon), ('lat', lat), ('tc_v', tc_v)):
        _check(name, t, f32, (T, N), dev)
    _check('env_wnds', env_wnds, f32, (T, N, 4), dev)
    _check('alive', alive, torch.bool, (T, N), dev)
    last = last_step.to(torch.int32).contiguous()
    _check('last_step', last, torch.int32, (N,), dev)
    for name, p in (('pos_before', pos_before), ('pos_after', pos_after)):
        if p is not None:
            _check(name, p, f32, (2, N), dev)
    if T < 2 and pos_before is None:
        raise ValueError('the start-edge extrapolation needs two rows')
    vmax = torch.empty((T, N), dtype=f32, device=dev)
    peak = torch.empty((N,), dtype=f32, device=dev)
    if N == 0:
        return vmax, peak
    iu2, iv2, iu8, iv8 = shear_channels
    with torch.cuda.device(dev):
        _kernel()[((N + BLOCK - 1) // BLOCK,)](
            lon, lat, tc_v, env_wnds, alive.view(torch.uint8), last,
            lon if pos_before is None else pos_before,
            lon if pos_after is None else pos_after,
            vmax, peak, T, N, float(dt_track), KM2, DEG2RAD,
            IU2=iu2, IV2=iv2, IU8=iu8, IV8=iv8,
            HAS_BEFORE=pos_before is not None,
            HAS_AFTER=pos_after is not None, BLOCK=BLOCK, num_warps=4,
            enable_fp_fusion=False)
    kernels.LAUNCHES['vmax'] += 1
    return vmax, peak
