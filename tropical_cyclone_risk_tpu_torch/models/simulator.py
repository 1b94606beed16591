"""Batched fixed-step track integration (twin of
tropical_cyclone_risk_tpu/models/simulator.py).

Per storm: hourly RK4 steps of the coupled FAST + beta-advection ODEs with
alive-mask termination (leaving the basin with a 1-degree margin, |lat| <= 2
or v <= 4 m/s, coupled_fast.py:246-256); dead storms freeze in place.

``integrate_segment`` is the hot loop.  On a CUDA tensor it launches the
hand-written integrator kernel (kernels/integrator.py, csrc/integrator.cu),
which keeps each storm's state in registers across the whole segment; on a
CPU tensor it runs ``integrate_segment_plain``, the same arithmetic as a
Python loop of torch ops (``lax.scan`` in the JAX package).  With a
``DiagState`` carry (Namelist.vmax_in_scan) both also compute each step's
vmax and the running lifetime peak (``_diag_step``).  The genesis gate
``genesis_alive`` dispatches the same way, to the same file's gate kernel
or to ``genesis_alive_plain``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import diagnostics, fast
from tropical_cyclone_risk_tpu_torch.models import fields as fields_mod
from tropical_cyclone_risk_tpu_torch.models.fields import (FieldPack,
                                                           GatherStacks)
from tropical_cyclone_risk_tpu_torch.utils import basins


class TrackOutput(NamedTuple):
    """Seed-major buffers [N, n_steps] (winds [N, n_steps, W]), NaN after
    each storm's death: the reference's output contract."""
    lon: torch.Tensor
    lat: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    wnds: torch.Tensor
    alive: torch.Tensor       # [N, n_steps] bool: sample validity
    last_step: torch.Tensor   # [N] index of last valid sample


class RawTracks(NamedTuple):
    """Time-major unmasked buffers [n_steps, N] (winds [n_steps, N, W]):
    samples past a storm's death hold the frozen death state."""
    lon: torch.Tensor
    lat: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    wnds: torch.Tensor
    alive: torch.Tensor       # [n_steps, N] bool: sample validity
    last_step: torch.Tensor   # [N] index of last valid sample


class DiagState(NamedTuple):
    """In-scan vmax carry (Namelist.vmax_in_scan): the previous output
    sample's position (the centred difference's left neighbour) and the
    running alive-masked lifetime vmax peak, which excludes each track's
    final valid sample (diagnostics.fix_last_sample re-derives that one)."""
    prev_lon: torch.Tensor    # [N]
    prev_lat: torch.Tensor    # [N]
    peak: torch.Tensor        # [N], -inf at the start


def analytic_fourier(cfg: Namelist) -> bool:
    """Whether F(t) is evaluated analytically at each RK stage or substep
    time (rk_exact_stage_fields, rk_substeps > 1) instead of streamed from
    the per-step grid (fourier_grid)."""
    return bool(cfg.rk_exact_stage_fields) or int(cfg.rk_substeps) > 1


def _f32(x) -> float:
    return float(np.float32(x))


def _step_time(k: int, dt_out: float) -> float:
    """Track time of output sample k, float32(k) * dt_out in float32."""
    return float(np.float32(k) * np.float32(dt_out))


def _events_alive(cfg: Namelist, bounds, y: fast.State):
    """Continuation condition (coupled_fast.py:246-256)."""
    in_b = basins.in_basin(y.lon, y.lat, bounds, 1.0)
    return in_b & (torch.abs(y.lat) > 2.0) & (y.v > 4.0)


def _rk4_step(rhs_fn, t: float, y: fast.State, dt: float):
    """Classical RK4 from time t (stage times in float32, as the JAX
    package adds them); returns (y1, winds of the first stage)."""
    k1, wnds = rhs_fn(t, y)
    add = lambda a, ka, h: fast.State(*(x + h * dx for x, dx in zip(a, ka)))
    t_half = _f32(t + _f32(dt / 2))
    k2, _ = rhs_fn(t_half, add(y, k1, dt / 2))
    k3, _ = rhs_fn(t_half, add(y, k2, dt / 2))
    k4, _ = rhs_fn(_f32(t + _f32(dt)), add(y, k3, dt))
    y1 = fast.State(*(x + dt / 6 * (a + 2 * b + 2 * c + d)
                      for x, a, b, c, d in zip(y, k1, k2, k3, k4)))
    return y1, wnds


def _rk4_step_frozen_fields(stacks, cfg, params, t: float, y: fast.State,
                            dt, f_t=None):
    """RK4 step with one field gather and one wind coloring at the step
    start; f_t is the step's Fourier sample F(t) [N, W], evaluated
    analytically when None."""
    smp = fast.sample_fields_at_time(stacks, cfg, y.lon, y.lat,
                                     params.plane, t)
    drv = fast.derive_sample(cfg, smp)
    if f_t is None:
        f_t = params.fourier.evaluate_in_order(t)
    wnds = fast.color_winds_given_f(cfg, smp.wind_stats, f_t)
    return _rk4_step(lambda tt, yy: fast.rhs_given_winds(
        cfg, yy, params, smp, wnds, drv), t, y, dt)


def _advance(cfg, bounds, y, y_next, alive):
    """Freeze dead storms and apply the termination events."""
    y1 = fast.State(*(torch.where(alive, a, b) for a, b in zip(y_next, y)))
    return y1, alive & _events_alive(cfg, bounds, y1)


def _diag_step(cfg, dstate: DiagState, y: fast.State, y1: fast.State, wnds0,
               alive, alive1, k: int, t_last: int, dt_out: float):
    """One in-scan vmax sample: the centred-difference translation between
    the carried previous position and the post-step position y1 (frozen for
    dead storms, as the output buffer records it at k+1), then the closed
    form.  At the global first sample the left neighbour is the start-edge
    extrapolation 2 pos[0] - pos[1].  The running peak takes every valid
    sample but a track's final one: a storm that dies in this step, or the
    run's last output row (k == t_last)."""
    if k == 0:
        p_lon, p_lat = 2.0 * y.lon - y1.lon, 2.0 * y.lat - y1.lat
    else:
        p_lon, p_lat = dstate.prev_lon, dstate.prev_lat
    ut, vt = diagnostics._translation_tm(y.lon, y.lat, p_lon, p_lat, y1.lon,
                                         y1.lat, dt_out)
    vmax_k = diagnostics.vmax_step(cfg, y.lat, y.v, wnds0, ut, vt)
    incl = alive & alive1 if k != t_last else torch.zeros_like(alive)
    peak = torch.maximum(dstate.peak, torch.where(incl, vmax_k, -math.inf))
    return vmax_k, DiagState(y.lon, y.lat, peak)


def _record(outs, y, wnds, alive, y1, alive1, cfg, dstate, k, t_last,
            dt_out):
    """Append sample k (and its in-scan vmax with a DiagState carry) to
    outs; returns the carry's DiagState."""
    out = (y.lon, y.lat, y.v, y.m, wnds, alive)
    if dstate is not None:
        vmax_k, dstate = _diag_step(cfg, dstate, y, y1, wnds, alive, alive1,
                                    k, t_last, dt_out)
        out = out + (vmax_k,)
    outs.append(out)
    return dstate


def _integrate_blocks(stacks, cfg, bounds, y, alive, params, f_all, k0: int,
                      n_blocks: int, stride: int, dt: float, dstate=None,
                      t_last: int = -1):
    """Strided steps: one field gather at each block's start position and
    time, reused for the block's `stride` steps; the Fourier flow, wind
    coloring and ODEs stay per step.  Records the colored winds."""
    outs = []
    for b in range(n_blocks):
        t0 = _step_time(k0 + b * stride, dt)
        smp = fast.sample_fields_at_time(stacks, cfg, y.lon, y.lat,
                                         params.plane, t0)
        drv = fast.derive_sample(cfg, smp)
        for j in range(stride):
            wnds = fast.color_winds_given_f(cfg, smp.wind_stats,
                                            f_all[b * stride + j])
            y_next, _ = _rk4_step(
                lambda tt, yy, w=wnds: fast.rhs_given_winds(
                    cfg, yy, params, smp, w, drv),
                _f32(t0 + j * dt), y, dt)
            y1, alive1 = _advance(cfg, bounds, y, y_next, alive)
            dstate = _record(outs, y, wnds, alive, y1, alive1, cfg, dstate,
                             k0 + b * stride + j, t_last, dt)
            y, alive = y1, alive1
    return outs, (y, alive, dstate)


def segment_plan(cfg: Namelist, n_steps: int) -> Tuple[int, int]:
    """(stride, n_blocks): the strided blocks of a segment; the remaining
    n_steps - n_blocks*stride steps gather at every step.  No blocks when
    F(t) is analytic (exact stage fields, substeps)."""
    stride = max(1, int(cfg.field_sample_stride))
    if stride > 1 and n_steps >= stride and not analytic_fourier(cfg):
        return stride, n_steps // stride
    return stride, 0


def fourier_grid(cfg: Namelist, params: fast.SeedParams, k0: int,
                 n_steps: int) -> torch.Tensor:
    """F(t) at the segment's sample times, [n_steps, N, W]."""
    ks = torch.arange(k0, k0 + n_steps, dtype=torch.float32,
                      device=params.h_bl.device)
    return params.fourier.evaluate_grid(ks * float(cfg.output_interval_s))


def integrate_segment_plain(stacks: GatherStacks, cfg: Namelist, bounds,
                            y0: fast.State, alive0: torch.Tensor,
                            params: fast.SeedParams, k0: int, n_steps: int,
                            diag: DiagState = None, t_last: int = -1):
    """Samples k0 .. k0+n_steps-1 from the carry (y0, alive0), in torch ops.

    Returns ((lon, lat, v, m, wnds, alive) time-major, (y_end, alive_end)),
    the carry being the state AT sample k0+n_steps.  The strided blocks
    record the colored winds, the per-step remainder the polar-zeroed
    winds of the first RK stage of substep 0, as the JAX package does.
    With rk_substeps > 1 each output step runs that many RK4 substeps
    (dead storms frozen per substep, the events checked once per output
    step); with rk_exact_stage_fields every RK stage gathers and colors
    at its own position and time.

    diag (Namelist.vmax_in_scan): a DiagState carry; the outputs then gain
    a 7th leaf vmax [n_steps, N] (_diag_step on the recorded winds) and
    the carry a 3rd element, the DiagState at the segment's end.  t_last:
    the global index of the run's final output sample, or -1 when this
    segment does not hold it."""
    if y0.lon.is_cuda:
        kernels.PLAIN_ON_CUDA['integrator'] += 1
    dt_out = float(cfg.output_interval_s)
    sub = max(1, int(cfg.rk_substeps))
    dt = dt_out / sub
    stride, n_blocks = segment_plan(cfg, n_steps)
    f_all = (None if analytic_fourier(cfg)
             else fourier_grid(cfg, params, k0, n_steps))
    outs, (y, alive, dstate) = _integrate_blocks(
        stacks, cfg, bounds, y0, alive0, params, f_all, k0, n_blocks, stride,
        dt_out, diag, t_last)
    for j in range(n_blocks * stride, n_steps):
        t = _step_time(k0 + j, dt_out)
        y1, wnds0 = y, None
        for s in range(sub):
            ts = _f32(t + _f32(s * dt))
            if cfg.rk_exact_stage_fields:
                y_next, wnds = _rk4_step(lambda tt, yy: fast.rhs(
                    stacks, cfg, tt, yy, params), ts, y1, dt)
            else:
                y_next, wnds = _rk4_step_frozen_fields(
                    stacks, cfg, params, ts, y1, dt,
                    None if f_all is None else f_all[j])
            if s == 0:
                wnds0 = wnds
            y1 = fast.State(*(torch.where(alive, a, b)
                              for a, b in zip(y_next, y1)))
        alive1 = alive & _events_alive(cfg, bounds, y1)
        dstate = _record(outs, y, wnds0, alive, y1, alive1, cfg, dstate,
                         k0 + j, t_last, dt_out)
        y, alive = y1, alive1
    carry = (y, alive) if diag is None else (y, alive, dstate)
    return tuple(torch.stack(ch) for ch in zip(*outs)), carry


def integrate_segment(stacks: GatherStacks, cfg: Namelist, bounds,
                      y0: fast.State, alive0: torch.Tensor,
                      params: fast.SeedParams, k0: int, n_steps: int,
                      diag: DiagState = None, t_last: int = -1):
    """integrate_segment_plain on CPU tensors; on any other device the CUDA
    integrator kernel, which raises on what it does not take.  The kernel
    reads F(t) from the per-step grid, or evaluates it from the storm's
    Fourier rows where the mode needs it at other times."""
    if y0.lon.device.type == 'cpu':
        return integrate_segment_plain(stacks, cfg, bounds, y0, alive0,
                                       params, k0, n_steps, diag, t_last)
    stride, n_blocks = segment_plan(cfg, n_steps)
    f_all = (None if analytic_fourier(cfg)
             else fourier_grid(cfg, params, k0, n_steps))
    return integrator.integrate_segment_cuda(
        stacks, cfg, bounds, y0, alive0, params, k0, n_steps, f_all, stride,
        n_blocks, diag, t_last)


def genesis_alive_plain(stacks: GatherStacks, cfg: Namelist,
                        y0: fast.State, params: fast.SeedParams,
                        integrate_mask: torch.Tensor):
    """Step-0 alive mask: genesis gates evaluated with the track's own
    Fourier draws (coupled_fast.py:237-244)."""
    if y0.lon.is_cuda:
        kernels.PLAIN_ON_CUDA['genesis'] += 1
    return integrate_mask & fast.ventilation_index_reject(stacks, cfg, y0,
                                                          params)


def genesis_alive(stacks: GatherStacks, cfg: Namelist, y0: fast.State,
                  params: fast.SeedParams, integrate_mask: torch.Tensor):
    """genesis_alive_plain on CPU tensors; on any other device the CUDA
    genesis gate kernel (K7), which raises where the integrator kernel
    raises."""
    if y0.lon.device.type == 'cpu':
        return genesis_alive_plain(stacks, cfg, y0, params, integrate_mask)
    return integrator.genesis_gate_cuda(stacks, cfg, y0, params,
                                        integrate_mask)


def integrate_raw(stacks: GatherStacks, cfg: Namelist, basin_id: str,
                  y0: fast.State, params: fast.SeedParams,
                  integrate_mask: torch.Tensor) -> RawTracks:
    """Integrate the batch for cfg.n_steps_output samples (one segment)."""
    bounds = basins.basin_bounds(cfg, basin_id)
    alive0 = genesis_alive(stacks, cfg, y0, params, integrate_mask)
    (lon, lat, v, m, wnds, alive), _ = integrate_segment(
        stacks, cfg, bounds, y0, alive0, params, 0, cfg.n_steps_output)
    last_step = torch.clamp_min(alive.sum(dim=0) - 1, 0)
    return RawTracks(lon, lat, v, m, wnds, alive, last_step)


def tc_filters_raw(cfg: Namelist, raw: RawTracks):
    """TC identification (util/compute.py:185-189) on the time-major
    buffers: reached seed_v_threshold while alive AND v at 2 days (or at
    death) >= the 2-day threshold.  Returns (is_tc [N], v_2d [N])."""
    steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
    idx_2d = torch.clamp_max(raw.last_step, steps_2d)
    v_2d = torch.gather(raw.v, 0, idx_2d[None, :])[0]
    reached = (torch.where(raw.alive, raw.v, 0.0)
               >= cfg.seed_v_threshold_ms).any(dim=0)
    is_tc = reached & (v_2d >= cfg.seed_v_2d_threshold_ms) & raw.alive[0]
    return is_tc, v_2d


def integrate(pack: FieldPack, cfg: Namelist, basin_id: str, y0: fast.State,
              params: fast.SeedParams,
              integrate_mask: torch.Tensor) -> TrackOutput:
    """The seed-major, NaN-masked view of integrate_raw on the pack's
    stacks (util/compute.py:126-133), for one-shot callers; the launch
    keeps the time-major layout.  On a card it runs K7 and K1."""
    raw = integrate_raw(fields_mod.build_stacks(pack), cfg, basin_id, y0,
                        params, integrate_mask)
    alive = raw.alive.transpose(0, 1)
    mask = lambda x: torch.where(alive, x.transpose(0, 1), math.nan)
    return TrackOutput(mask(raw.lon), mask(raw.lat), mask(raw.v),
                       mask(raw.m),
                       torch.where(alive[..., None], raw.wnds.transpose(0, 1),
                                   math.nan),
                       alive, raw.last_step)


def tc_filters(cfg: Namelist, out: TrackOutput):
    """tc_filters_raw on the seed-major NaN-masked buffers (the NaN of a
    dead sample counts as 0).  Returns (is_tc [N], v_2d [N])."""
    steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
    v = torch.nan_to_num(out.v)
    idx_2d = torch.clamp_max(out.last_step, steps_2d)
    v_2d = torch.gather(v, 1, idx_2d[:, None].to(torch.int64))[:, 0]
    reached = (v >= cfg.seed_v_threshold_ms).any(dim=1)
    is_tc = reached & (v_2d >= cfg.seed_v_2d_threshold_ms) & out.alive[:, 0]
    return is_tc, v_2d
