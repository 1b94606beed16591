"""Batched fixed-step track integration (twin of
tropical_cyclone_risk_tpu/models/simulator.py).

Per storm: hourly RK4 steps of the coupled FAST + beta-advection ODEs with
alive-mask termination (leaving the basin with a 1-degree margin, |lat| <= 2
or v <= 4 m/s, coupled_fast.py:246-256); dead storms freeze in place.

``integrate_segment`` is the hot loop.  On a CUDA tensor it launches the
hand-written integrator kernel (kernels/integrator.py, csrc/integrator.cu),
which keeps each storm's state in registers across the whole segment; on a
CPU tensor it runs ``integrate_segment_plain``, the same arithmetic as a
Python loop of torch ops (``lax.scan`` in the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import fast
from tropical_cyclone_risk_tpu_torch.models.fields import GatherStacks
from tropical_cyclone_risk_tpu_torch.utils import basins


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


def check_supported(cfg: Namelist) -> None:
    """Raise for the integration options this port does not implement."""
    unsupported = {
        'time_interp_fields': cfg.time_interp_fields,
        'rk_exact_stage_fields': cfg.rk_exact_stage_fields,
        'rk_substeps > 1': int(cfg.rk_substeps) > 1,
        'vmax_in_scan': cfg.vmax_in_scan,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f'not ported yet: {", ".join(bad)}')


def _events_alive(cfg: Namelist, bounds, y: fast.State):
    """Continuation condition (coupled_fast.py:246-256)."""
    in_b = basins.in_basin(y.lon, y.lat, bounds, 1.0)
    return in_b & (torch.abs(y.lat) > 2.0) & (y.v > 4.0)


def _rk4_step(rhs_fn, y: fast.State, dt: float):
    """Classical RK4; returns (y1, winds of the first stage)."""
    k1, wnds = rhs_fn(y)
    add = lambda a, ka, h: fast.State(*(x + h * dx for x, dx in zip(a, ka)))
    k2, _ = rhs_fn(add(y, k1, dt / 2))
    k3, _ = rhs_fn(add(y, k2, dt / 2))
    k4, _ = rhs_fn(add(y, k3, dt))
    y1 = fast.State(*(x + dt / 6 * (a + 2 * b + 2 * c + d)
                      for x, a, b, c, d in zip(y, k1, k2, k3, k4)))
    return y1, wnds


def _rk4_step_frozen_fields(stacks, cfg, params, y: fast.State, dt, f_t):
    """RK4 step with one field gather and one wind coloring at the step
    start; f_t is the step's Fourier sample F(t) [N, W]."""
    smp = fast.sample_fields(stacks, y.lon, y.lat, params.plane)
    drv = fast.derive_sample(cfg, smp)
    wnds = fast.color_winds_given_f(cfg, smp.wind_stats, f_t)
    return _rk4_step(lambda yy: fast.rhs_given_winds(cfg, yy, params, smp,
                                                     wnds, drv), y, dt)


def _advance(cfg, bounds, y, y_next, alive):
    """Freeze dead storms and apply the termination events."""
    y1 = fast.State(*(torch.where(alive, a, b) for a, b in zip(y_next, y)))
    return y1, alive & _events_alive(cfg, bounds, y1)


def _integrate_blocks(stacks, cfg, bounds, y, alive, params, f_all,
                      n_blocks: int, stride: int, dt: float):
    """Strided steps: one field gather at each block's start position,
    reused for the block's `stride` steps; the Fourier flow, wind coloring
    and ODEs stay per step.  Records the colored winds."""
    outs = []
    for b in range(n_blocks):
        smp = fast.sample_fields(stacks, y.lon, y.lat, params.plane)
        drv = fast.derive_sample(cfg, smp)
        for j in range(stride):
            wnds = fast.color_winds_given_f(cfg, smp.wind_stats,
                                            f_all[b * stride + j])
            y_next, _ = _rk4_step(
                lambda yy, w=wnds: fast.rhs_given_winds(cfg, yy, params, smp,
                                                        w, drv), y, dt)
            outs.append((y.lon, y.lat, y.v, y.m, wnds, alive))
            y, alive = _advance(cfg, bounds, y, y_next, alive)
    return outs, (y, alive)


def segment_plan(cfg: Namelist, n_steps: int) -> Tuple[int, int]:
    """(stride, n_blocks): the strided blocks of a segment; the remaining
    n_steps - n_blocks*stride steps gather at every step."""
    stride = max(1, int(cfg.field_sample_stride))
    if stride > 1 and n_steps >= stride:
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
                            params: fast.SeedParams, k0: int, n_steps: int):
    """Samples k0 .. k0+n_steps-1 from the carry (y0, alive0), in torch ops.

    Returns ((lon, lat, v, m, wnds, alive) time-major, (y_end, alive_end)),
    the carry being the state AT sample k0+n_steps.  The strided blocks
    record the colored winds, the per-step remainder the polar-zeroed
    winds of the first RK stage, as the JAX package does."""
    check_supported(cfg)
    if y0.lon.is_cuda:
        kernels.PLAIN_ON_CUDA['integrator'] += 1
    dt = float(cfg.output_interval_s)
    stride, n_blocks = segment_plan(cfg, n_steps)
    f_all = fourier_grid(cfg, params, k0, n_steps)
    outs, (y, alive) = _integrate_blocks(stacks, cfg, bounds, y0, alive0,
                                         params, f_all, n_blocks, stride, dt)
    for j in range(n_blocks * stride, n_steps):
        y_next, wnds = _rk4_step_frozen_fields(stacks, cfg, params, y, dt,
                                               f_all[j])
        outs.append((y.lon, y.lat, y.v, y.m, wnds, alive))
        y, alive = _advance(cfg, bounds, y, y_next, alive)
    return tuple(torch.stack(ch) for ch in zip(*outs)), (y, alive)


def integrate_segment(stacks: GatherStacks, cfg: Namelist, bounds,
                      y0: fast.State, alive0: torch.Tensor,
                      params: fast.SeedParams, k0: int, n_steps: int):
    """integrate_segment_plain on CPU tensors; on any other device the CUDA
    integrator kernel, which raises on what it does not take."""
    if y0.lon.device.type == 'cpu':
        return integrate_segment_plain(stacks, cfg, bounds, y0, alive0,
                                       params, k0, n_steps)
    check_supported(cfg)
    stride, n_blocks = segment_plan(cfg, n_steps)
    return integrator.integrate_segment_cuda(
        stacks, cfg, bounds, y0, alive0, params.plane, params.h_bl,
        fourier_grid(cfg, params, k0, n_steps), stride, n_blocks)


def genesis_alive(stacks: GatherStacks, cfg: Namelist, y0: fast.State,
                  params: fast.SeedParams, integrate_mask: torch.Tensor):
    """Step-0 alive mask: genesis gates evaluated with the track's own
    Fourier draws (coupled_fast.py:237-244)."""
    return integrate_mask & fast.ventilation_index_reject(stacks, cfg, y0,
                                                          params)


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
