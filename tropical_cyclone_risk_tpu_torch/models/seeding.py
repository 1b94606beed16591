"""Vectorized genesis seeding (twin of
tropical_cyclone_risk_tpu/models/seeding.py).

Each batch slot draws R proposal rounds up front (round 0 area-weighted,
retries uniform over the basin bounds) and takes the first round that lands
on the run-basin ocean mask; month, basin assignment, equatorward rejection
and the PI gate follow (util/compute.py:134-175).  Draws come from the
threefry twin (rng.py) with the JAX package's key splits, so both packages
propose the same seeds from the same key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.models import fields as F
from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
from tropical_cyclone_risk_tpu_torch.ops import interp
from tropical_cyclone_risk_tpu_torch.utils import basins

N_RETRY_ROUNDS = 16    # proposal rounds per slot (see the JAX package)


def _round256(w: float, lo: int, hi: int) -> int:
    w = int(-(-int(w) // 256) * 256)
    return min(hi, max(lo, w))


def _sin_deg_f32(x: float) -> float:
    """float32 sin(deg2rad(x)) of a Python scalar, as jnp rounds it."""
    t = torch.tensor([x], dtype=torch.float32)
    return float(torch.sin(t * (math.pi / 180.0))[0])


def _position_rounds(k_lon, k_lat0, k_latr, b, n: int, device):
    """[R, n] lon/lat proposals: round 0 area-weighted over the genesis belt
    [3, 45] per hemisphere, retries uniform over the basin bounds."""
    R = N_RETRY_ROUNDS
    lon_r = rng.uniform(k_lon, (R, n), b[0], b[2], device)
    lat_min = 3.0 if b[1] >= 0 else -45.0
    lat_max = 45.0 if b[3] >= 0 else -3.0
    y = rng.uniform(k_lat0, (n,), _sin_deg_f32(lat_min),
                    _sin_deg_f32(lat_max), device)
    lat_r = rng.uniform(k_latr, (R, n), b[1], b[3], device)
    lat_r[0] = torch.asin(y) * (180.0 / math.pi)
    return lon_r, lat_r


class SeedProposal(NamedTuple):
    lon: torch.Tensor          # [N]
    lat: torch.Tensor          # [N]
    month: torch.Tensor        # [N] int32, 1..12
    basin_idx: torch.Tensor    # [N] int64 into basin_ids_sorted()
    counted: torch.Tensor      # [N] bool: contributes to seeds_per_month
    integrate: torch.Tensor    # [N] bool: passes the PI gate
    dropped: torch.Tensor      # [N] bool: every proposal round missed
    v_init: torch.Tensor       # [N]
    m_init: torch.Tensor       # [N]
    h_bl: torch.Tensor         # [N]
    plane: torch.Tensor        # [N] int64 field plane


def _mask_lookup(pack: F.FieldPack):
    run_mask4 = interp.pack_corners(pack.run_mask[..., None])
    return lambda lo, la: interp.bilinear_packed(run_mask4, pack.mask_grid,
                                                 lo, la)[..., 0]


def propose_seeds(key: rng.Key, pack: F.FieldPack, cfg: Namelist,
                  basin_id: str, n: int,
                  plane_offset: int = 0) -> SeedProposal:
    dev = pack.device
    b = basins.basin_bounds(cfg, basin_id)
    k_lon, k_lat0, k_latr, k_month, k_reject, k_vinit = rng.split(key, 6)

    R = N_RETRY_ROUNDS
    lon_r, lat_r = _position_rounds(k_lon, k_lat0, k_latr, b, n, dev)
    mval = _mask_lookup(pack)
    caps = cfg.seed_retry_caps
    if caps is None:
        passes = mval(lon_r.reshape(-1), lat_r.reshape(-1)).reshape(R, n) \
            >= 1e-2
        first = torch.argmax(passes.to(torch.uint8), dim=0)
        any_pass = passes.any(dim=0)
    else:
        # retry-round compaction: each retry round tests only the still
        # unresolved slots, compacted slot-stably to width ~ caps[r-1] * n;
        # bit-identical to the full-width path while every unresolved slot
        # fits (an unresolved slot beyond a width is dropped)
        pass0 = mval(lon_r[0], lat_r[0]) >= 1e-2
        first = torch.where(pass0, 0, R)
        ur = ~pass0
        a_idx = None
        cur_w = n
        for r in range(1, R):
            cap = float(caps[min(r - 1, len(caps) - 1)])
            w = _round256(n * cap, 256, cur_w)
            order = compact_ops.stable_partition_order(ur, w)
            a_idx = order if a_idx is None else a_idx[order]
            active = ur[order]
            val = mval(lon_r[r][a_idx], lat_r[r][a_idx])
            pass_c = active & (val >= 1e-2)
            first = first.scatter_reduce(
                0, a_idx, torch.where(pass_c, r, R), 'amin')
            ur = active & ~pass_c
            cur_w = w
        any_pass = first < R
    first_idx = torch.where(any_pass, torch.clamp_max(first, R - 1), 0)
    lon = torch.gather(lon_r, 0, first_idx[None])[0]
    lat = torch.gather(lat_r, 0, first_idx[None])[0]

    # month and field plane (util/compute.py:151-152)
    month = rng.randint(k_month, (n,), 1, 13, dev)
    plane_raw = plane_offset + month.to(torch.int64) - cfg.start_month
    n_planes = pack.env.shape[0]
    plane_ok = (plane_raw >= 0) & (plane_raw < n_planes)
    plane = torch.clamp(plane_raw, 0, n_planes - 1)

    # basin assignment (util/compute.py:155-158)
    basin_vals = interp.bilinear_packed(
        interp.pack_corners(pack.basin_masks), pack.mask_grid, lon, lat)
    basin_max, basin_idx = torch.max(basin_vals, dim=1)
    basin_ok = basin_max > 1e-3

    # equatorward rejection (util/compute.py:160-166)
    powers = torch.tensor(cfg.lat_vort_power_by_basin(), dtype=torch.float32,
                          device=dev)
    p_lat = torch.clamp((torch.abs(lat) - cfg.lat_vort_fac) / 12.0, 0.0, 1.0) \
        ** powers[basin_idx]
    u = rng.uniform(k_reject, (n,), device=dev)
    counted = any_pass & basin_ok & (u < p_lat)

    # PI gate (util/compute.py:162,168-169)
    env = interp.bilinear_packed(interp.pack_corners(pack.env), pack.grid,
                                 lon, lat, plane)
    integrate = counted & plane_ok & (env[:, F.VPOT] > 35.0)

    # initial state (util/compute.py:172-175)
    v_init = cfg.seed_v_init_ms + rng.normal(k_vinit, (n,), dev)
    rh = env[:, F.RH]
    sigmoid_den = 1.0 + torch.exp(-(rh - cfg.m_init_mid) * cfg.m_init_slope)
    m_init = torch.clamp_min(
        torch.full_like(rh, cfg.m_init_amp) / sigmoid_den + cfg.m_init_base,
        0.0)
    h_bls = torch.tensor(cfg.h_bl_by_basin(), dtype=torch.float32, device=dev)
    return SeedProposal(lon, lat, month, basin_idx, counted, integrate,
                        ~any_pass, v_init, m_init, h_bls[basin_idx], plane)


def retry_unresolved_curve(key: rng.Key, pack: F.FieldPack, cfg: Namelist,
                           basin_id: str, n: int) -> np.ndarray:
    """[R] slots still unresolved after each proposal round of a full-width
    seeding pass, from the exact proposal stream of propose_seeds."""
    b = basins.basin_bounds(cfg, basin_id)
    k_lon, k_lat0, k_latr, *_ = rng.split(key, 6)
    lon_r, lat_r = _position_rounds(k_lon, k_lat0, k_latr, b, n, pack.device)
    miss = (_mask_lookup(pack)(lon_r.reshape(-1), lat_r.reshape(-1))
            .reshape(N_RETRY_ROUNDS, n) < 1e-2).to(torch.int64)
    return torch.cumprod(miss, dim=0).sum(dim=1).cpu().numpy()


def count_seeds_per_month(basin_idx, month, counted, n_basins: int,
                          upto: int | None = None):
    """seeds_per_month[basin, month] from per-slot metadata, optionally
    truncated at slot `upto` inclusive (the reference's stopping rule).
    Host-side numpy."""
    basin_idx = np.asarray(basin_idx)
    month = np.asarray(month)
    counted = np.asarray(counted)
    if upto is not None:
        sl = slice(0, upto + 1)
        basin_idx, month, counted = basin_idx[sl], month[sl], counted[sl]
    out = np.zeros((n_basins, 12))
    np.add.at(out, (basin_idx[counted], month[counted] - 1), 1)
    return out
