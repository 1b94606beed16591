"""Vectorized genesis seeding (twin of
tropical_cyclone_risk_tpu/models/seeding.py).

Each batch slot draws R proposal rounds (round 0 area-weighted, retries
uniform over the basin bounds) and takes the first round that lands on the
run-basin ocean mask; month, basin assignment, equatorward rejection and
the PI gate follow (util/compute.py:134-175).  Draws come from the threefry
stream (rng.py) with the JAX package's key splits, so both packages
propose the same seeds from the same key.

On a CUDA device ``propose_seeds`` and ``retry_unresolved_curve`` launch K3
(csrc/seeding.cu via kernels/seeding.py), which draws each slot's rounds
lazily; on the CPU they run the plain twins, which draw all R rounds up
front with the plain threefry twins (so on the card a twin is independent
of K3 and K5).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch import kernels, rng
from tropical_cyclone_risk_tpu_torch.models import fast
from tropical_cyclone_risk_tpu_torch.models import fields as F
from tropical_cyclone_risk_tpu_torch.ops import compact as compact_ops
from tropical_cyclone_risk_tpu_torch.ops import interp
from tropical_cyclone_risk_tpu_torch.utils import basins

N_RETRY_ROUNDS = 16    # proposal rounds per slot (see the JAX package)
# the thresholds of util/compute.py:134-175, shared with K3's parameters
MASK_PASS = 1e-2       # a proposal lands on the run mask
BASIN_MIN = 1e-3       # the largest basin-mask value assigns a basin
LAT_VORT_SCALE = 12.0  # equatorward rejection: (|lat| - fac) / 12 degrees
VPOT_GATE = 35.0       # PI gate (m/s)


def _round256(w: float, lo: int, hi: int) -> int:
    w = int(-(-int(w) // 256) * 256)
    return min(hi, max(lo, w))


def retry_widths(cfg: Namelist, n: int) -> list:
    """[R - 1] widths of the compacted retry rounds 1..R-1 under
    cfg.seed_retry_caps (each ~ caps[r-1] * n, rounded up to 256,
    non-increasing)."""
    caps = cfg.seed_retry_caps
    widths, cur_w = [], n
    for r in range(1, N_RETRY_ROUNDS):
        cap = float(caps[min(r - 1, len(caps) - 1)])
        cur_w = _round256(n * cap, 256, cur_w)
        widths.append(cur_w)
    return widths


def _sin_deg_f32(x: float) -> float:
    """float32 sin(deg2rad(x)) of a Python scalar, as jnp rounds it."""
    t = torch.tensor([x], dtype=torch.float32)
    return float(torch.sin(t * (math.pi / 180.0))[0])


def lat0_bounds(b) -> tuple:
    """Bounds of round 0's uniform draw in sin(latitude): the genesis belt
    [3, 45] degrees in the basin's hemisphere (sign(0) >= 0)."""
    lat_min = 3.0 if b[1] >= 0 else -45.0
    lat_max = 45.0 if b[3] >= 0 else -3.0
    return _sin_deg_f32(lat_min), _sin_deg_f32(lat_max)


def _position_rounds(k_lon, k_lat0, k_latr, b, n: int, device):
    """[R, n] lon/lat proposals: round 0 area-weighted over the genesis belt
    [3, 45] per hemisphere, retries uniform over the basin bounds."""
    R = N_RETRY_ROUNDS
    lon_r = rng.uniform_plain(k_lon, (R, n), b[0], b[2], device)
    y = rng.uniform_plain(k_lat0, (n,), *lat0_bounds(b), device)
    lat_r = rng.uniform_plain(k_latr, (R, n), b[1], b[3], device)
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


def _count_plain(pack: F.FieldPack) -> None:
    if pack.device.type == 'cuda':
        kernels.PLAIN_ON_CUDA['seeding'] += 1


def propose_seeds(key: rng.Key, pack: F.FieldPack, cfg: Namelist,
                  basin_id: str, n: int,
                  plane_offset: int = 0) -> SeedProposal:
    """n seed proposals from ``key``: K3 for a pack on a CUDA device, the
    plain twin on the CPU."""
    if pack.device.type == 'cuda':
        from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
        return SeedProposal(*k3.propose_seeds_cuda(key, pack, cfg, basin_id,
                                                   n, plane_offset))
    return propose_seeds_plain(key, pack, cfg, basin_id, n, plane_offset)


def propose_seeds_plain(key: rng.Key, pack: F.FieldPack, cfg: Namelist,
                        basin_id: str, n: int,
                        plane_offset: int = 0) -> SeedProposal:
    """Plain twin of ``propose_seeds``."""
    _count_plain(pack)
    dev = pack.device
    b = basins.basin_bounds(cfg, basin_id)
    k_lon, k_lat0, k_latr, k_month, k_reject, k_vinit = rng.split(key, 6)

    R = N_RETRY_ROUNDS
    lon_r, lat_r = _position_rounds(k_lon, k_lat0, k_latr, b, n, dev)
    mval = _mask_lookup(pack)
    if cfg.seed_retry_caps is None:
        passes = mval(lon_r.reshape(-1), lat_r.reshape(-1)).reshape(R, n) \
            >= MASK_PASS
        first = torch.argmax(passes.to(torch.uint8), dim=0)
        any_pass = passes.any(dim=0)
    else:
        # retry-round compaction: each retry round tests only the still
        # unresolved slots, compacted slot-stably to width ~ caps[r-1] * n;
        # bit-identical to the full-width path while every unresolved slot
        # fits (an unresolved slot beyond a width is dropped)
        pass0 = mval(lon_r[0], lat_r[0]) >= MASK_PASS
        first = torch.where(pass0, 0, R)
        ur = ~pass0
        a_idx = None
        for r, w in enumerate(retry_widths(cfg, n), start=1):
            order = compact_ops.stable_partition_order(ur, w)
            a_idx = order if a_idx is None else a_idx[order]
            active = ur[order]
            val = mval(lon_r[r][a_idx], lat_r[r][a_idx])
            pass_c = active & (val >= MASK_PASS)
            first = first.scatter_reduce(
                0, a_idx, torch.where(pass_c, r, R), 'amin')
            ur = active & ~pass_c
        any_pass = first < R
    first_idx = torch.where(any_pass, torch.clamp_max(first, R - 1), 0)
    lon = torch.gather(lon_r, 0, first_idx[None])[0]
    lat = torch.gather(lat_r, 0, first_idx[None])[0]

    # month and field plane (util/compute.py:151-152)
    month = rng.randint_plain(k_month, (n,), 1, 13, dev)
    plane_raw = plane_offset + month.to(torch.int64) - cfg.start_month
    n_planes = pack.env.shape[0]
    plane_ok = (plane_raw >= 0) & (plane_raw < n_planes)
    plane = torch.clamp(plane_raw, 0, n_planes - 1)

    # basin assignment (util/compute.py:155-158)
    basin_vals = interp.bilinear_packed(
        interp.pack_corners(pack.basin_masks), pack.mask_grid, lon, lat)
    basin_max, basin_idx = torch.max(basin_vals, dim=1)
    basin_ok = basin_max > BASIN_MIN

    # equatorward rejection (util/compute.py:160-166); a true division,
    # as the JAX package and K3 divide
    powers = torch.tensor(cfg.lat_vort_power_by_basin(), dtype=torch.float32,
                          device=dev)
    p_lat = torch.clamp(interp.true_div(torch.abs(lat) - cfg.lat_vort_fac,
                                        LAT_VORT_SCALE), 0.0, 1.0) \
        ** powers[basin_idx]
    u = rng.uniform_plain(k_reject, (n,), device=dev)
    counted = any_pass & basin_ok & (u < p_lat)

    # PI gate (util/compute.py:162,168-169)
    env = interp.bilinear_packed(interp.pack_corners(pack.env), pack.grid,
                                 lon, lat, plane)
    integrate = counted & plane_ok & (env[:, F.VPOT] > VPOT_GATE)

    # initial state (util/compute.py:172-175)
    v_init = cfg.seed_v_init_ms + rng.normal_plain(k_vinit, (n,), dev)
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
    seeding pass, from the exact proposal stream of propose_seeds: K3's
    histogram of first passing rounds on a CUDA device, the plain twin on
    the CPU."""
    if pack.device.type == 'cuda':
        from tropical_cyclone_risk_tpu_torch.kernels import seeding as k3
        return k3.retry_unresolved_curve_cuda(key, pack, cfg, basin_id, n)
    return retry_unresolved_curve_plain(key, pack, cfg, basin_id, n)


def retry_unresolved_curve_plain(key: rng.Key, pack: F.FieldPack,
                                 cfg: Namelist, basin_id: str,
                                 n: int) -> np.ndarray:
    """Plain twin of ``retry_unresolved_curve``."""
    _count_plain(pack)
    b = basins.basin_bounds(cfg, basin_id)
    k_lon, k_lat0, k_latr, *_ = rng.split(key, 6)
    lon_r, lat_r = _position_rounds(k_lon, k_lat0, k_latr, b, n, pack.device)
    miss = (_mask_lookup(pack)(lon_r.reshape(-1), lat_r.reshape(-1))
            .reshape(N_RETRY_ROUNDS, n) < MASK_PASS).to(torch.int64)
    return torch.cumprod(miss, dim=0).sum(dim=1).cpu().numpy()


def initial_state(prop: SeedProposal):
    """The integration's start state (lon, lat, v, m) of the proposals."""
    return fast.State(prop.lon, prop.lat, prop.v_init, prop.m_init)


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
