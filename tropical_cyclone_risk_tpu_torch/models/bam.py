"""Standalone (uncoupled) beta-advection track model (twin of
tropical_cyclone_risk_tpu/models/bam.py).

Reference equivalent: BetaAdvectionTrack.gen_track (track/bam_track.py:
153-178): a forward-Euler track integration with constant steering weights
and no intensity coupling, stopping on basin exit.  The reference keeps it
as a research mode beside the coupled model (the main pipeline calls only
the coupled path, util/compute.py:176).  It runs in plain PyTorch on the
pack's device, the card in production: a loop over the output steps of a
few elementwise operations on [N] storms, with no host synchronisation
and no kernel of its own (its time on the card is in PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fast
from tropical_cyclone_risk_tpu_torch.models.fields import FieldPack
from tropical_cyclone_risk_tpu_torch.ops.fourier import FourierSeries
from tropical_cyclone_risk_tpu_torch.utils import basins

class BamTracks(NamedTuple):
    lon: torch.Tensor     # [N, T] NaN after basin exit
    lat: torch.Tensor
    alive: torch.Tensor   # [N, T]


def gen_tracks(pack: FieldPack, cfg: Namelist, basin_id: str, lon0, lat0,
               plane, fourier: FourierSeries) -> BamTracks:
    """Batched uncoupled BAM tracks with constant steering coefficients
    (track/bam_track.py:147-178): forward Euler at the output interval,
    termination on basin exit (1-degree margin), NaN after it.  lon0,
    lat0 [N] degrees and plane [N] (the storm's (year, month) plane) go to
    the pack's device; fourier holds the storms' A/B [N, W, 15] there."""
    dev = pack.device
    bounds = basins.basin_bounds(cfg, basin_id)
    dt = float(cfg.output_interval_s)
    f32 = dict(dtype=torch.float32, device=dev)
    coefs = torch.tensor(cfg.steering_coefs, **f32)
    lon = torch.as_tensor(lon0, **f32)
    lat = torch.as_tensor(lat0, **f32)
    plane = torch.as_tensor(plane, device=dev)
    alive = torch.ones(lon.shape, dtype=torch.bool, device=dev)
    rows = []
    for k in range(cfg.n_steps_output):
        rows.append((lon, lat, alive))
        t = float(np.float32(k) * np.float32(dt))
        wnds = fast.sample_env_winds(pack, cfg, lon, lat, plane, fourier, t)
        polar = torch.abs(lat) >= 80.0
        wnds = torch.where(polar[:, None], 0.0, wnds)
        w_lat = torch.cos(lat * fast.DEG2RAD)
        u = (wnds[:, 0::2] * coefs).sum(dim=1) + cfg.u_beta * w_lat
        v = ((wnds[:, 1::2] * coefs).sum(dim=1)
             + torch.sign(lat) * cfg.v_beta * w_lat)
        u = torch.where(polar, 0.0, u)
        v = torch.where(polar, 0.0, v)
        # forward-Euler Cartesian step on the sphere (util/sphere.py:48-51)
        lon1 = torch.where(alive, lon + dt * u * fast.RAD_PER_M / w_lat, lon)
        lat1 = torch.where(alive, lat + dt * v * fast.RAD_PER_M, lat)
        alive = alive & basins.in_basin(lon1, lat1, bounds, 1.0)
        lon, lat = lon1, lat1
    lon, lat, alive = (torch.stack(x, dim=1) for x in zip(*rows))
    nan = torch.tensor(float('nan'), **f32)
    return BamTracks(torch.where(alive, lon, nan),
                     torch.where(alive, lat, nan), alive)
