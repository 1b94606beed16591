"""Miscellaneous utilities (copy of tropical_cyclone_risk_tpu/utils/util.py,
reading through the port's own io.netcdf).

Reference equivalent: util/util.py.  Of its contents: the wall-clock RNG
seeding (util/util.py:24-29) is intentionally NOT replicated (keyed
threefry streams, rng.py, replace it — SURVEY.md section 7 quirks); the
realtime-download helpers (util/util.py:48-67) reference a script absent
from the reference snapshot and are dead code; ``is_nc_file_valid`` had a
latent NameError (Dataset never imported) that is fixed here.
"""

from __future__ import annotations

import numpy as np


def inv_trans_sampling(data, n_bins: int = 40, n_samples: int = 1000,
                       rng=None) -> np.ndarray:
    """Inverse-transform sampling from an empirical histogram
    (util/util.py:11-17; uncalled in the reference pipeline, kept for API
    parity).  Deterministic when given a numpy Generator."""
    rng = rng or np.random.default_rng()
    hist, edges = np.histogram(np.asarray(data), bins=n_bins, density=True)
    cum = np.zeros(edges.shape)
    cum[1:] = np.cumsum(hist * np.diff(edges))
    r = rng.random(n_samples)
    return np.interp(r, cum, edges)


def is_nc_file_valid(fn: str) -> bool:
    """True iff the path is a readable NetCDF file (fixed version of
    util/util.py:37-46, which referenced an unimported Dataset class)."""
    from tropical_cyclone_risk_tpu_torch.io import netcdf
    try:
        netcdf.read(fn)
        return True
    except Exception:
        return False
