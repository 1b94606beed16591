"""The year driver's delivered tracks on a CUDA card: a settled year's
arrays are views of its group's pinned host buffer, and they keep their
values while torch's caching host allocator hands its other blocks out
again to later members.

Imports no JAX, so it runs on a machine with a card, without the JAX
package and without tests/conftest.py:

    python -m pytest tests/test_torch_pinned_views.py --noconftest -q -p no:cacheprovider

Elsewhere it skips (the ``cuda_card`` fixture).
"""

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fields, pipeline

SEG = dict(integrate_cap=0.375, recompact_schedule=((90, 0.75), (180, 0.5)))
KEYS = pipeline.YEAR_FIELDS + ('n_seeds',)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.card
def test_pinned_views_survive_cache_reuse(cuda_card, monkeypatch):
    """Member 0's years are kept and copied as delivered; members 1 and 2
    run after it, member 1's years dropped before member 2, so member 2's
    transfers take member 1's freed blocks.  No block that member 0's
    years hold is handed out again, and they still equal their copies."""
    cfg = Namelist(seed_batch=8192, end_year=2019, tracks_per_year=5
                   ).replace(**SEG)
    years = list(cfg.years())
    pack = fields.synthetic_pack(cfg, 12 * len(years), 91, 180, seed=0,
                                 device=str(cuda_card))
    made = []

    class Recorded(pipeline.Transfer):
        def __init__(self, tensors):
            super().__init__(tensors)
            made.append(self)

    monkeypatch.setattr(pipeline, 'Transfer', Recorded)
    base = rng.key(11)

    def member(i):
        made.clear()
        out = pipeline.run_tracks_years_fused(rng.fold_in(base, i), pack,
                                              cfg, 'GL', years)
        torch.cuda.synchronize()
        bufs = [(x._host.data_ptr(), x._host.numpy()) for x in made]
        assert bufs and all(x._host.is_pinned() for x in made)
        made.clear()
        return out, bufs

    kept, bufs0 = member(0)
    snap = [{k: getattr(y, k).copy() for k in KEYS} for y in kept]
    assert any(np.shares_memory(y.lon, b) for y in kept for _, b in bufs0)
    held = {p for p, b in bufs0
            if any(np.shares_memory(getattr(y, k), b) for y in kept
                   for k in pipeline.YEAR_FIELDS)}
    bufs0 = None
    out1, bufs1 = member(1)
    ptrs1 = {p for p, _ in bufs1}
    out1 = bufs1 = None
    out2, bufs2 = member(2)
    ptrs2 = {p for p, _ in bufs2}
    assert ptrs2 & ptrs1, 'member 2 took none of member 1\'s blocks'
    assert not (held & (ptrs1 | ptrs2))
    for y, ref in zip(kept, snap):
        for k in KEYS:
            np.testing.assert_array_equal(getattr(y, k), ref[k], err_msg=k)
    assert any(not np.array_equal(a.lon, b.lon, equal_nan=True)
               for a, b in zip(kept, out2))
